"""Command line of the port's pretraining entry point (counterpart of
main_avid.py's argument parsing): ``main_avid_torch.py``'s parser and
body. The eval CLIs come with the eval port (ROADMAP A7); multi-process
runs (``--multihost``) with A6."""

from __future__ import annotations

import argparse
from typing import List, Optional

from avid_cma_tpu_torch import config as config_lib


def pretrain_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="AVID and AVID-CMA pretraining on one NVIDIA card (PyTorch/CUDA port)")
    p.add_argument("cfg", help="YAML config (reference schema)")
    p.add_argument("--debug", action="store_true",
                   help="tiny batch, 1 worker, 2 epochs (reference --debug)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress stdout/file logging (reference --quiet)")
    p.add_argument("--seed", type=int, default=None,
                   help="override the config seed (reference --seed)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config overrides")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def pretrain_main(argv: Optional[List[str]] = None):
    """Parse ``argv``, load the config with the flags folded in as
    overrides, and run the pretraining loop; returns the final state."""
    args = pretrain_arg_parser().parse_args(argv)
    overrides = list(args.overrides)
    if args.quiet:
        overrides.append("quiet=true")
    if args.seed is not None:
        overrides.append(f"seed={args.seed}")
    cfg = config_lib.load(args.cfg, overrides=overrides)

    from avid_cma_tpu_torch.train.loop import run_pretraining

    return run_pretraining(cfg, debug=args.debug, device=args.device)
