"""Command lines of the port's entry points (counterpart of main_avid.py's
argument parsing and avid_cma_tpu/cli.py): ``main_avid_torch.py``'s
parser and body, and the parser the two eval CLIs share
(``eval_action_recg_torch.py``, ``eval_action_recg_linear_torch.py``).
``--multihost`` makes the pretraining process one rank of a torchrun
launch; on the eval CLIs it still raises (ROADMAP A6b)."""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.config import Config


def pretrain_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="AVID and AVID-CMA pretraining on NVIDIA cards (PyTorch/CUDA port)")
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
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a multi-process run launched by torchrun "
                        "(--nproc-per-node=<gpus>): the process group comes up from "
                        "torchrun's environment, NCCL on the cards, gloo with --device cpu; "
                        "a failure raises")
    return p


def pretrain_main(argv: Optional[List[str]] = None,
                  on_epoch: Optional[Callable[[Dict], None]] = None):
    """Parse ``argv``, load the config with the flags folded in as
    overrides, and run the pretraining loop (``on_epoch`` as
    ``run_pretraining``'s); returns the final state. With
    ``--multihost`` the process group comes up first and is destroyed at
    the end; without it, ``WORLD_SIZE`` > 1 raises naming the flag."""
    args = pretrain_arg_parser().parse_args(argv)
    overrides = list(args.overrides)
    if args.quiet:
        overrides.append("quiet=true")
    if args.seed is not None:
        overrides.append(f"seed={args.seed}")
    cfg = config_lib.load(args.cfg, overrides=overrides)

    from avid_cma_tpu_torch.parallel import mesh
    from avid_cma_tpu_torch.train.loop import run_pretraining

    if args.multihost:
        mesh.initialize(args.device)
    try:
        return run_pretraining(cfg, debug=args.debug, device=args.device, on_epoch=on_epoch)
    finally:
        if args.multihost:
            mesh.shutdown()


def eval_arg_parser(description: str) -> argparse.ArgumentParser:
    """The flags both eval CLIs take (avid_cma_tpu/cli.py:18-32), plus
    ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("eval_cfg", help="eval YAML (configs/benchmark/...)")
    p.add_argument("model_cfg", help="pretraining YAML whose model section names the run")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--test-only", dest="test_only", action="store_true",
                   help="skip training; evaluate the saved checkpoint")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process evaluation (not ported yet: raises, ROADMAP A6b)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted overrides of the eval config")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def parse_eval_args(p: argparse.ArgumentParser, argv: Optional[List[str]] = None
                    ) -> Tuple[argparse.Namespace, Config, Config]:
    """Parse ``argv``, fold the boolean flags into eval-config overrides
    (the loops read them as config keys) and load both configs; returns
    (args, eval_cfg, model_cfg), model_cfg being the model section."""
    args = p.parse_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "--multihost: multi-process evaluation is not ported yet (ROADMAP A6b, the "
            "eval half of A6; pretraining runs multi-process)")
    for flag in ("test_only", "resume", "quiet"):
        if getattr(args, flag):
            args.overrides.append(f"{flag}=true")
    eval_cfg = config_lib.load(args.eval_cfg, overrides=args.overrides)
    model_cfg = config_lib.load(args.model_cfg).model
    return args, eval_cfg, model_cfg


def finetune_main(argv: Optional[List[str]] = None):
    """``eval_action_recg_torch.py``: the full finetune of one fold."""
    p = eval_arg_parser("UCF-101 / HMDB-51 full finetune on one NVIDIA card "
                        "(PyTorch/CUDA port)")
    p.add_argument("--fold", type=int, default=None)
    args, eval_cfg, model_cfg = parse_eval_args(p, argv)

    from avid_cma_tpu_torch.train.eval_loop import run_action_recognition

    results = run_action_recognition(eval_cfg, model_cfg, fold=args.fold, debug=args.debug,
                                     device=args.device)
    print(results)
    return results


def linear_probe_main(argv: Optional[List[str]] = None):
    """``eval_action_recg_linear_torch.py``: the linear probe of every fold."""
    p = eval_arg_parser("Kinetics-400 multi-tap linear probe on one NVIDIA card "
                        "(PyTorch/CUDA port)")
    args, eval_cfg, model_cfg = parse_eval_args(p, argv)

    from avid_cma_tpu_torch.train.eval_loop import run_linear_probe

    out = {}
    for fold in range(1, int(eval_cfg.dataset.get("num_folds", 1)) + 1):
        out[fold] = run_linear_probe(eval_cfg, model_cfg, fold=fold, debug=args.debug,
                                     device=args.device)
        print(f"fold {fold}: {out[fold]}")
    return out
