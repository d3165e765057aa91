"""Checkpoint tooling: look inside a checkpoint, convert a reference
``.pth.tar`` to numpy, export a port pretraining run to a reference
``.pth.tar`` (counterpart of scripts/checkpoints.py).

    python -m avid_cma_tpu_torch.scripts.checkpoints inspect <ckpt.pth.tar | port run dir>
    python -m avid_cma_tpu_torch.scripts.checkpoints convert <ckpt.pth.tar> <out_dir>
    python -m avid_cma_tpu_torch.scripts.checkpoints export <port run dir> <out.pth.tar> \\
        [--lr LR] [--weight-decay WD]

``convert`` writes ``model.npz`` (the port's state-dict keys, which are
the reference's without ``module.``) and, where the checkpoint has a
``train_criterion``, ``criterion.npz`` (``view1_mem``, ``view2_mem``,
``z``). ``export`` reads the newest checkpoint of a run that
``main_avid_torch.py`` wrote (its ``config.yaml`` gives the
architecture) and writes the reference's layout: the model, the Adam
moments in the reference's parameter order, the banks and Z; the
param-group ``lr`` and ``weight_decay`` are the run's own unless given.
The JAX package's ``download`` of the released checkpoints has no
counterpart here: it needs the network, and the port never fetches.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train.checkpoint import (
    export_pth_tar,
    import_criterion_pth_tar,
    import_model_pth_tar,
    latest_run_payload,
)
from avid_cma_tpu_torch.train.optim import build_optimizer


def _describe(section: str, sd: dict, rows: int = 8) -> None:
    tensors = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    print(f"[{section}] {len(tensors)} tensors")
    for k, v in list(tensors.items())[:rows]:
        print(f"  {k}: {tuple(v.shape)} {v.dtype}")


def cmd_inspect(args) -> None:
    """The sections of a ``.pth.tar`` or of a port run's newest
    checkpoint, and the first tensors of each state dict."""
    if os.path.isdir(args.path):
        ckp = latest_run_payload(args.path)
        print(f"port run checkpoint: step {ckp['step']}, epoch {ckp['epoch']}")
    else:
        ckp = torch.load(args.path, map_location="cpu", weights_only=False)
    print("keys:", list(ckp.keys()))
    for section in ("model", "train_criterion", "bank"):
        if isinstance(ckp.get(section), dict):
            _describe(section, ckp[section])


def cmd_convert(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    model = import_model_pth_tar(args.path)
    np.savez(os.path.join(args.out, "model.npz"),
             **{k: v.numpy() for k, v in model.items()})
    try:
        bank = import_criterion_pth_tar(args.path)
    except KeyError:
        print("no train_criterion section; model only")
    else:
        np.savez(os.path.join(args.out, "criterion.npz"), view1_mem=bank.view1_mem.numpy(),
                 view2_mem=bank.view2_mem.numpy(), z=bank.z.numpy())
    print(f"wrote {args.out}/model.npz")


def cmd_export(args) -> None:
    """A port pretraining run's newest checkpoint -> the reference's
    ``.pth.tar`` (utils/main_utils.py:271-287), resumable by the
    reference."""
    cfg_path = os.path.join(args.path, "config.yaml")
    if not os.path.isfile(cfg_path):
        raise SystemExit(f"error: {args.path} has no config.yaml: not a port pretraining run")
    pcfg = builders.pretrain_config(config_lib.load(cfg_path), num_data=1)
    payload = latest_run_payload(args.path)
    model = av_wrapper(pcfg.video_backbone, {"depth": pcfg.video_depth}, pcfg.audio_backbone,
                       {"depth": pcfg.audio_depth}, proj_dim=list(pcfg.proj_dim),
                       device="cpu", dtype="float32")
    model.load_state_dict(payload["model"], strict=True)
    optimizer = None
    if pcfg.optimizer == "adam" and payload.get("optimizer"):
        optimizer = build_optimizer(model.parameters(), "adam", pcfg.base_lr,
                                    weight_decay=pcfg.weight_decay)
        optimizer.load_state_dict(payload["optimizer"])
        for group in optimizer.param_groups:
            if args.lr is not None:
                group["lr"] = args.lr
            if args.weight_decay is not None:
                group["weight_decay"] = args.weight_decay
    else:
        print("note: no Adam moments in the run; exporting the model and banks only")
    bank = payload.get("bank")
    if bank is not None:
        bank = BankState(view1_mem=bank["view1_mem"], view2_mem=bank["view2_mem"], z=bank["z"])
    export_pth_tar(args.out, model, bank=bank, epoch=int(payload["epoch"]), optimizer=optimizer)
    print(f"wrote {args.out}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    i = sub.add_parser("inspect", help="sections and first tensors of a checkpoint")
    i.add_argument("path", help="a .pth.tar or a port run's directory")
    i.set_defaults(fn=cmd_inspect)
    c = sub.add_parser("convert", help=".pth.tar -> model.npz (+ criterion.npz)")
    c.add_argument("path")
    c.add_argument("out")
    c.set_defaults(fn=cmd_convert)
    e = sub.add_parser("export", help="a port pretraining run -> a reference .pth.tar")
    e.add_argument("path", help="the run's directory, <model_dir>/<name>")
    e.add_argument("out", help="output .pth.tar")
    e.add_argument("--lr", type=float, default=None, help="param-group lr to record")
    e.add_argument("--weight-decay", dest="weight_decay", type=float, default=None)
    e.set_defaults(fn=cmd_export)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
