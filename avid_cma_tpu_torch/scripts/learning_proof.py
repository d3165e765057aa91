"""End-to-end learning proof: pretrain, then transfer above chance, or
fail (counterpart of scripts/learning_proof.py, with its defaults and
gates).

    python -m avid_cma_tpu_torch.scripts.learning_proof [--criterion avid|avid_cma] \\
        [--dtype float32|bfloat16|auto] [--device cuda|cpu] [--out PATH]

A short AVID pretraining through the port's ``run_pretraining`` on the
learnable synthetic A/V dataset (``data/learnable.py``: labels
recoverable from either modality, a per-instance latent shared by both),
then

  (a) cross-modal retrieval on UNSEEN instances in NCE space
      (``extract_features --space nce`` and ``retrieval.recall_metrics``):
      R@1 must reach ``--r1-factor`` x chance in both directions, and
  (b) a closed-form ridge probe (z-scored pool features, lambda 10) on
      frozen video features: top-1 must reach ``--probe-factor`` x chance.

It catches sign, wiring and BatchNorm-mode faults that the parity tests,
single steps and short trajectories, cannot see.

``--criterion avid_cma`` proves the second stage too: the AVID stage
above (its metrics the record's ``avid`` section), then AVID-CMA
warm-started from that run's directory (weights, banks and Z), mining
consensus positives at the start and every ``--resample-freq`` epochs.
Its gates (the ``cma`` section): the label purity of the positives mined
from the AVID banks >= ``--purity-factor`` x chance; the probe after CMA
>= ``--probe-factor`` x chance; retrieval R@1 after CMA >=
``--cma-r1-factor`` x chance (a retention gate, weaker than AVID's:
positive-set expansion trades instance alignment for class structure).

The defaults are the JAX script's (128 train / 64 test instances, 8
classes, batch 16, crop 56, 8 frames, 1 s of audio, 64 negatives, lr
1e-3, 400 epochs; CMA 60 epochs at lr 2e-4, pos_k 2, resampled every 40).
``--dtype float32`` is the default: the instance latent is a continuous
scalar of 1/128 resolution, which bf16 backbones do not carry through
10 layers, so the retrieval gate is an f32 gate; bf16 is gated on the
probe. Runs on the card unless ``--device cpu``. Writes a JSON record
(by default ``LEARNPROOF_TORCH[_CMA][_BF16].json`` at the repo root)
with the wall seconds beside the card's name and power limit, and exits
non-zero when a gate is missed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.criterions.mining import mine_positives
from avid_cma_tpu_torch.device import compute_dtype, resolve_device
from avid_cma_tpu_torch.scripts.extract_features import extract_features
from avid_cma_tpu_torch.scripts.retrieval import recall_metrics
from avid_cma_tpu_torch.train.checkpoint import import_criterion_run
from avid_cma_tpu_torch.train.loop import run_pretraining

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RIDGE_LAMBDA = 10.0


def build_cfg(args, name=None, loss=None, model_ckpt=None, epochs=None, lr=None):
    """The proof's pretraining config (the JAX script's ``build_cfg``)."""
    model_args = {
        "proj_dim": [512, 512, 128],
        "video_backbone": "R2Plus1D",
        "video_backbone_args": {"depth": 10},
        "audio_backbone": "Conv2D",
        "audio_backbone_args": {"depth": 10},
    }
    if model_ckpt is not None:
        model_args["checkpoint"] = model_ckpt
    return config_lib.from_dict({
        "seed": 0, "num_workers": 2, "print_freq": 32, "log2tb": False,
        "resume": args.resume, "quiet": not args.verbose,
        "dataset": {
            "name": "synthetic_av",
            "num_classes": args.classes,
            "jitter_order": args.jitter_order,
            "synthetic_size": args.train_size,
            "batch_size": args.batch,
            "video_clip_duration": 0.5,
            "video_fps": 16.0,
            "crop_size": args.crop,
            "audio_clip_duration": 1.0,
            "audio_fps": 24000.0,
            "spectrogram_fps": 100.0,
            "n_fft": 512,
            "train": {"split": "train", "use_augmentation": True,
                      "drop_last": True, "clips_per_video": 1},
            "test": {"split": "test", "mode": "clip", "clips_per_video": 1,
                     "use_augmentation": False, "use_shuffle": False,
                     "drop_last": False},
        },
        "optimizer": {
            "name": "adam", "weight_decay": 1e-5,
            "num_epochs": epochs if epochs is not None else args.epochs,
            "lr": {"name": "multistep", "base_lr": lr if lr is not None else args.lr,
                   "gamma": 1.0, "milestones": [10 ** 6]},
        },
        "model": {
            "name": name if name is not None else args.name,
            "model_dir": args.model_dir,
            "arch": "av_wrapper",
            "dtype": args.dtype,
            "args": model_args,
        },
        "loss": loss if loss is not None else {
            "name": "AVID",
            "args": {"num_data": args.train_size, "num_negatives": args.negatives,
                     "momentum": 0.5, "xModal_coeff": 1.0, "wModal_coeff": 0.0},
        },
    })


def cma_loss_cfg(args, avid_run: str) -> dict:
    """The AVID_CMA loss section, banks and Z warm-started from the AVID
    stage's run directory; the flagship head coefficients (xModalInst 1,
    wModalPos 1), pos_k and negatives scaled to the corpus."""
    return {
        "name": "AVID_CMA",
        "args": {
            "checkpoint": avid_run,
            "num_data": args.train_size,
            "momentum": 0.5,
            "num_negatives": args.negatives,
            "num_negatives_within": max(args.negatives // 2, 8),
            "xModalInstCoeff": 1.0,
            "wModalInstCoeff": 0.0,
            "xModalPosCoeff": 0.0,
            "wModalPosCoeff": 1.0,
            "resample_freq": args.resample_freq,
            "sampling_args": {"type": "consensus", "pos_k": args.pos_k},
        },
    }


def mined_purity(run_dir: str, args):
    """(purity, chance): the share of each instance's pos_k consensus
    positives, mined from the run's last banks, that share its class
    (labels are index % classes), and that share by chance."""
    bank = import_criterion_run(run_dir)
    pos = mine_positives(bank.view1_mem, bank.view2_mem, args.pos_k, "consensus").numpy()
    labels = np.arange(args.train_size) % args.classes
    purity = float((labels[pos] == labels[:, None]).mean())
    per_class = args.train_size // args.classes
    return purity, (per_class - 1) / (args.train_size - 1)


def ridge_probe(xtr, ytr, xte, yte, classes: int) -> float:
    """Top-1 of the closed-form ridge probe (lambda RIDGE_LAMBDA) on
    features z-scored by the train split's statistics."""
    mu, sd = xtr.mean(0), xtr.std(0) + 1e-6
    xtr, xte = (xtr - mu) / sd, (xte - mu) / sd
    w = np.linalg.solve(xtr.T @ xtr + RIDGE_LAMBDA * np.eye(xtr.shape[1]),
                        xtr.T @ np.eye(classes)[ytr])
    return float(((xte @ w).argmax(1) == yte).mean())


def evaluate(cfg, args) -> dict:
    """Cross-modal retrieval on the unseen instances (NCE space) and the
    ridge probe on frozen pooled video features."""
    db = cfg["dataset"]

    def extract(split, size, space, taps=("pool",)):
        sdb = dict(db)
        sdb["synthetic_size"] = size
        sdb["test"] = {"split": split, "mode": "clip", "clips_per_video": 1,
                       "use_augmentation": False, "use_shuffle": False, "drop_last": False}
        return extract_features(config_lib.from_dict({"dataset": sdb}), cfg["model"],
                                split="test", space=space, taps=taps, num_workers=2,
                                device=args.device)

    feats, _, _ = extract("test", args.test_size, "nce")
    v, a = feats["video"], feats["audio"]
    retrieval = {"v2a": recall_metrics(v, a, (1, 5)), "a2v": recall_metrics(a, v, (1, 5))}
    ftr, ytr, _ = extract("train", args.train_size, "taps")
    fte, yte, _ = extract("test", args.test_size, "taps")
    probe = ridge_probe(ftr["pool"], ytr, fte["pool"], yte, args.classes)
    return {
        "retrieval": {k: {m: float(x) for m, x in d.items()} for k, d in retrieval.items()},
        "chance_r1_pct": round(100.0 / v.shape[0], 3),
        "probe_top1": round(probe, 4),
        "chance_top1": round(1.0 / args.classes, 4),
        "test_instances": v.shape[0],
    }


def gates(m: dict, r1_factor: float, probe_factor: float) -> dict:
    r1 = min(m["retrieval"]["v2a"]["R@1"], m["retrieval"]["a2v"]["R@1"])
    return {"pass_retrieval": bool(r1 >= r1_factor * m["chance_r1_pct"]),
            "pass_probe": bool(m["probe_top1"] >= probe_factor * m["chance_top1"])}


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_proof(args) -> dict:
    dev = resolve_device(args.device)
    cma = args.criterion == "avid_cma"
    avid_name = args.name + "-avid" if cma else args.name
    run_dirs = [os.path.join(args.model_dir, avid_name)]
    if cma:
        run_dirs.append(os.path.join(args.model_dir, args.name))
    if args.resume:
        if not os.path.isdir(run_dirs[0]):
            sys.exit(f"--resume: no existing run at {run_dirs[0]}")
    else:
        # the proof certifies this code: a leftover finished run would
        # restore at its last step, train nothing, and be evaluated as new
        for d in run_dirs:
            shutil.rmtree(d, ignore_errors=True)
    common = {"criterion": args.criterion, "dtype": args.dtype,
              "compute_dtype": str(compute_dtype(dev, args.dtype)).replace("torch.", ""),
              "card": card(dev)}

    t0 = time.time()
    avid_cfg = build_cfg(args, name=avid_name)
    run_pretraining(avid_cfg, device=dev)
    avid_wall = time.time() - t0
    avid = evaluate(avid_cfg, args)
    avid.update(gates(avid, args.r1_factor, args.probe_factor))
    if not cma:
        result = {**common, "pretrain_wall_sec": round(avid_wall, 1),
                  "resumed": bool(args.resume), "epochs": args.epochs,
                  "train_instances": args.train_size,
                  "thresholds": {"r1_factor": args.r1_factor,
                                 "probe_factor": args.probe_factor},
                  **avid}
        result["pass"] = result["pass_retrieval"] and result["pass_probe"]
        return result

    # the mining premise, on the banks CMA mines at its start (the AVID
    # stage's): consensus neighbours of the same class well above chance
    purity_init, chance_p = mined_purity(run_dirs[0], args)
    t0 = time.time()
    cma_cfg = build_cfg(args, loss=cma_loss_cfg(args, run_dirs[0]), model_ckpt=run_dirs[0],
                        epochs=args.cma_epochs, lr=args.cma_lr)
    run_pretraining(cma_cfg, device=dev)
    cma_wall = time.time() - t0
    cma_metrics = evaluate(cma_cfg, args)
    cma_metrics.update(gates(cma_metrics, args.cma_r1_factor, args.probe_factor))
    purity_final, _ = mined_purity(run_dirs[1], args)
    cma_section = {
        "cma_epochs": args.cma_epochs, "cma_lr": args.cma_lr, "pos_k": args.pos_k,
        "mined_purity_init": round(purity_init, 4),
        "mined_purity_final": round(purity_final, 4),
        "chance_purity": round(chance_p, 4),
        "pass_mining": bool(purity_init >= args.purity_factor * chance_p),
        **cma_metrics,
    }
    result = {
        **common, "pretrain_wall_sec": round(avid_wall + cma_wall, 1),
        "avid_wall_sec": round(avid_wall, 1), "cma_wall_sec": round(cma_wall, 1),
        "resumed": bool(args.resume), "epochs": args.epochs,
        "train_instances": args.train_size,
        "thresholds": {"r1_factor": args.r1_factor, "cma_r1_factor": args.cma_r1_factor,
                       "probe_factor": args.probe_factor,
                       "purity_factor": args.purity_factor},
        "avid": avid, "cma": cma_section,
    }
    result["pass"] = bool(avid["pass_retrieval"] and avid["pass_probe"]
                          and cma_section["pass_mining"] and cma_section["pass_retrieval"]
                          and cma_section["pass_probe"])
    return result


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--criterion", choices=["avid", "avid_cma"], default="avid",
                    help="avid_cma: the AVID stage (--epochs), then AVID-CMA (--cma-epochs) "
                         "warm-started from it, with the mined-purity gate on top")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--cma-epochs", type=int, default=60)
    ap.add_argument("--cma-lr", type=float, default=2e-4,
                    help="the CMA stage's lr (gentler than AVID's: the corpus is tiny "
                         "and the model has converged)")
    ap.add_argument("--cma-r1-factor", type=float, default=2.0,
                    help="retrieval retention gate after CMA (x chance)")
    ap.add_argument("--pos-k", type=int, default=2,
                    help="mined positives an instance (top pos_k / (N - 1))")
    ap.add_argument("--resample-freq", type=int, default=40)
    ap.add_argument("--purity-factor", type=float, default=2.0,
                    help="mined same-class purity >= this x chance (avid_cma only)")
    ap.add_argument("--train-size", type=int, default=128)
    ap.add_argument("--test-size", type=int, default=64)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=56)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--negatives", type=int, default=64)
    ap.add_argument("--name", default="learning-proof")
    ap.add_argument("--model-dir",
                    default=os.path.join(tempfile.gettempdir(), "avid_cma_tpu_torch", "proofs"))
    ap.add_argument("--r1-factor", type=float, default=5.0,
                    help="retrieval R@1 >= this x chance")
    ap.add_argument("--probe-factor", type=float, default=3.0,
                    help="probe top-1 >= this x chance")
    ap.add_argument("--out", default=None,
                    help="the record (default LEARNPROOF_TORCH[_CMA][_BF16].json at the "
                         "repo root)")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted run instead of starting afresh")
    ap.add_argument("--dtype", choices=["float32", "bfloat16", "auto"], default="float32",
                    help="model.dtype of the proof (float32: the retrieval gate needs it)")
    ap.add_argument("--jitter-order", choices=["canonical", "random"], default="canonical")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.name == "learning-proof" and args.criterion == "avid_cma":
        args.name = "learning-proof-cma"
    if args.out is None:
        bf16 = compute_dtype(resolve_device(args.device), args.dtype) == torch.bfloat16
        args.out = os.path.join(REPO, "LEARNPROOF_TORCH" + ("_CMA" if args.criterion ==
                                "avid_cma" else "") + ("_BF16" if bf16 else "") + ".json")
    result = run_proof(args)
    text = json.dumps(result, indent=2)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
