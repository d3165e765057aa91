"""Clips/s of the Cross-N1024 fused train step on the card, in windows.

    python -m avid_cma_tpu_torch.scripts.train_clips [--windows 3] [--steps 10] [--cma]

Builds the full-width slice as chip_smoke.py does (32 clips of raw
256 x 320 uint8 frames, 2 s of audio), runs 3 warm-up steps, then
``--windows`` windows of ``--steps`` steps, each timed on the host clock
around work that ends in a synchronize. With ``--cma``, the AVID-CMA
slice (``kinetics_cma()``, its positive set mined first). Prints one JSON
line with the card's name and power limit. Needs a card.

To compare two trees on one card, run the script from each tree's root
with ``PYTHONPATH`` set to that root, in turns (parent, change, change,
parent): it imports the package it finds there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from avid_cma_tpu_torch.criterions.avid_cma import cma_state_from_bank
from avid_cma_tpu_torch.criterions.mining import mine_positives
from avid_cma_tpu_torch.train.builders import build_pretrain, kinetics_cma, kinetics_cross_n1024


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--cma", action="store_true", help="the AVID-CMA train step")
    args = p.parse_args()
    cfg = kinetics_cma() if args.cma else kinetics_cross_n1024()
    state, fused = build_pretrain(cfg, device="cuda")
    if args.cma:
        crit = cfg.criterion(state.model.out_dim)
        state.bank = cma_state_from_bank(state.bank, mine_positives(
            state.bank.view1_mem, state.bank.view2_mem, crit.pos_k, crit.sampling_type))
    rng = np.random.default_rng(0)
    b = cfg.batch_size
    raw = {
        "frames": torch.from_numpy(rng.integers(
            0, 255, (b, cfg.num_frames, 256, 320, 3), dtype=np.uint8)).cuda(),
        "audio": torch.from_numpy(rng.standard_normal(
            (b, int(cfg.audio_clip_duration * cfg.audio_fps)), dtype=np.float32)).cuda(),
        "index": torch.from_numpy(rng.choice(cfg.num_data, b, replace=False)).cuda(),
    }
    step = 0
    for _ in range(3):
        fused(state, raw, step)
        step += 1
    torch.cuda.synchronize()
    clips_per_sec = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            fused(state, raw, step)
            step += 1
        torch.cuda.synchronize()
        clips_per_sec.append(b * args.steps / (time.perf_counter() - t0))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = "AVID-CMA InstX-N1024-PosW-N64-Top32" if args.cma else "Cross-N1024"
    print(json.dumps({"metric": "train_clips_per_sec", "card": card,
                      "config": f"{name} R2Plus1D-18+Conv2D-10 b32 8x224^2",
                      "steps_per_window": args.steps, "clips_per_sec": clips_per_sec}))


if __name__ == "__main__":
    main()
