"""Where the time of one AVID pretraining step (or eval step) goes, on the card.

    python -m avid_cma_tpu_torch.profile_step [--steps 3] [--top 25] [--out FILE]
                                              [--eval | --cma]

Builds the Kinetics Cross-N1024 slice at full width (as chip_smoke.py),
warms it up, then
  1. times the step's phases with CUDA events (preprocessing, model
     forward, criterion, backward, optimizer), running the same calls the
     fused step makes;
  2. traces ``--steps`` fused steps with torch.profiler and reports the
     device's busy and idle share of the wall time, the kernels with the
     most device time (the port's own kernels K1-K4 by name), and each
     launch of the port's own kernels apart (K4's K = 1024 and K = 1
     calls, K1's and K3's two passes, K5's 13 launches a forward).
With ``--eval``, the forward-only slice instead (``build_eval``, raw
240 x 320 frames as chip_smoke.py's eval slice): only the trace (2), of
fused eval steps. With ``--cma``, the AVID-CMA train slice
(``kinetics_cma()``, its positive set mined first; K4 launches 8 times a
step). Prints one JSON object; ``--out`` also writes it to a file. Needs
a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch

from avid_cma_tpu_torch.criterions.avid_cma import cma_state_from_bank
from avid_cma_tpu_torch.criterions.mining import mine_positives
from avid_cma_tpu_torch.data.pipelines import preprocess_batch
from avid_cma_tpu_torch.train.builders import (
    build_eval,
    build_pretrain,
    kinetics_cma,
    kinetics_cross_n1024,
)
from avid_cma_tpu_torch.train.step import criterion_fn

OWN_KERNELS = {"stft_power_kernel": "K1", "db_clamp_norm_kernel": "K1",
               "stem_pool_fwd_kernel": "K2", "stem_pool_bwd_kernel": "K3",
               "stem_pool_bwd_sum_kernel": "K3",
               "nce_scores_kernel": "K4", "r2p1d_pair": "K5"}


def _own(name: str):
    return next((k for key, k in OWN_KERNELS.items() if key in name), None)


def _raw_batch(cfg, rng, hw=(256, 320)):
    b = cfg.batch_size
    return {
        "frames": torch.from_numpy(rng.integers(
            0, 255, (b, cfg.num_frames, *hw, 3), dtype=np.uint8)).cuda(),
        "audio": torch.from_numpy(rng.standard_normal(
            (b, int(cfg.audio_clip_duration * cfg.audio_fps)), dtype=np.float32)).cuda(),
        "index": torch.from_numpy(rng.choice(cfg.num_data, b, replace=False)).cuda(),
    }


def phase_times(state, cfg, raw, steps: int) -> dict:
    """Mean device ms per phase, the calls of make_fused_train_step."""
    crit = cfg.criterion(state.model.out_dim)
    criterion = criterion_fn(crit)
    pp = cfg.preprocess()
    names = ("preprocess", "forward", "criterion", "backward", "optimizer")
    totals = collections.Counter()
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        batch = preprocess_batch(raw, pp, state.generator)
        ev[1].record()
        v, a = state.model(batch["frames"], batch["audio"])
        ev[2].record()
        loss, _, bank = criterion(state.bank, v, a, batch["index"].long(), crit,
                                  generator=state.generator)
        ev[3].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[4].record()
        state.optimizer.step()
        state.bank = bank
        ev[5].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            totals[n] += ev[i].elapsed_time(ev[i + 1])
    return {n: totals[n] / steps for n in names}


def trace(state, fused, raw, steps: int, top: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fused(state, raw, 100 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name = collections.Counter()
    intervals = []
    launches = collections.defaultdict(list)  # port kernel -> each launch's ms
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        per_name[e.name] += end - start
        intervals.append((start, end))
        if _own(e.name):
            launches[_own(e.name)].append((end - start) / 1e3)
    busy = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):  # union of kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    kernels = [{"name": n[:120], "ms_per_step": t / steps / 1e3,
                "share": t / max(busy, 1e-9), "port_kernel": _own(n)}
               for n, t in per_name.most_common(top)]
    own = collections.Counter()
    for n, t in per_name.items():
        if _own(n):
            own[_own(n)] += t / steps / 1e3
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "idle_share": 1.0 - busy / wall_us if intervals else None,
            "device_events": len(intervals), "own_kernels_ms_per_step": dict(own),
            "own_kernel_launches_ms": {k: sorted(v) for k, v in launches.items()},
            "top_kernels": kernels}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eval", action="store_true", help="profile the fused eval step")
    mode.add_argument("--cma", action="store_true", help="profile the AVID-CMA train step")
    args = ap.parse_args()
    cfg = kinetics_cma() if args.cma else kinetics_cross_n1024()
    if args.eval:
        state, fused, _ = build_eval(cfg, device="cuda")
        raw = _raw_batch(cfg, np.random.default_rng(0), hw=(240, 320))
    else:
        state, fused = build_pretrain(cfg, device="cuda")
        raw = _raw_batch(cfg, np.random.default_rng(0))
    if args.cma:
        crit = cfg.criterion(state.model.out_dim)
        state.bank = cma_state_from_bank(state.bank, mine_positives(
            state.bank.view1_mem, state.bank.view2_mem, crit.pos_k, crit.sampling_type))
    for i in range(2):
        fused(state, raw, i)
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.eval:
        out = {"card": smi, "config": "Cross-N1024 eval (forward only) R2Plus1D-18+Conv2D-10 "
               "b32 8x224^2 from 240x320", **trace(state, fused, raw, args.steps, args.top)}
    else:
        name = "AVID-CMA InstX-N1024-PosW-N64-Top32" if args.cma else "Cross-N1024"
        out = {"card": smi, "config": f"{name} R2Plus1D-18+Conv2D-10 b32 8x224^2",
               "phase_ms": phase_times(state, cfg, raw, args.steps),
               **trace(state, fused, raw, args.steps, args.top)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
