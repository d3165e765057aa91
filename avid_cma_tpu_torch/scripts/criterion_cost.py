"""Host and device cost of the AVID and the AVID-CMA criterion, and the
host syncs of their fused train steps, on the card.

    python -m avid_cma_tpu_torch.scripts.criterion_cost [--calls 50]

1. The criterion alone (``avid_forward`` / ``cma_forward``, forward and
   backward into two (32, 128) embeddings) on the Kinetics recipes'
   banks (N = 232,067, the CMA positive set mined first): the host clock
   over ``--calls`` calls that end in one synchronize, and the CUDA-event
   time of the same calls. When the two agree, the host sets the pace.
2. The syncs that ``torch.cuda.set_sync_debug_mode`` reports over 3 fused
   train steps of each slice at full width (as chip_smoke.py builds them),
   each by the line of the port's code that made it.

Prints one JSON line per measurement with the card's name and power
limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import traceback
import warnings

import numpy as np
import torch

from avid_cma_tpu_torch.criterions.avid import init_bank_state
from avid_cma_tpu_torch.criterions.avid_cma import cma_state_from_bank
from avid_cma_tpu_torch.criterions.mining import mine_positives
from avid_cma_tpu_torch.device import resolve_device, set_full_f32_precision
from avid_cma_tpu_torch.train.builders import build_pretrain, kinetics_cma, kinetics_cross_n1024
from avid_cma_tpu_torch.train.step import criterion_fn

RECIPES = {"avid": kinetics_cross_n1024, "cma": kinetics_cma}


def _mined(bank, crit):
    pos = mine_positives(bank.view1_mem, bank.view2_mem, crit.pos_k, crit.sampling_type)
    return cma_state_from_bank(bank, pos)


def criterion_ms(name: str, calls: int) -> dict:
    cfg = RECIPES[name]()
    crit = cfg.criterion(128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bank = init_bank_state(cfg.num_data, 128, gen)
    if name == "cma":
        bank = _mined(bank, crit)
    fn = criterion_fn(crit)
    y = torch.randperm(cfg.num_data, device="cuda", generator=gen)[:cfg.batch_size]
    v = torch.randn(cfg.batch_size, 128, device="cuda", generator=gen, requires_grad=True)
    a = torch.randn(cfg.batch_size, 128, device="cuda", generator=gen, requires_grad=True)

    def call():
        loss, _, _ = fn(bank, v, a, y, crit, generator=gen)
        loss.backward()

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    return {"criterion": name, "calls": calls,
            "host_ms_per_call": (time.perf_counter() - t0) / calls * 1e3,
            "event_ms_per_call": start.elapsed_time(end) / calls}


def step_syncs(name: str) -> dict:
    cfg = RECIPES[name]()
    state, fused = build_pretrain(cfg, device="cuda")
    if name == "cma":
        state.bank = _mined(state.bank, cfg.criterion(state.model.out_dim))
    rng = np.random.default_rng(0)
    b = cfg.batch_size
    raw = {"frames": torch.from_numpy(rng.integers(
               0, 255, (b, cfg.num_frames, 256, 320, 3), dtype=np.uint8)).cuda(),
           "audio": torch.from_numpy(rng.standard_normal(
               (b, int(cfg.audio_clip_duration * cfg.audio_fps)), dtype=np.float32)).cuda(),
           "index": torch.from_numpy(rng.choice(cfg.num_data, b, replace=False)).cuda()}
    for i in range(2):
        fused(state, raw, i)
    torch.cuda.synchronize()
    sites = []

    def record(message, *args, **kwargs):
        # the innermost frame of the port's own code (not this script) that
        # made the sync
        if "synchronizing CUDA operation" in str(message):
            own = [f for f in traceback.extract_stack()
                   if "avid_cma_tpu_torch" in f.filename and f.filename != __file__]
            sites.append(f"{own[-1].filename.split('avid_cma_tpu_torch/')[-1]}:{own[-1].lineno}"
                         if own else "?")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(3):
                fused(state, raw, 10 + i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"slice": name, "steps": 3, "syncs": len(sites),
            "sync_sites": {site: sites.count(site) for site in sorted(set(sites))}}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=50)
    args = p.parse_args()
    resolve_device("cuda")  # raises without a card
    set_full_f32_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for name in RECIPES:
        print(json.dumps({"card": card, **criterion_ms(name, args.calls)}), flush=True)
        torch.cuda.empty_cache()
    for name in RECIPES:
        print(json.dumps({"card": card, **step_syncs(name)}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
