"""K5 (the fused (2+1)D conv pair) against its plain version on the card.

    python -m avid_cma_tpu_torch.scripts.r2p1d_block_bench [--batch 32]
        [--frames 8] [--size 56] [--channels 64] [--iters 20] [--dtype bfloat16]

Counterpart of scripts/r2p1d_block_bench.py. At the conv2x hot shape by
default (B=32, T=8, 56^2, C=64, bf16): holds K5 against ``plain_pair``
(max |kernel - plain| / max |plain|), then times both with CUDA events.
The plain version is two cuDNN convolutions in f32 with the scale, bias
and ReLU between them: the yardstick the JAX script raced as ``xla_ms``.
Prints one JSON line with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from avid_cma_tpu_torch.device import resolve_device, set_full_f32_precision
from avid_cma_tpu_torch.ops.kernels.r2p1d_pair import plain_pair, r2p1d_pair


def time_ms(fn, iters: int) -> float:
    """Mean device ms of fn() over iters calls (CUDA events), after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=56)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args()
    dev = resolve_device("cuda")
    set_full_f32_precision()

    b, t, h, c = args.batch, args.frames, args.size, args.channels
    dtype = getattr(torch, args.dtype)
    rng = np.random.default_rng(0)

    def tensor(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(dt)

    x = tensor(rng.normal(size=(b, t, h, h, c)) * 0.5)
    ws = tensor(rng.normal(size=(1, 3, 3, c, c)) * 0.05)
    wt = tensor(rng.normal(size=(3, 1, 1, c, c)) * 0.05)
    scale = tensor(rng.uniform(0.5, 1.5, c), torch.float32)
    bias = tensor(rng.normal(size=c) * 0.1, torch.float32)

    got = r2p1d_pair(x, ws, wt, scale, bias).float()
    ref = plain_pair(x, ws, wt, scale, bias).float()
    err = float((got - ref).abs().max() / ref.abs().max())
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    if not err <= tol:
        raise RuntimeError(f"K5 vs plain_pair: relative error {err} > {tol}")

    kernel_ms = time_ms(lambda: r2p1d_pair(x, ws, wt, scale, bias), args.iters)
    cudnn_ms = time_ms(lambda: plain_pair(x, ws, wt, scale, bias), args.iters)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "metric": "r2p1d_fused_pair_ms", "card": card,
        "shape": [b, t, h, h, c], "dtype": args.dtype,
        "kernel_ms": kernel_ms, "cudnn_ms": cudnn_ms, "speedup": cudnn_ms / kernel_ms,
        "rel_err": err, "io_bytes_mb": 2 * x.numel() * x.element_size() / 2**20,
    }))


if __name__ == "__main__":
    main()
