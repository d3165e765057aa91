"""K5 (the fused (2+1)D conv pair) against its plain version on the card.

    python -m avid_cma_tpu_torch.scripts.r2p1d_block_bench [--shape B T H W C]
        [--iters 20] [--dtype bfloat16]

Counterpart of scripts/r2p1d_block_bench.py. At the four stride-1 stage
shapes of R2Plus1D-18 (32 clips of 8 x 224^2) by default, or at
``--shape``: holds K5 against ``plain_pair`` (max |kernel - plain| /
max |plain|), then times with CUDA events
  - K5 (``kernel_ms``);
  - the plain version, two cuDNN convolutions in f32 with the scale, bias
    and ReLU between them (``plain_ms``): the oracle, not a speed target;
  - ``ref_cudnn_bf16_ms``, the yardstick: what the eval module would run
    without K5 (``cudnn_bf16_pair``), two bf16 cuDNN convolutions on
    channels-last with the folded scale, bias and ReLU between them. The
    port never calls it for K5's work.
Prints one JSON line per shape with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from avid_cma_tpu_torch.device import prepare_device
from avid_cma_tpu_torch.ops.kernels.r2p1d_pair import plain_pair, r2p1d_pair

# the stride-1 (2+1)D pairs of R2Plus1D-18 at 8 x 224^2, 32 clips: (B, T, H, W, C)
PAIR_SHAPES = {"conv2x": (32, 8, 56, 56, 64), "conv3x": (32, 4, 28, 28, 128),
               "conv4x": (32, 2, 14, 14, 256), "conv5x": (32, 1, 7, 7, 512)}


def cudnn_weights(w_spatial: torch.Tensor, w_temporal: torch.Tensor) -> tuple:
    """THWIO weights as the bf16 channels-last (O, I, kt, kh, kw) tensors
    that ``Conv3D`` hands cuDNN."""
    return tuple(w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
                 .contiguous(memory_format=torch.channels_last_3d)
                 for w in (w_spatial, w_temporal))


def cudnn_bf16_pair(x: torch.Tensor, ws: torch.Tensor, wt: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The yardstick of K5: the eval module's pair without K5, as the
    train-mode branch of ``BasicR2P1DBlock._pair`` computes it. x (B, T, H,
    W, C) bf16; ws, wt from ``cudnn_weights``; the spatial conv in bf16,
    ``* scale + bias`` and ReLU in f32 (the order of ``plain_pair``), a
    cast to bf16, the temporal conv in bf16. (B, T, H, W, C) bf16."""
    shape = (1, -1, 1, 1, 1)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), ws, padding=(0, 1, 1))
    y = torch.relu(y.float() * scale.view(shape) + bias.view(shape)).to(torch.bfloat16)
    return F.conv3d(y, wt, padding=(1, 0, 0)).permute(0, 2, 3, 4, 1)


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


def bench(shape, dtype: torch.dtype, iters: int, dev: torch.device, card: str) -> dict:
    b, t, h, w, c = shape
    rng = np.random.default_rng(0)

    def tensor(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(dt)

    x = tensor(rng.normal(size=shape) * 0.5)
    ws = tensor(rng.normal(size=(1, 3, 3, c, c)) * 0.05)
    wt = tensor(rng.normal(size=(3, 1, 1, c, c)) * 0.05)
    scale = tensor(rng.uniform(0.5, 1.5, c), torch.float32)
    bias = tensor(rng.normal(size=c) * 0.1, torch.float32)

    got = r2p1d_pair(x, ws, wt, scale, bias).float()
    ref = plain_pair(x, ws, wt, scale, bias).float()
    err = float((got - ref).abs().max() / ref.abs().max())
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    if not err <= tol:
        raise RuntimeError(f"K5 vs plain_pair at {list(shape)}: relative error {err} > {tol}")
    del got, ref

    xb = x.to(torch.bfloat16)
    cw = cudnn_weights(ws, wt)
    kernel_ms = time_ms(lambda: r2p1d_pair(x, ws, wt, scale, bias), iters)
    plain_ms = time_ms(lambda: plain_pair(x, ws, wt, scale, bias), iters)
    ref_ms = time_ms(lambda: cudnn_bf16_pair(xb, *cw, scale, bias), iters)
    return {
        "metric": "r2p1d_fused_pair_ms", "card": card, "shape": list(shape),
        "dtype": str(dtype).replace("torch.", ""), "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "ref_cudnn_bf16_ms": ref_ms,
        "vs_ref_cudnn_bf16": ref_ms / kernel_ms, "rel_err": err,
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", type=int, nargs=5, default=None, metavar=("B", "T", "H", "W", "C"))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args()
    dev = prepare_device("cuda")  # the entry points' state: cuDNN autotuned
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    shapes = [tuple(args.shape)] if args.shape else list(PAIR_SHAPES.values())
    for shape in shapes:
        print(json.dumps(bench(shape, getattr(torch, args.dtype), args.iters, dev, card)),
              flush=True)


if __name__ == "__main__":
    main()
