"""K5: the fused (2+1)D conv pair, forward only (``csrc/r2p1d_pair.cu``).

Replaces ``r2p1d_pair_pallas`` / ``_pair_kernel``
(avid_cma_tpu/ops/pallas/r2p1d_block.py:84, :32-80): a spatial (1,3,3)
conv, the folded BatchNorm ``* scale + bias``, ReLU, and a temporal
(3,1,1) conv, stride 1, SAME padding, with the intermediate rounded to
``x.dtype`` and kept out of device memory. It is the eval-mode form of
every stride-1 pair of ``BasicR2P1DBlock``. Bound by operations on this
card (7.9e10 FLOP against 206 MB at the conv2x shape); the source note
says what the shared-memory tile does about it.

Layouts are the JAX ones: x (B, T, H, W, C), w_spatial (1, 3, 3, C, C)
and w_temporal (3, 1, 1, C, C) THWIO, scale and bias f32 (C,).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from avid_cma_tpu_torch.device import set_full_f32_precision
from avid_cma_tpu_torch.ops.kernels import _lib


def _oikkk(w: torch.Tensor) -> torch.Tensor:
    """THWIO -> PyTorch's (O, I, kt, kh, kw), as f32."""
    return w.float().permute(4, 3, 0, 1, 2)


def plain_pair(x: torch.Tensor, w_spatial: torch.Tensor, w_temporal: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, as ``r2p1d_pair_xla``: both convs in f32 (TF32
    off) from the values in ``x.dtype``; scale, bias and ReLU in f32, then
    a cast to ``x.dtype``; the temporal conv, then a cast to ``x.dtype``."""
    set_full_f32_precision()
    xf = x.float().permute(0, 4, 1, 2, 3)
    y = F.conv3d(xf, _oikkk(w_spatial), padding=(0, 1, 1))
    shape = (1, -1, 1, 1, 1)
    y = torch.relu(y * scale.view(shape) + bias.view(shape)).to(x.dtype)
    out = F.conv3d(y.float(), _oikkk(w_temporal), padding=(1, 0, 0))
    return out.to(x.dtype).permute(0, 2, 3, 4, 1)


def r2p1d_pair(x: torch.Tensor, w_spatial: torch.Tensor, w_temporal: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, H, W, C) in x.dtype: kernel K5 for a CUDA
    tensor (bf16 or f32, contiguous, C a multiple of 64), the plain version
    for a CPU tensor."""
    if x.device.type == "cpu":
        return plain_pair(x, w_spatial, w_temporal, scale, bias)
    if x.dim() != 5:
        raise ValueError(f"x: expected (B, T, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: expected bfloat16 or float32, got {x.dtype}")
    bsz, t, h, w, c = x.shape
    if c % 64:
        raise ValueError(f"C must be a multiple of 64, got {c}")
    _lib.require(x, "x", x.dtype)
    _lib.require(w_spatial, "w_spatial", x.dtype, (1, 3, 3, c, c))
    _lib.require(w_temporal, "w_temporal", x.dtype, (3, 1, 1, c, c))
    _lib.require(scale, "scale", torch.float32, (c,))
    _lib.require(bias, "bias", torch.float32, (c,))
    for name, tensor in (("x", x), ("w_spatial", w_spatial), ("w_temporal", w_temporal)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    out = torch.empty_like(x)
    err = _lib.lib().avid_r2p1d_pair(
        x.data_ptr(), w_spatial.data_ptr(), w_temporal.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), bsz, t, h, w, c, int(x.dtype == torch.bfloat16),
        _lib.stream())
    _lib.check(err, "avid_r2p1d_pair")
    _lib.LAUNCHES["r2p1d_pair"] += 1
    return out
