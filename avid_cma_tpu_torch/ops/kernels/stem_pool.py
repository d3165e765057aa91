"""K2 + K3: fused stem BN-apply -> ReLU -> 3x3/s2/p1 max-pool and its
backward (``csrc/stem_pool.cu``).

Replaces ``_fwd_kernel`` / ``_pallas_fwd`` and ``_bwd_kernel`` /
``_pallas_bwd`` (avid_cma_tpu/ops/pallas/stem_pool.py:91-109,139-212,247,
272). Both directions are bound by bytes on this card: the forward reads
the (B*T, 112, 112, 64) bf16 stem activation once (411 MB at the Kinetics
shape) and writes the pooled quarter; the backward reads it and the
pooled gradient and writes dy.

Each direction has two kernels, picked by ``y.dtype``: the staged
shared-memory kernels for bf16 (the card's default compute dtype), and
plain one-thread-per-pixel kernels for f32 (``model.dtype: float32``),
counted apart as ``stem_pool_fwd_f32`` / ``stem_pool_bwd_f32``.

Semantics (identical in kernel and plain version): the affine
``relu(y*a + b)`` is computed in f32 with a separate multiply and add and
rounded once to ``y.dtype``; padding is excluded from the max; the
backward routes each window's gradient to its first row-major max (XLA
select-and-scatter ties), masks by ``relu(...) > 0``, and returns
``dy = d*a``, ``da = sum d*y``, ``db = sum d`` (f32).

``scale_relu_pool`` is the autograd op the model calls. BatchNorm
statistics stay outside it (a, b are computed by the caller), so autograd
carries the gradient through them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from avid_cma_tpu_torch.ops.kernels import _lib

# channel counts every kernel takes (bf16: C / 8 chunks of 16 bytes per
# element; f32: C / 4 float4s, dividing the block's 256 threads)
KERNEL_CHANNELS = (8, 16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _relu_affine(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(y*a + b) in f32, rounded once to y.dtype."""
    return torch.relu(y.float() * a + b).to(y.dtype)


def _windows(yh: torch.Tensor):
    """The nine strided (dh, dw) views of the -inf padded activation, in
    row-major window order, each of shape (N, H/2, W/2, C)."""
    n, h, w, c = yh.shape
    pad = F.pad(yh.float(), (0, 0, 1, 1, 1, 1), value=-float("inf"))
    return pad, [
        (dh, dw, pad[:, dh:dh + h:2, dw:dw + w:2, :])
        for dh in range(3) for dw in range(3)
    ]


def plain_fwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (N, H, W, C) -> (N, H/2, W/2, C) in y.dtype."""
    _, views = _windows(_relu_affine(y, a, b))
    out = views[0][2]
    for _, _, v in views[1:]:
        out = torch.maximum(out, v)
    return out.to(y.dtype)


def plain_bwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: (dy in y.dtype, da, db in f32)."""
    n, h, w, c = y.shape
    yh = _relu_affine(y, a, b)
    pad, views = _windows(yh)
    out = views[0][2]
    for _, _, v in views[1:]:
        out = torch.maximum(out, v)
    gf = g.float()
    found = torch.zeros(out.shape, dtype=torch.bool, device=y.device)
    dpad = torch.zeros_like(pad)
    for dh, dw, v in views:
        sel = (v == out) & ~found
        found |= sel
        dpad[:, dh:dh + h:2, dw:dw + w:2, :] += torch.where(sel, gf, 0.0)
    d = torch.where(yh.float() > 0, dpad[:, 1:h + 1, 1:w + 1, :], 0.0)
    dy = (d * a).to(y.dtype)
    return dy, (d * y.float()).sum((0, 1, 2)), d.sum((0, 1, 2))


def _check_shapes(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> Tuple[int, ...]:
    if y.dim() != 4:
        raise ValueError(f"y: expected (N, H, W, C), got {tuple(y.shape)}")
    n, h, w, c = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"y: H and W must be even, got {h}x{w}")
    if y.dtype not in KERNEL_DTYPES:
        raise ValueError(f"y: expected bfloat16 or float32, got {y.dtype}")
    _lib.require(y, "y", y.dtype)
    _lib.require(a, "a", torch.float32, (c,))
    _lib.require(b, "b", torch.float32, (c,))
    if y.dtype == torch.float32:  # the f32 forms read a float4 at a time
        for name, t in (("y", y), ("a", a), ("b", b)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    return n, h, w, c


def _require_kernel_shape(direction: str, n: int, h: int, w: int, c: int) -> None:
    if n * h * w == 0 or c not in KERNEL_CHANNELS:
        raise ValueError(f"the {direction} kernel takes no (N, H, W, C) = {(n, h, w, c)}: "
                         f"it needs N, H, W > 0 and C in {', '.join(map(str, KERNEL_CHANNELS))}")


def stem_pool_fwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward (N, H, W, C) -> (N, H/2, W/2, C): kernel K2 for a CUDA
    tensor (bf16 or f32, contiguous, C in ``KERNEL_CHANNELS``), the plain
    version for a CPU tensor."""
    if y.device.type == "cpu":
        return plain_fwd(y, a, b)
    n, h, w, c = _check_shapes(y, a, b)
    _require_kernel_shape("forward", n, h, w, c)
    out = torch.empty((n, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    key = "stem_pool_fwd_f32" if y.dtype == torch.float32 else "stem_pool_fwd"
    err = getattr(_lib.lib(), f"avid_{key}")(
        y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c,
        _lib.stream())
    _lib.check(err, f"avid_{key}")
    _lib.LAUNCHES[key] += 1
    return out


def stem_pool_bwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: kernel K3 for CUDA tensors (bf16 or f32, g in y's
    dtype), the plain version for CPU."""
    if y.device.type == "cpu":
        return plain_bwd(y, a, b, g)
    n, h, w, c = _check_shapes(y, a, b)
    _lib.require(g, "g", y.dtype, (n, h // 2, w // 2, c))
    _require_kernel_shape("backward", n, h, w, c)
    if y.dtype == torch.float32:
        if g.data_ptr() % 16:
            raise ValueError("g: expected a 16-byte aligned tensor")
        return _bwd_f32(y, a, b, g)
    kernels = _lib.lib()
    # the kernel's persistent grid, one partial row of da and db per block
    parts = kernels.avid_stem_pool_bwd_parts(n, h, w, c)
    if parts < 1:
        raise RuntimeError(f"avid_stem_pool_bwd_parts found no launch for {(n, h, w, c)}")
    dy = torch.empty_like(y)
    scratch = torch.empty((2, parts, c), dtype=torch.float32, device=y.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=y.device)
    err = kernels.avid_stem_pool_bwd(
        y.data_ptr(), a.data_ptr(), b.data_ptr(), g.data_ptr(), dy.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), sums[0].data_ptr(),
        sums[1].data_ptr(), n, h, w, c, parts, _lib.stream())
    _lib.check(err, "avid_stem_pool_bwd")
    _lib.LAUNCHES["stem_pool_bwd"] += 1
    return dy, sums[0], sums[1]


def _bwd_f32(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's f32 form on checked CUDA tensors: the window codes, the
    gather, the sum of the f64 partial rows."""
    n, h, w, c = y.shape
    kernels = _lib.lib()
    parts = kernels.avid_stem_pool_bwd_f32_parts(n, h, w, c)
    if parts < 1:
        raise RuntimeError(f"avid_stem_pool_bwd_f32_parts found no launch for {(n, h, w, c)}")
    dy = torch.empty_like(y)
    code = torch.empty((n, h // 2, w // 2, c), dtype=torch.uint8, device=y.device)
    part = torch.empty((2, parts, c), dtype=torch.float64, device=y.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=y.device)
    err = kernels.avid_stem_pool_bwd_f32(
        y.data_ptr(), a.data_ptr(), b.data_ptr(), g.data_ptr(), dy.data_ptr(),
        code.data_ptr(), part.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
        n, h, w, c, parts, _lib.stream())
    _lib.check(err, "avid_stem_pool_bwd_f32")
    _lib.LAUNCHES["stem_pool_bwd_f32"] += 1
    return dy, sums[0], sums[1]


class ScaleReluPool(torch.autograd.Function):
    """relu(y*a + b) then 3x3/s2/p1 max-pool over (H, W), with K2/K3."""

    @staticmethod
    def forward(ctx, y, a, b):
        bsz, t, h, w, c = y.shape
        ctx.save_for_backward(y, a, b)
        out = stem_pool_fwd(y.reshape(bsz * t, h, w, c), a, b)
        return out.reshape(bsz, t, h // 2, w // 2, c)

    @staticmethod
    def backward(ctx, g):
        y, a, b = ctx.saved_tensors
        bsz, t, h, w, c = y.shape
        dy, da, db = stem_pool_bwd(
            y.reshape(bsz * t, h, w, c), a, b,
            g.reshape(bsz * t, h // 2, w // 2, c).contiguous(),
        )
        return dy.reshape(y.shape), da.to(a.dtype), db.to(b.dtype)


def scale_relu_pool(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y (B, T, H, W, C) channels-last, H and W even; a, b (C,) float32.
    Returns (B, T, H/2, W/2, C) in y.dtype."""
    return ScaleReluPool.apply(y, a, b)
