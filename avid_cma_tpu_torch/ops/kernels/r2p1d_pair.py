"""K5: the fused (2+1)D conv pair, forward only (``csrc/r2p1d_pair.cu``).

Replaces ``r2p1d_pair_pallas`` / ``_pair_kernel``
(avid_cma_tpu/ops/pallas/r2p1d_block.py:84, :32-80): a spatial (1,3,3)
conv, the folded BatchNorm ``* scale + bias``, ReLU, and a temporal
(3,1,1) conv, stride 1, SAME padding, with the intermediate rounded to
``x.dtype`` and kept out of device memory. It is the eval-mode form of
every stride-1 pair of ``BasicR2P1DBlock``. Bound by operations on this
card (7.6e10 FLOP against 103 MB at the conv2x shape in bf16).

Two kernels, by dtype: bf16 (the card's model dtype) on the tensor cores,
``csrc/r2p1d_pair_mma.cu``, with the tile picked here by ``plan_bf16``;
f32 on the CUDA cores, ``csrc/r2p1d_pair.cu`` (TF32 tensor cores would
miss f32's 1e-5 gate). The source notes say what each tile does.

Layouts are the JAX ones: x (B, T, H, W, C), w_spatial (1, 3, 3, C, C)
and w_temporal (3, 1, 1, C, C) THWIO, scale and bias f32 (C,).
"""

from __future__ import annotations

from dataclasses import dataclass

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


# csrc/r2p1d_pair_mma.cu: 4 warps per frame of a group, 64 x 64 bf16 weight
# tiles in a ring of 3, a halo of (tile_h + 2) x 10 pixels of 64 channels
# per frame in two buffers, and the intermediate's ring of min(T, frames + 2)
# frames
WARPS_PER_FRAME = 4
MMA_STAGES = 3
TILE_W = 8
TILE_HEIGHTS = (8, 4, 2)  # tall tiles read the weights from L2 the fewest times
MAX_SMEM = 232448  # bytes a block can use on sm_90


@dataclass(frozen=True)
class TilePlan:
    """The bf16 kernel's launch: tile_h x tile_w pixel tiles of one clip
    across every frame and channel, ``frames`` frames sharing each weight
    tile (4 warps each), ``smem_bytes`` of dynamic shared memory, ``grid``
    blocks (batch x tiles_y x tiles_x)."""
    tile_h: int
    tile_w: int
    frames: int
    slots: int
    warps: int
    smem_bytes: int
    tiles_y: int
    tiles_x: int
    grid: int


def mma_smem_bytes(tile_h: int, frames: int, slots: int, c: int) -> int:
    """Dynamic shared memory of the bf16 kernel (as its ``smem_bytes``)."""
    halo = (tile_h + 2) * (TILE_W + 2) * 64 * 2
    return MMA_STAGES * 64 * 64 * 2 + 2 * frames * halo + slots * tile_h * TILE_W * c * 2


def plan_bf16(b: int, t: int, h: int, w: int, c: int, sms: int) -> TilePlan:
    """The bf16 kernel's tile for x (b, t, h, w, c) on a card of ``sms``
    SMs: the tallest tile whose grid keeps at least half the SMs busy
    (else the shortest, which has the most blocks). Two frames share each
    weight tile only where the grid has no more than a block per SM: they
    halve the weight traffic but double the halo's shared memory, which
    costs blocks per SM on a larger grid. Raises for C not a multiple of
    64 and for an intermediate that no tile fits in shared memory."""
    if c % 64 or c <= 0:
        raise ValueError(f"C must be a multiple of 64, got {c}")
    if min(b, t, h, w) < 1:
        raise ValueError(f"empty input {(b, t, h, w, c)}")
    if h * w * c >= 2**31:
        raise ValueError(f"a frame of {h * w * c} elements needs 64-bit offsets")
    plans = []
    for tile_h in TILE_HEIGHTS:
        ty, tx = -(-h // tile_h), -(-w // TILE_W)
        grid = b * ty * tx
        for frames in ((2, 1) if t >= 2 and grid <= sms else (1,)):
            slots = min(t, frames + 2)
            smem = mma_smem_bytes(tile_h, frames, slots, c)
            if smem <= MAX_SMEM:
                plans.append(TilePlan(tile_h, TILE_W, frames, slots, WARPS_PER_FRAME * frames,
                                      smem, ty, tx, grid))
                break
    if not plans:
        raise ValueError(f"C = {c} at T = {t}: the intermediate fits no tile in "
                         f"{MAX_SMEM} bytes of shared memory")
    return next((p for p in plans if 2 * p.grid >= sms), plans[-1])


def r2p1d_pair(x: torch.Tensor, w_spatial: torch.Tensor, w_temporal: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, H, W, C) in x.dtype: kernel K5 for a CUDA
    tensor (bf16 on the tensor cores, f32 on the CUDA cores; contiguous, C
    a multiple of 64), the plain version for a CPU tensor."""
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
    args = (x.data_ptr(), w_spatial.data_ptr(), w_temporal.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), bsz, t, h, w, c)
    if x.dtype == torch.bfloat16:
        plan = plan_bf16(bsz, t, h, w, c,
                         torch.cuda.get_device_properties(x.device).multi_processor_count)
        if plan.grid >= 2**31:
            raise ValueError(f"x: {plan.grid} blocks exceed the grid")
        err = _lib.lib().avid_r2p1d_pair_bf16(*args, plan.tile_h, plan.frames,
                                              plan.smem_bytes, _lib.stream())
        _lib.check(err, "avid_r2p1d_pair_bf16")
    else:
        err = _lib.lib().avid_r2p1d_pair_f32(*args, _lib.stream())
        _lib.check(err, "avid_r2p1d_pair_f32")
    _lib.LAUNCHES["r2p1d_pair"] += 1
    return out
