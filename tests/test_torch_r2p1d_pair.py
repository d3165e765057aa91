"""K5's plain version (avid_cma_tpu_torch/ops/kernels/r2p1d_pair.py
``plain_pair``) against the JAX package's fused conv pair: the Pallas
kernel in interpret mode and its XLA two-conv composition, in f32 at the
shapes of tests/test_r2p1d_block.py (atol 5e-5, rtol 1e-4: both sum 576
products per spatial output in another order), a single frame (T = 1,
conv5x at 8 input frames), and the temporal-edge case. The wrapper takes
the plain version for a CPU tensor and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avid_cma_tpu.ops.pallas.r2p1d_block import r2p1d_pair_pallas, r2p1d_pair_xla
from avid_cma_tpu_torch.ops.kernels import _lib
from avid_cma_tpu_torch.ops.kernels.r2p1d_pair import (
    MAX_SMEM,
    TILE_HEIGHTS,
    mma_smem_bytes,
    plain_pair,
    plan_bf16,
    r2p1d_pair,
)
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)


def _inputs(b, t, h, c, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.normal(size=(b, t, h, h, c)) * 0.5).astype(np.float32),
        (rng.normal(size=(1, 3, 3, c, c)) * 0.05).astype(np.float32),
        (rng.normal(size=(3, 1, 1, c, c)) * 0.05).astype(np.float32),
        rng.uniform(0.5, 1.5, c).astype(np.float32),
        (rng.normal(size=c) * 0.1).astype(np.float32),
    )


def _plain(args):
    return plain_pair(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("b,t,h,c", [(2, 4, 16, 64), (1, 2, 8, 128), (2, 1, 7, 64)],
                         ids=["t4-c64", "t2-c128", "t1-7x7"])
def test_plain_pair_matches_jax(b, t, h, c):
    args = _inputs(b, t, h, c)
    got = _plain(args)
    jargs = [jnp.asarray(a) for a in args]
    want_xla = np.asarray(r2p1d_pair_xla(*jargs))
    np.testing.assert_allclose(got, want_xla, atol=5e-5, rtol=1e-4)
    want_pallas = np.asarray(r2p1d_pair_pallas(*jargs, interpret=True))
    np.testing.assert_allclose(got, want_pallas, atol=5e-5, rtol=1e-4)


def test_plain_pair_temporal_edges_zero_padded():
    """The first and last frames see zero temporal neighbours: a signal in
    frame 0 only, an identity spatial conv, temporal taps (2, 3, 5)."""
    b, t, h, c = 1, 3, 8, 64
    x = np.zeros((b, t, h, h, c), np.float32)
    x[0, 0] = 1.0
    ws = np.zeros((1, 3, 3, c, c), np.float32)
    ws[0, 1, 1] = np.eye(c)
    wt = np.zeros((3, 1, 1, c, c), np.float32)
    wt[0, 0, 0] = np.eye(c) * 2.0
    wt[1, 0, 0] = np.eye(c) * 3.0
    wt[2, 0, 0] = np.eye(c) * 5.0
    out = _plain((x, ws, wt, np.ones(c, np.float32), np.zeros(c, np.float32)))
    np.testing.assert_allclose(out[0, 0], 3.0)
    np.testing.assert_allclose(out[0, 1], 2.0)
    np.testing.assert_allclose(out[0, 2], 0.0)


def test_cpu_tensor_takes_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 2, 5, 64, seed=1)]
    before = dict(_lib.LAUNCHES)
    got = r2p1d_pair(*args)
    assert _lib.LAUNCHES == before
    assert got.shape == (1, 2, 5, 5, 64) and got.dtype == torch.float32
    torch.testing.assert_close(got, plain_pair(*args), rtol=0, atol=0)


H100_SMS = 132


@pytest.mark.parametrize("shape", [
    (32, 8, 56, 56, 64), (32, 4, 28, 28, 128), (32, 2, 14, 14, 256), (32, 1, 7, 7, 512),
    (32, 32, 56, 56, 64), (2, 3, 9, 9, 128), (4, 2, 20, 20, 64), (1, 32, 7, 7, 64),
], ids=["conv2x", "conv3x", "conv4x", "conv5x", "conv2x-32-frames", "9x9", "20x20",
        "32-frames-7x7"])
def test_bf16_plan_covers_every_pixel_once_and_fits(shape):
    b, t, h, w, c = shape
    plan = plan_bf16(b, t, h, w, c, H100_SMS)
    assert plan.tile_h in TILE_HEIGHTS and plan.frames in (1, 2) and plan.frames <= t
    assert plan.slots == min(t, plan.frames + 2)
    assert plan.smem_bytes == mma_smem_bytes(plan.tile_h, plan.frames, plan.slots, c)
    assert plan.smem_bytes <= MAX_SMEM == 232448
    assert plan.grid == b * plan.tiles_y * plan.tiles_x
    # block (ty, tx) owns rows ty*tile_h .. +tile_h-1, columns tx*tile_w .. +tile_w-1
    seen = np.zeros((h, w), np.int64)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            rows = np.arange(ty * plan.tile_h, (ty + 1) * plan.tile_h)
            cols = np.arange(tx * plan.tile_w, (tx + 1) * plan.tile_w)
            rows, cols = rows[rows < h], cols[cols < w]
            assert rows.size and cols.size  # no block without a pixel
            seen[np.ix_(rows, cols)] += 1
    assert (seen == 1).all()


def test_bf16_plan_at_the_stage_shapes():
    """8 x 8 tiles where the grid keeps half the SMs busy, shorter ones for
    conv5x's 7^2 planes; two frames a weight tile only where the grid has
    no more than a block per SM (conv4x)."""
    plans = [plan_bf16(32, t, h, h, c, H100_SMS)
             for t, h, c in ((8, 56, 64), (4, 28, 128), (2, 14, 256), (1, 7, 512))]
    assert [(p.tile_h, p.frames) for p in plans] == [(8, 1), (8, 1), (8, 2), (2, 1)]
    assert [p.grid for p in plans] == [1568, 512, 128, 128]
    assert [p.warps for p in plans] == [4, 4, 8, 4]


def test_bf16_plan_raises_on_shapes_it_cannot_take():
    with pytest.raises(ValueError, match="multiple of 64"):
        plan_bf16(1, 2, 7, 7, 96, H100_SMS)
    # two 4096-channel frames of even the 2 x 8 tile: 262,144 bytes
    with pytest.raises(ValueError, match="fits no tile"):
        plan_bf16(1, 2, 7, 7, 4096, H100_SMS)
    with pytest.raises(ValueError, match="64-bit"):
        plan_bf16(1, 1, 4096, 4096, 128, H100_SMS)


def test_bf16_plan_takes_every_shape_the_cuda_core_kernel_took():
    """The CUDA-core kernel (csrc/r2p1d_pair.cu, the bf16 path before the
    tensor-core one) held T * C * P bf16 of intermediate beside f32 staging
    (KC = 32) in one of its tiles (MP, CG): P = 256 / CG * MP pixels,
    4 * CG channels. Every (T, C) it took, the plan takes."""
    old_tiles = ((4, 16), (4, 32), (4, 64), (2, 16))
    for t in range(1, 41):
        for c in range(64, 8193, 64):
            took = any(c % (4 * cg) == 0
                       and 32 * (256 // cg * mp) * 4 + 32 * 4 * cg * 4
                       + t * c * (256 // cg * mp) * 2 <= MAX_SMEM
                       for mp, cg in old_tiles)
            if took:
                plan = plan_bf16(2, t, 9, 9, c, H100_SMS)
                assert plan.smem_bytes <= MAX_SMEM
