"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes the chip check does not cover (partial
tiles, narrow channels, D < 128, out-of-range indices, one or three
frames, 7^2 and 9^2 planes), plus the wrappers' input checks, launch
counters, and the channels-last layouts that reach K2 and K5 without a
copy; the AVID-CMA path: K4 at its index shapes, the mining sweep on
the card against the CPU, and one CMA train step on the card against the
CPU; and the eval paths: K5 at T = 32 and at B = 128, K2/K3 at the 32at16
stem (3.3 GB, its last images), and the launches of the warmup, finetune,
clip-test and probe steps; the f32 forms of K2/K3 (``model.dtype:
float32``) at ragged shapes, with ties, through autograd, and their
input checks.

Needs an NVIDIA card; skips without one. Imports no JAX, so it runs on a
card host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from avid_cma_tpu_torch.device import set_full_f32_precision
from avid_cma_tpu_torch.models import blocks
from avid_cma_tpu_torch.models.video import R2Plus1D
from avid_cma_tpu_torch.ops import stft
from avid_cma_tpu_torch.ops.conv3d import Conv3D
from avid_cma_tpu_torch.ops.kernels import (
    _lib,
    nce_gather,
    r2p1d_pair,
    spectrogram,
    stem_pool,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    set_full_f32_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("normalize,top_db", [(True, 100.0), (False, None)])
def test_spectrogram_kernel_matches_plain(dev, normalize, top_db):
    rng = np.random.default_rng(0)
    # 3 x 12000: 51 frames (a ragged 64-row tile); DC offset keeps every
    # bin away from f32 cancellation
    sig = torch.from_numpy((0.1 * rng.standard_normal((3, 12000)) + 0.05)
                           .astype(np.float32)).to(dev)
    kw = dict(sample_rate=24000, n_fft=512, hop_size=0.01, duration=None,
              normalize=normalize, top_db=top_db)
    before = _lib.LAUNCHES["spectrogram"]
    got = spectrogram.log_spectrogram_kernel(sig, **kw)
    assert _lib.LAUNCHES["spectrogram"] == before + 1
    ref = stft.log_spectrogram(sig, **kw)
    assert got.shape == ref.shape == (3, 51, 257, 1)
    tol = 1e-4 if normalize else 1.7e-3  # the same bound in dB (std >= 17.36)
    assert float((got - ref).abs().max()) < tol


# K1 tiles 80 frames by 128 packed columns (32 output bins); frames come
# from the waveform by 16-byte copies unless a frame touches the reflect
# padding or the waveform is not 16-byte aligned (odd L)
@pytest.mark.parametrize("shape", [(1, 12000), (3, 12001), (5, 7201)],
                         ids=["b1", "odd-length", "ragged-rows"])
def test_spectrogram_kernel_ragged_shapes(dev, shape):
    rng = np.random.default_rng(10)
    sig = torch.from_numpy((0.1 * rng.standard_normal(shape) + 0.05)
                           .astype(np.float32)).to(dev)
    kw = dict(sample_rate=24000, n_fft=512, hop_size=0.01, duration=None)
    got = spectrogram.log_spectrogram_kernel(sig, **kw)
    ref = stft.log_spectrogram(sig, **kw)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) < 1e-4
    # bin 0 (DC) and the last bin (it folds in the Nyquist bin) on their own
    for k in (0, 256):
        assert float((got[:, :, k] - ref[:, :, k]).abs().max()) < 1e-4


def test_spectrogram_kernel_unnormalized_is_the_db(dev):
    """normalize=False returns the dB itself, as the JAX kernel does: the
    first K1 divided it by 1 + 1e-5, which a 190 dB signal shows."""
    rng = np.random.default_rng(11)
    sig = torch.from_numpy((1e8 * (rng.standard_normal((2, 12000)) + 0.5))
                           .astype(np.float32)).to(dev)
    kw = dict(sample_rate=24000, n_fft=512, hop_size=0.01, duration=None,
              normalize=False, top_db=None)
    got = spectrogram.log_spectrogram_kernel(sig, **kw)
    ref = stft.log_spectrogram(sig, **kw)
    assert float(ref.max()) > 180.0
    assert float((got - ref).abs().max()) < 1.7e-3


def _bf16_ulp(v):
    av = v.float().abs()
    e = torch.floor(torch.log2(torch.where(av > 0, av, torch.ones_like(av))))
    return torch.where(av > 0, torch.exp2(e - 7), torch.full_like(av, 2.0 ** -133))


def _stem_inputs(dev, shape, ties, seed=1):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    c = shape[-1]
    if ties:
        y = torch.round(y * 2.0) / 2.0
        a, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    else:
        a = torch.from_numpy((rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)).to(dev)
        b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[1] // 2, shape[2] // 2, c), dtype=np.float32)).to(dev).to(torch.bfloat16)
    return y.to(torch.bfloat16), a, b, g


def _check_stem_bwd(y, a, b, g):
    """K3 against its plain version: dy within 1 bf16 ulp, da/db 2e-3."""
    dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
    rdy, rda, rdb = stem_pool.plain_bwd(y, a, b, g)
    assert float(((dy.float() - rdy.float()).abs() / _bf16_ulp(rdy)).max()) <= 1.0
    torch.testing.assert_close(da, rda, rtol=2e-3, atol=1e-3)
    torch.testing.assert_close(db, rdb, rtol=2e-3, atol=1e-3)
    return da, db


# K3 walks tiles of 7 x 8 windows (14 x 16 elements), K2 tiles of 8 x 8
# (16 x 16): shapes where the tiles do not divide H, W (9 x 17 windows,
# 10 x 22) or fill a grid, exactly one K2 tile, one image of one window,
# every channel count the kernels take, and 16 Kinetics-sized images, so
# that each persistent block walks several tiles
@pytest.mark.parametrize("shape", [
    (2, 6, 10, 64), (3, 8, 4, 8), (1, 2, 2, 64), (3, 18, 34, 64), (2, 18, 34, 8),
    (1, 34, 20, 16), (1, 20, 18, 32), (1, 18, 18, 128), (1, 16, 16, 64), (2, 20, 44, 64),
    (16, 112, 112, 64),
], ids=["c64", "c8", "n1-2x2", "ragged-c64", "ragged-c8", "c16", "c32", "c128",
        "one-fwd-tile", "ragged-fwd-tiles", "kinetics-16"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_stem_pool_kernels_match_plain(dev, shape, ties):
    y, a, b, g = _stem_inputs(dev, shape, ties)
    out = stem_pool.stem_pool_fwd(y, a, b)
    assert torch.equal(out, stem_pool.plain_fwd(y, a, b))
    assert torch.equal(out, stem_pool.stem_pool_fwd(y, a, b))  # the same bits again
    _check_stem_bwd(y, a, b, g)


@pytest.mark.parametrize("edge", [15, 16, 17], ids=["halo-row", "tile-start", "tile-centre"])
def test_stem_pool_fwd_tile_edge_in_halo(dev, edge):
    """K2 stages a tile's 16 x 16 elements and the row and column before
    them: element row and column 15 end windows 7 and begin windows 8, so
    they are in one tile's windows and the next tile's halo; a unique
    largest value there (and at rows 16, 17 beside it) must reach both."""
    y, a, b, _ = _stem_inputs(dev, (2, 34, 50, 64), False, seed=12)
    a, b = a.abs() + 0.5, torch.zeros_like(b)
    y[:, edge, :, :] = 8.0
    y[:, :, edge, :] = 9.0
    out = stem_pool.stem_pool_fwd(y, a, b)
    assert torch.equal(out, stem_pool.plain_fwd(y, a, b))


def test_stem_pool_bwd_tile_edge_windows(dev):
    """Element row 13 and column 15 are the last of a tile: the windows on
    both sides of the tile edge (rows 6 and 7, columns 7 and 8) take their
    max there, so one element gathers from windows that two tiles stage."""
    y, a, b, g = _stem_inputs(dev, (2, 34, 34, 64), False, seed=7)
    y[:, 13, :, :] = 8.0
    y[:, :, 15, :] = 8.0
    a, b = a.abs() + 0.5, torch.zeros_like(b)
    _check_stem_bwd(y, a, b, g)


def test_stem_pool_bwd_sums_are_reproducible(dev):
    """Persistent blocks walk several tiles each; da/db are the same bits
    from call to call (no float atomics)."""
    y, a, b, g = _stem_inputs(dev, (16, 112, 112, 64), False, seed=8)
    da, db = _check_stem_bwd(y, a, b, g)
    _, da2, db2 = stem_pool.stem_pool_bwd(y, a, b, g)
    assert torch.equal(da, da2) and torch.equal(db, db2)


# the first K3 summed partials of 256 x 64 elements, a size the wrapper
# copied by hand; the kernel library now reports its partial count
@pytest.mark.parametrize("shape", [(1, 16, 16, 64), (1, 18, 16, 64), (3, 16, 18, 64)])
def test_stem_pool_bwd_partials_straddling_old_block(dev, shape):
    n, h, w, c = shape
    assert _lib.lib().avid_stem_pool_bwd_parts(n, h, w, c) >= 1
    _check_stem_bwd(*_stem_inputs(dev, shape, False, seed=9))


@pytest.mark.parametrize("c", [24, 256])
def test_stem_pool_bwd_rejects_channel_counts_it_cannot_take(dev, c):
    y, a, b, g = _stem_inputs(dev, (1, 4, 4, c), False)
    assert _lib.lib().avid_stem_pool_bwd_parts(1, 4, 4, c) == 0
    with pytest.raises(ValueError, match="C in 8"):
        stem_pool.stem_pool_bwd(y, a, b, g)


@pytest.mark.parametrize("c", [24, 256])
def test_stem_pool_fwd_rejects_channel_counts_it_cannot_take(dev, c):
    y, a, b, _ = _stem_inputs(dev, (1, 4, 4, c), False)
    with pytest.raises(ValueError, match="C in 8"):
        stem_pool.stem_pool_fwd(y, a, b)


def test_scale_relu_pool_autograd_on_card(dev):
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.standard_normal((2, 3, 8, 8, 64), dtype=np.float32)
                         ).to(dev).to(torch.bfloat16).requires_grad_()
    a = torch.from_numpy((rng.standard_normal(64) + 1).astype(np.float32)).to(dev).requires_grad_()
    b = torch.zeros(64, device=dev, requires_grad=True)
    before = dict(_lib.LAUNCHES)
    out = stem_pool.scale_relu_pool(y, a, b)
    out.float().square().sum().backward()
    assert _lib.LAUNCHES["stem_pool_fwd"] == before["stem_pool_fwd"] + 1
    assert _lib.LAUNCHES["stem_pool_bwd"] == before["stem_pool_bwd"] + 1
    assert y.grad.dtype == torch.bfloat16 and a.grad.shape == (64,)


def _stem_inputs_f32(dev, shape, ties, seed=1):
    y, a, b, g = _stem_inputs(dev, shape, ties, seed)
    rng = np.random.default_rng(seed + 100)
    # f32 values off the bf16 grid, ties kept on the 0.5 grid
    y = y.float() if ties else y.float() + torch.from_numpy(
        1e-3 * rng.standard_normal(shape, dtype=np.float32)).to(dev)
    return y, a, b, g.float()


def _check_stem_bwd_f32(y, a, b, g):
    """K3's f32 form against its plain version: dy within 1e-6 of the
    largest |dy|, da/db within 1e-5 of the largest."""
    dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
    rdy, rda, rdb = stem_pool.plain_bwd(y, a, b, g)
    assert dy.dtype == torch.float32 and da.dtype == db.dtype == torch.float32
    assert float((dy - rdy).abs().max()) <= 1e-6 * float(rdy.abs().max())
    assert float((da - rda).abs().max()) <= 1e-5 * float(rda.abs().max())
    assert float((db - rdb).abs().max()) <= 1e-5 * float(rdb.abs().max())
    return da, db


# the f32 forms walk pixels, not tiles: odd N, W not a multiple of 8 or
# 16 windows, one window, every channel count, a Kinetics-sized batch
@pytest.mark.parametrize("shape", [
    (3, 6, 10, 64), (1, 2, 2, 64), (5, 18, 34, 64), (3, 8, 4, 8), (1, 34, 20, 16),
    (1, 20, 18, 32), (1, 18, 18, 128), (9, 112, 112, 64),
], ids=["c64", "n1-2x2", "ragged-c64", "c8", "c16", "c32", "c128", "kinetics-9"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_stem_pool_f32_kernels_match_plain(dev, shape, ties):
    y, a, b, g = _stem_inputs_f32(dev, shape, ties)
    before = dict(_lib.LAUNCHES)
    out = stem_pool.stem_pool_fwd(y, a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, stem_pool.plain_fwd(y, a, b))
    da, db = _check_stem_bwd_f32(y, a, b, g)
    _, da2, db2 = stem_pool.stem_pool_bwd(y, a, b, g)
    assert torch.equal(da, da2) and torch.equal(db, db2)  # the same bits again
    launched = {k: _lib.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**dict.fromkeys(before, 0), "stem_pool_fwd_f32": 1,
                        "stem_pool_bwd_f32": 2}


@pytest.mark.parametrize("c", [24, 256])
def test_stem_pool_f32_rejects_channel_counts_it_cannot_take(dev, c):
    y, a, b, g = _stem_inputs_f32(dev, (1, 4, 4, c), False)
    with pytest.raises(ValueError, match="C in 8"):
        stem_pool.stem_pool_fwd(y, a, b)
    with pytest.raises(ValueError, match="C in 8"):
        stem_pool.stem_pool_bwd(y, a, b, g)


def test_stem_pool_f32_rejects_mixed_dtypes_and_misaligned_tensors(dev):
    y, a, b, g = _stem_inputs_f32(dev, (1, 4, 4, 64), False)
    with pytest.raises(ValueError, match="g: expected torch.float32"):
        stem_pool.stem_pool_bwd(y, a, b, g.to(torch.bfloat16))
    a_off = torch.zeros(65, device=dev)[1:]  # contiguous, 4 bytes past a float4
    with pytest.raises(ValueError, match="a: expected a 16-byte aligned tensor"):
        stem_pool.stem_pool_fwd(y, a_off, b)


def test_scale_relu_pool_autograd_on_card_f32(dev):
    """The f32 model's stem: the f32 kernels in both directions, the
    gradients those of the plain versions."""
    rng = np.random.default_rng(3)
    y0 = torch.from_numpy(rng.standard_normal((3, 2, 10, 14, 64), dtype=np.float32)).to(dev)
    a0 = torch.from_numpy((rng.standard_normal(64) + 1).astype(np.float32)).to(dev)
    b0 = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(np.float32)).to(dev)
    y, a, b = (t.clone().requires_grad_() for t in (y0, a0, b0))
    before = dict(_lib.LAUNCHES)
    out = stem_pool.scale_relu_pool(y, a, b)
    out.square().sum().backward()
    assert _lib.LAUNCHES["stem_pool_fwd_f32"] == before["stem_pool_fwd_f32"] + 1
    assert _lib.LAUNCHES["stem_pool_bwd_f32"] == before["stem_pool_bwd_f32"] + 1
    assert _lib.LAUNCHES["stem_pool_fwd"] == before["stem_pool_fwd"]
    g = 2 * stem_pool.plain_fwd(y0.reshape(6, 10, 14, 64), a0, b0)
    rdy, rda, rdb = stem_pool.plain_bwd(y0.reshape(6, 10, 14, 64), a0, b0, g)
    assert y.grad.dtype == torch.float32
    torch.testing.assert_close(y.grad, rdy.reshape(y0.shape), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a.grad, rda, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, rdb, rtol=1e-5, atol=1e-5)


# K4 scores one (b, k) a warp, four a block: K = 1 (the positive), B = 1,
# K not a multiple of the block's four (blocks that span query rows) or
# past a warp's 32, D = 64 (half the lanes idle) and 256 (two float4 a
# lane), and a repeated row in every case
@pytest.mark.parametrize("bk", [(5, 7), (3, 1), (1, 1), (1, 33), (4, 64), (2, 1030)],
                         ids=["k7", "k1", "b1-k1", "b1-k33", "k64", "k1030"])
@pytest.mark.parametrize("d", [128, 64, 256])
def test_nce_scores_match_plain(dev, d, bk):
    rng = np.random.default_rng(3)
    bank = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((1000, d), dtype=np.float32)).to(dev), dim=1)
    q = torch.from_numpy(rng.standard_normal((bk[0], d), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 1000, bk)).to(dev)
    idx[-1, -1] = idx[0, 0]
    got = nce_gather.scores(bank, idx, q, 0.07)
    assert got.shape == bk
    ref = nce_gather.plain_scores(bank, idx, q, 0.07)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1.3e-5
    qg = q.clone().requires_grad_()
    nce_gather.gather_scores(bank, idx, qg, 0.07).sum().backward()
    qp = q.clone().requires_grad_()
    nce_gather.plain_scores(bank, idx, qp, 0.07).sum().backward()
    torch.testing.assert_close(qg.grad, qp.grad, rtol=1e-5, atol=1e-5)


def test_nce_out_of_range_index_scores_nan(dev):
    bank = torch.ones((10, 128), device=dev)
    q = torch.ones((1, 128), device=dev)
    got = nce_gather.scores(bank, torch.tensor([[0, 10, -1]], device=dev), q, 1.0)
    assert float(got[0, 0]) == 128.0
    assert bool(torch.isnan(got[0, 1:]).all())


@pytest.mark.parametrize("bk", [(2, 32), (3, 5)], ids=["one-query-blocks", "mixed-blocks"])
def test_nce_out_of_range_indices_inside_blocks(dev, bk):
    """An index past either end (or far past it) scores NaN in a block of
    one query row and in a block that spans several; the other scores
    there are untouched."""
    rng = np.random.default_rng(13)
    bank = torch.from_numpy(rng.standard_normal((50, 128), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((bk[0], 128), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 50, bk)).to(dev)
    bad = torch.zeros(bk, dtype=torch.bool, device=dev)
    for (i, j), v in zip([(0, 1), (-1, -1), (1, 0)], [50, -7, 1 << 40]):
        idx[i, j] = v
        bad[i, j] = True
    got = nce_gather.scores(bank, idx, q, 0.07)
    ref = nce_gather.plain_scores(bank, torch.where(bad, 0, idx), q, 0.07)
    assert bool(torch.isnan(got[bad]).all())
    assert float((got[~bad] - ref[~bad]).abs().max() / ref.abs().max()) < 1.3e-5


def test_wrappers_reject_bad_inputs(dev):
    y = torch.zeros((2, 8, 8, 64), device=dev)
    a = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        stem_pool.stem_pool_fwd(y.double(), a, a)  # f64 activation
    yb = torch.zeros((2, 8, 8, 128), device=dev, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        stem_pool.stem_pool_fwd(yb, a, a)
    with pytest.raises(ValueError, match="int64"):
        nce_gather.scores(torch.zeros((4, 128), device=dev),
                          torch.zeros((1, 2), dtype=torch.int32, device=dev),
                          torch.zeros((1, 128), device=dev), 1.0)
    with pytest.raises(ValueError, match="float32"):
        spectrogram.log_spectrogram_kernel(torch.zeros((1, 4800), device=dev,
                                                       dtype=torch.float64))


def test_stem_conv_output_feeds_k2_without_a_copy(dev):
    """The stem conv runs channels-last, so the (B, T, H, W, C) view that
    K2 needs is already contiguous: no 411 MB copy at the Kinetics shape."""
    conv = R2Plus1D(depth=10, dtype=torch.bfloat16).conv1[0].to(dev)
    torch.nn.init.zeros_(conv.weight)
    x = torch.zeros((2, 4, 32, 32, 3), device=dev)
    h = conv(x.permute(0, 4, 1, 2, 3))
    assert h.is_contiguous(memory_format=torch.channels_last_3d)
    assert h.permute(0, 2, 3, 4, 1).is_contiguous()


def _pair_inputs(dev, shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(dt)

    return (t(rng.standard_normal(shape)),
            t(rng.standard_normal((1, 3, 3, c, c)) / np.sqrt(9 * c)),
            t(rng.standard_normal((3, 1, 1, c, c)) / np.sqrt(3 * c)),
            t(rng.uniform(0.5, 1.5, c), torch.float32),
            t(rng.standard_normal(c) * 0.1, torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("hw", [7, 9])
@pytest.mark.parametrize("t", [1, 3])
def test_r2p1d_pair_kernel_matches_plain(dev, t, hw, c, dtype):
    args = _pair_inputs(dev, (2, t, hw, hw, c), dtype)
    before = _lib.LAUNCHES["r2p1d_pair"]
    got = r2p1d_pair.r2p1d_pair(*args)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["r2p1d_pair"] == before + 1
    ref = r2p1d_pair.plain_pair(*args)
    assert got.shape == ref.shape and got.dtype == dtype
    # bf16: two ulps at the output's scale (sum order and the rounding of
    # the bf16 intermediate differ from cuDNN's); f32: sum order only
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) <= tol


# shapes that take each tile of the bf16 plan (tile_h x 8 pixels, frames
# sharing a weight tile; r2p1d_pair.plan_bf16 on an H100's 132 SMs), and
# the CUDA-core kernel's 16-pixel tile in f32
@pytest.mark.parametrize("shape,dtype,tile", [
    ((4, 2, 20, 20, 64), torch.bfloat16, (2, 2)),
    ((2, 3, 9, 9, 128), torch.bfloat16, (2, 2)),
    ((2, 2, 9, 9, 256), torch.float32, None),
    ((1, 32, 7, 7, 64), torch.bfloat16, (2, 2)),
    ((6, 2, 40, 40, 64), torch.bfloat16, (8, 1)),
    ((10, 2, 20, 20, 64), torch.bfloat16, (8, 2)),
    ((5, 2, 20, 20, 64), torch.bfloat16, (4, 2)),
    ((5, 1, 20, 20, 64), torch.bfloat16, (4, 1)),
    ((2, 1, 9, 9, 128), torch.bfloat16, (2, 1)),
], ids=["2x8-2f-20x20", "2x8-2f-9x9", "f32-16px", "2x8-2f-32-frames", "8x8-1f", "8x8-2f",
        "4x8-2f", "4x8-1f", "2x8-1f"])
def test_r2p1d_pair_kernel_tile_shapes(dev, shape, dtype, tile):
    if tile is not None:
        plan = r2p1d_pair.plan_bf16(*shape, 132)
        assert (plan.tile_h, plan.frames) == tile
    args = _pair_inputs(dev, shape, dtype)
    got = r2p1d_pair.r2p1d_pair(*args).float()
    ref = r2p1d_pair.plain_pair(*args).float()
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.parametrize("shape", [(6, 2, 40, 40, 64), (2, 3, 9, 9, 128)],
                         ids=["8x8-tiles", "2x8-tiles-ragged"])
def test_r2p1d_pair_bf16_tile_borders_in_halo(dev, shape):
    """Input only on the pixels of each tile's border rows and columns, so
    every output reads its neighbours across a tile edge through the staged
    halo: a wrong shift, swizzle or zero fill shows."""
    args = list(_pair_inputs(dev, shape, torch.bfloat16, seed=7))
    b, t, h, w, c = shape
    th = r2p1d_pair.plan_bf16(*shape, 132).tile_h
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    border = ((ys % th == 0) | (ys % th == th - 1))[:, None] | ((xs % 8 == 0) | (xs % 8 == 7))[None]
    args[0] = (args[0] * border[None, None, :, :, None]).contiguous()
    got = r2p1d_pair.r2p1d_pair(*args).float()
    ref = r2p1d_pair.plain_pair(*args).float()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 8e-3


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("hw", [28, 14])
def test_r2p1d_pair_bf16_ragged_stage_planes(dev, hw, c):
    """The late stages' planes (28^2, 14^2) are not multiples of the 8-pixel
    tile: the ragged tiles are masked."""
    args = _pair_inputs(dev, (2, 3, hw, hw, c), torch.bfloat16, seed=8)
    got = r2p1d_pair.r2p1d_pair(*args).float()
    ref = r2p1d_pair.plain_pair(*args).float()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 8e-3


def test_r2p1d_pair_bf16_same_bits_twice(dev):
    args = _pair_inputs(dev, (2, 8, 56, 56, 64), torch.bfloat16, seed=9)
    first = r2p1d_pair.r2p1d_pair(*args)
    second = r2p1d_pair.r2p1d_pair(*args)
    assert torch.equal(first, second)


def test_r2p1d_pair_bf16_and_f32_paths_side_by_side(dev):
    """The same values through both kernels in one run: bf16 (tensor cores)
    within 8e-3 and f32 (CUDA cores) within 1e-5 of the plain version,
    each launched once."""
    shape = (2, 4, 28, 28, 128)
    x, ws, wt, a, b = _pair_inputs(dev, shape, torch.float32, seed=10)
    before = _lib.LAUNCHES["r2p1d_pair"]
    for dtype, tol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        args = (x.to(dtype), ws.to(dtype), wt.to(dtype), a, b)
        got = r2p1d_pair.r2p1d_pair(*args).float()
        ref = r2p1d_pair.plain_pair(*args).float()
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol
    assert _lib.LAUNCHES["r2p1d_pair"] == before + 2


def test_r2p1d_pair_kernel_temporal_edges(dev):
    c = 64
    x = torch.zeros((1, 3, 8, 8, c), device=dev)
    x[0, 0] = 1.0
    ws = torch.zeros((1, 3, 3, c, c), device=dev)
    ws[0, 1, 1] = torch.eye(c)
    wt = torch.stack([torch.eye(c) * k for k in (2.0, 3.0, 5.0)]).to(dev)[:, None, None]
    out = r2p1d_pair.r2p1d_pair(x, ws, wt.contiguous(), torch.ones(c, device=dev),
                                torch.zeros(c, device=dev))
    assert bool((out[0, 0] == 3.0).all() and (out[0, 1] == 2.0).all())
    assert bool((out[0, 2] == 0.0).all())


def test_r2p1d_pair_rejects_bad_inputs(dev):
    x, ws, wt, a, b = _pair_inputs(dev, (1, 2, 7, 7, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        r2p1d_pair.r2p1d_pair(x, ws.float(), wt, a, b)  # weights not in x.dtype
    with pytest.raises(ValueError, match="shape"):
        r2p1d_pair.r2p1d_pair(x, ws, wt[:2], a, b)
    with pytest.raises(ValueError, match="contiguous"):
        r2p1d_pair.r2p1d_pair(x.transpose(2, 3), ws, wt, a, b)
    with pytest.raises(ValueError, match="multiple of 64"):
        r2p1d_pair.r2p1d_pair(*_pair_inputs(dev, (1, 2, 7, 7, 32), torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        r2p1d_pair.r2p1d_pair(x, ws, wt, a.double(), b)


def test_eval_block_activation_feeds_k5_without_a_copy(dev, monkeypatch):
    """In eval mode both stride-1 pairs of a block take the NTHWC view of
    the channels-last activation as it is: the first pair reads the
    block's input memory itself, and each input is already contiguous."""
    block = blocks.BasicR2P1DBlock(64, 64, dtype=torch.bfloat16).to(dev).eval()
    for m in block.modules():
        if isinstance(m, Conv3D):
            torch.nn.init.normal_(m.weight, std=0.05)
    seen = []

    def spy(x, *rest):
        seen.append((x.data_ptr(), x.is_contiguous()))
        return real(x, *rest)

    real = blocks.r2p1d_pair
    monkeypatch.setattr(blocks, "r2p1d_pair", spy)
    x = torch.randn((2, 4, 14, 14, 64), device=dev, dtype=torch.bfloat16)
    before = _lib.LAUNCHES["r2p1d_pair"]
    with torch.inference_mode():
        out = block(x.permute(0, 4, 1, 2, 3))
    assert _lib.LAUNCHES["r2p1d_pair"] == before + 2
    assert seen[0] == (x.data_ptr(), True) and seen[1][1]
    assert out.permute(0, 2, 3, 4, 1).is_contiguous()


def test_device_prefetch_orders_the_kernels_after_the_copy(dev):
    """Batches prefetched on the side stream arrive whole on the card, and
    a kernel launched on the current stream (K1, whose ctypes launch takes
    ``_lib.stream()``, the current stream) reads the copied batch: its
    result equals the plain version on the host batch."""
    from avid_cma_tpu_torch.data.prefetch import device_prefetch

    assert _lib.stream() == torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(12)
    host = [{"audio": (0.1 * rng.standard_normal((4, 24000)) + 0.05).astype(np.float32),
             "frames": rng.integers(0, 256, (4, 2, 64, 80, 3), dtype=np.uint8)}
            for _ in range(5)]
    kw = dict(sample_rate=24000, n_fft=512, hop_size=0.01, duration=1.0)
    for b, src in zip(device_prefetch(iter(host), dev, depth=2), host):
        assert b["audio"].is_cuda and b["frames"].dtype == torch.uint8
        got = spectrogram.log_spectrogram_kernel(b["audio"], **kw)
        ref = stft.log_spectrogram(torch.from_numpy(src["audio"]), **kw)
        assert float((got.cpu() - ref).abs().max()) < 1e-4
        assert torch.equal(b["frames"].cpu(), torch.from_numpy(src["frames"]))


# AVID-CMA: K4 at the positives' K = 32 and the within-modal negatives'
# K = 64 (a contiguous copy of a 1024-column draw's first 64 columns, as
# cma_forward passes them); the slice itself, not contiguous, is refused
@pytest.mark.parametrize("k,cols", [(32, 32), (64, 1024)], ids=["k32", "k64-of-1024"])
def test_nce_scores_at_the_cma_index_shapes(dev, k, cols):
    rng = np.random.default_rng(21)
    bank = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((5000, 128), dtype=np.float32)).to(dev), dim=1)
    q = torch.from_numpy(rng.standard_normal((32, 128), dtype=np.float32)).to(dev)
    full = torch.from_numpy(rng.integers(0, 5000, (32, cols))).to(dev)
    idx = full[:, :k].contiguous()
    before = _lib.LAUNCHES["nce_gather"]
    got = nce_gather.scores(bank, idx, q, 0.07)
    assert _lib.LAUNCHES["nce_gather"] == before + 1
    ref = nce_gather.plain_scores(bank, idx, q, 0.07)
    assert got.shape == (32, k)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1.3e-5
    if k < cols:
        with pytest.raises(ValueError, match="contiguous"):
            nce_gather.scores(bank, full[:, :k], q, 0.07)


def test_mining_on_the_card_matches_the_cpu(dev):
    """Every agreement type at a ragged N (1000 rows, tiles of 256): the
    card's set equals the CPU's, except rows whose k-th and (k+1)-th
    agreement, recomputed in f64, lie within 1e-6 (the two sum the f32
    products in other orders)."""
    from avid_cma_tpu_torch.criterions import mining

    rng = np.random.default_rng(22)
    banks = rng.standard_normal((2, 1000, 128)).astype(np.float32)
    banks /= np.linalg.norm(banks, axis=2, keepdims=True)
    cpu_banks = [torch.from_numpy(b) for b in banks]
    for kind in mining.AGREEMENT_TYPES:
        got = mining.mine_positives(*(b.to(dev) for b in cpu_banks), 16, kind, tile=256)
        assert got.is_cuda and got.dtype == torch.int64
        want = mining.mine_positives(*cpu_banks, 16, kind, tile=256)
        differ = (got.cpu() != want).any(dim=1).nonzero().flatten()
        if differ.numel():
            gaps = mining.boundary_gap(*cpu_banks, differ, 16, kind)
            assert float(gaps.max()) < 1e-6, (kind, differ.tolist(), gaps.tolist())


def test_cma_step_on_the_card_matches_the_cpu(dev):
    """One AVID-CMA train step (R2Plus1D-10 + Conv2D-10, B=4, 8 x 64^2,
    N=256, pos_k 8, 32 negatives, 8 within) on the card and on the CPU
    from the same weights, banks, positive set and negatives: loss and Z
    within 2%, the touched bank rows within cosine 0.99; 8 K4 launches."""
    from avid_cma_tpu_torch.criterions import avid_cma, mining
    from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
    from avid_cma_tpu_torch.ops.sampling import rank_shift
    from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
    from avid_cma_tpu_torch.train.state import TrainState
    from avid_cma_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(23)
    n, k, pos_k, b = 256, 32, 8, 4
    banks = rng.standard_normal((2, n, 128)).astype(np.float32)
    banks /= np.linalg.norm(banks, axis=2, keepdims=True)
    pos = mining.mine_positives(*(torch.from_numpy(m) for m in banks), pos_k)
    batch = {"frames": rng.standard_normal((b, 8, 64, 64, 3), dtype=np.float32),
             "audio": rng.standard_normal((b, 40, 257, 1), dtype=np.float32),
             "index": rng.choice(n, b, replace=False)}
    y = torch.from_numpy(batch["index"])
    negs = rank_shift(torch.from_numpy(rng.integers(0, n - pos_k, (b, k))), pos[y])
    crit = avid_cma.AVIDCMAConfig(num_data=n, num_negatives=k, num_negatives_within=8,
                                  pos_k=pos_k)
    out = {}
    for d in ("cpu", dev):
        model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                           proj_dim=[512, 512, 128], seed=0, device=d)
        opt = build_optimizer(model.parameters(), "adam", 2e-4, weight_decay=1e-5)
        bank = avid_cma.CMAState(*(torch.from_numpy(m.copy()).to(d) for m in banks),
                                 z=torch.tensor(-1.0, device=d), positive_set=pos.to(d))
        state = TrainState(model, opt, multistep_scheduler(opt, [], 1.0), bank,
                           torch.Generator(device=d))
        before = _lib.LAUNCHES["nce_gather"]
        m = make_train_step(crit)(state, {key: torch.from_numpy(v).to(d)
                                          for key, v in batch.items()}, neg_idx=negs.to(d))
        launched = _lib.LAUNCHES["nce_gather"] - before
        assert launched == (0 if d == "cpu" else 8)
        out[str(d)] = (float(m["loss"]), float(state.bank.z),
                       state.bank.view2_mem[y.to(d)].cpu())
    card, cpu = out[str(dev)], out["cpu"]
    assert abs(card[0] - cpu[0]) / abs(cpu[0]) <= 2e-2
    assert abs(card[1] - cpu[1]) / abs(cpu[1]) <= 2e-2
    assert float((card[2] * cpu[2]).sum(1).min()) >= 0.99


# the eval paths' K5 shapes: the 32at16 finetune's stride-1 pairs at T = 32
# (conv2x to conv5x, 2 of its 64 clips) and the linear probe's conv2x at
# B = 128 (T = 8)
@pytest.mark.parametrize("shape", [
    (2, 32, 56, 56, 64), (2, 16, 28, 28, 128), (2, 8, 14, 14, 256), (2, 4, 7, 7, 512),
    (128, 8, 56, 56, 64),
], ids=["32at16-conv2x", "32at16-conv3x", "32at16-conv4x", "32at16-conv5x", "probe-b128-conv2x"])
def test_r2p1d_pair_bf16_at_the_eval_shapes(dev, shape):
    args = _pair_inputs(dev, shape, torch.bfloat16)
    before = _lib.LAUNCHES["r2p1d_pair"]
    got = r2p1d_pair.r2p1d_pair(*args).float()
    assert _lib.LAUNCHES["r2p1d_pair"] == before + 1
    ref = r2p1d_pair.plain_pair(*args).float()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 8e-3
    # the last clip's last frame, where a wrapped offset would land
    assert float((got[-1, -1] - ref[-1, -1]).abs().max() / ref.abs().max()) <= 8e-3


def test_stem_pool_kernels_at_the_32at16_stem(dev):
    """K2 and K3 at the 32at16 finetune's stem: 64 clips x 32 frames of
    112^2 x 64 (3.3 GB of bf16, past 2^31 bytes). The first and the last
    two images against the plain versions (where a 32-bit offset would
    wrap); K3's da and db against the plain sums over every image, taken
    in chunks."""
    n, h, w, c = 64 * 32, 112, 112, 64
    gen = torch.Generator(device=dev).manual_seed(7)
    y = torch.randn((n, h, w, c), generator=gen, device=dev, dtype=torch.bfloat16)
    g = torch.randn((n, h // 2, w // 2, c), generator=gen, device=dev, dtype=torch.bfloat16)
    a = torch.rand(c, generator=gen, device=dev) + 0.5
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    assert y.numel() * y.element_size() > 2**31
    out = stem_pool.stem_pool_fwd(y, a, b)
    dy, da, db = stem_pool.stem_pool_bwd(y, a, b, g)
    for rows in (slice(0, 2), slice(n - 2, n)):
        assert torch.equal(out[rows], stem_pool.plain_fwd(y[rows], a, b))
        rdy, _, _ = stem_pool.plain_bwd(y[rows], a, b, g[rows])
        assert float(((dy[rows].float() - rdy.float()).abs() / _bf16_ulp(rdy)).max()) <= 1.0
    rda, rdb = torch.zeros_like(da), torch.zeros_like(db)
    for i in range(0, n, 128):
        _, pa, pb = stem_pool.plain_bwd(y[i:i + 128], a, b, g[i:i + 128])
        rda += pa
        rdb += pb
    torch.testing.assert_close(da, rda, rtol=2e-3, atol=1e-3)
    torch.testing.assert_close(db, rdb, rtol=2e-3, atol=1e-3)


def test_eval_steps_on_the_card(dev):
    """The eval paths' launches at a small size: a warmup step (the
    backbone frozen: K2, no K3, its parameters the same bits, its BN
    running stats moved), a finetune step (K2 and K3), a clip-test
    forward (K2, K5 on the five stride-1 pairs of R2Plus1D-10) and a
    probe step (K2, K5; the extractor the same bits)."""
    from avid_cma_tpu_torch.models.av_wrapper import init_params
    from avid_cma_tpu_torch.models.eval_wrappers import (
        ClassificationWrapper,
        MOSTModel,
        classifier_parameters,
    )
    from avid_cma_tpu_torch.train.eval_loop import (
        frozen,
        make_logits_fn,
        make_supervised_train_step,
    )
    from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
    from avid_cma_tpu_torch.train.state import TrainState

    rng = np.random.default_rng(31)
    frames = torch.from_numpy(rng.standard_normal((8, 8, 64, 64, 3), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 5, 8)).to(dev)
    backbone = R2Plus1D(10, dtype=torch.bfloat16)
    init_params(backbone, torch.Generator().manual_seed(0))
    model = ClassificationWrapper(backbone, 5, (8, 64, 64)).to(dev)

    def state_for(params):
        opt = build_optimizer(params, "adam", 1e-3)
        return TrainState(model, opt, multistep_scheduler(opt, [], 1.0), None,
                          torch.Generator(device=dev))

    def launches(fn):
        before = dict(_lib.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        return tuple(_lib.LAUNCHES[k] - before[k]
                     for k in ("stem_pool_fwd", "stem_pool_bwd", "r2p1d_pair"))

    step = make_supervised_train_step()
    params0 = [p.detach().clone() for p in model.feature_extractor.parameters()]
    stats0 = [t.clone() for t in model.feature_extractor.buffers()]
    state = state_for(classifier_parameters(model))
    with frozen(model.feature_extractor):
        assert launches(lambda: step(state, frames, labels)) == (1, 0, 0)
    assert all(torch.equal(p, q) for p, q in zip(model.feature_extractor.parameters(), params0))
    assert not all(torch.equal(s, t) for s, t in zip(model.feature_extractor.buffers(), stats0))
    state = state_for(model.parameters())
    assert launches(lambda: step(state, frames, labels)) == (1, 1, 0)
    logits = make_logits_fn(model)
    assert launches(lambda: logits(frames)) == (1, 0, 5)
    assert logits(frames).dtype == torch.float32

    probe = MOSTModel(model.feature_extractor, 5, ["conv2x", "conv5x"],
                      ["AdaptiveMaxPool3d((1, 6, 6))", None], (8, 64, 64), use_bn=True).to(dev)
    extractor = [t.clone() for t in probe.feature_extractor.state_dict().values()]
    opt = build_optimizer(classifier_parameters(probe), "adam", 1e-3)
    pstate = TrainState(probe, opt, multistep_scheduler(opt, [], 1.0), None,
                        torch.Generator(device=dev))
    pstep = make_supervised_train_step(multi_output=True)
    assert launches(lambda: pstep(pstate, frames, labels)) == (1, 0, 5)
    assert all(torch.equal(s, t) for s, t in
               zip(probe.feature_extractor.state_dict().values(), extractor))


# ---------------------------------------------------------------------------
# row-sharded banks in a one-rank NCCL world (the card host has one card)
# ---------------------------------------------------------------------------

@pytest.fixture()
def one_rank_world(dev):
    from avid_cma_tpu_torch.parallel import mesh

    world = mesh.initialize("cuda", 0, 1, torch.distributed.HashStore())
    yield world
    mesh.shutdown()


@pytest.mark.parametrize("n,b,k", [(1, 3, 1), (37, 5, 7), (1000, 33, 1), (1000, 1, 64),
                                   (4097, 45, 1030)],
                         ids=["n1", "ragged", "b33-k1", "b1-k64", "b45-k1030"])
def test_scores_sharded_through_k4_equals_direct_k4(one_rank_world, n, b, k):
    from avid_cma_tpu_torch.parallel import sharding

    gen = torch.Generator(device="cuda").manual_seed(n + b + k)
    bank = torch.nn.functional.normalize(torch.randn((n, 128), generator=gen, device="cuda"),
                                         dim=1)
    idx = torch.randint(0, n, (b, k), generator=gen, device="cuda")
    q = torch.randn((b, 128), generator=gen, device="cuda")
    g = torch.randn((b, k), generator=gen, device="cuda")
    layout = sharding.BankLayout(n=n, world=one_rank_world, sharded=True)
    shard = sharding.shard_rows(bank, 0, 1)
    for dtype in (torch.float32, torch.bfloat16):
        qs = q.to(dtype).clone().requires_grad_(True)
        qr = q.to(dtype).clone().requires_grad_(True)
        before = _lib.LAUNCHES["nce_gather"]
        got = sharding.scores_sharded(shard, idx, qs, layout, 0.07)
        assert _lib.LAUNCHES["nce_gather"] == before + 1
        want = nce_gather.gather_scores(bank, idx, qr, 0.07)
        assert torch.equal(got, want)
        assert torch.equal(got, nce_gather.scores(bank, idx, qr.detach(), 0.07))
        got.backward(g)
        want.backward(g)
        assert qs.grad.dtype == dtype and torch.equal(qs.grad, qr.grad)


def test_sharded_bank_update_and_mining_on_the_card(one_rank_world):
    from avid_cma_tpu_torch.criterions import mining
    from avid_cma_tpu_torch.criterions.avid import BankState, update_banks
    from avid_cma_tpu_torch.parallel import sharding

    gen = torch.Generator(device="cuda").manual_seed(5)
    n, d = 1001, 128
    banks = [torch.nn.functional.normalize(torch.randn((n, d), generator=gen, device="cuda"),
                                           dim=1) for _ in range(2)]
    y = torch.randint(0, n, (9,), generator=gen, device="cuda")
    y[3] = y[7]
    emb = torch.randn((9, d), generator=gen, device="cuda")
    state = BankState(banks[0], banks[1], torch.tensor(0.5, device="cuda"))
    layout = sharding.BankLayout(n=n, world=one_rank_world, sharded=True)
    sharded = update_banks(sharding.shard_bank(state, layout), emb, emb.flip(1), y,
                           (0.5, 0.5), layout)
    replicated = update_banks(state, emb, emb.flip(1), y, (0.5, 0.5))
    full = sharding.unshard_bank(sharded, layout)
    assert torch.equal(full.view1_mem, replicated.view1_mem)
    assert torch.equal(full.view2_mem, replicated.view2_mem)
    assert not sharded.view1_mem[n].any()
    pos = mining.mine_positives_sharded(*(sharding.shard_rows(m, 0, 1) for m in banks), layout, 8)
    assert pos.shape == (n + 1, 8) and not pos[n].any()
    assert torch.equal(pos[:n], mining.mine_positives(banks[0], banks[1], 8))
    mesh_pos = mining.mine_positives_mesh(banks[0], banks[1], 8, one_rank_world)
    assert torch.equal(mesh_pos, pos[:n])
