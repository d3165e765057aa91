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
from avid_cma_tpu_torch.ops.kernels.r2p1d_pair import plain_pair, r2p1d_pair


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
