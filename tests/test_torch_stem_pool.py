"""Port K2/K3 (avid_cma_tpu_torch/ops/kernels/stem_pool.py) on the CPU,
where the wrapper runs the plain version, against the JAX op: the XLA
composition ``_xla_scale_relu_pool`` and its ``jax.vjp``, and the Pallas
kernels ``_pallas_fwd``/``_pallas_bwd`` in interpret mode. Includes a
tie-heavy input (values on a 0.5 grid), where routing to the first
row-major max decides the gradient. Tolerances: fwd 1e-6; dy 1e-5;
da, db rtol 1e-4 (f32 sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import avid_cma_tpu.ops.pallas.stem_pool as sp
from avid_cma_tpu_torch.ops.kernels import stem_pool as port
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)


def _inputs(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(shape).astype(np.float32)
    c = shape[-1]
    if ties:
        y = np.round(y * 2.0) / 2.0
        a, b = np.ones(c, np.float32), np.zeros(c, np.float32)
    else:
        a = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
        b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal((*shape[:-3], shape[-3] // 2, shape[-2] // 2, c))
    return y, a, b, g.astype(np.float32)


def _port_vjp(y, a, b, g):
    ty = torch.from_numpy(y).requires_grad_()
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = port.scale_relu_pool(ty, ta, tb)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), ty.grad.numpy(), ta.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie-heavy"])
def test_matches_xla_composition_and_vjp(ties):
    y, a, b, g = _inputs(0, (2, 3, 16, 16, 8), ties)
    out, dy, da, db = _port_vjp(y, a, b, g)
    ref, vjp = jax.vjp(sp._xla_scale_relu_pool, jnp.asarray(y), jnp.asarray(a),
                       jnp.asarray(b))
    rdy, rda, rdb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dy, np.asarray(rdy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(da, np.asarray(rda), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db, np.asarray(rdb), rtol=1e-4, atol=1e-5)


def test_matches_pallas_kernels_interpret(monkeypatch):
    monkeypatch.setattr(
        sp.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    y, a, b, g = _inputs(1, (2, 16, 12, 8))
    ty, ta, tb = map(torch.from_numpy, (y, a, b))
    out = port.stem_pool_fwd(ty, ta, tb).numpy()
    ref = np.asarray(sp._pallas_fwd(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    dy, da, db = port.stem_pool_bwd(ty, ta, tb, torch.from_numpy(g))
    rdy, rda, rdb = sp._pallas_bwd(jnp.asarray(y), jnp.asarray(a),
                                   jnp.asarray(b), jnp.asarray(g))
    np.testing.assert_allclose(dy.numpy(), np.asarray(rdy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(da.numpy(), np.asarray(rda), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), rtol=1e-4, atol=1e-5)


def test_bf16_rounds_affine_once():
    """bf16 input: the affine runs in f32 and rounds once, as the Pallas
    kernel's _relu_affine; the max of rounded values is exact."""
    y, a, b, _ = _inputs(2, (1, 4, 8, 8, 8))
    yb = torch.from_numpy(y).to(torch.bfloat16)
    out = port.scale_relu_pool(yb, torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    pre = torch.relu(yb.float() * torch.from_numpy(a) + torch.from_numpy(b))
    ref = torch.nn.functional.max_pool2d(
        pre.to(torch.bfloat16).float().reshape(4, 8, 8, 8).permute(0, 3, 1, 2),
        3, 2, 1).permute(0, 2, 3, 1).reshape(out.shape)
    torch.testing.assert_close(out.float(), ref, atol=0, rtol=0)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tie-heavy"])
def test_zero_padding_and_separable_max_are_exact(ties):
    """The forward kernel's arithmetic in torch: relu_affine once per
    element, padding as 0 instead of -inf (every window holds its
    in-bounds centre and relu >= 0), a 3-wide row max at each window
    column, then a 3-high max over those. Bit for bit the plain version,
    with negative scales and all-negative windows included."""
    y, a, b, _ = _inputs(3, (3, 18, 22, 16), ties)
    if not ties:
        a[:4] = -np.abs(a[:4])  # windows whose max comes from their smallest y
        y[:, :6, :6, :] = -np.abs(y[:, :6, :6, :]) - 1.0  # relu 0 in a corner
    ty = torch.from_numpy(y).to(torch.bfloat16)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    n, h, w, c = ty.shape
    yh = torch.relu(ty.float() * ta + tb).to(torch.bfloat16)
    pad = torch.nn.functional.pad(yh, (0, 0, 1, 0, 1, 0))  # top row, left column: 0
    rows = torch.maximum(torch.maximum(pad[:, :, 0:w:2], pad[:, :, 1:w + 1:2]),
                         pad[:, :, 2:w + 2:2])
    out = torch.maximum(torch.maximum(rows[:, 0:h:2], rows[:, 1:h + 1:2]), rows[:, 2:h + 2:2])
    assert torch.equal(out, port.stem_pool_fwd(ty, ta, tb))
