"""Port K4 (avid_cma_tpu_torch/ops/kernels/nce_gather.py) on the CPU,
where the wrapper runs the plain version, against JAX ``gather_scores``,
the Pallas kernel ``_pallas_scores`` in interpret mode, and an f64 numpy
ground truth. Tolerances: scores 1.3e-5 relative to the largest score
(the figure the JAX kernel met at Kinetics scale); dq 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import avid_cma_tpu.ops.pallas.nce_gather as ng
from avid_cma_tpu_torch.ops.kernels import nce_gather as port
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

T = 0.07


def _setup(seed, n=300, d=128, b=16, k=48):
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((n, d))
    bank = (bank / np.linalg.norm(bank, axis=1, keepdims=True)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, k))
    if k > 1:
        idx[:, 1] = idx[:, 0]  # duplicate rows within a query
    g = rng.standard_normal((b, k)).astype(np.float32)
    return bank, q, idx, g


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _truth(bank, q, idx):
    return np.einsum("bd,bkd->bk", q.astype(np.float64),
                     bank.astype(np.float64)[idx]) / T


@pytest.mark.parametrize("k", [48, 1], ids=["negatives", "positive"])
def test_scores_and_query_grad(k):
    bank, q, idx, g = _setup(0, k=k)
    tq = torch.from_numpy(q).requires_grad_()
    tbank = torch.from_numpy(bank).requires_grad_()
    s = port.gather_scores(tbank, torch.from_numpy(idx), tq, T)
    s.backward(torch.from_numpy(g))
    assert s.dtype == torch.float32
    assert tbank.grad is None  # no gradient to the bank

    ref = ng.gather_scores(jnp.asarray(bank), jnp.asarray(idx, jnp.int32),
                           jnp.asarray(q), T)
    assert _rel(s.detach().numpy(), np.asarray(ref)) < 1.3e-5
    assert _rel(s.detach().numpy(), _truth(bank, q, idx)) < 1.3e-5

    rdq = jax.grad(lambda qq: jnp.sum(ng.gather_scores(
        jnp.asarray(bank), jnp.asarray(idx, jnp.int32), qq, T) * g))(jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(rdq), atol=1e-5, rtol=1e-5)
    dq64 = np.einsum("bk,bkd->bd", g.astype(np.float64),
                     bank.astype(np.float64)[idx]) / T
    np.testing.assert_allclose(tq.grad.numpy(), dq64, atol=1e-5, rtol=1e-5)


def test_matches_pallas_kernel_interpret(monkeypatch):
    monkeypatch.setattr(
        ng.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    bank, q, idx, _ = _setup(1, n=250, b=8, k=64)
    got = port.scores(torch.from_numpy(bank), torch.from_numpy(idx),
                      torch.from_numpy(q), T).numpy()
    ref = ng._pallas_scores(jnp.asarray(bank), jnp.asarray(idx, jnp.int32),
                            jnp.asarray(q), T)
    assert _rel(got, np.asarray(ref)) < 1.3e-5


def test_bf16_query_gets_bf16_grad():
    bank, q, idx, g = _setup(2, b=8, k=16)
    qb = torch.from_numpy(q).to(torch.bfloat16).requires_grad_()
    s = port.gather_scores(torch.from_numpy(bank), torch.from_numpy(idx), qb, T)
    assert s.dtype == torch.float32  # bank is f32: the query is promoted
    s.backward(torch.from_numpy(g))
    assert qb.grad.dtype == torch.bfloat16
    rdq = jax.grad(lambda qq: jnp.sum(ng.gather_scores(
        jnp.asarray(bank), jnp.asarray(idx, jnp.int32), qq, T) * g))(
            jnp.asarray(q, jnp.bfloat16))
    assert rdq.dtype == jnp.bfloat16
    np.testing.assert_allclose(qb.grad.float().numpy(),
                               np.asarray(rdq.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
