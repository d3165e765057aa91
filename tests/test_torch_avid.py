"""Port AVID criterion (avid_cma_tpu_torch/criterions/) against JAX
``avid_forward`` with the same injected negatives: total loss, per-head
logs, the frozen Z, the new banks, and the gradients w.r.t. both
embeddings, within 1e-4. Covers the first step (Z estimated and frozen),
a second step with Z frozen, and a batch with repeated indices, where
the bank EMA is last-write-wins on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avid_cma_tpu.criterions.avid as jax_avid
from avid_cma_tpu_torch.criterions import avid as port
from avid_cma_tpu_torch.ops.sampling import draw_negatives_uniform
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

N, D, K, B = 64, 128, 16, 6
TOL = 1e-4


def _inputs(seed, y):
    rng = np.random.default_rng(seed)
    bank_v = rng.standard_normal((N, D))
    bank_a = rng.standard_normal((N, D))
    bank_v /= np.linalg.norm(bank_v, axis=1, keepdims=True)
    bank_a /= np.linalg.norm(bank_a, axis=1, keepdims=True)
    ve = rng.standard_normal((len(y), D)).astype(np.float32)
    ae = rng.standard_normal((len(y), D)).astype(np.float32)
    negs = np.stack([rng.choice(np.setdiff1d(np.arange(N), [yi]), K) for yi in y])
    return bank_v.astype(np.float32), bank_a.astype(np.float32), ve, ae, negs


def _jax_side(monkeypatch, bank_v, bank_a, z, ve, ae, y, negs, cfg):
    monkeypatch.setattr(jax_avid, "draw_negatives_uniform",
                        lambda key, yy, kk, nn: jnp.asarray(negs, jnp.int32))
    state = jax_avid.BankState(view1_mem=jnp.asarray(bank_v),
                               view2_mem=jnp.asarray(bank_a), z=jnp.float32(z))

    def f(v, a):
        loss, logs, new = jax_avid.avid_forward(
            state, v, a, jnp.asarray(y, jnp.int32), jax.random.key(0), cfg)
        return loss, (logs, new)

    (loss, (logs, new)), (gv, ga) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ve), jnp.asarray(ae))
    return loss, logs, new, gv, ga


def _port_side(bank_v, bank_a, z, ve, ae, y, negs, cfg):
    state = port.BankState(view1_mem=torch.from_numpy(bank_v).clone(),
                           view2_mem=torch.from_numpy(bank_a).clone(),
                           z=torch.tensor(z))
    tv = torch.from_numpy(ve).requires_grad_()
    ta = torch.from_numpy(ae).requires_grad_()
    loss, logs, new = port.avid_forward(state, tv, ta, torch.from_numpy(y),
                                        cfg, neg_idx=torch.from_numpy(negs))
    loss.backward()
    # the old banks are left as they were (functional update)
    np.testing.assert_array_equal(state.view1_mem.numpy(), bank_v)
    return loss, logs, new, tv.grad, ta.grad


@pytest.mark.parametrize("case", ["first-step", "frozen-z", "repeated-y"])
def test_avid_forward_matches(monkeypatch, case):
    y = np.array([3, 5, 3, 7, 11, 5] if case == "repeated-y" else [3, 5, 9, 7, 11, 40])
    seed = {"first-step": 0, "frozen-z": 1, "repeated-y": 2}[case]
    bank_v, bank_a, ve, ae, negs = _inputs(seed, y)
    z = 1.7 if case == "frozen-z" else -1.0
    jcfg = jax_avid.AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K, momentum=0.5)
    pcfg = port.AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K, momentum=0.5)
    jl, jlogs, jnew, jgv, jga = _jax_side(monkeypatch, bank_v, bank_a, z, ve, ae, y, negs, jcfg)
    pl, plogs, pnew, pgv, pga = _port_side(bank_v, bank_a, z, ve, ae, y, negs, pcfg)

    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=TOL)
    for k in ("Loss/v2a", "Loss/a2v", "Loss/xModal"):
        np.testing.assert_allclose(float(plogs[k]), float(jlogs[k]), rtol=TOL)
    np.testing.assert_allclose(float(pnew.z), float(jnew.z), rtol=TOL)
    if case == "frozen-z":
        assert float(pnew.z) == pytest.approx(1.7)
    np.testing.assert_allclose(pnew.view1_mem.numpy(), np.asarray(jnew.view1_mem), atol=TOL)
    np.testing.assert_allclose(pnew.view2_mem.numpy(), np.asarray(jnew.view2_mem), atol=TOL)
    np.testing.assert_allclose(pgv.numpy(), np.asarray(jgv), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pga.numpy(), np.asarray(jga), atol=TOL, rtol=TOL)
    untouched = np.setdiff1d(np.arange(N), y)
    np.testing.assert_array_equal(pnew.view1_mem.numpy()[untouched], bank_v[untouched])
    touched = np.linalg.norm(pnew.view1_mem.numpy()[np.unique(y)], axis=1)
    np.testing.assert_allclose(touched, 1.0, atol=1e-6)


def test_draw_negatives_avoids_self():
    gen = torch.Generator().manual_seed(0)
    y = torch.tensor([0, 5, 63, 5])
    idx = draw_negatives_uniform(y, 2000, N, gen)
    assert idx.shape == (4, 2000) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < N
    assert not bool((idx == y[:, None]).any())
    # every other index is reachable
    assert len(torch.unique(idx[1])) == N - 1


def test_init_bank_state_is_unit_norm():
    st = port.init_bank_state(N, D, torch.Generator().manual_seed(0))
    for mem in (st.view1_mem, st.view2_mem):
        assert mem.shape == (N, D)
        np.testing.assert_allclose(torch.linalg.vector_norm(mem, dim=1).numpy(), 1.0,
                                   atol=1e-6)
    assert float(st.z) == -1.0
