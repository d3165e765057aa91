"""The port's row-sharded banks and sharded mining (avid_cma_tpu_torch/
parallel/sharding.py, criterions/mining.py) in a simulated world, one
process, no process group: each primitive's rank-local part is called
for every rank r = 0..world-1 and the parts are combined as the
collective would (all_gather: concatenated rank-major; reduce_scatter and
all_reduce: summed, each rank keeping its slot).

- The layout: the shards hold the full table's rows, zero past N, and a
  zero sentinel row; unsharding gives the table back.
- Against the port's replicated versions, bit for bit, at world 2 and 4
  with N not a multiple of the world: ``gather_rows_sharded`` (per-rank
  and replicated indices), ``gather_values_sharded`` (the int64 positive
  set), ``scores_sharded`` forward (K4's plain version on each shard) and
  its dq, and ``ema_update_rows_sharded`` with duplicate ids.
- Against the JAX package's ``parallel/sharding.py`` run in ``shard_map``
  on a CPU mesh of tests/conftest.py's virtual devices: exact for the
  gathers and the row update, within 1e-6 of the largest value for the
  scores and dq; the EMA
  with its renorm within one f32 rounding (the two norms sum in other
  orders).
- The query-sharded and the row-sharded mining sweeps against JAX's
  ``mine_positives(mesh=...)`` and ``mine_positives_sharded``: the sets
  exactly equal, and equal to the port's one-device ``mine_positives``;
  no padded row is ever chosen.
- ``scores_sharded`` through its autograd function in a world of one
  equals ``gather_scores`` bit for bit, forward and dq.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import avid_cma_tpu.parallel.sharding as jsh
from avid_cma_tpu.criterions.mining import mine_positives as jax_mine
from avid_cma_tpu.criterions.mining import mine_positives_sharded as jax_mine_sharded
from avid_cma_tpu_torch.criterions.avid import BankState, _last_occurrence, update_banks
from avid_cma_tpu_torch.criterions.mining import (
    mine_block_mesh,
    mine_block_sharded,
    mine_positives,
)
from avid_cma_tpu_torch.criterions.nce import l2_normalize
from avid_cma_tpu_torch.ops.kernels.nce_gather import gather_scores, scores_vjp
from avid_cma_tpu_torch.parallel.sharding import (
    BankLayout,
    gather_rows_local,
    local_index,
    scores_local,
    scores_sharded,
    shard_bank,
    shard_rows,
    unshard_bank,
    update_rows_local,
)
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

N, D, B, K, T = 37, 16, 3, 5, 0.07
WORLDS = (2, 4)


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(world, seed=0):
    rng = np.random.default_rng(seed)
    bank = _unit(rng, N, D)
    idx = rng.integers(0, N, (world, B, K))
    idx[0, 0, 0], idx[-1, -1, -1] = 0, N - 1  # the first and the last row
    q = rng.standard_normal((world, B, D)).astype(np.float32)
    g = rng.standard_normal((world, B, K)).astype(np.float32)
    return bank, idx, q, g


def _shards(full, world):
    return [shard_rows(full, r, world) for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_shards_hold_the_rows_and_a_zero_sentinel(world):
    bank = torch.from_numpy(_inputs(world)[0])
    n_local = -(-N // world)
    shards = _shards(bank, world)
    assert all(s.shape == (n_local + 1, D) for s in shards)
    assert all(not s[n_local].any() for s in shards)
    rows = torch.cat([s[:n_local] for s in shards])
    assert torch.equal(rows[:N], bank) and not rows[N:].any()
    idx = torch.arange(-1, N + 1)
    for r in range(world):
        local = local_index(idx, r, n_local)
        owned = (idx >= r * n_local) & (idx < (r + 1) * n_local)
        assert torch.equal(local[owned], idx[owned] - r * n_local)
        assert bool((local[~owned] == n_local).all())
    # the BankState forms, a world of one process: sharding keeps the full
    # table plus the sentinel, unsharding gives the state back
    pos = torch.arange(N * 2).reshape(N, 2)
    state = BankState(bank, bank.flip(0), torch.tensor(0.5))
    one = BankLayout(n=N, sharded=True)
    sharded = shard_bank(state, one)
    assert sharded.view1_mem.shape == (N + 1, D) and sharded.z is state.z
    back = unshard_bank(sharded, one)
    assert torch.equal(back.view1_mem, bank) and torch.equal(back.view2_mem, bank.flip(0))
    assert shard_bank(state, BankLayout(n=N)) is state
    assert torch.equal(shard_rows(pos, world - 1, world)[:N - (world - 1) * n_local],
                       pos[(world - 1) * n_local:])


@pytest.mark.parametrize("world", WORLDS)
def test_gathers_equal_the_replicated_ones(world):
    bank, idx, _, _ = _inputs(world)
    full = torch.from_numpy(bank)
    shards = _shards(full, world)
    idx_g = torch.from_numpy(idx.reshape(world * B, K))
    # per-rank indices: all_gather, each rank's masked gather, reduce_scatter
    total = sum(gather_rows_local(shards[r], idx_g, r) for r in range(world))
    for r in range(world):
        assert torch.equal(total[r * B:(r + 1) * B], full[torch.from_numpy(idx[r])])
    # indices equal on every rank: one all_reduce of the parts
    y = torch.from_numpy(idx[0, :, 0])
    assert torch.equal(sum(gather_rows_local(s, y, r) for r, s in enumerate(shards)), full[y])
    # the positive set (int64 values)
    table = torch.from_numpy(np.random.default_rng(1).integers(0, N, (N, 4)))
    parts = [gather_rows_local(s, idx_g[:, 0], r) for r, s in enumerate(_shards(table, world))]
    assert torch.equal(sum(parts), table[idx_g[:, 0]])
    assert sum(parts).dtype == torch.int64


@pytest.mark.parametrize("world", WORLDS)
def test_scores_and_dq_equal_the_replicated_ones(world):
    bank, idx, q, g = _inputs(world)
    full = torch.from_numpy(bank)
    shards = _shards(full, world)
    idx_g = torch.from_numpy(idx.reshape(world * B, K))
    q_g = torch.from_numpy(q.reshape(world * B, D))
    g_g = torch.from_numpy(g.reshape(world * B, K))
    scores = sum(scores_local(shards[r], idx_g, q_g, r, T) for r in range(world))
    rows = sum(gather_rows_local(shards[r], idx_g, r) for r in range(world))
    for r in range(world):
        sl = slice(r * B, (r + 1) * B)
        qr = q_g[sl].clone().requires_grad_(True)
        want = gather_scores(full, idx_g[sl], qr, T)
        want.backward(g_g[sl])
        assert torch.equal(scores[sl], want.detach())
        assert torch.equal(scores_vjp(g_g[sl], rows[sl], T, torch.float32), qr.grad)


def test_scores_sharded_in_a_world_of_one_equals_gather_scores():
    bank, idx, q, g = _inputs(1)
    full = torch.from_numpy(bank)
    layout = BankLayout(n=N, sharded=True)
    shard = shard_rows(full, 0, 1)
    for dtype in (torch.float32, torch.float64):
        qs = torch.from_numpy(q[0]).to(dtype).requires_grad_(True)
        qr = qs.detach().clone().requires_grad_(True)
        got = scores_sharded(shard, torch.from_numpy(idx[0]), qs, layout, T)
        want = gather_scores(full, torch.from_numpy(idx[0]), qr, T)
        got.backward(torch.from_numpy(g[0]))
        want.backward(torch.from_numpy(g[0]))
        assert torch.equal(got, want) and got.dtype == torch.float32
        assert torch.equal(qs.grad, qr.grad) and qs.grad.dtype == dtype


def _gathered_batch(world, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, N, world * B)
    y[1] = y[world * B - 1] = N - 1  # a duplicate id, the last row
    return torch.from_numpy(y), torch.from_numpy(_unit(rng, world * B, D))


@pytest.mark.parametrize("world", WORLDS)
def test_ema_update_equals_the_replicated_one(world):
    bank = torch.from_numpy(_inputs(world)[0])
    y, emb = _gathered_batch(world)
    last = _last_occurrence(y)
    shards = _shards(bank, world)
    old = sum(gather_rows_local(s, y, r) for r, s in enumerate(shards))  # all_reduce
    new = l2_normalize(old * 0.5 + emb * 0.5)
    updated = [update_rows_local(s, y, new[last], r) for r, s in enumerate(shards)]
    n_local = -(-N // world)
    assert all(not u[n_local].any() for u in updated)
    got = torch.cat([u[:n_local] for u in updated])[:N]
    # the replicated update of the criterion (a world of one process)
    want = update_banks(BankState(bank, bank, torch.tensor(-1.0)), emb, emb, y, (0.5, 0.5))
    assert torch.equal(got, want.view1_mem)
    assert not torch.equal(got, bank)


# ---------------------------------------------------------------------------
# against the JAX package's shard_map primitives
# ---------------------------------------------------------------------------

def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _smap(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(world), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


@pytest.mark.parametrize("world", WORLDS)
def test_gathers_and_update_equal_jax_shard_map(world):
    bank, idx, _, _ = _inputs(world)
    full = torch.from_numpy(bank)
    shards = _shards(full, world)
    jbank = jsh.shard_bank(jnp.asarray(bank), _mesh(world))
    idx_g = torch.from_numpy(idx.reshape(world * B, K))
    got = sum(gather_rows_local(shards[r], idx_g, r) for r in range(world))
    jgot = _smap(lambda b, i: jsh.gather_rows_sharded(b, i, "data"), world,
                 (P("data", None), P("data")), P("data"))(
        jbank, jnp.asarray(idx.reshape(world * B, K), jnp.int32))
    assert np.array_equal(got.numpy(), np.asarray(jgot))

    # the update: the same new rows (duplicates carrying equal rows) land
    # on the same rows of the same shards
    y, emb = _gathered_batch(world)
    last = _last_occurrence(y)
    old = sum(gather_rows_local(s, y, r) for r, s in enumerate(shards))
    new = l2_normalize(old * 0.5 + emb * 0.5)[last]
    n_local = -(-N // world)
    got = torch.cat([update_rows_local(s, y, new, r)[:n_local] for r, s in enumerate(shards)])
    specs = ((P("data", None), P(), P()), P("data", None))
    jy = jnp.asarray(y.numpy(), jnp.int32)
    jgot = _smap(lambda b, yy, e: jsh.update_rows_sharded(b, yy, e, "data"), world, *specs)(
        jbank, jy, jnp.asarray(new.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(jgot))
    # the EMA with its renorm: jnp.linalg.norm and torch's vector_norm sum
    # the squares in other orders, so a renormed row may differ by one f32
    # rounding (6e-8 at unit norm), in the replicated update as well
    jema = _smap(lambda b, yy, e: jsh.ema_update_rows_sharded(b, yy, e, 0.5, "data"), world,
                 *specs)(jbank, jy, jnp.asarray(emb.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jema), rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_scores_and_dq_match_jax_shard_map(world):
    bank, idx, q, g = _inputs(world)
    shards = _shards(torch.from_numpy(bank), world)
    idx_g = torch.from_numpy(idx.reshape(world * B, K))
    q_g = torch.from_numpy(q.reshape(world * B, D))
    g_g = torch.from_numpy(g.reshape(world * B, K))
    scores = sum(scores_local(shards[r], idx_g, q_g, r, T) for r in range(world))
    rows = sum(gather_rows_local(shards[r], idx_g, r) for r in range(world))
    dq = scores_vjp(g_g, rows, T, torch.float32)

    def local(bk, qq, ii, gg):
        s, vjp = jax.vjp(lambda x: jsh.scores_sharded(bk, ii, x, "data") / T, qq)
        return s, vjp(gg)[0]

    js, jdq = _smap(local, world, (P("data", None), P("data"), P("data"), P("data")),
                    (P("data"), P("data")))(
        jsh.shard_bank(jnp.asarray(bank), _mesh(world)), jnp.asarray(q_g.numpy()),
        jnp.asarray(idx_g.numpy(), jnp.int32), jnp.asarray(g_g.numpy()))
    # relative to the largest value: the two sum a row's products in
    # other orders
    for got, want in ((scores.numpy(), np.asarray(js)), (dq.numpy(), np.asarray(jdq))):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("world", WORLDS)
def test_mining_sweeps_equal_jax_mesh_and_sharded_sweeps(world):
    rng = np.random.default_rng(world)
    n, pos_k = 45, 4  # not a multiple of either world
    bv, ba = _unit(rng, n, D), _unit(rng, n, D)
    tv, ta = torch.from_numpy(bv), torch.from_numpy(ba)
    one_device = mine_positives(tv, ta, pos_k, tile=8)
    mesh = _mesh(world)

    # query-sharded over replicated banks: all_gather of the rank blocks
    got = torch.cat([mine_block_mesh(tv, ta, pos_k, r, world, tile=8)
                     for r in range(world)])[:n]
    want = np.asarray(jax_mine(jnp.asarray(bv), jnp.asarray(ba), pos_k, tile=8, mesh=mesh))
    assert np.array_equal(got.numpy(), want) and torch.equal(got, one_device)

    # row-sharded: each rank's shard of the set from the gathered banks
    n_local = -(-n // world)
    blocks = [mine_block_sharded(tv, ta, pos_k, r, world, tile=8) for r in range(world)]
    assert all(b.shape == (n_local + 1, pos_k) and not b[n_local].any() for b in blocks)
    got = torch.cat([b[:n_local] for b in blocks])
    assert not got[n:].any()  # padded queries give no set
    got = got[:n]
    jwant = jax_mine_sharded(jsh.shard_bank(jnp.asarray(bv), mesh),
                             jsh.shard_bank(jnp.asarray(ba), mesh), n, pos_k, tile=8,
                             mesh=mesh)
    assert np.array_equal(got.numpy(), np.asarray(jwant)[:n])
    assert torch.equal(got, one_device)
    assert int(got.max()) < n  # no padded row was chosen
