"""The port's AVID-CMA (avid_cma_tpu_torch/ops/sampling.py rank shift,
criterions/mining.py, criterions/avid_cma.py, the CMA train and eval
steps) against the JAX package on the CPU, at small sizes (N <= 256,
D = 128, pos_k 4-8, K <= 32), inputs made from a numpy seed:

- the rank shift of ``draw_negatives_avoid_sorted``, given JAX's own
  ``randint`` draws: the same integers, for positive sets at 0, at N - 1,
  in contiguous runs and at random; no negative hits a positive;
- ``mine_positives`` for the four agreement types, with a tile that does
  not divide N: the sets exactly equal; ``exact=False`` raises;
- ``cma_forward`` with JAX's negatives passed in, for the Kinetics
  coefficients (InstX + PosW) and all four heads, ``num_negatives_within``
  None and 8: every ``Loss/*`` entry, the total, Z, both new banks and the
  gradients of both embeddings within 1e-4;
- a six-step CMA trajectory against JAX's ``make_train_step`` on a
  one-device mesh (R2Plus1D-10 + Conv2D-10, B=4, 4 x 32^2, N=64): step 0
  within 1e-4, all six within 1%;
- the CMA eval-loss step: JAX's value, the state untouched.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import avid_cma_tpu.criterions.avid_cma as jax_cma
from avid_cma_tpu.criterions.avid import BankState as JaxBankState
from avid_cma_tpu.criterions.mining import mine_positives as jax_mine
from avid_cma_tpu.models import av_wrapper as jax_av_wrapper
from avid_cma_tpu.ops.sampling import draw_negatives_avoid_sorted as jax_draw_avoid
from avid_cma_tpu.train.optim import build_optimizer as jax_build_optimizer
from avid_cma_tpu.train.state import TrainState as JaxTrainState
from avid_cma_tpu.train.step import make_eval_loss_step as jax_make_eval_loss_step
from avid_cma_tpu.train.step import make_train_step as jax_make_train_step
from avid_cma_tpu_torch.criterions import avid_cma as port
from avid_cma_tpu_torch.criterions.mining import (
    AGREEMENT_TYPES,
    boundary_gap,
    default_tile,
    mine_positives,
)
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.ops.sampling import draw_negatives_avoid_sorted, rank_shift
from avid_cma_tpu_torch.train.checkpoint import flax_to_port_state
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import init_train_state, make_eval_loss_step, make_train_step
from tests.test_torch_models import (  # noqa: F401  (autouse fixture)
    random_variables,
    torch_threads_per_worker,
)

TOL = 1e-4
D = 128


def _banks(rng, n):
    b = rng.standard_normal((2, n, D))
    return (b / np.linalg.norm(b, axis=2, keepdims=True)).astype(np.float32)


def _positive_sets(kind, rng, bsz, pos_k, n):
    if kind == "random":
        return np.sort(np.stack([rng.choice(n, pos_k, replace=False) for _ in range(bsz)]), 1)
    if kind == "at-zero":
        return np.tile(np.arange(pos_k), (bsz, 1))
    if kind == "at-end":
        return np.tile(np.arange(n - pos_k, n), (bsz, 1))
    # two contiguous runs per row, one touching 0 or N - 1
    half = pos_k // 2
    rows = []
    for i in range(bsz):
        start = int(rng.integers(half + 1, n - pos_k))
        first = np.arange(half) if i % 2 else np.arange(n - half, n)
        rows.append(np.sort(np.concatenate([first, np.arange(start, start + pos_k - half)])))
    return np.stack(rows)


@pytest.mark.parametrize("kind", ["random", "at-zero", "at-end", "runs"])
def test_rank_shift_equals_jax(kind):
    n, pos_k, k, bsz = 64, 8, 32, 6
    rng = np.random.default_rng(["random", "at-zero", "at-end", "runs"].index(kind))
    pos = _positive_sets(kind, rng, bsz, pos_k, n)
    key = jax.random.key(7)
    want = np.asarray(jax_draw_avoid(key, jnp.asarray(pos, jnp.int32), k, n))
    # the draws inside the JAX function, fed to the port's shift
    draws = np.asarray(jax.random.randint(key, (bsz, k), 0, n - pos_k))
    got = rank_shift(torch.from_numpy(draws.copy()), torch.from_numpy(pos))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the extremes of the draw land on the extremes of the complement
    edge = rank_shift(torch.tensor([[0, n - pos_k - 1]] * bsz), torch.from_numpy(pos)).numpy()
    for row, p in zip(edge, pos):
        rest = np.setdiff1d(np.arange(n), p)
        assert (row[0], row[1]) == (rest[0], rest[-1])
    assert not any(np.isin(r, p).any() for r, p in zip(got.numpy(), pos))


def test_draw_negatives_avoid_sorted_covers_the_complement():
    n, pos_k = 64, 8
    pos = torch.from_numpy(_positive_sets("runs", np.random.default_rng(0), 3, pos_k, n))
    idx = draw_negatives_avoid_sorted(pos, 4000, n, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 4000) and idx.dtype == torch.int64
    for row, p in zip(idx, pos):
        assert set(row.tolist()) == set(range(n)) - set(p.tolist())


@pytest.mark.parametrize("kind", AGREEMENT_TYPES)
@pytest.mark.parametrize("tile", [48, 256])
def test_mine_positives_equals_jax(kind, tile):
    n, pos_k = 200, 8  # tile 48 does not divide 200; 256 holds it in one tile
    banks = _banks(np.random.default_rng(10 + AGREEMENT_TYPES.index(kind)), n)
    want = np.asarray(jax_mine(jnp.asarray(banks[0]), jnp.asarray(banks[1]), pos_k, kind,
                               tile=tile))
    got = mine_positives(torch.from_numpy(banks[0]), torch.from_numpy(banks[1]), pos_k, kind,
                         tile=tile)
    assert got.shape == (n, pos_k) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got[:, 1:] > got[:, :-1]).all())
    assert not bool((got == torch.arange(n)[:, None]).any())


def test_mine_positives_refuses_approximate_topk():
    b = torch.nn.functional.normalize(torch.randn(32, 16), dim=1)
    with pytest.raises(NotImplementedError, match="exact: false"):
        mine_positives(b, b, 4, exact=False)
    with pytest.raises(ValueError, match="agreement"):
        mine_positives(b, b, 4, kind="both")


def test_boundary_gap_and_the_card_tile():
    """``boundary_gap``, which the card checks use to excuse a near-tie,
    is the f64 gap between each row's k-th and (k+1)-th agreement, the
    row's own column left out; the card's tile keeps a tile's three
    (tile, N) f32 matrices within 3 GiB (1024 at the Kinetics N)."""
    banks = _banks(np.random.default_rng(5), 40)
    rows = torch.tensor([0, 7, 39])
    gap = boundary_gap(torch.from_numpy(banks[0]), torch.from_numpy(banks[1]), rows, 4, "union")
    b = banks.astype(np.float64)
    for g, r in zip(gap.numpy(), rows.numpy()):
        agree = np.maximum(b[0] @ b[0][r], b[1] @ b[1][r])
        agree[r] = -np.inf
        top = np.sort(agree)[::-1]
        assert g == pytest.approx(top[3] - top[4], abs=1e-12) and g >= 0
    assert default_tile(232067, torch.device("cuda")) == 1024
    assert default_tile(232067, torch.device("cpu")) == 256
    assert default_tile(10_000_000, torch.device("cuda")) == 26


CMA_CASES = {
    # name: (coefficients xInst, wInst, xPos, wPos; num_negatives_within; z; y)
    "kinetics-w8": ((1.0, 0.0, 0.0, 1.0), 8, -1.0, [3, 5, 9, 7, 11, 40]),
    "kinetics-w8-frozen-z-repeated-y": ((1.0, 0.0, 0.0, 1.0), 8, 1.7, [3, 5, 3, 7, 11, 5]),
    "all-heads-w8": ((1.0, 0.5, 0.25, 1.0), 8, -1.0, [3, 5, 9, 7, 11, 40]),
    "all-heads-w-none": ((1.0, 0.5, 0.25, 1.0), None, -1.0, [3, 5, 9, 7, 11, 40]),
}


@pytest.mark.parametrize("case", list(CMA_CASES))
def test_cma_forward_matches_jax(monkeypatch, case):
    coeffs, within, z, y = CMA_CASES[case]
    n, k, pos_k = 64, 16, 4
    y = np.array(y)
    rng = np.random.default_rng(list(CMA_CASES).index(case))
    banks = _banks(rng, n)
    positive_set = _positive_sets("random", rng, n, pos_k, n)
    ve = rng.standard_normal((len(y), D)).astype(np.float32)
    ae = rng.standard_normal((len(y), D)).astype(np.float32)
    negs = rank_shift(torch.from_numpy(rng.integers(0, n - pos_k, (len(y), k))),
                      torch.from_numpy(positive_set[y])).numpy()
    names = ("xModalInstCoeff", "wModalInstCoeff", "xModalPosCoeff", "wModalPosCoeff")
    kw = dict(num_data=n, embedding_dim=D, num_negatives=k, num_negatives_within=within,
              momentum=0.5, pos_k=pos_k, **dict(zip(names, coeffs)))

    # JAX, with the same negatives
    monkeypatch.setattr(jax_cma, "draw_negatives_avoid_sorted",
                        lambda key, pos, kk, nn: jnp.asarray(negs, jnp.int32))
    jstate = jax_cma.cma_state_from_bank(
        JaxBankState(view1_mem=jnp.asarray(banks[0]), view2_mem=jnp.asarray(banks[1]),
                     z=jnp.float32(z)), jnp.asarray(positive_set))

    def f(v, a):
        loss, logs, new = jax_cma.cma_forward(jstate, v, a, jnp.asarray(y, jnp.int32),
                                              jax.random.key(0), jax_cma.AVIDCMAConfig(**kw))
        return loss, (logs, new)

    (jl, (jlogs, jnew)), (jgv, jga) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ve), jnp.asarray(ae))

    # the port
    pstate = port.CMAState(view1_mem=torch.from_numpy(banks[0].copy()),
                           view2_mem=torch.from_numpy(banks[1].copy()), z=torch.tensor(z),
                           positive_set=torch.from_numpy(positive_set))
    tv = torch.from_numpy(ve).requires_grad_()
    ta = torch.from_numpy(ae).requires_grad_()
    pl, plogs, pnew = port.cma_forward(pstate, tv, ta, torch.from_numpy(y),
                                       port.AVIDCMAConfig(**kw), neg_idx=torch.from_numpy(negs))
    pl.backward()

    assert set(plogs) == set(jlogs)
    for key in jlogs:
        np.testing.assert_allclose(float(plogs[key]), float(jlogs[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(pnew.z), float(jnew.z), rtol=TOL)
    if z > 0:
        assert float(pnew.z) == pytest.approx(z)
    np.testing.assert_allclose(pnew.view1_mem.numpy(), np.asarray(jnew.view1_mem), atol=TOL)
    np.testing.assert_allclose(pnew.view2_mem.numpy(), np.asarray(jnew.view2_mem), atol=TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga), atol=TOL, rtol=TOL)
    # a CMA state in, a CMA state out; the old banks untouched
    assert isinstance(pnew, port.CMAState) and pnew.positive_set is pstate.positive_set
    np.testing.assert_array_equal(pstate.view1_mem.numpy(), banks[0])


def test_cma_config_from_yaml_args():
    args = {"num_data": 100, "momentum": 0.5, "num_negatives": 1024, "num_negatives_within": 64,
            "xModalInstCoeff": 1.0, "wModalInstCoeff": 0.0, "xModalPosCoeff": 0.0,
            "wModalPosCoeff": 1.0, "resample_freq": 5,
            "sampling_args": {"type": "union", "pos_k": 16, "exact": False}}
    for mod in (jax_cma, port):
        cfg = mod.AVIDCMAConfig.from_config(args)
        assert (cfg.pos_k, cfg.sampling_type, cfg.mining_exact, cfg.momentum) == (
            16, "union", False, (0.5, 0.5))
        assert cfg.coeffs == (0.5, 0.0, 0.0, 0.5)
    for epoch, freq in [(0, 1), (1, 1), (5, 5), (4, 5), (10, 5), (3, -1)]:
        assert port.should_resample(epoch, freq) == jax_cma.should_resample(epoch, freq)


# ---------------------------------------------------------------------------
# the step against JAX's make_train_step / make_eval_loss_step
# ---------------------------------------------------------------------------

STEPS, B, N, K, POS_K, WITHIN = 6, 4, 64, 16, 4, 8
LR, WD = 2e-5, 1e-5


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.default_rng(0)
    videos = rng.standard_normal((STEPS, B, 4, 32, 32, 3)).astype(np.float32)
    audios = rng.standard_normal((STEPS, B, 24, 33, 1)).astype(np.float32)
    ys = np.stack([rng.choice(N, B, replace=False) for _ in range(STEPS)])
    # negatives from a fixed table, indexed on both sides by a function of
    # the batch's positive rows (what the JAX sampler sees inside its step)
    table = rng.integers(0, N, (N, K))
    banks = _banks(rng, N)
    positive_set = np.asarray(jax_mine(jnp.asarray(banks[0]), jnp.asarray(banks[1]), POS_K))
    jm = jax_av_wrapper(video_backbone="R2Plus1D", video_backbone_args={"depth": 10},
                        audio_backbone="Conv2D", audio_backbone_args={"depth": 10},
                        proj_dim=[512, 512, D])
    variables = random_variables(jm, 1, jnp.asarray(videos[0]), jnp.asarray(audios[0]))
    return dict(videos=videos, audios=audios, ys=ys, table=table, banks=banks,
                positive_set=positive_set, jm=jm, variables=variables,
                mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))


def _cfgs():
    kw = dict(num_data=N, embedding_dim=D, num_negatives=K, num_negatives_within=WITHIN,
              momentum=0.5, pos_k=POS_K)
    return jax_cma.AVIDCMAConfig(**kw), port.AVIDCMAConfig(**kw)


def _negs(table, pos_rows):
    return table[pos_rows.sum(axis=1) % N]


def _patch_jax_negatives(monkeypatch, table):
    monkeypatch.setattr(jax_cma, "draw_negatives_avoid_sorted",
                        lambda key, pos, kk, nn: jnp.asarray(table, jnp.int32)[pos.sum(1) % N])


def _jax_state(s, params, opt_state, step):
    bank = jax_cma.cma_state_from_bank(
        JaxBankState(view1_mem=jnp.asarray(s["banks"][0]), view2_mem=jnp.asarray(s["banks"][1]),
                     z=jnp.float32(-1.0)), jnp.asarray(s["positive_set"]))
    st = JaxTrainState(step=jnp.int32(step), epoch=jnp.int32(0), params=params,
                       batch_stats=s["variables"]["batch_stats"], opt_state=opt_state,
                       bank=bank, rng=jax.random.key(0))
    return jax.device_put(st, NamedSharding(s["mesh"], PartitionSpec()))


def _port_state(s, lr):
    pm = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                    proj_dim=[512, 512, D], device="cpu")
    pm.load_state_dict(flax_to_port_state(s["variables"]), strict=True)
    opt = build_optimizer(pm.parameters(), "adam", lr, weight_decay=WD)
    bank = port.CMAState(torch.from_numpy(s["banks"][0].copy()),
                         torch.from_numpy(s["banks"][1].copy()), torch.tensor(-1.0),
                         torch.from_numpy(s["positive_set"].astype(np.int64)))
    return TrainState(model=pm, optimizer=opt, scheduler=multistep_scheduler(opt, [10], 1.0),
                      bank=bank, generator=torch.Generator().manual_seed(0))


def _batch(s, i, lib):
    if lib == "jax":
        return {"frames": jnp.asarray(s["videos"][i]), "audio": jnp.asarray(s["audios"][i]),
                "index": jnp.asarray(s["ys"][i], jnp.int32)}
    return {"frames": torch.from_numpy(s["videos"][i]), "audio": torch.from_numpy(s["audios"][i]),
            "index": torch.from_numpy(s["ys"][i])}


def test_six_step_cma_trajectory_matches_jax(slice_inputs, monkeypatch):
    s = slice_inputs
    _patch_jax_negatives(monkeypatch, s["table"])
    jcfg, pcfg = _cfgs()
    tx = jax_build_optimizer("adam", LR, weight_decay=WD)
    params = s["variables"]["params"]
    jstate = _jax_state(s, params, tx.init(params), 0)
    jstep = jax_make_train_step(s["jm"], jcfg, tx, s["mesh"], donate=False)
    pstate = _port_state(s, LR)
    pstep = make_train_step(pcfg)

    j_losses, p_losses = [], []
    for i in range(STEPS):
        jstate, jmet = jstep(jstate, _batch(s, i, "jax"))
        pos_rows = s["positive_set"][s["ys"][i]]
        pmet = pstep(pstate, _batch(s, i, "torch"),
                     neg_idx=torch.from_numpy(_negs(s["table"], pos_rows)))
        j_losses.append(float(jmet["loss"]))
        p_losses.append(float(pmet["loss"]))
        if i == 0:
            assert set(pmet) == set(jmet)
            for key in jmet:
                np.testing.assert_allclose(float(pmet[key]), float(jmet[key]), rtol=TOL,
                                           atol=TOL, err_msg=key)
            np.testing.assert_allclose(float(pstate.bank.z), float(jstate.bank.z), rtol=TOL)
            np.testing.assert_allclose(pstate.bank.view1_mem.numpy(),
                                       np.asarray(jstate.bank.view1_mem), atol=TOL)
            np.testing.assert_allclose(pstate.bank.view2_mem.numpy(),
                                       np.asarray(jstate.bank.view2_mem), atol=TOL)
    rel = np.abs(np.array(p_losses) - np.array(j_losses)) / np.abs(np.array(j_losses))
    assert rel.max() < 1e-2, (p_losses, j_losses)
    assert float(pstate.bank.z) == pytest.approx(float(jstate.bank.z), rel=1e-4)
    np.testing.assert_array_equal(pstate.bank.positive_set.numpy(), s["positive_set"])
    assert pstate.step == STEPS


def test_cma_eval_loss_step_matches_jax(slice_inputs, monkeypatch):
    s = slice_inputs
    _patch_jax_negatives(monkeypatch, s["table"])
    jcfg, pcfg = _cfgs()
    jstate = _jax_state(s, s["variables"]["params"], (), 3)
    jmet = jax_make_eval_loss_step(s["jm"], jcfg, s["mesh"])(jstate, _batch(s, 0, "jax"), 5)

    pstate = _port_state(s, 1e-4)
    pstate.model.train()
    before = (copy.deepcopy(pstate.model.state_dict()), copy.deepcopy(pstate.bank),
              pstate.generator.get_state())
    pstep = make_eval_loss_step(pcfg, seed=0)
    pos_rows = s["positive_set"][s["ys"][0]]
    pmet = pstep(pstate, _batch(s, 0, "torch"), 5,
                 neg_idx=torch.from_numpy(_negs(s["table"], pos_rows)))
    assert set(pmet) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(pmet[key]), float(jmet[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    # own negatives (past the positives): per batch index, reproducible
    own = [float(pstep(pstate, _batch(s, 0, "torch"), i)["loss"]) for i in (0, 0, 1)]
    assert own[0] == own[1] and own[1] != own[2]
    sd, bank, gen = before
    for key, v in pstate.model.state_dict().items():
        assert torch.equal(v, sd[key]), key
    for f in ("view1_mem", "view2_mem", "z", "positive_set"):
        assert torch.equal(getattr(pstate.bank, f), getattr(bank, f)), f
    assert pstate.model.training and torch.equal(pstate.generator.get_state(), gen)


def test_init_train_state_zeroes_the_positive_set():
    _, pcfg = _cfgs()
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(model.parameters())
    state = init_train_state(model, opt, multistep_scheduler(opt, [], 1.0), pcfg, seed=0)
    assert isinstance(state.bank, port.CMAState)
    assert state.bank.positive_set.shape == (N, POS_K)
    assert state.bank.positive_set.dtype == torch.int64
    assert not bool(state.bank.positive_set.any())
