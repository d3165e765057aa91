"""The forward-only path on the CPU: the port's eval-loss step, embed fn
and eval-mode forward (the stride-1 R(2+1)D pairs through ``r2p1d_pair``,
kernel K5's route) against the JAX package's ``make_eval_loss_step`` and
``make_embed_fn`` on a one-device mesh, at R2Plus1D-10 + Conv2D-10, B=4,
4 x 32^2, N=64, K=16, from the same weights, banks, batch and negatives
(a fixed per-instance table on both sides, as test_torch_step.py).
Tolerance 1e-4 (f32). Also: the eval step leaves params, BN stats,
banks, Z, the step count, the generator and the train/eval mode as they
were, and draws its own negatives per ``batch_idx``; the fused eval step
runs the eval preprocessing."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import avid_cma_tpu.criterions.avid as jax_avid
from avid_cma_tpu.models import av_wrapper as jax_av_wrapper
from avid_cma_tpu.train.state import TrainState as JaxTrainState
from avid_cma_tpu.train.step import make_embed_fn as jax_make_embed_fn
from avid_cma_tpu.train.step import make_eval_loss_step as jax_make_eval_loss_step
from avid_cma_tpu_torch.criterions.avid import AVIDConfig, BankState
from avid_cma_tpu_torch.data.pipelines import PreprocessConfig
from avid_cma_tpu_torch.models import blocks
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.train.checkpoint import flax_to_port_state
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import (
    make_embed_fn,
    make_eval_loss_step,
    make_fused_eval_step,
)
from tests.test_torch_models import (  # noqa: F401  (autouse fixture)
    random_variables,
    torch_threads_per_worker,
)

TOL = 1e-4
B, N, K, D = 4, 64, 16, 128


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    video = rng.standard_normal((B, 4, 32, 32, 3)).astype(np.float32)
    audio = rng.standard_normal((B, 24, 33, 1)).astype(np.float32)
    y = rng.choice(N, B, replace=False)
    table = np.stack([rng.choice(np.setdiff1d(np.arange(N), [i]), K) for i in range(N)])
    banks = rng.standard_normal((2, N, D))
    banks = (banks / np.linalg.norm(banks, axis=2, keepdims=True)).astype(np.float32)
    jm = jax_av_wrapper(video_backbone="R2Plus1D", video_backbone_args={"depth": 10},
                        audio_backbone="Conv2D", audio_backbone_args={"depth": 10},
                        proj_dim=[512, 512, D])
    variables = random_variables(jm, 1, jnp.asarray(video), jnp.asarray(audio))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    ref_emb = jax_make_embed_fn(jm, mesh)(variables["params"], variables["batch_stats"],
                                          jnp.asarray(video), jnp.asarray(audio))
    return dict(video=video, audio=audio, y=y, table=table, banks=banks, jm=jm,
                variables=variables, mesh=mesh,
                ref_emb=tuple(np.asarray(e) for e in ref_emb))


def _port_state(s, z=-1.0):
    pm = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                    proj_dim=[512, 512, D], device="cpu")
    pm.load_state_dict(flax_to_port_state(s["variables"]), strict=True)
    opt = build_optimizer(pm.parameters(), "adam", 1e-4)
    return TrainState(
        model=pm, optimizer=opt, scheduler=multistep_scheduler(opt, [10], 1.0),
        bank=BankState(torch.from_numpy(s["banks"][0].copy()),
                       torch.from_numpy(s["banks"][1].copy()), torch.tensor(z)),
        generator=torch.Generator().manual_seed(0), step=3)


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()),
            [t.clone() for t in (state.bank.view1_mem, state.bank.view2_mem, state.bank.z)],
            state.step, state.generator.get_state(), state.model.training)


def _assert_unchanged(state, snap):
    sd, bank, step, gen, training = snap
    now = state.model.state_dict()
    assert now.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(now[k], v), k
    for t, ref in zip((state.bank.view1_mem, state.bank.view2_mem, state.bank.z), bank):
        assert torch.equal(t, ref)
    assert state.step == step and state.model.training == training
    assert torch.equal(state.generator.get_state(), gen)


def test_eval_loss_step_matches_jax(setup, monkeypatch):
    s = setup
    table = s["table"]
    monkeypatch.setattr(jax_avid, "draw_negatives_uniform",
                        lambda key, y, kk, nn: jnp.asarray(table, jnp.int32)[y])
    jcfg = jax_avid.AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K, momentum=0.5)
    bank = jax_avid.BankState(view1_mem=jnp.asarray(s["banks"][0]),
                              view2_mem=jnp.asarray(s["banks"][1]), z=jnp.float32(-1.0))
    jstate = JaxTrainState(step=jnp.int32(3), epoch=jnp.int32(0),
                           params=s["variables"]["params"],
                           batch_stats=s["variables"]["batch_stats"], opt_state=(),
                           bank=bank, rng=jax.random.key(0))
    jstate = jax.device_put(jstate, NamedSharding(s["mesh"], PartitionSpec()))
    jstep = jax_make_eval_loss_step(s["jm"], jcfg, s["mesh"])
    jm = jstep(jstate, {"frames": jnp.asarray(s["video"]), "audio": jnp.asarray(s["audio"]),
                        "index": jnp.asarray(s["y"], jnp.int32)}, 5)

    pstate = _port_state(s)
    pstate.model.train()
    snap = _snapshot(pstate)
    pstep = make_eval_loss_step(AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K,
                                           momentum=0.5), seed=0)
    batch = {"frames": torch.from_numpy(s["video"]), "audio": torch.from_numpy(s["audio"]),
             "index": torch.from_numpy(s["y"])}
    pm = pstep(pstate, batch, 5, neg_idx=torch.from_numpy(table[s["y"]]))
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL, atol=TOL, err_msg=k)
    _assert_unchanged(pstate, snap)
    # the JAX step returns metrics only: its state is left as it was
    assert float(jstate.bank.z) == -1.0

    # own negatives: the same batch_idx gives the same loss, the next one
    # other negatives; the state is still untouched
    own = [float(pstep(pstate, batch, i)["loss"]) for i in (0, 0, 1)]
    assert own[0] == own[1] and own[1] != own[2]
    _assert_unchanged(pstate, snap)


def test_embed_fn_matches_jax(setup):
    s = setup
    pstate = _port_state(s)
    v, a = make_embed_fn(pstate.model)(torch.from_numpy(s["video"]),
                                       torch.from_numpy(s["audio"]))
    np.testing.assert_allclose(v.numpy(), s["ref_emb"][0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a.numpy(), s["ref_emb"][1], rtol=TOL, atol=TOL)
    assert pstate.model.training


def test_eval_forward_goes_through_the_pair_route(setup, monkeypatch):
    """Depth 10: conv2x's block has two stride-1 pairs, conv3x..conv5x one
    each (their first pair is strided): five ``r2p1d_pair`` calls."""
    s = setup
    calls = []

    def spy(x, *rest):
        calls.append(tuple(x.shape))
        return real(x, *rest)

    real = blocks.r2p1d_pair
    monkeypatch.setattr(blocks, "r2p1d_pair", spy)
    model = _port_state(s).model.eval()
    with torch.inference_mode():
        v, a = model(torch.from_numpy(s["video"]), torch.from_numpy(s["audio"]))
    assert calls == [(B, 4, 8, 8, 64)] * 2 + [(B, 2, 4, 4, 128), (B, 1, 2, 2, 256),
                                               (B, 1, 1, 1, 512)]
    np.testing.assert_allclose(v.numpy(), s["ref_emb"][0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a.numpy(), s["ref_emb"][1], rtol=TOL, atol=TOL)


def test_fused_eval_step_runs_the_eval_preprocessing(setup):
    s = setup
    rng = np.random.default_rng(3)
    raw = {"frames": torch.from_numpy(rng.integers(0, 256, (B, 4, 30, 40, 3), dtype=np.uint8)),
           "audio": torch.from_numpy(rng.standard_normal((B, 4800)).astype(np.float32)),
           "index": torch.from_numpy(s["y"])}
    pstate = _port_state(s, z=0.5)
    snap = _snapshot(pstate)
    cfg = AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K, momentum=0.5)
    fused = make_fused_eval_step(cfg, PreprocessConfig(crop_size=32, audio_clip_duration=0.2),
                                 seed=0)
    losses = [float(fused(pstate, raw, i)["loss"]) for i in (2, 2)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    _assert_unchanged(pstate, snap)
