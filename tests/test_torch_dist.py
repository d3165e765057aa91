"""The port's distributed pretraining over two real gloo ranks on the CPU
(avid_cma_tpu_torch/parallel/, the train step, run_pretraining). Each
test spawns the two ranks of tests/torch_dist_worker.py (one torch thread
each, no JAX), which meet through a FileStore in the test's tmp_path; each
spawn is bounded by its own timeout and fails with the ranks' output.
The JAX references come from this process and reach the ranks as files.

- AVID: three steps (R2Plus1D-10 + Conv2D-10, 4 frames at 32^2, 4 clips a
  rank, N = 63, 16 negatives from one table indexed by each rank's y)
  against JAX's ``make_train_step`` on a 2-device CPU mesh: the first
  step's metrics, Z, banks and BN running stats within 1e-4, every
  step's loss within 1% (PARITY.md rows 4-5); the BN running stats and
  parameters the same on both ranks; the row-sharded run equal to the
  replicated run bit for bit (every metric, Z, the banks, the
  parameters). Four clips a rank, not two: BatchNorm over two clips
  leaves the deepest video layers so few values a channel that the JAX
  and the port forward differ by 2e-2 on one device already.
- AVID-CMA: the positive set mined by the query-sharded (replicated
  banks) and the row-sharded sweep equal to JAX's 2-device
  ``mine_positives``; two steps against JAX's as above; sharded equal to
  replicated bit for bit.
- ``run_pretraining`` with row-sharded banks (N = 17, a padded row): one
  epoch and a resume equal to two epochs straight, bit for bit; the
  checkpoint holds the full 17-row banks; a one-process run resumes from
  it; the host-scalar collectives.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import avid_cma_tpu.criterions.avid as jax_avid
import avid_cma_tpu.criterions.avid_cma as jax_cma
from avid_cma_tpu.criterions.mining import mine_positives as jax_mine
from avid_cma_tpu.models import av_wrapper as jax_av_wrapper
from avid_cma_tpu.train.optim import build_optimizer as jax_build_optimizer
from avid_cma_tpu.train.state import TrainState as JaxTrainState
from avid_cma_tpu.train.step import make_train_step as jax_make_train_step
from avid_cma_tpu_torch.config import from_dict
from avid_cma_tpu_torch.train.checkpoint import CheckpointManager, flax_to_port_state
from avid_cma_tpu_torch.train.loop import run_pretraining
from tests.test_torch_models import (  # noqa: F401  (autouse fixture)
    random_variables,
    torch_threads_per_worker,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD, B_RANK, N, K, D = 2, 4, 63, 16, 128
LR, WD = 2e-5, 1e-5  # as the worker's
SPAWN_TIMEOUT_S = 300


def spawn(case, tmp_path, timeout=SPAWN_TIMEOUT_S):
    """Run the worker's ``case`` on WORLD gloo ranks; return each rank's
    results. A rank that fails or outlives ``timeout`` fails the test with
    every rank's output; no rank outlives this call."""
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir(exist_ok=True)
    out_dir.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    logs = [tmp_path / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    try:
        for r in range(WORLD):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, WORKER, case, str(r), str(WORLD), str(tmp_path / "store"),
                     str(in_dir), str(out_dir)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        tails = "\n".join(f"--- rank {r}:\n{logs[r].read_text()[-4000:]}" for r in range(WORLD))
        pytest.fail(f"{case}: {'timed out after %d s' % timeout if hung else ''} "
                    f"ranks {failed} failed\n{tails}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _unit(rng, *shape):
    x = rng.standard_normal(shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(tmp_path, steps, **extra):
    """Batches, banks and the negative table, written for the ranks with
    the weights of ``random_variables``; returns them for the JAX side."""
    rng = np.random.default_rng(0)
    gb = WORLD * B_RANK
    data = dict(
        videos=rng.standard_normal((steps, gb, 4, 32, 32, 3)).astype(np.float32),
        audios=rng.standard_normal((steps, gb, 24, 33, 1)).astype(np.float32),
        ys=np.stack([rng.choice(N, gb, replace=False) for _ in range(steps)]),
        banks=np.stack([_unit(rng, N, D), _unit(rng, N, D)]),
        n=N, b=B_RANK, **extra)
    data["table"] = np.stack([rng.choice(np.setdiff1d(np.arange(N), [i]), K) for i in range(N)])
    jm = jax_av_wrapper(video_backbone="R2Plus1D", video_backbone_args={"depth": 10},
                        audio_backbone="Conv2D", audio_backbone_args={"depth": 10},
                        proj_dim=[512, 512, D])
    variables = random_variables(jm, 1, jnp.asarray(data["videos"][0]),
                                 jnp.asarray(data["audios"][0]))
    (tmp_path / "in").mkdir()
    np.savez(tmp_path / "in" / "data.npz", **data)
    torch.save(flax_to_port_state(variables), tmp_path / "in" / "weights.pt")
    return data, jm, variables


def _jax_run(data, jm, variables, cfg, bank):
    """JAX's make_train_step on a 2-device mesh: per-step metrics, Z, the
    banks after the first step, the final BN stats (port keys)."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    tx = jax_build_optimizer("adam", LR, weight_decay=WD)
    state = JaxTrainState(step=jnp.int32(0), epoch=jnp.int32(0), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), bank=bank,
                          rng=jax.random.key(0))
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    step = jax_make_train_step(jm, cfg, tx, mesh, donate=False)
    out = {"metrics": [], "z": []}
    for s in range(data["videos"].shape[0]):
        state, m = step(state, {"frames": jnp.asarray(data["videos"][s]),
                                "audio": jnp.asarray(data["audios"][s]),
                                "index": jnp.asarray(data["ys"][s], jnp.int32)})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["z"].append(float(state.bank.z))
        if s == 0:
            out["banks_step1"] = (np.asarray(state.bank.view1_mem),
                                  np.asarray(state.bank.view2_mem))
            sd = flax_to_port_state({"params": state.params, "batch_stats": state.batch_stats})
            out["bn_step1"] = {k: v for k, v in sd.items()
                               if k.endswith(("running_mean", "running_var"))}
    return out


def _check_against_jax(ranks, want, model_keys):
    for rank in ranks:
        for layout in ("replicated", "sharded"):
            got = rank[layout]
            losses = np.array([m["loss"] for m in got["metrics"]])
            j_losses = np.array([m["loss"] for m in want["metrics"]])
            assert set(got["metrics"][0]) == set(want["metrics"][0])
            for key, val in want["metrics"][0].items():  # the first step: 1e-4
                np.testing.assert_allclose(got["metrics"][0][key], val, rtol=1e-4, atol=1e-4,
                                           err_msg=key)
            np.testing.assert_allclose(float(got["z"][0]), want["z"][0], rtol=1e-4)
            for mine, theirs in zip(got["banks_step1"], want["banks_step1"]):
                np.testing.assert_allclose(mine.numpy(), theirs, atol=1e-4)
            assert (np.abs(losses - j_losses) / np.abs(j_losses)).max() < 1e-2
            # BN running stats after the first step: within 1e-4 of JAX's
            # pmean'd stats
            bn = got["bn_step1"]
            assert set(bn) == set(want["bn_step1"]) and len(bn) == len(got["bn"])
            for k, v in bn.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(want["bn_step1"][k]),
                                           atol=1e-4, err_msg=k)
    # the ranks hold the same BN stats and parameters
    for a, b in zip(ranks[0]["sharded"]["bn"], ranks[1]["sharded"]["bn"]):
        assert torch.equal(a, b)
    for k in model_keys:
        assert torch.equal(ranks[0]["sharded"]["model"][k], ranks[1]["sharded"]["model"][k]), k
    # the row-sharded run is the replicated run, bit for bit
    for rank in ranks:
        rep, sh = rank["replicated"], rank["sharded"]
        assert rep["metrics"] == sh["metrics"]
        assert all(torch.equal(a, b) for a, b in zip(rep["z"], sh["z"]))
        assert all(torch.equal(a, b) for a, b in zip(rep["banks"], sh["banks"]))
        assert all(torch.equal(rep["model"][k], sh["model"][k]) for k in model_keys)


def test_avid_steps_over_two_ranks_match_jax_and_sharded_equals_replicated(
        tmp_path, monkeypatch):
    data, jm, variables = _inputs(tmp_path, steps=3)
    ranks = spawn("avid", tmp_path)
    table = jnp.asarray(data["table"], jnp.int32)
    monkeypatch.setattr(jax_avid, "draw_negatives_uniform", lambda key, y, kk, nn: table[y])
    cfg = jax_avid.AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K, momentum=0.5)
    bank = jax_avid.BankState(view1_mem=jnp.asarray(data["banks"][0]),
                              view2_mem=jnp.asarray(data["banks"][1]), z=jnp.float32(-1.0))
    want = _jax_run(data, jm, variables, cfg, bank)
    _check_against_jax(ranks, want, list(ranks[0]["replicated"]["model"]))
    assert math.isfinite(want["metrics"][-1]["loss"])


def test_cma_steps_with_sharded_mining_over_two_ranks(tmp_path, monkeypatch):
    pos_k, within = 4, 8
    data, jm, variables = _inputs(tmp_path, steps=2, pos_k=pos_k, within=within)
    ranks = spawn("cma", tmp_path)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jpos = jax_mine(jnp.asarray(data["banks"][0]), jnp.asarray(data["banks"][1]), pos_k,
                    mesh=mesh)
    for rank in ranks:
        for layout in ("replicated", "sharded"):
            pos = rank[layout]["positive_set"]
            assert pos.shape == (N, pos_k) and int(pos.max()) < N
            assert np.array_equal(pos.numpy(), np.asarray(jpos)), layout
    table = jnp.asarray(data["table"], jnp.int32)
    monkeypatch.setattr(jax_cma, "draw_negatives_avoid_sorted",
                        lambda key, pos, kk, nn: table[pos.sum(1) % N])
    cfg = jax_cma.AVIDCMAConfig(num_data=N, embedding_dim=D, num_negatives=K,
                                num_negatives_within=within, momentum=0.5, pos_k=pos_k)
    bank = jax_cma.cma_state_from_bank(
        jax_avid.BankState(view1_mem=jnp.asarray(data["banks"][0]),
                           view2_mem=jnp.asarray(data["banks"][1]), z=jnp.float32(-1.0)), jpos)
    want = _jax_run(data, jm, variables, cfg, bank)
    _check_against_jax(ranks, want, list(ranks[0]["replicated"]["model"]))


def _loop_cfg(model_dir):
    return {
        "seed": 0, "num_workers": 1, "print_freq": 1, "log2tb": False, "resume": False,
        "no_test": True, "steps_per_epoch": 2,
        "dataset": {
            "name": "kinetics", "backend": "synthetic", "synthetic_size": 17,
            "batch_size": 4, "video_clip_duration": 0.5, "video_fps": 8.0,
            "decode_size": [40, 48], "crop_size": 32, "audio_clip_duration": 0.5,
            "audio_fps": 24000, "spectrogram_fps": 100.0, "n_fft": 512,
            "train": {"split": "train", "use_augmentation": True, "drop_last": True},
        },
        "optimizer": {"name": "adam", "weight_decay": 1e-5, "num_epochs": 2,
                      "lr": {"name": "multistep", "base_lr": 2e-4, "gamma": 0.5,
                             "milestones": [1]}},
        "model": {"name": "loop", "model_dir": str(model_dir), "arch": "av_wrapper",
                  "args": {"proj_dim": [64, 32], "video_backbone": "R2Plus1D",
                           "video_backbone_args": {"depth": 10},
                           "audio_backbone": "Conv2D", "audio_backbone_args": {"depth": 10}}},
        "loss": {"name": "AVID", "bank_sharding": "sharded",
                 "args": {"num_data": 17, "num_negatives": 8, "momentum": 0.5,
                          "xModal_coeff": 1.0, "wModal_coeff": 0.0}},
    }


def test_run_pretraining_over_two_ranks_resumes_at_any_world(tmp_path):
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "config.json").write_text(json.dumps(_loop_cfg(tmp_path)))
    ranks = spawn("loop", tmp_path)
    for rank in ranks:
        straight, resumed = rank["straight"], rank["resumed"]
        assert (straight["step"], straight["epoch"]) == (4, 2) == (resumed["step"],
                                                                  resumed["epoch"])
        assert [(r["epoch"], r["start_step"], r["steps"], r["clips"])
                for r in straight["records"]] == [(0, 0, 2, 4), (1, 2, 2, 4)]
        assert straight["shard_rows"] == 10  # ceil(17 / 2) + the sentinel row
        for k, v in straight["model"].items():
            assert torch.equal(v, resumed["model"][k]), k
        for i, st in straight["optimizer"].items():
            assert all(torch.equal(st[k], resumed["optimizer"][i][k]) for k in st)
        assert all(torch.equal(a, b) for a, b in zip(straight["banks"], resumed["banks"]))
        assert float(straight["banks"][2]) > 0
        assert rank["sync"]["mean"] == 2.0 and rank["sync"]["sum"] == 4.0
        assert rank["sync"]["any"] and not rank["sync"]["none"]
        assert rank["sync"]["counts"].tolist() == [2, 1]
    for k, v in ranks[0]["straight"]["model"].items():
        assert torch.equal(v, ranks[1]["straight"]["model"][k]), k

    # the checkpoint holds the full banks, and resumes in one process
    run = tmp_path / "out" / "straight" / "loop" / "checkpoints"
    saved = torch.load(CheckpointManager(str(run)).path(2), map_location="cpu",
                       weights_only=False)
    assert saved["bank"]["view1_mem"].shape == (17, 32)
    one = tmp_path / "one" / "loop" / "checkpoints"
    one.mkdir(parents=True)
    shutil.copy(CheckpointManager(str(run)).path(2), one)
    for sharding in ("sharded", "replicated"):
        cfg = from_dict(_loop_cfg(tmp_path / "one"))
        cfg["resume"] = True
        cfg.loss["bank_sharding"] = sharding
        records = []
        state = run_pretraining(cfg, device="cpu", on_epoch=records.append)
        assert [(r["epoch"], r["start_step"], r["steps"]) for r in records] == [(1, 2, 2)]
        assert state.step == 4 and state.bank.view1_mem.shape[0] == (18 if sharding ==
                                                                      "sharded" else 17)
        assert torch.equal(state.bank.z, saved["bank"]["z"])
        shutil.rmtree(tmp_path / "one" / "loop" / "checkpoints")
        one.mkdir(parents=True)
        shutil.copy(CheckpointManager(str(run)).path(2), one)
