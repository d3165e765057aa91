"""The whole slice on the CPU: the port's train step against the JAX
package's ``make_train_step`` on a one-device mesh, over a six-step AVID
trajectory (R2Plus1D-10 + Conv2D-10, B=4, 4 x 32^2, N=64, K=16) from the
same weights, banks, batches and negatives. Tolerances: the first step's
loss, Z and banks within 1e-4; every step's loss within 1% (the parity
gate the JAX package met against the reference).

Negatives come from a fixed per-instance table indexed by the batch's
``y`` on both sides: inside the jitted JAX step the patched sampler sees
a traced ``y`` and a constant table, so the draws differ per step without
retracing.

Learning rate 2e-5: Adam moves every parameter by about lr per step, also
those whose gradient is only rounding noise, so f32 reassociation
differences between the two stacks grow with lr. Measured at this size:
up to 1.1% apart by step 5 at lr 1e-4, within 0.2% at 2e-5.

Also: the fused step (preprocessing + step) runs and is reproducible; the
Cross-N1024 dataclass matches the YAML recipe; entry points and the
measurement scripts raise without a card; and no module of the port, nor chip_smoke.py, imports JAX, flax,
optax or the JAX package.
"""

import ast
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import avid_cma_tpu.criterions.avid as jax_avid
from avid_cma_tpu.models import av_wrapper as jax_av_wrapper
from avid_cma_tpu.train.optim import build_optimizer as jax_build_optimizer
from avid_cma_tpu.train.state import TrainState as JaxTrainState
from avid_cma_tpu.train.step import make_train_step as jax_make_train_step
from avid_cma_tpu_torch.criterions.avid import AVIDConfig, BankState
from avid_cma_tpu_torch.device import resolve_device
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.scripts import criterion_cost, r2p1d_block_bench, train_clips
from avid_cma_tpu_torch.train.builders import build_eval, build_pretrain, kinetics_cross_n1024
from avid_cma_tpu_torch.train.checkpoint import flax_to_port_state
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import make_train_step
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS, B, N, K, D = 6, 4, 64, 16, 128
LR, WD = 2e-5, 1e-5


def _random_variables(model, seed, *inputs):
    shapes = jax.eval_shape(
        lambda *x: model.init(jax.random.key(0), *x, train=False), *inputs)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(math.prod(s.shape[:-1])), s.shape)
        elif name in ("scale", "var"):
            v = 1.0 + 0.2 * rng.uniform(size=s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _data():
    rng = np.random.default_rng(0)
    videos = rng.standard_normal((STEPS, B, 4, 32, 32, 3)).astype(np.float32)
    audios = rng.standard_normal((STEPS, B, 24, 33, 1)).astype(np.float32)
    ys = np.stack([rng.choice(N, B, replace=False) for _ in range(STEPS)])
    table = np.stack([rng.choice(np.setdiff1d(np.arange(N), [i]), K) for i in range(N)])
    banks = rng.standard_normal((2, N, D))
    banks = (banks / np.linalg.norm(banks, axis=2, keepdims=True)).astype(np.float32)
    return videos, audios, ys, table, banks


def test_six_step_trajectory_matches_jax(monkeypatch):
    videos, audios, ys, table, banks = _data()
    jm = jax_av_wrapper(video_backbone="R2Plus1D", video_backbone_args={"depth": 10},
                        audio_backbone="Conv2D", audio_backbone_args={"depth": 10},
                        proj_dim=[512, 512, D])
    variables = _random_variables(jm, 1, jnp.asarray(videos[0]), jnp.asarray(audios[0]))

    # ---- JAX: make_train_step on a one-device mesh ----
    monkeypatch.setattr(jax_avid, "draw_negatives_uniform",
                        lambda key, y, kk, nn: jnp.asarray(table, jnp.int32)[y])
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    tx = jax_build_optimizer("adam", LR, weight_decay=WD)
    jcfg = jax_avid.AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K, momentum=0.5)
    jstate = JaxTrainState(
        step=jnp.int32(0), epoch=jnp.int32(0), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        bank=jax_avid.BankState(view1_mem=jnp.asarray(banks[0]),
                                view2_mem=jnp.asarray(banks[1]), z=jnp.float32(-1.0)),
        rng=jax.random.key(0))
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    jstep = jax_make_train_step(jm, jcfg, tx, mesh, donate=False)

    # ---- port: make_train_step on the CPU ----
    pm = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                    proj_dim=[512, 512, D], device="cpu")
    pm.load_state_dict(flax_to_port_state(variables), strict=True)
    opt = build_optimizer(pm.parameters(), "adam", LR, weight_decay=WD)
    pstate = TrainState(
        model=pm, optimizer=opt, scheduler=multistep_scheduler(opt, [10], 1.0),
        bank=BankState(torch.from_numpy(banks[0].copy()), torch.from_numpy(banks[1].copy()),
                       torch.tensor(-1.0)),
        generator=torch.Generator().manual_seed(0))
    pstep = make_train_step(AVIDConfig(num_data=N, embedding_dim=D, num_negatives=K,
                                       momentum=0.5))

    j_losses, p_losses = [], []
    for s in range(STEPS):
        y = ys[s]
        jstate, jm_metrics = jstep(jstate, {"frames": jnp.asarray(videos[s]),
                                            "audio": jnp.asarray(audios[s]),
                                            "index": jnp.asarray(y, jnp.int32)})
        pm_metrics = pstep(pstate, {"frames": torch.from_numpy(videos[s]),
                                    "audio": torch.from_numpy(audios[s]),
                                    "index": torch.from_numpy(y)},
                           neg_idx=torch.from_numpy(table[y]))
        j_losses.append(float(jm_metrics["loss"]))
        p_losses.append(float(pm_metrics["loss"]))
        if s == 0:
            np.testing.assert_allclose(p_losses[0], j_losses[0], rtol=1e-4)
            np.testing.assert_allclose(float(pstate.bank.z), float(jstate.bank.z), rtol=1e-4)
            np.testing.assert_allclose(pstate.bank.view1_mem.numpy(),
                                       np.asarray(jstate.bank.view1_mem), atol=1e-4)
            np.testing.assert_allclose(pstate.bank.view2_mem.numpy(),
                                       np.asarray(jstate.bank.view2_mem), atol=1e-4)
    rel = np.abs(np.array(p_losses) - np.array(j_losses)) / np.abs(np.array(j_losses))
    assert rel.max() < 1e-2, (p_losses, j_losses)
    assert float(pstate.bank.z) == pytest.approx(float(jstate.bank.z), rel=1e-4)
    assert pstate.step == STEPS


def _small_cfg():
    return dataclasses.replace(kinetics_cross_n1024(), video_depth=10, num_data=N,
                               num_negatives=K, crop_size=32)


def test_fused_step_runs_and_is_reproducible():
    rng = np.random.default_rng(3)
    raw = {"frames": torch.from_numpy(rng.integers(0, 256, (B, 4, 40, 48, 3), dtype=np.uint8)),
           "audio": torch.from_numpy(rng.standard_normal((B, 4800)).astype(np.float32)),
           "index": torch.tensor([1, 7, 7, 30])}
    runs = []
    for _ in range(2):
        state, fused = build_pretrain(_small_cfg(), device="cpu")
        losses, zs = [], []
        for i in range(2):
            m = fused(state, raw, i)
            losses.append(float(m["loss"]))
            zs.append(float(state.bank.z))
        runs.append(losses)
        assert all(math.isfinite(v) for v in losses)
        assert zs[0] > 0 and zs[1] == zs[0]  # Z frozen after the first step
        rows = state.bank.view1_mem[raw["index"]]
        np.testing.assert_allclose(torch.linalg.vector_norm(rows, dim=1).numpy(), 1.0,
                                   atol=1e-6)
    assert runs[0] == runs[1]


def test_kinetics_dataclass_matches_yaml():
    with open(REPO / "configs/main/avid/kinetics/Cross-N1024.yaml") as f:
        y = yaml.safe_load(f)
    c = kinetics_cross_n1024()
    ds, opt, lr, model, loss = (y["dataset"], y["optimizer"], y["optimizer"]["lr"],
                                y["model"], y["loss"]["args"])
    assert c.seed == y["seed"]
    assert c.global_batch_size == ds["batch_size"] and c.batch_size == 32
    assert (c.video_clip_duration, c.video_fps, c.crop_size) == (
        ds["video_clip_duration"], ds["video_fps"], ds["crop_size"])
    assert c.num_frames == 8
    assert (c.audio_clip_duration, c.audio_fps, c.spectrogram_fps, c.n_fft) == (
        ds["audio_clip_duration"], ds["audio_fps"], ds["spectrogram_fps"], ds["n_fft"])
    assert c.transform == ds["transforms"]
    assert (c.optimizer, c.weight_decay) == (opt["name"], opt["weight_decay"])
    assert (c.base_lr, c.gamma, list(c.milestones)) == (
        lr["base_lr"], lr["gamma"], lr["milestones"])
    args = model["args"]
    assert list(c.proj_dim) == args["proj_dim"]
    assert (c.video_backbone, c.video_depth) == (
        args["video_backbone"], args["video_backbone_args"]["depth"])
    assert (c.audio_backbone, c.audio_depth) == (
        args["audio_backbone"], args["audio_backbone_args"]["depth"])
    assert y["loss"]["name"] == "AVID"
    assert (c.num_data, c.num_negatives, c.momentum, c.xModal_coeff, c.wModal_coeff) == (
        loss["num_data"], loss["num_negatives"], loss["momentum"], loss["xModal_coeff"],
        loss["wModal_coeff"])


def test_entry_points_raise_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CUDA entry points would run")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10})
    with pytest.raises(RuntimeError, match="cuda"):
        build_pretrain(_small_cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        build_eval(_small_cfg())
    monkeypatch.setattr("sys.argv", ["script"])
    for script in (r2p1d_block_bench, train_clips, criterion_cost):
        with pytest.raises(RuntimeError, match="cuda"):
            script.main()


# the card host has none of these: the port, its entry script and
# chip_smoke.py import none of them
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "avid_cma_tpu", "yaml", "orbax", "tensorflow")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "avid_cma_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "main_avid_torch.py"]
    assert len(files) > 20
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{os.path.relpath(path, REPO)} imports {name}"
    # optional packages are imported by the code that needs them, never
    # when the port is imported (a fresh interpreter: this one may hold them)
    probe = ("import sys, avid_cma_tpu_torch, avid_cma_tpu_torch.data, "
             "avid_cma_tpu_torch.train.loop, avid_cma_tpu_torch.cli; "
             "print(sorted(m for m in ('cv2', 'av', 'tensorboard', 'tensorflow', 'yaml', "
             "'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]", f"importing the port loaded {out}"
