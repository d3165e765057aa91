"""The port's action-recognition evals (avid_cma_tpu_torch/train/
eval_loop.py, the eval CLIs) on the CPU.

Against the JAX package (avid_cma_tpu/train/eval_loop.py), at
R2Plus1D-10, 4 frames x 32^2, 8 clips, 7 classes, the same weights
carried over by ``flax_eval_to_port_state``:
- the finetune trajectory: 2 classifier-only warmup steps, then 4 full
  steps with a fresh optimizer, given the same preprocessed frames and no
  dropout, against ``make_supervised_train_step`` on a one-device mesh:
  losses within 1% a step, the backbone's parameters through the warmup
  exactly as they were (on both sides), its BN running stats after it
  within 1e-4 of the JAX ones;
- the probe trajectory over four taps: 6 steps, each tap's loss within 1%,
  the extractor's parameters and stats exactly as they were;
- ``_topk_counts``, the clip and the dense aggregation: the JAX functions'
  counts exactly, on fixed logits from a stub logits function, with a
  ragged last batch and a ragged last flush.

Port only (as tests/test_eval_loops.py for the JAX loops): best.json and
the best checkpoint, ``test_only`` repeating the results and raising
without a checkpoint, runs resumed from the warmup checkpoint and from a
finetune epoch equal to the straight run bit for bit, the multi-tap probe
metrics, the Kinetics crop+color route, the backbone from a port run's
directory and from its ``.pth.tar`` export, both CLIs in a subprocess, and
the gaps that raise (``--multihost``, no card).
"""

import itertools
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from avid_cma_tpu.config import from_dict as jax_from_dict
from avid_cma_tpu.models import eval_wrappers as jax_ew
from avid_cma_tpu.models.video import R2Plus1D as JaxR2Plus1D
from avid_cma_tpu.train import builders as jax_builders
from avid_cma_tpu.train import eval_loop as jax_loop
from avid_cma_tpu.train.optim import build_from_config as jax_build_from_config
from avid_cma_tpu.train.state import TrainState as JaxTrainState
from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.cli import finetune_main
from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.models.eval_wrappers import (
    ClassificationWrapper,
    MOSTModel,
    classifier_parameters,
)
from avid_cma_tpu_torch.models.video import R2Plus1D
from avid_cma_tpu_torch.ops import video_aug
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train import eval_loop
from avid_cma_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_pth_tar,
    flax_eval_to_port_state,
)
from avid_cma_tpu_torch.train.optim import build_from_config, build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from tests.test_torch_models import (  # noqa: F401  (autouse fixture)
    random_variables,
    torch_threads_per_worker,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, CLIP, NCLS = 8, (4, 32, 32), 7
OPT = {"name": "adam", "weight_decay": 1e-3,
       "lr": {"name": "multistep", "base_lr": 1e-4, "gamma": 0.3, "milestones": [6]}}
TAPS = ["conv2x", "conv3x", "conv4x", "conv5x"]
TAP_POOLS = ["AdaptiveMaxPool3d((1, 3, 3))", "AdaptiveMaxPool3d((1, 3, 3))",
             "AdaptiveMaxPool3d((1, 2, 2))", None]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, *CLIP, 3)).astype(np.float32),
             rng.integers(0, NCLS, B).astype(np.int32)) for _ in range(n)]


def _jax_state(params, batch_stats, opt):
    return JaxTrainState(step=jnp.int32(0), epoch=jnp.int32(0), params=params,
                         batch_stats=batch_stats, opt_state=opt.init(params), bank=None,
                         rng=jax.random.key(0))


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _copy(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _port_state(model, params):
    optimizer, scheduler = build_from_config(OPT, params)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, bank=None,
                      generator=torch.Generator())


def test_finetune_trajectory_matches_jax():
    data = _batches(6)
    jm = jax_ew.ClassificationWrapper(feature_extractor=JaxR2Plus1D(depth=10), n_classes=NCLS)
    variables = random_variables(jm, 11, jnp.asarray(data[0][0]))
    pm = ClassificationWrapper(R2Plus1D(10), NCLS, CLIP)
    init = flax_eval_to_port_state(variables)  # before the JAX steps donate the arrays
    pm.load_state_dict(init, strict=True)
    backbone0 = {k: v.clone() for k, v in pm.feature_extractor.named_parameters()}
    jbackbone0 = _copy(variables["params"]["feature_extractor"])

    # JAX: the classifier-only optimizer, then a fresh full one
    mesh, full_opt = _mesh(), jax_build_from_config(OPT, steps_per_epoch=100)
    warm_opt = jax_loop.classifier_only_optimizer(full_opt, variables["params"])
    jstate = _jax_state(variables["params"], variables["batch_stats"], warm_opt)
    jlosses = []
    warm_step = jax_loop.make_supervised_train_step(jm, warm_opt, mesh)
    for frames, labels in data[:2]:
        jstate, m, _ = warm_step(jstate, jnp.asarray(frames), jnp.asarray(labels))
        jlosses.append(float(m["loss"]))
    jax.tree.map(np.testing.assert_array_equal,
                 _copy(jstate.params["feature_extractor"]), jbackbone0)
    jstats_warm = flax_eval_to_port_state({"params": _copy(jstate.params),
                                           "batch_stats": _copy(jstate.batch_stats)})
    jstate = jstate.replace(opt_state=full_opt.init(jstate.params))
    full_step = jax_loop.make_supervised_train_step(jm, full_opt, mesh)
    for frames, labels in data[2:]:
        jstate, m, _ = full_step(jstate, jnp.asarray(frames), jnp.asarray(labels))
        jlosses.append(float(m["loss"]))

    # the port: the warmup under `frozen`, then a fresh optimizer
    step = eval_loop.make_supervised_train_step()
    state = _port_state(pm, classifier_parameters(pm))
    losses = []
    with eval_loop.frozen(pm.feature_extractor):
        for frames, labels in data[:2]:
            m, _ = step(state, torch.from_numpy(frames), torch.from_numpy(labels))
            losses.append(float(m["loss"]))
    assert all(p.requires_grad for p in pm.parameters())
    for k, p in pm.feature_extractor.named_parameters():
        assert torch.equal(p.detach(), backbone0[k]), k
    sd = pm.state_dict()
    moved = 0
    for k in (k for k in sd if "running_" in k):
        np.testing.assert_allclose(sd[k].numpy(), jstats_warm[k].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
        moved += not np.allclose(sd[k].numpy(), init[k].numpy())
    assert moved > 0, "the warmup's train-mode forward moved no running stat"
    state.optimizer, state.scheduler = build_from_config(OPT, pm.parameters())
    for frames, labels in data[2:]:
        m, _ = step(state, torch.from_numpy(frames), torch.from_numpy(labels))
        losses.append(float(m["loss"]))
    assert state.step == 6
    np.testing.assert_allclose(losses, jlosses, rtol=1e-2)
    assert not np.allclose(losses[2:], losses[2]), "the full steps trained nothing"


def test_probe_trajectory_matches_jax():
    data = _batches(6, seed=1)
    jm = jax_ew.MOSTModel(feature_extractor=JaxR2Plus1D(depth=10), n_classes=NCLS,
                          feat_names=TAPS, pooling_ops=TAP_POOLS, use_bn=True)
    variables = random_variables(jm, 12, jnp.asarray(data[0][0]))
    pm = MOSTModel(R2Plus1D(10), NCLS, TAPS, TAP_POOLS, CLIP, use_bn=True)
    pm.load_state_dict(flax_eval_to_port_state(variables), strict=True)
    extractor0 = {k: v.clone() for k, v in pm.feature_extractor.state_dict().items()}
    jextractor0 = (_copy(variables["params"]["feature_extractor"]),
                   _copy(variables["batch_stats"]["feature_extractor"]))

    opt = jax_loop.classifier_only_optimizer(jax_build_from_config(OPT, 100),
                                             variables["params"])
    jstate = _jax_state(variables["params"], variables["batch_stats"], opt)
    jstep = jax_loop.make_supervised_train_step(jm, opt, _mesh(), multi_output=True)
    step = eval_loop.make_supervised_train_step(multi_output=True)
    state = _port_state(pm, classifier_parameters(pm))
    for frames, labels in data:
        jstate, jm_, _ = jstep(jstate, jnp.asarray(frames), jnp.asarray(labels))
        m, logits = step(state, torch.from_numpy(frames), torch.from_numpy(labels))
        assert list(logits) == TAPS
        for ft in TAPS + ["loss"]:
            np.testing.assert_allclose(float(m[ft]), float(jm_[ft]), rtol=1e-2, err_msg=ft)
    for k, v in pm.feature_extractor.state_dict().items():
        assert torch.equal(v, extractor0[k]), k
    jax.tree.map(np.testing.assert_array_equal,
                 (_copy(jstate.params["feature_extractor"]),
                  _copy(jstate.batch_stats["feature_extractor"])), jextractor0)


def test_topk_counts_equal_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((64, 20)).astype(np.float32)
    labels = rng.integers(0, 20, 64)
    np.testing.assert_array_equal(eval_loop._topk_counts(logits, labels),
                                  jax_loop._topk_counts(logits, labels))
    np.testing.assert_array_equal(eval_loop._topk_counts(logits, labels, maxk=3),
                                  jax_loop._topk_counts(logits, labels, maxk=3))


def _data_cfg(**over):
    train = {"split": "trainlist{fold:02d}", "mode": "clip", "clips_per_video": 1,
             "use_augmentation": True, "use_shuffle": True, "drop_last": True}
    test = {"split": "testlist{fold:02d}", "mode": "clip", "clips_per_video": 1,
            "use_augmentation": False, "use_shuffle": False, "drop_last": False}
    return {"name": "ucf101", "backend": "synthetic", "synthetic_size": 8, "fold": 1,
            "batch_size": 4, "clip_duration": 0.5, "video_fps": 8.0, "crop_size": 32,
            "decode_size": [40, 48], "train": train, "test": test,
            "test_dense": {**test, "mode": "video", "clips_per_video": 2}, **over}


class _Stub:
    """Logits functions that ignore their frames: call i gives table i,
    cut to the batch's rows (a dict of one table per tap for a multi-tap
    stub); one function for the JAX loop, one for the port's."""

    def __init__(self, rows, taps, calls=16, ncls=11):
        rng = np.random.default_rng(3)
        self.tables = [{t: rng.standard_normal((rows, ncls)).astype(np.float32) for t in taps}
                       for _ in range(calls)]
        self.taps = taps

    def _pick(self, i, n, wrap):
        out = {t: wrap(v[:n]) for t, v in self.tables[i].items()}
        return out[None] if self.taps == [None] else out

    def jax_fn(self):
        calls = itertools.count()
        return lambda params, stats, frames: self._pick(next(calls), frames.shape[0],
                                                        jnp.asarray)

    def port_fn(self):
        calls = itertools.count()
        return lambda frames: self._pick(next(calls), frames.shape[0], torch.from_numpy)


def _aggregation_data(**over):
    """10 test clips in batches of 4 (the last ragged); 10 dense videos of
    3 clips each."""
    data = _data_cfg(synthetic_size=10, test_dense={
        "split": "testlist{fold:02d}", "mode": "video", "clips_per_video": 3,
        "use_augmentation": False, "use_shuffle": False, "drop_last": False}, **over)
    return jax_from_dict(data), config_lib.from_dict(data)


KW = dict(return_audio=False, return_labels=True, fold=1)
JSTATE = types.SimpleNamespace(params=None, batch_stats=None)


def test_clip_aggregation_equals_jax():
    jdb, pdb = _aggregation_data()
    stub = _Stub(4, [None])
    want = jax_loop._clip_eval(
        JSTATE, stub.jax_fn(), jax_builders.build_dataloader(
            jax_builders.build_dataset(jdb, jdb.test, **KW), jdb, jdb.test, 1),
        jax_builders.build_preprocess_config(jdb), None)
    got = eval_loop._clip_eval(
        stub.port_fn(), builders.build_dataloader(builders.build_dataset(pdb, pdb.test, **KW),
                                                  pdb, pdb.test, 1),
        builders.build_preprocess_config(pdb), torch.device("cpu"))
    assert got == tuple(want)


def test_clip_aggregation_counts_each_tap_as_jax():
    """The multi-tap clip metrics: each tap's counts equal the JAX counts
    of that tap's logits alone (the JAX probe's per-tap sums)."""
    _, pdb = _aggregation_data()
    loader = builders.build_dataloader(builders.build_dataset(pdb, pdb.test, **KW), pdb,
                                       pdb.test, 1)
    stub = _Stub(4, ["a", "b"])
    got = eval_loop._clip_eval(stub.port_fn(), loader, builders.build_preprocess_config(pdb),
                               torch.device("cpu"))
    labels = np.concatenate([b["label"] for b in loader])
    assert labels.shape == (10,)
    for tap in ("a", "b"):
        logits = np.concatenate([t[tap] for t in stub.tables[:3]])[:10]
        counts = jax_loop._topk_counts(logits, labels)
        assert got[tap] == (100.0 * counts[0] / 10, 100.0 * counts[1] / 10)


@pytest.mark.parametrize("taps", [[None], ["a", "b"]])
def test_dense_aggregation_equals_jax(taps):
    """5 videos of 3 clips in flushes of 4 rows: the last flush ragged
    (3 rows), padded by repeating its last row."""
    jdb, pdb = _aggregation_data()
    stub = _Stub(4, taps)
    pdense = builders.build_dataset(pdb, pdb.test_dense, mode="video", **KW)
    want = jax_loop._dense_eval(
        JSTATE, stub.jax_fn(), jax_builders.build_dataset(jdb, jdb.test_dense, mode="video", **KW),
        jax_builders.build_preprocess_config(jdb), batch_clips=4, max_videos=5)
    got = eval_loop._dense_eval(stub.port_fn(), pdense, builders.build_preprocess_config(pdb),
                                4, torch.device("cpu"), max_videos=5)
    if taps == [None]:
        assert got == tuple(want)
    else:
        assert {t: tuple(v) for t, v in got.items()} == {t: tuple(v) for t, v in want.items()}


# ---------------------------------------------------------------------------
# the loops, port only
# ---------------------------------------------------------------------------

def _model_cfg(model_dir, name="smoke"):
    return config_lib.from_dict({
        "name": name, "model_dir": str(model_dir), "arch": "av_wrapper",
        "args": {"proj_dim": [64, 32], "video_backbone": "R2Plus1D",
                 "video_backbone_args": {"depth": 10}, "audio_backbone": "Conv2D",
                 "audio_backbone_args": {"depth": 10}}})


def _finetune_cfg(**over):
    return config_lib.from_dict({
        "seed": 0, "num_workers": 1, "test_only": False, "resume": False, "quiet": True,
        "benchmark": {"name": "ucf-smoke"}, "dataset": _data_cfg(),
        "optimizer": {"name": "adam", "num_epochs": 2, "weight_decay": 0.0,
                      "warmup_classifier": True, "warmup_epochs": 1,
                      "lr": {"name": "multistep", "base_lr": 1e-3, "gamma": 0.5,
                             "milestones": [1]}},
        "model": {"name": "ClassificationWrapper",
                  "args": {"n_classes": 11, "feat_name": "pool", "pooling_op": None,
                           "use_dropout": True, "dropout": 0.5}}, **over})


def _probe_cfg(**over):
    return config_lib.from_dict({
        "seed": 0, "num_workers": 1, "test_only": False, "resume": False, "quiet": True,
        "benchmark": {"name": "probe-smoke"}, "dataset": _data_cfg(),
        "optimizer": {"name": "adam", "num_epochs": 1, "weight_decay": 0.0,
                      "lr": {"name": "multistep", "base_lr": 1e-3, "gamma": 1.0,
                             "milestones": [1]}},
        "model": {"name": "MOST", "args": {"n_classes": 11, "feat_names": ["conv5x", "pool"],
                                           "pooling_ops": ["AdaptiveMaxPool3d((1, 1, 1))",
                                                           None],
                                           "l2_norm": False, "use_bn": True}}, **over})


def _eval_dir(root, bench="ucf-smoke"):
    return os.path.join(str(root), "smoke", f"eval-{bench}", "fold-01")


def _latest(directory):
    mgr = CheckpointManager(directory)
    return torch.load(mgr.path(mgr.latest_step()), map_location="cpu", weights_only=False)


def test_finetune_best_checkpoint_and_test_only(tmp_path):
    mcfg = _model_cfg(tmp_path)
    results = eval_loop.run_action_recognition(_finetune_cfg(), mcfg, fold=1, debug=True,
                                               device="cpu")
    assert set(results) == {"clip@1", "clip@5", "video@1", "video@5"}
    assert all(np.isfinite(v) for v in results.values())
    eval_dir = _eval_dir(tmp_path)
    with open(os.path.join(eval_dir, "best.json")) as f:
        best = json.load(f)
    last = CheckpointManager(os.path.join(eval_dir, "checkpoints")).latest_step()
    assert best["step"] == last == 4 and best["top1"] >= 0.0  # 2 warmup + 2 finetune steps
    assert CheckpointManager(os.path.join(eval_dir, "checkpoints_best")).all_steps() == [4]
    assert config_lib.load(os.path.join(eval_dir, "config.yaml")) == _finetune_cfg()
    again = eval_loop.run_action_recognition(_finetune_cfg(test_only=True), mcfg, fold=1,
                                             debug=True, device="cpu")
    assert again == results


@pytest.mark.parametrize("run", [eval_loop.run_action_recognition, eval_loop.run_linear_probe])
def test_test_only_without_checkpoint_raises(tmp_path, run):
    cfg = (_finetune_cfg if run is eval_loop.run_action_recognition else _probe_cfg)(
        test_only=True)
    with pytest.raises(FileNotFoundError, match="test_only"):
        run(cfg, _model_cfg(tmp_path), fold=1, debug=True, device="cpu")


def test_resumed_finetunes_equal_the_straight_run(tmp_path):
    """One warmup and two finetune epochs of 2 steps (with dropout);
    resumed after the warmup (the finetune checkpoints lost), and after
    finetune epoch 1 (its last checkpoint lost): the same final
    checkpoint and results as the straight run, bit for bit."""
    straight = tmp_path / "straight"
    want = eval_loop.run_action_recognition(_finetune_cfg(), _model_cfg(straight), fold=1,
                                            device="cpu")
    final = _latest(os.path.join(_eval_dir(straight), "checkpoints"))
    assert (final["step"], final["epoch"]) == (6, 2)
    for case in ("warmup", "epoch"):
        root = tmp_path / case
        shutil.copytree(straight, root)
        ckdir = os.path.join(_eval_dir(root), "checkpoints")
        if case == "warmup":
            shutil.rmtree(ckdir)
        else:
            os.remove(CheckpointManager(ckdir).path(6))
        got = eval_loop.run_action_recognition(_finetune_cfg(resume=True, quiet=False),
                                               _model_cfg(root),
                                               fold=1, device="cpu")
        assert got == want, case
        resumed = _latest(ckdir)
        assert (resumed["step"], resumed["epoch"]) == (6, 2)
        for k, v in final["model"].items():
            assert torch.equal(resumed["model"][k], v), (case, k)
        for i, st in final["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(resumed["optimizer"]["state"][i][k], st[k]), (case, i, k)
        with open(os.path.join(_eval_dir(root), "eval.log")) as f:
            log = f.read()
        assert ("restored warmup checkpoint" if case == "warmup"
                else "restored eval checkpoint @ step 4") in log


def test_probe_multi_tap_metrics_and_resume(tmp_path):
    mcfg = _model_cfg(tmp_path)
    results = eval_loop.run_linear_probe(_probe_cfg(), mcfg, fold=1, debug=True, device="cpu")
    assert set(results) == {"conv5x", "pool"}
    for tap in results.values():
        assert set(tap) == {"clip@1", "clip@5", "video@1", "video@5"}
        assert all(np.isfinite(v) for v in tap.values())
    again = eval_loop.run_linear_probe(_probe_cfg(test_only=True), mcfg, fold=1, debug=True,
                                       device="cpu")
    assert again == results


def test_linear_probe_kinetics_crop_color_route(tmp_path, monkeypatch):
    """The Kinetics linear-probe recipe's transform (crop+color) runs its
    train and eval branches."""
    calls = {"train": 0, "eval": 0}
    for kind in calls:
        name = f"crop_augment_clips_{kind}"
        orig = getattr(video_aug, name)

        def spy(*a, _orig=orig, _kind=kind, **k):
            calls[_kind] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(video_aug, name, spy)
    data = _data_cfg(name="kinetics", resize=40, transform="crop+color",
                     train={"split": "train", "mode": "clip", "clips_per_video": 1,
                            "use_augmentation": True, "use_shuffle": True, "drop_last": True},
                     test={"split": "val", "mode": "clip", "clips_per_video": 1,
                           "use_augmentation": False, "use_shuffle": False,
                           "drop_last": False})
    del data["test_dense"]
    cfg = _probe_cfg(dataset=data)
    cfg.model["args"] = config_lib.from_dict({"n_classes": 400, "feat_names": ["pool"],
                                              "pooling_ops": [None], "use_bn": True})
    results = eval_loop.run_linear_probe(cfg, _model_cfg(tmp_path), fold=1, debug=True,
                                         device="cpu")
    assert calls["train"] >= 1 and calls["eval"] >= 1
    assert set(results["pool"]) == {"clip@1", "clip@5"}


def test_backbone_from_a_port_run_and_its_pth_tar(tmp_path):
    model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10}, proj_dim=[64, 32],
                       seed=3, device="cpu")
    opt = build_optimizer(model.parameters(), "adam", 1e-4)
    mem = torch.nn.functional.normalize(torch.randn(16, 32), dim=1)
    state = TrainState(model, opt, multistep_scheduler(opt, [], 1.0),
                       BankState(mem, mem.clone(), torch.tensor(1.0)), torch.Generator())
    CheckpointManager(tmp_path / "run" / "smoke" / "checkpoints").save(
        1, state, {"epoch": 1, "batch": 0})
    os.makedirs(tmp_path / "pth" / "smoke")
    export_pth_tar(str(tmp_path / "pth" / "smoke" / "checkpoint.pth.tar"), model)
    want = model.video_model.state_dict()
    cpu = torch.device("cpu")
    for kind in ("run", "pth"):
        backbone, source = eval_loop.load_backbone(_model_cfg(tmp_path / kind), cpu)
        assert source is not None and source.startswith(str(tmp_path / kind))
        got = backbone.state_dict()
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    backbone, source = eval_loop.load_backbone(_model_cfg(tmp_path / "none"), cpu)
    assert source is None


def _write_cfgs(tmp_path, eval_cfg):
    paths = str(tmp_path / "eval.yaml"), str(tmp_path / "model.yaml")
    config_lib.dump(eval_cfg, paths[0])
    config_lib.dump({"model": _model_cfg(tmp_path / "runs").to_dict()}, paths[1])
    return paths


@pytest.mark.parametrize("script,cfg", [("eval_action_recg_torch.py", _finetune_cfg),
                                        ("eval_action_recg_linear_torch.py", _probe_cfg)])
def test_eval_clis_run_on_the_cpu(tmp_path, script, cfg):
    ecfg, mcfg = _write_cfgs(tmp_path, cfg())
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, os.path.join(REPO, script), ecfg, mcfg,
                          "--device", "cpu", "--debug", "--set", "quiet=false"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clip@1" in out.stdout and "RESULTS" in out.stdout


def test_eval_gaps_raise(tmp_path, monkeypatch):
    ecfg, mcfg = _write_cfgs(tmp_path, _finetune_cfg())
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        finetune_main([ecfg, mcfg, "--multihost", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        finetune_main([ecfg, mcfg, "--debug"])  # the card by default
    assert not os.path.exists(tmp_path / "runs")
