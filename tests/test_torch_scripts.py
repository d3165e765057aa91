"""The port's scripts (avid_cma_tpu_torch/scripts: retrieval,
extract_features, classify, checkpoints, learning_proof) on the CPU.

Against the JAX package's scripts (scripts/*.py), from the same weights:
random variables of the JAX package's R2Plus1D-10 + Conv2D-10 AV model
(BatchNorm statistics that are not 1 and 0) carried over by
``flax_to_port_state`` and written as the ``.pth.tar`` both sides read
(``extract_features``: the taps of clips and of dense videos, and the NCE
space, within 1e-4 of the largest value); a classification wrapper on
that backbone carried over by ``flax_eval_to_port_state`` (``classify``:
the dense protocol's probabilities within 1e-4); ``recall_metrics`` and
``evaluate`` exactly, ties and repeated indices included; the learning
proof's retrieval, ridge probe and gates exactly, on fixed features.

Port only: ``checkpoints`` ``export`` of a port run, ``convert`` and
``inspect``, bit for bit; the learning proof end to end at a tiny size
(both stages, gates at 0) writing every key of the JAX record; the
scripts import neither JAX nor the JAX package.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avid_cma_tpu  # noqa: F401  (registries)
from avid_cma_tpu import config as jax_config
from avid_cma_tpu.registry import MODELS
from avid_cma_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.scripts import (
    checkpoints,
    classify,
    extract_features,
    learning_proof,
    retrieval,
)
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_pth_tar,
    flax_eval_to_port_state,
    flax_to_port_state,
    import_criterion_pth_tar,
    import_model_pth_tar,
    import_optimizer_pth_tar,
)
from avid_cma_tpu_torch.train.optim import build_optimizer
from tests.test_torch_models import (  # noqa: F401  (autouse fixture)
    random_variables,
    torch_threads_per_worker,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts import classify as jax_classify  # noqa: E402
from scripts import extract_features as jax_extract  # noqa: E402
from scripts import learning_proof as jax_proof  # noqa: E402
from scripts import retrieval as jax_retrieval  # noqa: E402

MODEL_ARGS = {"proj_dim": [64, 32], "video_backbone": "R2Plus1D",
              "video_backbone_args": {"depth": 10}, "audio_backbone": "Conv2D",
              "audio_backbone_args": {"depth": 10}}
N_CLASSES = 101
TEST = {"split": "testlist{fold:02d}", "mode": "clip", "clips_per_video": 1,
        "use_augmentation": False, "use_shuffle": False, "drop_last": False}
UCF = {"name": "ucf101", "backend": "synthetic", "synthetic_size": 8, "fold": 1,
       "batch_size": 4, "clip_duration": 0.25, "video_fps": 8.0, "crop_size": 32}
KINETICS = {"name": "kinetics", "backend": "synthetic", "synthetic_size": 8, "batch_size": 4,
            "video_clip_duration": 0.25, "video_fps": 8.0, "crop_size": 32,
            "audio_clip_duration": 0.5, "audio_fps": 24000, "n_fft": 512,
            "spectrogram_fps": 100.0, "test": {**TEST, "split": "test"}}
SCRIPTS = ("retrieval", "extract_features", "classify", "checkpoints", "learning_proof")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(model_dir, the variables): random variables of the JAX av_wrapper's
    structure (non-trivial BN statistics), carried over by
    ``flax_to_port_state`` and written as
    ``<model_dir>/smoke/checkpoint.pth.tar`` through the port."""
    model = MODELS.get("av_wrapper")(**MODEL_ARGS)
    variables = jax.tree_util.tree_map(np.asarray, random_variables(
        model, 3, jnp.zeros((1, 2, 32, 32, 3)), jnp.zeros((1, 64, 65, 1))))
    port = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                      proj_dim=MODEL_ARGS["proj_dim"], device="cpu")
    port.load_state_dict(flax_to_port_state(variables), strict=True)
    model_dir = tmp_path_factory.mktemp("scripts")
    os.makedirs(model_dir / "smoke")
    export_pth_tar(str(model_dir / "smoke" / "checkpoint.pth.tar"), port)
    return model_dir, variables


def _model_cfg(model_dir, lib):
    return lib({"model": {"name": "smoke", "model_dir": str(model_dir), "arch": "av_wrapper",
                          "args": MODEL_ARGS}})["model"]


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", ["taps-clip", "taps-dense", "nce"])
def test_extract_features_matches_jax(weights, mode):
    model_dir, _ = weights
    if mode == "nce":
        data, kw = {"dataset": KINETICS}, dict(space="nce")
    else:
        test = {**TEST, "mode": "video", "clips_per_video": 2} if mode == "taps-dense" else TEST
        data, kw = {"dataset": {**UCF, "test": test}}, dict(taps=("pool", "conv5x", "conv1"),
                                                            fold=1)
    want = jax_extract.extract_features(jax_config._wrap(data), _model_cfg(model_dir,
                                        jax_config._wrap), max_items=4, num_workers=1, **kw)
    got = extract_features.extract_features(config_lib.from_dict(data),
                                            _model_cfg(model_dir, config_lib.from_dict),
                                            max_items=4, num_workers=1, device="cpu", **kw)
    assert sorted(got[0]) == sorted(want[0])
    for name, ref in want[0].items():
        assert got[0][name].shape == ref.shape and got[0][name].dtype == np.float32
        assert _rel(got[0][name], ref) <= 1e-4, name
    for g, w in zip(got[1:], want[1:]):
        assert (g is None and w is None) or np.array_equal(g, w)


def test_extract_features_cli_writes_the_jax_keys(weights, tmp_path):
    model_dir, _ = weights
    dpath, mpath = tmp_path / "data.yaml", tmp_path / "model.yaml"
    config_lib.dump({"dataset": {**UCF, "test": TEST}}, str(dpath))
    config_lib.dump({"model": dict(_model_cfg(model_dir, config_lib.from_dict))}, str(mpath))
    out = tmp_path / "feats.npz"
    extract_features.main([str(dpath), str(mpath), "--taps", "pool", "conv5x", "--fold", "1",
                           "--out", str(out), "--max-items", "3", "--num-workers", "1",
                           "--device", "cpu"])
    z = np.load(out)
    assert sorted(z) == ["feat_conv5x", "feat_pool", "index", "label"]
    assert z["feat_pool"].shape == (3, 512) and z["index"].shape == (3,)


def test_extract_features_raises_without_weights(tmp_path):
    cfg = _model_cfg(tmp_path, config_lib.from_dict)
    with pytest.raises(FileNotFoundError, match="no checkpoint.pth.tar"):
        extract_features.extract_features(config_lib.from_dict({"dataset": {**UCF, "test": TEST}}),
                                          cfg, fold=1, num_workers=1, device="cpu")


def _eval_cfg(lib):
    return lib({
        "seed": 0, "benchmark": {"name": "ucf-smoke"},
        "dataset": {**UCF, "train": TEST, "test": TEST,
                    "test_dense": {**TEST, "mode": "video", "clips_per_video": 2}},
        "model": {"name": "ClassificationWrapper",
                  "args": {"n_classes": N_CLASSES, "feat_name": "pool", "pooling_op": None,
                           "use_dropout": True, "dropout": 0.5}},
    })


def test_classify_matches_jax(weights, tmp_path, capsys):
    """A finetuned eval run of each package from the same weights (the
    fabricated backbone and a drawn classifier): the dense protocol's
    probabilities within 1e-4, from the best checkpoint; 'last' without
    a per-epoch checkpoint raises."""
    _, av_vars = weights
    rng = np.random.default_rng(6)
    variables = {
        "params": {"feature_extractor": av_vars["params"]["video_model"],
                   "classifier": {
                       "kernel": (0.05 * rng.standard_normal((512, N_CLASSES))).astype(np.float32),
                       "bias": (0.1 * rng.standard_normal(N_CLASSES)).astype(np.float32)}},
        "batch_stats": {"feature_extractor": av_vars["batch_stats"]["video_model"]},
    }
    eval_dir = tmp_path / "smoke" / "eval-ucf-smoke" / "fold-01"
    JaxCheckpointManager(str(eval_dir / "orbax_best")).save(0, variables, wait=True)
    best = eval_dir / "checkpoints_best"
    os.makedirs(best)
    torch.save({"model": flax_eval_to_port_state(variables)}, best / "ckpt-000000001.pt")

    paths = ["clipA.mp4", "clipB.mp4", "clipC.mp4"]
    want, kind = jax_classify.classify_videos(_eval_cfg(jax_config._wrap),
                                              _model_cfg(tmp_path, jax_config._wrap), paths,
                                              fold=1, clips=2)
    got, port_kind = classify.classify_videos(_eval_cfg(config_lib.from_dict),
                                              _model_cfg(tmp_path, config_lib.from_dict), paths,
                                              fold=1, clips=2, device="cpu")
    assert (kind, port_kind) == ("orbax_best", "checkpoints_best")
    assert got.shape == want.shape == (3, N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.max()))
    with pytest.raises(FileNotFoundError, match="no finetuned checkpoint"):
        classify.classify_videos(_eval_cfg(config_lib.from_dict),
                                 _model_cfg(tmp_path, config_lib.from_dict), paths[:1],
                                 fold=1, which="last", clips=2, device="cpu")

    # the CLI: the same ranking, with the class names of a --classes file
    epath, mpath = tmp_path / "eval.yaml", tmp_path / "model.yaml"
    config_lib.dump(_eval_cfg(dict), str(epath))
    config_lib.dump({"model": dict(_model_cfg(tmp_path, config_lib.from_dict))}, str(mpath))
    names = tmp_path / "names.txt"
    names.write_text("\n".join(f"action{i:03d}" for i in range(N_CLASSES)))
    classify.main([str(epath), str(mpath), paths[0], "--clips", "2", "--topk", "3",
                   "--classes", str(names), "--device", "cpu"])
    out = capsys.readouterr().out
    top = int(np.argmax(got[0]))
    assert "checkpoint: checkpoints_best" in out
    assert f"{paths[0]}: action{top:03d}={got[0, top]:.3f}" in out


def _embeddings(case: str):
    rng = np.random.default_rng({"random": 0, "ties": 1, "constant": 2}[case])
    q = rng.standard_normal((24, 8)).astype(np.float32)
    g = rng.standard_normal((24, 8)).astype(np.float32)
    if case == "ties":  # coarse values: many equal scores
        q, g = np.round(q), np.round(g)
        g[5] = g[6]
    elif case == "constant":
        q[:] = 1.0
    return q, g


@pytest.mark.parametrize("case", ["random", "ties", "constant"])
def test_recall_metrics_equals_jax(case):
    q, g = _embeddings(case)
    for ks in ((1, 5, 10), (1, 2, 3, 24)):
        assert retrieval.recall_metrics(q, g, ks) == jax_retrieval.recall_metrics(q, g, ks)
    with pytest.raises(ValueError, match="shape mismatch"):
        retrieval.recall_metrics(q, g[:3])


def test_retrieval_evaluate_equals_jax(tmp_path, capsys):
    """Repeated indices (a padded extraction) are dropped first, on both sides."""
    v, a = _embeddings("ties")
    index = np.arange(24)
    index[20:] = index[:4]
    path = tmp_path / "feats.npz"
    np.savez(path, feat_video=v, feat_audio=a, index=index)
    assert retrieval.evaluate(str(path), (1, 5)) == jax_retrieval.evaluate(str(path), (1, 5))
    retrieval.main([str(path), "--ks", "1", "5"])
    assert json.loads(capsys.readouterr().out) == jax_retrieval.evaluate(str(path), (1, 5))
    np.savez(tmp_path / "taps.npz", feat_pool=v)
    with pytest.raises(KeyError, match="--space nce"):
        retrieval.evaluate(str(tmp_path / "taps.npz"))


def _port_run(tmp_path):
    """A port pretraining run's directory: its config.yaml and one
    checkpoint of a state whose Adam moments, banks and Z are not the
    initial ones."""
    cfg = config_lib.from_dict({
        "seed": 0, "model": {"name": "run", "model_dir": str(tmp_path), "arch": "av_wrapper",
                             "args": MODEL_ARGS},
        "dataset": {**KINETICS, "train": TEST},
        "optimizer": {"name": "adam", "weight_decay": 1e-5, "num_epochs": 1,
                      "lr": {"name": "multistep", "base_lr": 3e-4, "gamma": 1.0,
                             "milestones": [1]}},
        "loss": {"name": "AVID", "args": {"num_data": 8, "num_negatives": 4}},
    })
    state, _ = builders.build_pretrain(builders.pretrain_config(cfg), "cpu")
    gen = torch.Generator().manual_seed(1)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    state.bank = BankState(state.bank.view1_mem, state.bank.view2_mem, torch.tensor(2.5))
    state.step, state.epoch = 3, 1
    run = tmp_path / "run"
    CheckpointManager(str(run / "checkpoints")).save(3, state, {"epoch": 1, "batch": 0})
    config_lib.dump(cfg, str(run / "config.yaml"))
    return run, state


def test_checkpoints_export_convert_inspect_round_trip(tmp_path, capsys):
    run, state = _port_run(tmp_path)
    pth = tmp_path / "out.pth.tar"
    checkpoints.main(["export", str(run), str(pth)])
    own = state.model.state_dict()
    got = import_model_pth_tar(str(pth))
    assert sorted(got) == sorted(own) and all(torch.equal(got[k], own[k]) for k in own)
    bank = import_criterion_pth_tar(str(pth))
    assert torch.equal(bank.view1_mem, state.bank.view1_mem)
    assert torch.equal(bank.view2_mem, state.bank.view2_mem) and float(bank.z) == 2.5
    assert torch.load(str(pth), weights_only=False)["epoch"] == 1
    model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                       proj_dim=MODEL_ARGS["proj_dim"], device="cpu")
    fresh = build_optimizer(model.parameters(), "adam", 1.0)
    import_optimizer_pth_tar(str(pth), model, fresh)
    by_name = dict(state.model.named_parameters())
    for name, p in model.named_parameters():
        a, b = fresh.state[p], state.optimizer.state[by_name[name]]
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    group = torch.load(str(pth), weights_only=False)["optimizer"]["param_groups"][0]
    assert (group["lr"], group["weight_decay"]) == (3e-4, 1e-5)

    out = tmp_path / "npz"
    checkpoints.main(["convert", str(pth), str(out)])
    flat = np.load(out / "model.npz")
    assert sorted(flat) == sorted(own)
    assert all(np.array_equal(flat[k], own[k].numpy()) for k in own)
    crit = np.load(out / "criterion.npz")
    assert np.array_equal(crit["view1_mem"], state.bank.view1_mem.numpy())
    assert np.array_equal(crit["view2_mem"], state.bank.view2_mem.numpy())
    assert float(crit["z"]) == 2.5

    checkpoints.main(["export", str(run), str(pth), "--lr", "0.5", "--weight-decay", "0"])
    group = torch.load(str(pth), weights_only=False)["optimizer"]["param_groups"][0]
    assert (group["lr"], group["weight_decay"]) == (0.5, 0.0)

    capsys.readouterr()
    checkpoints.main(["inspect", str(pth)])
    text = capsys.readouterr().out
    assert "keys: ['epoch', 'model', 'optimizer', 'train_criterion']" in text
    assert f"[model] {len(own)} tensors" in text and "[train_criterion] 3 tensors" in text
    checkpoints.main(["inspect", str(run)])
    assert "port run checkpoint: step 3, epoch 1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        checkpoints.main(["download"])


def _fake_features(size, space, taps, classes):
    """Fixed features for the proof's evaluation: noisy class and
    instance structure, so neither gate is trivially met or missed."""
    rng = np.random.default_rng(size)
    idx = np.arange(size)
    labels = idx % classes
    if space == "nce":
        base = rng.standard_normal((size, 16))
        v = base + 0.8 * rng.standard_normal((size, 16))
        a = base + 0.8 * rng.standard_normal((size, 16))
        return ({"video": (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32),
                 "audio": (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)},
                labels, idx)
    centres = np.random.default_rng(99).standard_normal((classes, 32))
    x = centres[labels] + 1.5 * rng.standard_normal((size, 32))
    return {t: x.astype(np.float32) for t in taps}, labels, idx


def test_learning_proof_evaluation_equals_jax_on_fixed_features(monkeypatch, tmp_path):
    """Both proofs' retrieval, ridge probe, gates and record, with the
    pretraining skipped and the extraction replaced by fixed features."""
    def fake(data_cfg, model_cfg, split="test", space="taps", taps=("pool",), **_):
        return _fake_features(int(data_cfg["dataset"]["synthetic_size"]), space, taps, 8)

    monkeypatch.setattr("avid_cma_tpu.train.loop.run_pretraining", lambda *a, **k: None)
    monkeypatch.setattr("scripts.extract_features.extract_features", fake)
    monkeypatch.setattr(learning_proof, "run_pretraining", lambda *a, **k: None)
    monkeypatch.setattr(learning_proof, "extract_features", fake)
    argv = ["--model-dir", str(tmp_path), "--probe-factor", "3.5"]
    want = jax_proof.run_proof(jax_proof_args(argv))
    got = learning_proof.run_proof(learning_proof.build_argparser().parse_args(
        argv + ["--device", "cpu"]))
    for key in ("pretrain_wall_sec",):
        want.pop(key), got.pop(key)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"dtype", "compute_dtype", "card"}
    xtr, ytr, _ = _fake_features(128, "taps", ("pool",), 8)
    xte, yte, _ = _fake_features(64, "taps", ("pool",), 8)
    assert learning_proof.ridge_probe(xtr["pool"], ytr, xte["pool"], yte, 8) == pytest.approx(
        got["probe_top1"], abs=5e-5)


def jax_proof_args(argv):
    """The JAX script's arguments, parsed as its ``main`` parses them."""
    captured = {}

    def capture(args):
        captured["args"] = args
        return {"pass": True}

    monkey = pytest.MonkeyPatch()
    monkey.setattr(jax_proof, "run_proof", capture)
    try:
        jax_proof.main(argv + ["--out", ""])
    finally:
        monkey.undo()
    return captured["args"]


def _keys(record):
    return {k: _keys(v) if isinstance(v, dict) and k not in ("retrieval", "thresholds") else None
            for k, v in record.items()}


def test_learning_proof_end_to_end_on_cpu(tmp_path):
    """Both stages through run_pretraining, extraction and mining at 16
    train and 8 test instances, 2 + 2 epochs, crop 32, every gate at 0:
    the record holds every key of the JAX package's AVID-CMA record."""
    out = tmp_path / "proof.json"
    rc = learning_proof.main([
        "--criterion", "avid_cma", "--device", "cpu", "--train-size", "16", "--test-size", "8",
        "--epochs", "2", "--cma-epochs", "2", "--crop", "32", "--r1-factor", "0",
        "--probe-factor", "0", "--purity-factor", "0", "--cma-r1-factor", "0",
        "--model-dir", str(tmp_path), "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    with open(REPO / "LEARNPROOF_CMA.json") as f:
        want = json.load(f)
    keys, want_keys = _keys(got), _keys(want)
    for section in ("avid", "cma"):
        assert set(want_keys[section]) <= set(keys[section]), section
    assert set(want_keys) <= set(keys)
    assert (got["pass"], got["epochs"], got["train_instances"]) == (True, 2, 16)
    assert got["cma"]["test_instances"] == 8 and got["card"] == "cpu"
    assert got["dtype"] == got["compute_dtype"] == "float32"
    for section in ("avid", "cma"):
        for direction in ("v2a", "a2v"):
            assert 0.0 <= got[section]["retrieval"][direction]["R@1"] <= 100.0
    assert 0.0 <= got["cma"]["mined_purity_init"] <= 1.0


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_no_jax(script):
    path = REPO / "avid_cma_tpu_torch" / "scripts" / f"{script}.py"
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "avid_cma_tpu", "scripts"}


def test_scripts_load_no_jax_in_a_fresh_interpreter():
    probe = ("import sys; " + "; ".join(f"import avid_cma_tpu_torch.scripts.{s}" for s in SCRIPTS)
             + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'flax', 'avid_cma_tpu', 'scripts')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
