"""The port's config layer (avid_cma_tpu_torch/config.py, yaml_lite.py)
against PyYAML and the JAX package's config: its YAML reader equals
``yaml.safe_load`` on every file under configs/ and on a list of tricky
documents, its ``_coerce`` equals JAX's on override strings, what its
writer emits reads back equal with both readers, and the ``Config`` of
Cross-N1024.yaml gives the ``PretrainConfig`` of the published recipe;
the Kinetics AVID-CMA YAML gives its recipe and the JAX package's
criterion config; the AudioSet AVID YAML (row-sharded banks) passes
``check_ported``, and the AudioSet AVID-CMA YAML is refused for its
approximate mining only; WORLD_SIZE > 1 without ``--multihost`` raises
naming the flag."""

import dataclasses
import math
import pathlib

import pytest
import yaml

from avid_cma_tpu import config as jax_config
from avid_cma_tpu.train.builders import build_criterion_config
from avid_cma_tpu_torch import config as port_config
from avid_cma_tpu_torch import yaml_lite
from avid_cma_tpu_torch.criterions.avid_cma import AVIDCMAConfig
from avid_cma_tpu_torch.train.builders import (
    build_preprocess_config,
    kinetics_cma,
    kinetics_cross_n1024,
    pretrain_config,
)
from avid_cma_tpu_torch.train.loop import check_ported
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").rglob("*.yaml"))


def test_reader_equals_safe_load_on_every_config():
    assert len(CONFIGS) == 19
    for path in CONFIGS:
        text = path.read_text()
        assert yaml_lite.safe_load(text) == yaml.safe_load(text), path


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b and type(a) is type(b)


DOCS = [
    "1e-5", "2.", "16.", "0.00001", "1.0e-05", "-.inf", ".nan", "1_000", "0x1F", "010",
    "0b101", "1:30", "~", "null", "", "yes", "On", "off", "'x'", "'it''s'",
    '"a\\tb\\u00e9"', "a b c", "/tmp/x", "+1", "09", "3.",
    "[1, 2]", "[]", "{a: 1, b: [x, 'y z']}", "{a: b, c}",
    "- a\n- b\n", "k:\n- 1\n- 2\n", "k:\n  - {a: 1}\n  - b\n",
    "a: \"x # y\" # c\nb: 2", "x: # c\n  y: 1\n", "- a: 1\n  b: 2\n- c: 3\n",
    "t: {p: 'q',\n  r: [1,\n    2], s: t}\n", "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
]


@pytest.mark.parametrize("doc", DOCS)
def test_reader_equals_safe_load_on_tricky_documents(doc):
    assert _same(yaml_lite.safe_load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("doc", ["a: &x 1\nb: *x\n", "a: |\n  text\n", "a: !!str 1",
                                 "d: 2001-12-14", "a:\n\tb: 1", "a: b\n  c\n"])
def test_reader_refuses_what_is_outside_the_subset(doc):
    with pytest.raises(yaml_lite.YAMLError):
        yaml_lite.safe_load(doc)


@pytest.mark.parametrize("raw", ["1e-5", "2.", "[1, 2]", "null", "'x'", "true", "1.5E3",
                                 "-3e2", "synthetic", "160", "/tmp/x", "{name: strong}",
                                 " 0.5 ", "[256, 342]", "1e5x", "nan"])
def test_coerce_equals_jax(raw):
    assert _same(port_config._coerce(raw), jax_config._coerce(raw))


def test_writer_reads_back_equal():
    obj = {"a": 1e-5, "b": [1, 2.5, None, True], "on": 1, "1": "2",
           "c": {"d": "yes", "e": "", "f": "x: y", "g": "é\u2028\U0001f600", "h": [], "i": {}},
           "l": [{"x": 1}, [1, [2]]], "m": float("inf"), "n": 1e20, "o": "1e-5",
           "p": " lead", "q": "#x", "r": "-", "s": "null"}
    text = yaml_lite.safe_dump(obj)
    assert yaml.safe_load(text) == obj
    assert yaml_lite.safe_load(text) == obj
    for path in CONFIGS:
        cfg = yaml.safe_load(path.read_text())
        assert yaml.safe_load(yaml_lite.safe_dump(cfg)) == cfg, path


def test_load_overrides_merge_match_jax(tmp_path):
    path = REPO / "configs/main/avid/kinetics/Cross-N1024.yaml"
    ovs = ["dataset.backend=synthetic", "optimizer.lr.base_lr=1e-4", "model.dtype=auto",
           "dataset.decode_size=[64, 80]", "extra.key={name: strong}"]
    port, ref = port_config.load(str(path), ovs), jax_config.load(str(path), ovs)
    assert port.to_dict() == ref.to_dict()
    assert port.dataset.train.clips_per_video == 10 and port.extra.key.name == "strong"
    with pytest.raises(ValueError, match="no '='"):
        port_config.load(str(path), ["dataset.backend"])
    upd = {"dataset": {"batch_size": 8, "new": [1]}, "seed": 3}
    assert port_config.merge(port, upd).to_dict() == jax_config.merge(ref, upd).to_dict()
    port_config.dump(port, str(tmp_path / "config.yaml"))
    assert yaml.safe_load((tmp_path / "config.yaml").read_text()) == port.to_dict()


def test_cross_n1024_yaml_gives_the_recipe():
    cfg = port_config.load(str(REPO / "configs/main/avid/kinetics/Cross-N1024.yaml"))
    one_card = pretrain_config(cfg)
    assert one_card.batch_size == 256 and one_card.num_data == 232067
    # the published recipe split its 256 clips over 8 GPUs
    assert dataclasses.replace(one_card, num_replicas=8) == kinetics_cross_n1024()
    assert pretrain_config(cfg, num_data=160).num_data == 160
    lin = port_config.load(str(REPO / "configs/benchmark/kinetics/8x224x224-linear.yaml"))
    pp = build_preprocess_config(lin.dataset)
    assert (pp.transform, pp.resize, pp.color) == ("crop+color", (256, 256), (0.4, 0.4, 0.4, 0.2))


def test_kinetics_cma_yaml_gives_the_recipe():
    path = REPO / "configs/main/avid-cma/kinetics/InstX-N1024-PosW-N64-Top32.yaml"
    cfg = port_config.load(str(path))
    y = yaml.safe_load(path.read_text())
    loss, sampling = y["loss"]["args"], y["loss"]["args"]["sampling_args"]
    one_card = pretrain_config(cfg)
    assert one_card.loss == "AVID_CMA" and one_card.batch_size == y["dataset"]["batch_size"]
    assert (one_card.num_data, one_card.num_negatives, one_card.num_negatives_within,
            one_card.momentum, one_card.resample_freq) == (
        loss["num_data"], loss["num_negatives"], loss["num_negatives_within"],
        loss["momentum"], loss["resample_freq"])
    assert (one_card.xModalInstCoeff, one_card.wModalInstCoeff, one_card.xModalPosCoeff,
            one_card.wModalPosCoeff) == (loss["xModalInstCoeff"], loss["wModalInstCoeff"],
                                         loss["xModalPosCoeff"], loss["wModalPosCoeff"])
    assert (one_card.pos_k, one_card.sampling_type, one_card.mining_exact) == (
        sampling["pos_k"], sampling["type"], True)
    assert list(one_card.milestones) == y["optimizer"]["lr"]["milestones"]
    # the published recipe split its 256 clips over 8 GPUs
    assert dataclasses.replace(one_card, num_replicas=8) == kinetics_cma()
    crit = kinetics_cma().criterion(128)
    assert isinstance(crit, AVIDCMAConfig)
    ref = build_criterion_config(jax_config.from_dict(y)["loss"], embedding_dim=128)
    assert dataclasses.asdict(crit) == dataclasses.asdict(ref)
    # the hyphenated spelling is the same loss
    cfg.loss["name"] = "AVID-CMA"
    assert pretrain_config(cfg).loss == "AVID_CMA"


def test_audioset_cma_yaml_raises_naming_its_gaps():
    cfg = port_config.load(str(REPO / "configs/main/avid-cma/audioset/"
                                      "InstX-N1024-PosW-N64-Top32.yaml"))
    assert pretrain_config(cfg).mining_exact is False
    assert cfg.loss["bank_sharding"] == "sharded"
    with pytest.raises(NotImplementedError, match="exact: false") as e:
        check_ported(cfg)
    # sharded banks are ported: approximate mining is the only gap left
    assert "A8.5" in str(e.value) and "bank_sharding" not in str(e.value)
    cfg.loss["args"]["sampling_args"]["exact"] = True
    check_ported(cfg)


def test_audioset_avid_yaml_passes_and_world_size_needs_multihost(tmp_path, monkeypatch):
    cfg = port_config.load(str(REPO / "configs/main/avid/audioset/Cross-N1024.yaml"))
    assert cfg.loss["bank_sharding"] == "sharded" and cfg.loss["args"]["num_data"] == 1784108
    check_ported(cfg)
    cfg.loss["bank_sharding"] = "shraded"
    with pytest.raises(ValueError, match="bank_sharding"):
        check_ported(cfg)

    from avid_cma_tpu_torch.cli import pretrain_main

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="--multihost"):
        pretrain_main([str(REPO / "configs/smoke/avid-synthetic.yaml"), "--debug",
                       "--device", "cpu", "--set", f"model.model_dir={tmp_path}"])
    assert not list(tmp_path.iterdir())  # raised before writing anything
