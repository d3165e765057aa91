"""``model.dtype`` in the port (avid_cma_tpu_torch/device.py
``compute_dtype``, ``train/builders.check_model_dtype``), the
counterpart of ``resolve_compute_dtype`` (avid_cma_tpu/train/builders.py:
20-42), on the CPU: every spec on each device; the spec reaching the
model's convolutions, the clips of the preprocessing (train and eval),
the pretraining config, the eval backbone and the entry points. The
CPU computes f32 only, so ``bfloat16`` raises there; on the card every
spec runs (K2/K3 and K5 have bf16 and f32 forms; the card tests hold
them).
"""

import numpy as np
import pytest
import torch

from avid_cma_tpu.train.builders import resolve_compute_dtype
from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.data.pipelines import PreprocessConfig, preprocess_batch
from avid_cma_tpu_torch.device import compute_dtype
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.models.blocks import BatchNorm, Conv2DLayer
from avid_cma_tpu_torch.ops.conv3d import Conv3D
from avid_cma_tpu_torch.train import builders, eval_loop
from avid_cma_tpu_torch.train.loop import run_pretraining
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

SPECS = (None, "auto", "float32", "f32", "bfloat16", "bf16")
# (spec, device) -> the compute dtype, or the error it raises
EXPECTED = {
    **{(s, "cpu"): torch.float32 for s in (None, "auto", "float32", "f32")},
    **{(s, "cpu"): NotImplementedError for s in ("bfloat16", "bf16")},
    **{(s, "cuda"): torch.bfloat16 for s in (None, "auto", "bfloat16", "bf16")},
    **{(s, "cuda"): torch.float32 for s in ("float32", "f32")},
}
MODEL_ARGS = {"proj_dim": [64, 32], "video_backbone": "R2Plus1D",
              "video_backbone_args": {"depth": 10}, "audio_backbone": "Conv2D",
              "audio_backbone_args": {"depth": 10}}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("spec", SPECS)
def test_compute_dtype_and_check_model_dtype(spec, device):
    want = EXPECTED[(spec, device)]
    if isinstance(want, torch.dtype):
        assert compute_dtype(device, spec) == want
        builders.check_model_dtype(spec, device)
    else:
        with pytest.raises(want, match="model.dtype=bfloat16 on the CPU"):
            compute_dtype(device, spec)
        with pytest.raises(want, match="model.dtype"):
            builders.check_model_dtype(spec, device)


@pytest.mark.parametrize("spec", SPECS)
def test_explicit_specs_agree_with_the_jax_package(spec):
    """An explicit spec names the JAX package's dtype (None there is
    f32); 'auto' is the backend's own choice in both (the CPU: f32)."""
    jax_dtype = resolve_compute_dtype(spec)
    name = "float32" if jax_dtype is None else np.dtype(jax_dtype).name
    assert str(compute_dtype("cuda" if name == "bfloat16" else "cpu", spec)) == f"torch.{name}"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_unknown_spec_raises(device):
    with pytest.raises(ValueError, match="unknown model.dtype 'float16'"):
        compute_dtype(device, "float16")
    with pytest.raises(ValueError, match="unknown model.dtype"):
        builders.check_model_dtype("half", device)


def _pretrain_cfg(tmp_path, dtype):
    test = {"split": "test", "mode": "clip", "clips_per_video": 1, "use_augmentation": False,
            "use_shuffle": False, "drop_last": False}
    return config_lib.from_dict({
        "seed": 0, "num_workers": 1, "log2tb": False, "quiet": True,
        "model": {"name": "run", "model_dir": str(tmp_path), "arch": "av_wrapper",
                  "dtype": dtype, "args": MODEL_ARGS},
        "dataset": {"name": "kinetics", "backend": "synthetic", "synthetic_size": 8,
                    "batch_size": 4, "video_clip_duration": 0.25, "video_fps": 8.0,
                    "crop_size": 32, "audio_clip_duration": 0.5, "audio_fps": 24000,
                    "train": {**test, "split": "train", "use_augmentation": True},
                    "test": test},
        "optimizer": {"name": "adam", "weight_decay": 1e-5, "num_epochs": 1,
                      "lr": {"name": "multistep", "base_lr": 1e-4, "gamma": 1.0,
                             "milestones": [1]}},
        "loss": {"name": "AVID", "args": {"num_data": 8, "num_negatives": 4}},
    })


@pytest.mark.parametrize("dtype", [None, "auto", "float32"])
def test_the_spec_reaches_the_pretraining_config_and_preprocessing(tmp_path, dtype):
    pcfg = builders.pretrain_config(_pretrain_cfg(tmp_path, dtype))
    want = "auto" if dtype is None else dtype
    assert pcfg.model_dtype == pcfg.preprocess().model_dtype == want
    db = _pretrain_cfg(tmp_path, dtype).dataset
    assert builders.build_preprocess_config(db, dtype).model_dtype == want
    assert builders.build_preprocess_config(db).model_dtype == "auto"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("transform", ["msc+color", "crop+color"])
def test_preprocessing_emits_the_model_dtype(train, transform):
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.integers(0, 255, (2, 2, 40, 48, 3), dtype=np.uint8)),
             "audio": torch.from_numpy(rng.standard_normal((2, 12000)).astype(np.float32))}
    for spec in ("auto", "float32"):
        cfg = PreprocessConfig(transform=transform, crop_size=32, resize=(36, 40),
                               audio_clip_duration=0.5, model_dtype=spec)
        out = preprocess_batch(batch, cfg, torch.Generator().manual_seed(1), train=train)
        assert out["frames"].dtype == torch.float32 and out["audio"].dtype == torch.float32
    cfg = PreprocessConfig(transform=transform, crop_size=32, resize=(36, 40),
                           audio_clip_duration=0.5, model_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bfloat16 on the CPU"):
        preprocess_batch(batch, cfg, torch.Generator().manual_seed(1), train=train)


def test_the_spec_reaches_every_convolution():
    model = av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10}, proj_dim=[64, 32],
                       device="cpu", dtype="float32")
    layers = [m for m in model.modules() if isinstance(m, (Conv3D, Conv2DLayer, BatchNorm))]
    assert len(layers) > 40 and {m.dtype for m in layers} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(NotImplementedError, match="bfloat16 on the CPU"):
        av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10}, proj_dim=[64, 32],
                   device="cpu", dtype="bfloat16")


def test_eval_backbone_follows_the_spec(tmp_path):
    model_cfg = config_lib.from_dict({"model": {"name": "none", "model_dir": str(tmp_path),
                                                "dtype": "float32", "args": MODEL_ARGS}}).model
    backbone, source = eval_loop.load_backbone(model_cfg, torch.device("cpu"))
    assert source is None and backbone.conv1[0].dtype == torch.float32
    model_cfg["dtype"] = "bfloat16"
    with pytest.raises(NotImplementedError, match="bfloat16 on the CPU"):
        eval_loop.load_backbone(model_cfg, torch.device("cpu"))


def test_pretraining_entry_point_raises_for_bf16_on_the_cpu(tmp_path):
    with pytest.raises(NotImplementedError, match="bfloat16 on the CPU"):
        run_pretraining(_pretrain_cfg(tmp_path, "bfloat16"), device="cpu")
