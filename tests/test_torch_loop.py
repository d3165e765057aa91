"""The port's pretraining loop and entry point (avid_cma_tpu_torch/train/
loop.py, cli.py, main_avid_torch.py) on the CPU at a small size (4 frames
at 32^2, depth 10, 16 synthetic clips, batch 8): two epochs straight
equal one epoch plus a resume, and a mid-epoch resume equals the straight
run, bit for bit (weights, Adam state, banks, Z, step); a profile_steps
window writes its trace; what is not ported raises naming its ROADMAP
item; the entry script raises without a card unless --device cpu is
given."""

import pathlib
import runpy
import shutil

import pytest
import torch

from avid_cma_tpu_torch.config import from_dict
from avid_cma_tpu_torch.train.loop import run_pretraining

REPO = pathlib.Path(__file__).resolve().parents[1]


def _cfg(model_dir, epochs, **top):
    cfg = {
        "seed": 0, "num_workers": 1, "print_freq": 1, "log2tb": False, "resume": False,
        "test_freq": 1,
        "dataset": {
            "name": "kinetics", "backend": "synthetic", "synthetic_size": 16,
            "batch_size": 8, "video_clip_duration": 0.5, "video_fps": 8.0,
            "decode_size": [40, 48], "crop_size": 32, "audio_clip_duration": 0.5,
            "audio_fps": 24000, "spectrogram_fps": 100.0, "n_fft": 512,
            "train": {"split": "train", "use_augmentation": True, "drop_last": True},
            "test": {"split": "val", "use_augmentation": False, "drop_last": True},
        },
        "optimizer": {"name": "adam", "weight_decay": 1e-5, "num_epochs": epochs,
                      "lr": {"name": "multistep", "base_lr": 2e-4, "gamma": 0.5,
                             "milestones": [1]}},
        "model": {"name": "loop", "model_dir": str(model_dir), "arch": "av_wrapper",
                  "args": {"proj_dim": [64, 32], "video_backbone": "R2Plus1D",
                           "video_backbone_args": {"depth": 10},
                           "audio_backbone": "Conv2D", "audio_backbone_args": {"depth": 10}}},
        "loss": {"name": "AVID", "args": {"num_data": 16, "num_negatives": 8,
                                          "momentum": 0.5, "xModal_coeff": 1.0,
                                          "wModal_coeff": 0.0}},
    }
    cfg.update(top)
    return from_dict(cfg)


def _same_state(a, b):
    assert (a.step, a.epoch) == (b.step, b.epoch)
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert torch.equal(a.bank.view1_mem, b.bank.view1_mem)
    assert torch.equal(a.bank.view2_mem, b.bank.view2_mem)
    assert torch.equal(a.bank.z, b.bank.z)


def test_resumed_runs_equal_the_straight_run(tmp_path):
    epochs = []
    straight = run_pretraining(_cfg(tmp_path / "a", 2, save_freq_steps=1, profile_steps=[1, 3]),
                               device="cpu", on_epoch=epochs.append)
    assert straight.step == 4 and straight.epoch == 2
    assert [e["steps"] for e in epochs] == [2, 2] and [e["clips"] for e in epochs] == [16, 16]
    assert all(e["test_loss"] is not None and e["test_loss"] == e["test_loss"] for e in epochs)
    assert float(straight.bank.z) > 0
    assert straight.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)  # one milestone
    ckpts = tmp_path / "a" / "loop" / "checkpoints"
    assert sorted(p.name for p in ckpts.glob("ckpt-*.pt")) == [
        f"ckpt-{s:09d}.pt" for s in (2, 3, 4)]
    assert (tmp_path / "a" / "loop" / "config.yaml").is_file()
    assert (tmp_path / "a" / "loop" / "profile" / "trace_steps_1_3.json").is_file()

    # one epoch, then a resume for the second
    run_pretraining(_cfg(tmp_path / "b", 1), device="cpu")
    resumed = run_pretraining(_cfg(tmp_path / "b", 2, resume=True), device="cpu")
    _same_state(resumed, straight)

    # mid-epoch: the checkpoint of step 3 (epoch 1, one batch in)
    mid = tmp_path / "c" / "loop" / "checkpoints"
    mid.mkdir(parents=True)
    shutil.copy(ckpts / "ckpt-000000003.pt", mid)
    resumed_mid = run_pretraining(_cfg(tmp_path / "c", 2, resume=True), device="cpu")
    _same_state(resumed_mid, straight)


@pytest.mark.parametrize("name", ["AVID-CMA", "AVID_CMA"])
def test_cma_raises_naming_a5(tmp_path, name):
    cfg = _cfg(tmp_path, 1)
    cfg.loss["name"] = name
    with pytest.raises(NotImplementedError, match="A5"):
        run_pretraining(cfg, device="cpu")
    cfg = _cfg(tmp_path, 1)
    cfg.loss["bank_sharding"] = "sharded"
    with pytest.raises(NotImplementedError, match="A6"):
        run_pretraining(cfg, device="cpu")


def test_model_dtype_float32_on_the_card_raises():
    from avid_cma_tpu_torch.train.builders import check_model_dtype

    with pytest.raises(NotImplementedError, match="model.dtype"):
        check_model_dtype("float32", "cuda")
    with pytest.raises(ValueError, match="model.dtype"):
        check_model_dtype("float16", "cpu")
    for spec in (None, "auto", "float32"):
        check_model_dtype(spec, "cpu")
    for spec in ("auto", "bfloat16"):
        check_model_dtype(spec, "cuda")


def test_entry_script_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry script would run on it")
    monkeypatch.setattr("sys.argv", ["main_avid_torch.py",
                                     str(REPO / "configs/smoke/avid-synthetic.yaml"), "--debug"])
    with pytest.raises(RuntimeError, match="cuda"):
        runpy.run_path(str(REPO / "main_avid_torch.py"), run_name="__main__")
