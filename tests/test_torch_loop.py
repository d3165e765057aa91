"""The port's pretraining loop and entry point (avid_cma_tpu_torch/train/
loop.py, cli.py, main_avid_torch.py) on the CPU at a small size (4 frames
at 32^2, depth 10, 16 synthetic clips, batch 8): two epochs straight
equal one epoch plus a resume, and a mid-epoch resume equals the straight
run, bit for bit (weights, Adam state, banks, Z, step); a profile_steps
window writes its trace; what is not ported raises naming its ROADMAP
item; the entry script raises without a card unless --device cpu is
given. AVID-CMA (pos_k 4, 8 negatives, 4 within, re-mined every epoch):
a run chained from a tiny AVID run's directory equals one chained from
its exported .pth.tar, with the AVID run's Z; resumed runs equal the
straight run bit for bit, positive set included, at an epoch boundary
that re-mines and mid-epoch."""

import pathlib
import runpy
import shutil

import pytest
import torch

from avid_cma_tpu_torch.config import from_dict
from avid_cma_tpu_torch.train.checkpoint import export_pth_tar
from avid_cma_tpu_torch.train.loop import run_pretraining
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

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


def _cma_cfg(model_dir, epochs, checkpoint=None, **top):
    cfg = _cfg(model_dir, epochs, **top)
    cfg.model["name"] = "cma"
    cfg.loss = from_dict({"name": "AVID_CMA", "args": {
        "num_data": 16, "num_negatives": 8, "num_negatives_within": 4, "momentum": 0.5,
        "xModalInstCoeff": 1.0, "wModalInstCoeff": 0.0, "xModalPosCoeff": 0.0,
        "wModalPosCoeff": 1.0, "resample_freq": 1,
        "sampling_args": {"type": "consensus", "pos_k": 4}}})
    if checkpoint is not None:
        cfg.model["args"]["checkpoint"] = str(checkpoint)
        cfg.loss["args"]["checkpoint"] = str(checkpoint)
    return cfg


def _valid_positive_set(pos, n=16, pos_k=4):
    assert pos.shape == (n, pos_k) and pos.dtype == torch.int64
    assert bool((pos[:, 1:] > pos[:, :-1]).all()) and int(pos.min()) >= 0 and int(pos.max()) < n
    assert not bool((pos == torch.arange(n)[:, None]).any())


def test_cma_chained_from_an_avid_run_and_from_its_pth_tar(tmp_path):
    avid = run_pretraining(_cfg(tmp_path / "avid", 1), device="cpu")
    run_dir = tmp_path / "avid" / "loop"
    export_pth_tar(str(tmp_path / "avid.pth.tar"), avid.model, bank=avid.bank,
                   epoch=avid.epoch, optimizer=avid.optimizer)
    epochs = []
    from_dir = run_pretraining(_cma_cfg(tmp_path / "a", 1, run_dir), device="cpu",
                               on_epoch=epochs.append)
    from_file = run_pretraining(_cma_cfg(tmp_path / "b", 1, tmp_path / "avid.pth.tar"),
                                device="cpu")
    # Z comes back from the AVID run bit for bit and stays frozen
    assert float(avid.bank.z) > 0
    for run in (from_dir, from_file):
        assert torch.equal(run.bank.z, avid.bank.z)
        _valid_positive_set(run.bank.positive_set)
    _same_state(from_dir, from_file)
    assert torch.equal(from_dir.bank.positive_set, from_file.bank.positive_set)
    assert epochs[0]["mine_s"] is not None and epochs[0]["test_loss"] == epochs[0]["test_loss"]
    log = (tmp_path / "a" / "cma" / "train.log").read_text()
    assert f"restored banks from port run {run_dir}" in log and "mining CMA positives" in log
    # the run started from the AVID weights, not from its own seed
    fresh = run_pretraining(_cma_cfg(tmp_path / "c", 1), device="cpu")
    assert not torch.equal(fresh.bank.view1_mem, from_dir.bank.view1_mem)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_pretraining(_cma_cfg(tmp_path / "d", 1, tmp_path / "a"), device="cpu")


def test_cma_resumed_runs_equal_the_straight_run(tmp_path):
    epochs = []
    straight = run_pretraining(_cma_cfg(tmp_path / "a", 2, save_freq_steps=1), device="cpu",
                               on_epoch=epochs.append)
    assert straight.step == 4 and straight.epoch == 2
    # mined before epoch 0, re-mined at the start of epoch 1 (resample_freq 1)
    assert [e["mine_s"] is not None for e in epochs] == [True, True]
    _valid_positive_set(straight.bank.positive_set)
    ckpts = tmp_path / "a" / "cma" / "checkpoints"

    # the epoch boundary: the checkpoint holds the set from before the
    # re-mine; the resumed run re-mines at epoch 1
    run_pretraining(_cma_cfg(tmp_path / "b", 1), device="cpu")
    resumed_epochs = []
    resumed = run_pretraining(_cma_cfg(tmp_path / "b", 2, resume=True), device="cpu",
                              on_epoch=resumed_epochs.append)
    assert [e["mine_s"] is not None for e in resumed_epochs] == [True]
    _same_state(resumed, straight)
    assert torch.equal(resumed.bank.positive_set, straight.bank.positive_set)

    # mid-epoch (step 3: epoch 1, one batch in): the checkpoint's set is kept
    mid = tmp_path / "c" / "cma" / "checkpoints"
    mid.mkdir(parents=True)
    shutil.copy(ckpts / "ckpt-000000003.pt", mid)
    mid_epochs = []
    resumed_mid = run_pretraining(_cma_cfg(tmp_path / "c", 2, resume=True), device="cpu",
                                  on_epoch=mid_epochs.append)
    assert [e["mine_s"] for e in mid_epochs] == [None]
    _same_state(resumed_mid, straight)
    assert torch.equal(resumed_mid.bank.positive_set, straight.bank.positive_set)


def test_approximate_mining_raises_naming_it(tmp_path):
    cfg = _cma_cfg(tmp_path, 1)
    cfg.loss["args"]["sampling_args"]["exact"] = False
    with pytest.raises(NotImplementedError, match="exact: false"):
        run_pretraining(cfg, device="cpu")


def test_model_dtype_float32_on_the_card_raises():
    """float32 on the card no longer raises (K2/K3 have f32 forms); what
    still raises is bfloat16 on the CPU and an unknown spec."""
    from avid_cma_tpu_torch.train.builders import check_model_dtype

    with pytest.raises(NotImplementedError, match="model.dtype"):
        check_model_dtype("bfloat16", "cpu")
    with pytest.raises(ValueError, match="model.dtype"):
        check_model_dtype("float16", "cpu")
    for spec in (None, "auto", "float32"):
        check_model_dtype(spec, "cpu")
    for spec in (None, "auto", "float32", "bfloat16"):
        check_model_dtype(spec, "cuda")


def test_entry_script_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry script would run on it")
    monkeypatch.setattr("sys.argv", ["main_avid_torch.py",
                                     str(REPO / "configs/smoke/avid-synthetic.yaml"), "--debug"])
    with pytest.raises(RuntimeError, match="cuda"):
        runpy.run_path(str(REPO / "main_avid_torch.py"), run_name="__main__")
