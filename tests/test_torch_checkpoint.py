"""The port's checkpoints (avid_cma_tpu_torch/train/checkpoint.py) against
the JAX package's: JAX ``export_pth_tar`` of flax weights, Adam moments
and banks, and the port's ``export_pth_tar`` of the same values carried
over by ``flax_to_port_state``, write the same keys, shapes and values;
the port's ``import_*_pth_tar`` read both files back bit for bit; and the
``CheckpointManager`` round trip, retention and milestones; an AVID-CMA
state's positive set through the manager (and its absence from an AVID
checkpoint refused), the AVID -> AVID-CMA warm start from a port run's
directory (``import_model_run`` / ``import_criterion_run``, which raise
naming a path that holds no checkpoint), and a CMA state's ``.pth.tar``
equal to the JAX package's, without the positive set."""

import numpy as np
import pytest
import torch

from avid_cma_tpu.criterions.avid import BankState as JaxBankState
from avid_cma_tpu.train.checkpoint import export_pth_tar as jax_export_pth_tar
from avid_cma_tpu.train.checkpoint import torch_state_to_flax
from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.criterions.avid_cma import CMAState, cma_state_from_bank
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_pth_tar,
    flax_to_port_state,
    import_criterion_pth_tar,
    import_criterion_run,
    import_model_pth_tar,
    import_model_run,
    import_optimizer_pth_tar,
)
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from tests.test_torch_models import torch_threads_per_worker  # noqa: F401  (autouse fixture)

LR, WD, N, D = 2e-4, 1e-5, 12, 16


def _model(seed):
    return av_wrapper("R2Plus1D", {"depth": 10}, "Conv2D", {"depth": 10},
                      proj_dim=[32, D], seed=seed, device="cpu")


def _flax_tree(rng, model):
    """Random flax variables shaped like the model's (through the JAX
    package's own torch -> flax mapping)."""
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
          for k, v in model.state_dict().items()}
    return torch_state_to_flax(sd)


def _equal(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_export_matches_jax_and_imports_read_both(tmp_path):
    rng = np.random.default_rng(0)
    template = _model(0)
    variables = _flax_tree(rng, template)
    mu = _flax_tree(rng, template)["params"]
    nu = _flax_tree(rng, template)["params"]
    banks = rng.standard_normal((2, N, D)).astype(np.float32)
    jax_bank = JaxBankState(view1_mem=banks[0], view2_mem=banks[1], z=np.float32(3.25))
    jax_path = str(tmp_path / "jax.pth.tar")
    jax_export_pth_tar(variables, jax_path, bank=jax_bank, epoch=4,
                       opt_state={"count": np.int32(7), "mu": mu, "nu": nu},
                       opt_hparams={"lr": LR, "weight_decay": WD})

    model = _model(1)
    model.load_state_dict(flax_to_port_state(variables), strict=True)
    opt = build_optimizer(model.parameters(), "adam", LR, weight_decay=WD)
    mu_t, nu_t = flax_to_port_state({"params": mu}), flax_to_port_state({"params": nu})
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(7.0), "exp_avg": mu_t[name].clone(),
                        "exp_avg_sq": nu_t[name].clone()}
    bank = BankState(torch.from_numpy(banks[0]), torch.from_numpy(banks[1]),
                     torch.tensor(3.25))
    port_path = str(tmp_path / "port.pth.tar")
    export_pth_tar(port_path, model, bank=bank, epoch=4, optimizer=opt)

    ref = torch.load(jax_path, weights_only=False)
    got = torch.load(port_path, weights_only=False)
    assert sorted(got) == sorted(ref) == ["epoch", "model", "optimizer", "train_criterion"]
    _equal(got["model"], ref["model"], "model")
    _equal(got["train_criterion"], ref["train_criterion"], "train_criterion")
    _equal(got["optimizer"]["state"], ref["optimizer"]["state"], "optimizer/state")
    _equal(got["optimizer"]["param_groups"], ref["optimizer"]["param_groups"], "param_groups")
    assert got["epoch"] == ref["epoch"] == 4

    for path in (jax_path, port_path):
        fresh = _model(2)
        fresh.load_state_dict(import_model_pth_tar(path), strict=True)
        _equal(fresh.state_dict(), model.state_dict(), f"{path} model")
        b = import_criterion_pth_tar(path)
        assert torch.equal(b.view1_mem, bank.view1_mem) and torch.equal(b.view2_mem, bank.view2_mem)
        assert float(b.z) == 3.25
        fresh_opt = build_optimizer(fresh.parameters(), "adam", LR, weight_decay=WD)
        import_optimizer_pth_tar(path, fresh, fresh_opt)
        params = dict(fresh.named_parameters())
        for name, p in model.named_parameters():
            _equal(fresh_opt.state[params[name]], opt.state[p], f"{path} adam {name}")


def _state(seed):
    model = _model(seed)
    opt = build_optimizer(model.parameters(), "adam", LR, weight_decay=WD)
    gen = torch.Generator().manual_seed(seed)
    bank = BankState(torch.randn(N, D, generator=gen), torch.randn(N, D, generator=gen),
                     torch.tensor(-1.0))
    return TrainState(model, opt, multistep_scheduler(opt, [1], 0.5), bank, gen)


def test_manager_round_trip_retention_and_milestones(tmp_path):
    a = _state(0)
    # one optimizer step so Adam has moments, one scheduler step
    loss = sum(p.sum() for p in a.model.parameters())
    loss.backward()
    a.optimizer.step()
    a.scheduler.step()
    a.step, a.epoch = 5, 1
    torch.rand(3, generator=a.generator)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.save(5, a, {"epoch": 1, "batch": 2}, milestone=True)
    assert not mgr.save(5, a, {"epoch": 1, "batch": 2})  # already written
    for step in (6, 7, 8):
        mgr.save(step, a, {"epoch": 1, "batch": 0})
    assert mgr.all_steps() == [5, 7, 8]  # two newest + the milestone
    assert CheckpointManager(str(tmp_path)).latest_step() == 8
    assert not list(tmp_path.glob("*.tmp"))

    b = _state(1)
    pos = CheckpointManager(str(tmp_path)).restore(b, step=5)
    assert pos == {"epoch": 1, "batch": 2} and (b.step, b.epoch) == (5, 1)
    _equal(b.model.state_dict(), a.model.state_dict(), "model")
    _equal(b.optimizer.state_dict(), a.optimizer.state_dict(), "optimizer")
    assert b.scheduler.state_dict() == a.scheduler.state_dict()
    assert torch.equal(b.bank.view1_mem, a.bank.view1_mem) and float(b.bank.z) == -1.0
    assert torch.equal(torch.rand(4, generator=b.generator), torch.rand(4, generator=a.generator))


def test_cma_state_round_trip_and_warm_start_from_a_run(tmp_path):
    a = _state(0)
    pos = torch.sort(torch.randint(0, N, (N, 3), generator=torch.Generator().manual_seed(1)),
                     dim=1).values
    a.bank = cma_state_from_bank(a.bank, pos)
    a.bank.z = torch.tensor(2.5)
    run = tmp_path / "run"
    CheckpointManager(str(run / "checkpoints")).save(4, a, {"epoch": 1, "batch": 0})

    # a CMA state restores the positive set; an AVID checkpoint has none
    b = _state(1)
    b.bank = cma_state_from_bank(b.bank, torch.zeros_like(pos))
    CheckpointManager(str(run / "checkpoints")).restore(b)
    assert isinstance(b.bank, CMAState) and torch.equal(b.bank.positive_set, pos)
    avid = _state(2)
    CheckpointManager(str(tmp_path / "avid")).save(1, avid, {"epoch": 0, "batch": 0})
    with pytest.raises(KeyError, match="positive set"):
        CheckpointManager(str(tmp_path / "avid")).restore(b)

    # the AVID -> CMA warm start: the run's directory or its checkpoints/
    for path in (run, run / "checkpoints"):
        bank = import_criterion_run(str(path))
        assert type(bank) is BankState and float(bank.z) == 2.5
        assert torch.equal(bank.view1_mem, a.bank.view1_mem)
        assert torch.equal(bank.view2_mem, a.bank.view2_mem)
        _equal(import_model_run(str(path)), a.model.state_dict(), "model")
    (tmp_path / "empty").mkdir()
    for path in (tmp_path / "empty", tmp_path / "missing"):
        with pytest.raises(FileNotFoundError, match=str(path)):
            import_model_run(str(path))
        with pytest.raises(FileNotFoundError, match=str(path)):
            import_criterion_run(str(path))

    # the .pth.tar of a CMA state: banks + Z, no positive set, as the JAX export
    export_pth_tar(str(tmp_path / "port.pth.tar"), a.model, bank=a.bank)
    jax_bank = JaxBankState(view1_mem=a.bank.view1_mem.numpy(),
                            view2_mem=a.bank.view2_mem.numpy(), z=np.float32(2.5))
    jax_export_pth_tar(torch_state_to_flax({k: v.numpy() for k, v in
                                            a.model.state_dict().items()}),
                       str(tmp_path / "jax.pth.tar"), bank=jax_bank)
    got = torch.load(tmp_path / "port.pth.tar", weights_only=False)["train_criterion"]
    _equal(got, torch.load(tmp_path / "jax.pth.tar", weights_only=False)["train_criterion"],
           "train_criterion")
