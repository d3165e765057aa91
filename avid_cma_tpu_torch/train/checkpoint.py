"""Checkpoints of the port (counterpart of avid_cma_tpu/train/checkpoint.py).

- ``flax_to_port_state``: weights from the JAX package into the port (the
  key mapping of ``flax_to_torch_state`` and the layout transposes of
  avid_cma_tpu/train/checkpoint.py:47-54,139-207).
- ``CheckpointManager``: the loop's own checkpoints, one ``torch.save`` of
  the whole train state per step saved (model, optimizer, scheduler,
  banks and Z, the AVID-CMA positive set, step, epoch, the generator's
  state, the loader's position), each written to a temporary file and moved into place, so a
  crash leaves the previous checkpoint whole. The ``max_to_keep`` newest
  are kept, and milestone copies (the reference's
  ``checkpoint-ep{N}.pth.tar``) always. The banks are saved whole (N
  rows) whatever the run's layout; over several ranks rank 0 writes, and
  on restore each rank keeps its own rows.
- ``export_pth_tar`` and the ``import_*_pth_tar`` functions: the
  reference's ``.pth.tar`` layout (utils/main_utils.py:271-287): model
  keys prefixed ``module.``, the Adam moments indexed in the reference's
  parameter order, ``train_criterion`` holding both banks and
  ``avg_exp_score``. The port's state-dict keys are the reference's, so
  no key mapping is needed.
- ``import_model_run`` and ``import_criterion_run``: the model, and the
  banks and Z, from the newest checkpoint of one of the port's own runs
  (the AVID -> AVID-CMA chain without a ``.pth.tar``; counterparts of the
  JAX package's ``import_model_orbax`` / ``import_criterion_orbax``).
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.criterions.avid_cma import CMAState, cma_state_from_bank
from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import barrier
from avid_cma_tpu_torch.parallel.sharding import shard_bank, unshard_bank
from avid_cma_tpu_torch.train.state import TrainState

_BN_SUFFIX = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def to_torch_weight(k: np.ndarray) -> np.ndarray:
    """flax kernel layout -> PyTorch weight layout."""
    if k.ndim == 5:  # (D, H, W, I, O) -> (O, I, D, H, W)
        return np.transpose(k, (4, 3, 0, 1, 2))
    if k.ndim == 4:  # (H, W, I, O) -> (O, I, H, W)
        return np.transpose(k, (3, 2, 0, 1))
    if k.ndim == 2:  # (I, O) -> (O, I)
        return np.transpose(k, (1, 0))
    return k


def flax_to_port_state(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested dicts of arrays (as
    produced by the JAX AVWrapper) -> the port's state_dict, with the
    reference keys (``video_model.conv1.0.weight``, bare
    ``video_model.conv2x.spt_conv1.weight`` for single-block stages,
    ``audio_model.block1.conv1.weight``, ``video_proj.projection.<i>.*``)."""
    out: Dict[str, torch.Tensor] = {}

    # single-block stages (depth 10) are bare blocks in the reference
    stage_blocks: Dict[str, int] = {}
    for k in variables.get("params", {}).get("video_model", {}):
        m = re.match(r"(conv\dx)_(\d+)$", k)
        if m:
            stage_blocks[m.group(1)] = max(stage_blocks.get(m.group(1), 0),
                                           int(m.group(2)) + 1)

    def emit(key: str, arr: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def leaf_key(prefix: str, leaf: str, arr: np.ndarray) -> None:
        if leaf == "kernel":
            emit(f"{prefix}.weight", to_torch_weight(arr))
        else:
            emit(f"{prefix}.{_BN_SUFFIX[leaf]}", arr)

    def emit_key(path, leaf, arr):
        tower = path[0]
        if tower in ("video_proj", "audio_proj"):
            i = int(path[1].replace("linear", "")) * 2
            suffix = "weight" if leaf == "kernel" else "bias"
            emit(f"{tower}.projection.{i}.{suffix}",
                 to_torch_weight(arr) if leaf == "kernel" else arr)
            return
        rest = path[1:]
        if rest[0] == "conv1":
            emit(f"{tower}.conv1.0.weight", to_torch_weight(arr))
        elif rest[0] == "bn1":
            emit(f"{tower}.conv1.1.{_BN_SUFFIX[leaf]}", arr)
        elif tower == "audio_model":
            leaf_key(f"{tower}.{rest[0]}.{rest[1]}", leaf, arr)
        else:  # video stages conv{2..5}x_<i>
            stage, idx = rest[0].rsplit("_", 1)
            prefix = (f"{tower}.{stage}" if stage_blocks.get(stage, 2) == 1
                      else f"{tower}.{stage}.{idx}")
            leaf_key(f"{prefix}.{rest[1]}", leaf, arr)

    def walk(path, node):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(path + [k], v)
            else:
                emit_key(path, k, np.asarray(v))

    walk([], variables["params"])
    walk([], variables.get("batch_stats", {}))
    return out


def flax_eval_to_port_state(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX eval wrappers' variables (``ClassificationWrapper``,
    ``MOSTModel``) -> the port's eval wrapper state_dict: the backbone
    under ``feature_extractor.`` with ``flax_to_port_state``'s video keys,
    each head's Dense kernel as an (O, I) ``weight`` and its BatchNorm as
    ``weight, bias, running_mean, running_var``
    (``classifier.weight``, ``classifier_conv5x.bn.running_var``)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    backbone = flax_to_port_state({
        "params": {"video_model": params["feature_extractor"]},
        "batch_stats": {"video_model": stats.get("feature_extractor", {})}})
    out = {"feature_extractor." + k.split(".", 1)[1]: v for k, v in backbone.items()}

    def walk(path, node):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(path + [k], v)
            elif k == "kernel":
                out[".".join(path + ["weight"])] = torch.from_numpy(
                    np.array(to_torch_weight(np.asarray(v)), dtype=np.float32))
            else:
                out[".".join(path + [_BN_SUFFIX[k]])] = torch.from_numpy(
                    np.array(v, dtype=np.float32))

    for tree in (params, stats):
        walk([], {k: v for k, v in tree.items() if k != "feature_extractor"})
    return out


# ---------------------------------------------------------------------------
# the reference's .pth.tar layout
# ---------------------------------------------------------------------------

def reference_parameter_order(keys: Iterable[str]) -> List[str]:
    """Sort reference-format PARAMETER keys (buffers excluded) into the
    reference ``model.parameters()`` registration order, the order torch
    optimizers index their per-parameter state by (a copy of
    avid_cma_tpu/train/checkpoint.py:278-320): video_model, audio_model,
    video_proj, audio_proj; stem before stages; within a block the
    attribute order of network_blocks.py:13-51; weight before bias."""
    towers = {"video_model": 0, "audio_model": 1, "video_proj": 2, "audio_proj": 3}
    r2p1d = {"spt_conv1": 0, "spt_bn1": 1, "tmp_conv1": 2, "tmp_bn1": 3,
             "spt_conv2": 4, "spt_bn2": 5, "tmp_conv2": 6, "out_bn": 7, "res_conv": 8}
    basic2d = {"conv1": 0, "bn1": 1, "conv2": 2, "bn2": 3}
    leaf_order = {"weight": 0, "bias": 1}

    def sort_key(key):
        parts = re.sub(r"^module\.", "", key).split(".")
        tower, rest, leaf = parts[0], parts[1:-1], parts[-1]
        if tower in ("video_proj", "audio_proj"):
            return (towers[tower], int(rest[1]), 0, 0, leaf_order[leaf])
        if rest[0] == "conv1":  # stem Sequential: 0 = conv, 1 = BN
            return (towers[tower], 0, int(rest[1]), 0, leaf_order[leaf])
        if tower == "audio_model":  # block<i>.<sub>
            return (towers[tower], int(rest[0][-1]), 0, basic2d[rest[1]], leaf_order[leaf])
        stage = int(rest[0][4])  # conv2x -> 2
        if rest[1].isdigit():
            block, sub = int(rest[1]), rest[2]
        else:
            block, sub = 0, rest[1]  # depth-10 bare block
        return (towers[tower], stage, block, r2p1d[sub], leaf_order[leaf])

    params = [k for k in keys if k.rsplit(".", 1)[-1] in ("weight", "bias")
              and "running_" not in k and "num_batches" not in k]
    return sorted(params, key=sort_key)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


def export_pth_tar(path: str, model: torch.nn.Module, bank: Optional[BankState] = None,
                   epoch: int = 0, optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write a reference-compatible checkpoint {'epoch', 'model',
    'optimizer', 'train_criterion'} (the layout of
    avid_cma_tpu/train/checkpoint.py:354-423; an AVID-CMA state's
    positive set is not written, as there). ``optimizer`` (Adam)
    exports its moments as a torch ``optimizer.state_dict()`` indexed in
    the reference parameter order, so the reference resumes with intact
    moments; parameters Adam has not stepped yet are left out."""
    sd = model.state_dict()
    ckp: Dict[str, Any] = {"epoch": epoch,
                           "model": {f"module.{k}": _cpu(v) for k, v in sd.items()}}
    if optimizer is not None:
        if not isinstance(optimizer, torch.optim.Adam):
            raise ValueError("only Adam moments can be exported to the reference layout")
        params = dict(model.named_parameters())
        order = reference_parameter_order(sd.keys())
        group = optimizer.param_groups[0]
        state = {}
        for i, key in enumerate(order):
            st = optimizer.state.get(params[key])
            if st:
                state[i] = {"step": torch.tensor(float(st["step"])),
                            "exp_avg": _cpu(st["exp_avg"]),
                            "exp_avg_sq": _cpu(st["exp_avg_sq"])}
        ckp["optimizer"] = {
            "state": state,
            "param_groups": [{
                "lr": float(group["lr"]), "betas": tuple(group["betas"]),
                "eps": float(group["eps"]), "weight_decay": float(group["weight_decay"]),
                "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
                "differentiable": False, "fused": None, "params": list(range(len(order))),
            }],
        }
    if bank is not None:
        ckp["train_criterion"] = {
            "nce_average.view1_mem": _cpu(bank.view1_mem),
            "nce_average.view2_mem": _cpu(bank.view2_mem),
            "criterion.avg_exp_score": torch.tensor(float(bank.z)),
        }
    _atomic_save(ckp, path)


def _load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def import_model_pth_tar(path: str) -> Dict[str, torch.Tensor]:
    """A reference pretrain checkpoint's model -> the port's state_dict
    (``module.`` stripped, ``num_batches_tracked`` dropped; reference
    loader: utils/eval_utils.py:337-339)."""
    ckp = _load(path)
    sd = ckp["model"] if "model" in ckp else ckp
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def import_criterion_pth_tar(path: str, device: str | torch.device = "cpu") -> BankState:
    """Banks and the frozen Z from a reference checkpoint's
    train_criterion (criterions/avid_cma.py:308-319: Z is the mean over
    every avg_exp_score buffer; -1 when there is none)."""
    crit = _load(path)["train_criterion"]
    zs = [float(v) for k, v in crit.items() if "avg_exp_score" in k]
    dev = torch.device(device)
    return BankState(
        view1_mem=crit["nce_average.view1_mem"].to(dev, torch.float32),
        view2_mem=crit["nce_average.view2_mem"].to(dev, torch.float32),
        z=torch.tensor(float(np.mean(zs)) if zs else -1.0, dtype=torch.float32, device=dev))


def import_optimizer_pth_tar(path: str, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """A reference checkpoint's ``optimizer`` section -> the Adam moments
    of ``optimizer`` over ``model``'s parameters (inverse of
    ``export_pth_tar``; reference resume: utils/main_utils.py:290-300).
    Parameters the checkpoint lacks keep the state they have."""
    ckp = _load(path)
    if "optimizer" not in ckp:
        raise KeyError(f"{path} has no optimizer section")
    saved = ckp["optimizer"]["state"]
    params = dict(model.named_parameters())
    for i, key in enumerate(reference_parameter_order(model.state_dict().keys())):
        st = saved.get(i, saved.get(str(i)))
        if st is None:
            continue
        p = params[key]
        optimizer.state[p] = {
            "step": torch.tensor(float(st["step"]), dtype=torch.float32),
            "exp_avg": st["exp_avg"].to(p.device, p.dtype).clone(),
            "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype).clone(),
        }


# ---------------------------------------------------------------------------
# the loop's own checkpoints
# ---------------------------------------------------------------------------

def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def state_payload(state: TrainState, loader_position: Dict[str, int]) -> Dict[str, Any]:
    """Everything a resume needs, as one ``torch.save``-able dict (an
    eval run's state has no banks). The banks (and the positive set) are
    the full N rows whatever the layout: under a sharded one this is a
    collective, which every rank must call."""
    bank = None
    if state.bank is not None:
        full = unshard_bank(state.bank, state.layout) if state.layout else state.bank
        bank = {"view1_mem": full.view1_mem, "view2_mem": full.view2_mem, "z": full.z}
        if isinstance(full, CMAState):
            bank["positive_set"] = full.positive_set
    return {
        "step": int(state.step), "epoch": int(state.epoch),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "bank": bank,
        "generator": state.generator.get_state(),
        "loader": dict(loader_position),
    }


def load_payload(state: TrainState, payload: Dict[str, Any]) -> Dict[str, int]:
    """Restore ``state`` in place from ``state_payload``'s dict; returns
    the loader's position. An AVID-CMA state needs the payload's
    positive set. Each rank keeps its own rows of the full banks, so a
    checkpoint resumes at any world size, sharded or replicated."""
    bank = payload["bank"]
    if (state.bank is None) != (bank is None):
        raise KeyError("the checkpoint's banks do not match the state's: "
                       f"state {type(state.bank).__name__}, checkpoint "
                       f"{'none' if bank is None else 'banks'}")
    if isinstance(state.bank, CMAState) and "positive_set" not in bank:
        raise KeyError("the checkpoint holds no positive set: it is not an AVID-CMA run's")
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    if bank is not None:
        dev = state.bank.view1_mem.device
        restored = BankState(view1_mem=bank["view1_mem"].to(dev),
                             view2_mem=bank["view2_mem"].to(dev), z=bank["z"].to(dev))
        if isinstance(state.bank, CMAState):
            restored = cma_state_from_bank(restored, bank["positive_set"])
        if state.layout is not None:
            if restored.view1_mem.shape[0] != state.layout.n:
                raise ValueError(f"the checkpoint's banks have {restored.view1_mem.shape[0]} "
                                 f"rows; this run's have {state.layout.n}")
            restored = shard_bank(restored, state.layout)
        state.bank = restored
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    state.epoch = int(payload["epoch"])
    return dict(payload["loader"])


def _saved_steps(directory: str) -> List[int]:
    """The steps of the ``ckpt-<step>.pt`` files in ``directory``, ascending."""
    return sorted(int(m.group(1)) for m in (re.fullmatch(r"ckpt-(\d+)\.pt", name)
                                            for name in os.listdir(directory)) if m)


class CheckpointManager:
    """The loop's checkpoints in ``directory``: ``ckpt-<step>.pt`` files
    (reference analogue: utils/main_utils.py:265-323). Saves are
    synchronous and atomic. Milestone steps (the reference's
    permanently kept ``checkpoint-ep{N}.pth.tar`` copies,
    main-avid.py:126-127) are exempt from the ``max_to_keep`` cleanup and
    listed in ``milestones.txt``, so they survive restarts. Over several
    ranks (``world``) every rank calls ``save``, rank 0 alone writes
    (avid_cma_tpu/train/checkpoint.py:540-570), and all wait for it."""

    def __init__(self, directory: str, max_to_keep: int = 3, world: World = World()):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.world = world
        os.makedirs(self.directory, exist_ok=True)
        self._milestones_path = os.path.join(self.directory, "milestones.txt")
        self._milestones = set()
        if os.path.isfile(self._milestones_path):
            with open(self._milestones_path) as f:
                self._milestones = {int(x) for x in f.read().split()}

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{int(step):09d}.pt")

    def all_steps(self) -> List[int]:
        return _saved_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, loader_position: Dict[str, int],
             milestone: bool = False) -> bool:
        """Write the checkpoint of ``step`` unless it exists (a
        mid-epoch save landing on the epoch's end); returns whether it
        wrote. Every rank checks before any writes, and none returns
        before rank 0 has written, so all ranks take the same branch."""
        main = self.world.is_main
        if main and milestone and int(step) not in self._milestones:
            self._milestones.add(int(step))
            tmp = self._milestones_path + ".tmp"
            with open(tmp, "w") as f:
                f.write("\n".join(str(s) for s in sorted(self._milestones)))
            os.replace(tmp, self._milestones_path)
        if os.path.exists(self.path(step)):
            return False
        payload = state_payload(state, loader_position)
        if main:
            _atomic_save(payload, self.path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                if old not in self._milestones:
                    os.remove(self.path(old))
        barrier(self.world)
        return True

    def restore(self, state: TrainState, step: Optional[int] = None) -> Dict[str, int]:
        """Restore ``state`` in place from ``step`` (default: the latest);
        returns the loader's position {epoch, batch}."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        # on the CPU: load_state_dict moves each tensor where it belongs,
        # and Adam's step counts and the generator's state must stay there
        payload = torch.load(self.path(step), map_location="cpu", weights_only=False)
        return load_payload(state, payload)


# ---------------------------------------------------------------------------
# warm starts from the port's own runs
# ---------------------------------------------------------------------------

def latest_run_payload(path: str) -> Dict[str, Any]:
    """The newest checkpoint's payload under a port run's directory
    (``<model_dir>/<name>``) or its ``checkpoints/``."""
    directory = os.path.join(path, "checkpoints")
    if not os.path.isdir(directory):
        directory = path
    steps = _saved_steps(directory) if os.path.isdir(directory) else []
    if not steps:
        raise FileNotFoundError(f"no checkpoint of a port run (ckpt-*.pt) under {path}")
    return torch.load(os.path.join(directory, f"ckpt-{steps[-1]:09d}.pt"),
                      map_location="cpu", weights_only=False)


def import_model_run(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a port run's newest checkpoint (the model
    half of the AVID -> AVID-CMA chain)."""
    return latest_run_payload(path)["model"]


def import_criterion_run(path: str, device: str | torch.device = "cpu") -> BankState:
    """The banks and the frozen Z of a port run's newest checkpoint (no
    positive set: the AVID-CMA run mines its own)."""
    bank = latest_run_payload(path)["bank"]
    dev = torch.device(device)
    return BankState(view1_mem=bank["view1_mem"].to(dev, torch.float32),
                     view2_mem=bank["view2_mem"].to(dev, torch.float32),
                     z=bank["z"].to(dev, torch.float32))
