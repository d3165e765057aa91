"""Optimizer and LR schedule (counterpart of avid_cma_tpu/train/optim.py).

Adam or SGD with *coupled* weight decay (wd * param added to the gradient
before the moment updates) -- which is what ``torch.optim`` does, and what
the JAX package builds from optax -- and a MultiStepLR stepped once per
epoch. The published pretrain recipes use gamma = 1.0, a constant LR whose
milestones only mark checkpoint copies; that quirk is kept as it is.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch


def build_optimizer(params: Iterable[torch.nn.Parameter], name: str, lr: float,
                    weight_decay: float = 0.0, momentum: float = 0.9,
                    nesterov: bool = False) -> torch.optim.Optimizer:
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               nesterov=nesterov, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer '{name}' (adam|sgd)")


def multistep_scheduler(optimizer: torch.optim.Optimizer, milestones: Sequence[int],
                        gamma: float) -> torch.optim.lr_scheduler.MultiStepLR:
    """MultiStepLR over epochs: call ``step()`` once per epoch."""
    return torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=list(milestones), gamma=gamma)


def build_from_config(opt_cfg, params: Iterable[torch.nn.Parameter]
                      ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.MultiStepLR]:
    """(optimizer, scheduler) over ``params`` from a YAML ``optimizer:``
    block (avid_cma_tpu/train/optim.py:58-77): name, weight_decay,
    momentum, nesterov, and lr {name: multistep, base_lr, gamma,
    milestones}; the scheduler is stepped once per epoch."""
    lr_cfg = opt_cfg["lr"]
    if lr_cfg.get("name", "multistep") != "multistep":
        raise ValueError(f"unknown lr schedule '{lr_cfg.get('name')}'")
    optimizer = build_optimizer(
        params, str(opt_cfg["name"]), float(lr_cfg["base_lr"]),
        weight_decay=float(opt_cfg.get("weight_decay", 0.0)),
        momentum=float(opt_cfg.get("momentum", 0.9)),
        nesterov=bool(opt_cfg.get("nesterov", False)))
    scheduler = multistep_scheduler(optimizer, [int(m) for m in lr_cfg.get("milestones", [])],
                                    float(lr_cfg.get("gamma", 1.0)))
    return optimizer, scheduler
