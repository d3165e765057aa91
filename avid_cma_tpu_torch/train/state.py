"""Train state (counterpart of avid_cma_tpu/train/state.py).

Where the JAX package threads one immutable pytree through a jitted step,
the port keeps the same pieces in one mutable object: the model (params
and BN running stats), the optimizer and its schedule, the banks, the
generator every random draw of a step comes from, and the global step
and epoch the loop has reached. For AVID-CMA the banks carry the mined
positive set (``CMAState``); the eval runs (finetune, probe) have none.

``layout`` records how the banks are held (``parallel.sharding.
BankLayout``, the counterpart of ``bank_state_specs``,
avid_cma_tpu/train/step.py:94-107): over which ranks, and replicated
(each rank the full N rows) or row-sharded (each rank its n_local rows
and the zero sentinel row). None is one process with replicated banks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.criterions.avid_cma import CMAState
from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.sharding import BankLayout


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    bank: Optional[Union[BankState, CMAState]]  # CMAState for AVID-CMA; None to evaluate
    generator: torch.Generator
    step: int = 0
    epoch: int = 0
    layout: Optional[BankLayout] = None

    @property
    def world(self) -> World:
        return self.layout.world if self.layout is not None else World()
