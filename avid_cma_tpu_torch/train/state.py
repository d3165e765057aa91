"""Train state (counterpart of avid_cma_tpu/train/state.py, one device).

Where the JAX package threads one immutable pytree through a jitted step,
the port keeps the same pieces in one mutable object: the model (params
and BN running stats), the optimizer and its schedule, the banks, the
generator every random draw of a step comes from, and the global step
and epoch the loop has reached. For AVID-CMA the banks carry the mined
positive set (``CMAState``); the eval runs (finetune, probe) have none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from avid_cma_tpu_torch.criterions.avid import BankState
from avid_cma_tpu_torch.criterions.avid_cma import CMAState


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    bank: Optional[Union[BankState, CMAState]]  # CMAState for AVID-CMA; None to evaluate
    generator: torch.Generator
    step: int = 0
    epoch: int = 0
