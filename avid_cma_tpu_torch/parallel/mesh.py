"""The process world of a run (counterpart of avid_cma_tpu/parallel/mesh.py).

The JAX package runs one program over a device mesh; the port runs one
process per GPU, launched by ``torchrun``, joined by ``torch.distributed``:
NCCL for CUDA tensors, gloo for CPU tensors (a CUDA tensor never goes
through gloo). ``initialize`` brings the group up from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or from an explicit rank, size and store; any failure
raises, so a run that asked for a world never degrades into independent
single-process runs. ``current_world`` describes the process the caller
runs in: the group's rank and size when a group is up, else the world of
one process, whose collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from avid_cma_tpu_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in a run: ``rank`` of ``size`` ranks on
    ``device``. ``distributed``: a process group is up, and every
    collective goes through it, also at size 1; otherwise the world is
    one process and its collectives are the identity."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def initialize(device: str | torch.device = "cuda", rank: Optional[int] = None,
               world_size: Optional[int] = None,
               store: Optional[dist.Store] = None) -> World:
    """Start the default process group and return this process's world.

    Without ``rank``/``world_size``/``store``, from torchrun's
    environment: all of ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` must be set. With them (tests),
    from the given store. On CUDA the process takes ``cuda:LOCAL_RANK``
    (``cuda:rank`` with an explicit store) and NCCL; on the CPU, gloo.
    Raises on a missing variable, an unknown device or any failure of
    ``init_process_group``."""
    dev = resolve_device(device)
    explicit = (rank, world_size, store)
    if any(v is not None for v in explicit) and not all(v is not None for v in explicit):
        raise ValueError("pass rank, world_size and store together, or none of them")
    if store is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"multi-process run requested (--multihost) but {', '.join(missing)} "
                "is not set: launch with torchrun --nproc-per-node=<gpus> "
                "main_avid_torch.py <cfg> --multihost")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
    else:
        local_rank = rank
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    kwargs = {"init_method": "env://"} if store is None else {"store": store}
    try:
        dist.init_process_group(BACKENDS[dev.type], rank=rank, world_size=world_size,
                                **kwargs)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"process group initialization failed for an explicitly requested "
            f"multi-process run (rank {rank} of {world_size}): {e}") from e
    # the collectives this port uses exist in every torch it runs on; the
    # newer names the warning suggests may not
    warnings.filterwarnings("ignore", message=r".*(reduce_scatter_tensor|"
                            r"all_gather_into_tensor).*deprecated", category=FutureWarning)
    return World(rank=rank, size=world_size, device=dev, distributed=True)


def current_world(device: str | torch.device = "cuda") -> World:
    """The world this process runs in: the default group's rank and size
    when one is up (on CUDA, the device ``initialize`` set), else one
    process on ``device``. Raises when the environment says more than one
    process (``WORLD_SIZE`` > 1) but no group is up: each would train
    alone and clobber the others' checkpoints."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        want = BACKENDS[dev.type]
        if dist.get_backend() != want:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but "
                               f"{dev.type} tensors need {want}")
        return World(rank=dist.get_rank(), size=dist.get_world_size(), device=dev,
                     distributed=True)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no process group is up: pass "
            "--multihost to main_avid_torch.py (or call parallel.mesh.initialize)")
    return World(device=dev)


def shutdown() -> None:
    """Destroy the default process group if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_batch_slice(global_batch: int, world: World) -> int:
    """This rank's share of the global batch (the reference divides the
    config's batch over its GPU processes, utils/main_utils.py:128-133)."""
    if global_batch % world.size:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world.size} processes")
    return global_batch // world.size
