"""Collectives of the port's training (counterpart of the training part of
avid_cma_tpu/parallel/multihost.py).

The JAX package assembles global arrays from each process's rows
(``global_batch``, ``distribute_tree``); in the port each rank already
holds its own rows, so what remains are the collectives themselves. Every
function takes the caller's ``World``: in a world of one process without
a group it is the identity (its result is its input, or a copy); with a
group it runs on the world's device (NCCL on CUDA, gloo on the CPU),
also at size 1. Tensors travel flat, which both backends take.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from avid_cma_tpu_torch.parallel.mesh import World


def all_reduce_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor when a group is up)."""
    if not world.distributed:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out.view(-1))
    return out


def all_reduce_mean_(tensors: Iterable[torch.Tensor], world: World) -> None:
    """Average each tensor over the ranks, in place: one flat all_reduce
    per dtype, then a division by the world's size (as ``pmean``)."""
    if not world.distributed:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= world.size
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather(t: torch.Tensor, world: World) -> torch.Tensor:
    """The ranks' ``t`` stacked rank-major along dim 0:
    (size * t.shape[0], ...), as ``all_gather(tiled=True)``."""
    if not world.distributed:
        return t
    t = t.contiguous()
    out = torch.empty((world.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.view(-1))
    return out


def reduce_scatter(t: torch.Tensor, world: World) -> torch.Tensor:
    """``t`` (size * m, ...) summed over the ranks; this rank keeps its
    slot, rows [rank * m, (rank + 1) * m): (m, ...), as
    ``psum_scatter(tiled=True)``."""
    if not world.distributed:
        return t
    t = t.contiguous()
    m = t.shape[0] // world.size
    out = torch.empty((m, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out.view(-1), t.view(-1))
    return out


def barrier(world: World) -> None:
    if world.distributed:
        dist.barrier()


def sync_float(value: float, world: World, reduce: str = "mean") -> float:
    """A host scalar reduced over the ranks (``mean`` or ``sum``; in f64)."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if not world.distributed:
        return float(value)
    t = all_reduce_sum(torch.tensor([float(value)], dtype=torch.float64,
                                    device=world.device), world)
    total = float(t.item())
    return total / world.size if reduce == "mean" else total


def sync_any(flag: bool, world: World) -> bool:
    """True when ``flag`` is set on any rank."""
    return sync_float(float(bool(flag)), world, reduce="sum") > 0


def sync_counts(counts, world: World) -> np.ndarray:
    """The sum over the ranks of a count vector (int64 or f64)."""
    counts = np.asarray(counts)
    if not world.distributed:
        return counts
    dtype = torch.int64 if np.issubdtype(counts.dtype, np.integer) else torch.float64
    t = torch.as_tensor(counts, dtype=dtype).to(world.device)
    return all_reduce_sum(t, world).cpu().numpy()

