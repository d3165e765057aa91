"""Negative sampling (counterpart of avid_cma_tpu/ops/sampling.py: the
self-avoiding uniform draw of AVID and the rank-shift draw past a sorted
positive set of AVID-CMA; the alias sampler is not ported, since the
reference uses it with uniform weights only)."""

from __future__ import annotations

import torch


def draw_negatives_uniform(y: torch.Tensor, num_negatives: int,
                           memory_size: int,
                           generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform negatives over [0, memory_size) avoiding the self index:
    draw from memory_size - 1 choices, then shift draws >= y up by one.
    y (B,) int64 -> (B, num_negatives) int64 on y's device."""
    idx = torch.randint(0, memory_size - 1, (y.shape[0], num_negatives),
                        generator=generator, device=y.device)
    return idx + (idx >= y[:, None]).to(idx.dtype)


def rank_shift(rand: torch.Tensor, pos_sorted: torch.Tensor) -> torch.Tensor:
    """Map draws ``rand`` (B, K) from [0, N - pos_k) onto [0, N) minus
    each row's positives ``pos_sorted`` (B, pos_k), sorted ascending: with
    ref[j] = pos_sorted[j] - j, each draw moves up by the number of j with
    draw >= ref[j]. The same comparison sum as the JAX function, so any
    input (also an unsorted one) gives its integers. int64 out."""
    pos_k = pos_sorted.shape[1]
    ref = pos_sorted.long() - torch.arange(pos_k, device=pos_sorted.device)[None, :]
    rand = rand.long()
    return rand + (rand[:, :, None] >= ref[:, None, :]).sum(dim=2)


def draw_negatives_avoid_sorted(pos_sorted: torch.Tensor, num_negatives: int,
                                memory_size: int,
                                generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform negatives over [0, memory_size) excluding each row's sorted
    positive set (B, pos_k): draw from memory_size - pos_k choices, then
    ``rank_shift``. Like the JAX function (and the reference,
    criterions/avid_cma.py:196-209) it excludes the positives, not the
    self index. (B, num_negatives) int64 on the positives' device."""
    bsz, pos_k = pos_sorted.shape
    rand = torch.randint(0, memory_size - pos_k, (bsz, num_negatives),
                         generator=generator, device=pos_sorted.device)
    return rank_shift(rand, pos_sorted)
