"""Adaptive max pooling for the probe heads, from the configs' strings
(counterpart of avid_cma_tpu/ops/pooling.py).

The eval configs name torch pooling ops by string, e.g.
"AdaptiveMaxPool3d((1, 12, 12))" (configs/benchmark/kinetics/
8x224x224-linear.yaml ``pooling_ops``). Output bin i of an axis of size n
pooled to o covers [floor(i*n/o), ceil((i+1)*n/o)): ``adaptive_max_pool3d``
and ``adaptive_max_pool2d`` have the same bins, so they run on the
channels-first view of the channels-last maps.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_POOL_RE = re.compile(r"AdaptiveMaxPool(\d)d\(\((.*?)\)\)")


def parse_pooling_op(spec: Optional[str]) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(ndim, out_size) of a config pooling string, None for None; raises
    for anything else than AdaptiveMaxPool{2,3}d((...))."""
    if spec is None:
        return None
    m = _POOL_RE.match(spec.replace(" ", ""))
    if not m:
        raise ValueError(f"unsupported pooling op {spec!r}")
    ndim = int(m.group(1))
    sizes = tuple(int(s) for s in m.group(2).split(",") if s)
    if ndim not in (2, 3) or len(sizes) != ndim:
        raise ValueError(f"unsupported pooling op {spec!r}")
    return ndim, sizes


def pooled_shape(shape: Tuple[int, ...], spec: Optional[str]) -> Tuple[int, ...]:
    """The shape ``apply_pooling_op`` gives a map of ``shape`` (batch axis
    excluded): the pooled axes take the op's sizes."""
    parsed = parse_pooling_op(spec)
    if parsed is None:
        return tuple(shape)
    ndim, sizes = parsed
    if len(shape) != ndim + 1:
        raise ValueError(f"{spec!r} pools {ndim} axes; the map has shape {tuple(shape)}")
    return (*sizes, shape[-1])


def apply_pooling_op(x: torch.Tensor, spec: Optional[str]) -> torch.Tensor:
    """Apply a config pooling string to a channels-last map: 3d ->
    (B, T, H, W, C), 2d -> (B, H, W, C). Returns a channels-last map."""
    parsed = parse_pooling_op(spec)
    if parsed is None:
        return x
    ndim, sizes = parsed
    if x.dim() != ndim + 2:
        raise ValueError(f"{spec!r} takes a {ndim + 2}-d channels-last map, got {tuple(x.shape)}")
    pool = F.adaptive_max_pool3d if ndim == 3 else F.adaptive_max_pool2d
    cf = x.movedim(-1, 1)  # the channels-first view of the same memory
    return pool(cf, sizes).movedim(1, -1)
