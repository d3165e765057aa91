"""Device prefetch: overlap the host->device copy of the next batches with
the device's work on the current one (counterpart of
avid_cma_tpu/data/prefetch.py).

On CUDA each numpy batch is copied into pinned host memory and sent with
``non_blocking`` copies on a side stream, ``depth`` batches ahead of the
consumer. Before a batch is handed out, the current stream waits on the
copy's event, so every launch the step makes after that on the current
stream (PyTorch's and the port's own kernels, which launch on
``torch.cuda.current_stream()``, ``ops/kernels/_lib.stream()``) reads the
batch only once it has landed; ``record_stream`` keeps the caching
allocator from reusing its memory while the current stream may still read
it. On the CPU batches pass through as tensors.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch

Batch = Dict[str, torch.Tensor]


def _to_tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


class _CudaPlacer:
    """Pinned host copies and non-blocking transfers on a side stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)

    def place(self, batch: Dict[str, Any]):
        host = {k: _to_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        # the pinned buffers must live until the copies have run: keep
        # them with the batch until it is handed out
        return out, done, host

    def hand_out(self, placed) -> Batch:
        out, done, _host = placed
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for v in out.values():
            v.record_stream(current)
        return out


def device_prefetch(batches: Iterable[Dict[str, Any]], device: str | torch.device,
                    depth: int = 2) -> Iterator[Batch]:
    """Iterate ``batches`` (dicts of numpy arrays), keeping up to ``depth``
    of them in flight to ``device`` ahead of the consumer (double
    buffering at depth 2). Yields exactly the batches of the underlying
    iterator, in order, as tensors on ``device``."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in batches:
            yield {k: _to_tensor(v).to(dev) for k, v in batch.items()}
        return
    placer = _CudaPlacer(dev)
    it = iter(batches)
    buf: collections.deque = collections.deque()
    for batch in it:
        buf.append(placer.place(batch))
        if len(buf) >= depth:
            break
    while buf:
        placed = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(placer.place(nxt))
        yield placer.hand_out(placed)
