"""Profiling and step timing (counterpart of avid_cma_tpu/utils/profiling.py).

``StepWindowTracer`` records the loop's ``profile_steps: [start, stop)``
window of global steps as a ``torch.profiler`` trace (CPU and, on a card,
CUDA activity) into ``model_dir/profile``; open the ``.json`` trace in
Perfetto or ``chrome://tracing``. ``StepTimer`` is a rolling step-time /
throughput tracker with an optional FLOP model.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import torch


class StepWindowTracer:
    """Traces the global steps in [start, stop). Call ``before_step(step)``
    before each step and ``after_step(step + 1)`` after it (the step
    count the loop holds then); ``close()`` ends a trace the run left
    open. Range conditions, not equality: a resumed run may start inside
    the window (the trace starts late) or past it (no trace)."""

    def __init__(self, window: Optional[Sequence[int]], logdir: str,
                 device: torch.device):
        self.window = None
        if window:
            w = [int(x) for x in window]
            if len(w) != 2 or w[1] <= w[0]:
                raise ValueError(
                    f"profile_steps must be [start, stop) with stop > start; got {w}")
            self.window = tuple(w)
        self.logdir = logdir
        self.device = torch.device(device)
        self._prof: Optional[torch.profiler.profile] = None
        self.path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def before_step(self, step: int) -> bool:
        """Start the trace when ``step`` is inside the window; True when it
        started here."""
        if self.window is None or self.active or not (self.window[0] <= step < self.window[1]):
            return False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return True

    def after_step(self, steps_done: int) -> bool:
        """Stop the trace once ``steps_done`` reaches the window's end;
        True when it stopped here."""
        if self.active and steps_done >= self.window[1]:
            self.close()
            return True
        return False

    def close(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir, f"trace_steps_{self.window[0]}_{self.window[1]}.json")
        prof.export_chrome_trace(self.path)


class StepTimer:
    """Rolling step-time / throughput tracker with an optional FLOP model
    for utilization estimates."""

    def __init__(self, items_per_step: int, flops_per_item: Optional[float] = None,
                 window: int = 50):
        self.items = items_per_step
        self.flops = flops_per_item
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def step_time(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def items_per_sec(self) -> float:
        st = self.step_time
        return self.items / st if st else 0.0

    def utilization(self, peak_flops: float) -> Optional[float]:
        if self.flops is None or not self._times:
            return None
        return (self.items * self.flops / self.step_time) / peak_flops
