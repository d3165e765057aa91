"""Logging + metric meters (counterpart of avid_cma_tpu/utils/logger.py).

Capability reference: utils/logger.py:15-79 (rank-0 Logger to
stdout+file, ProgressMeter with per-batch display and cross-GPU meter
sync — whose `synchronize_meters` references a nonexistent attribute,
a latent bug we do not reproduce), utils/metrics_utils.py:12-58
(top-k accuracy, AverageMeter with optional sliding window).

Meters consume host-side floats. Only rank 0 writes: the logger and the
scalar writer are quiet on every other rank. ``synchronize_meters``
averages the meters over the ranks (``parallel.multihost.sync_float``).
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, Iterable, Optional

import numpy as np

from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import sync_float


class Logger:
    """Print + append-to-file logger, active only on process 0
    (reference: utils/logger.py:15-40)."""

    def __init__(self, quiet: bool = False, path: Optional[str] = None, rank: int = 0):
        self.rank = rank
        self.quiet = quiet or rank != 0
        self.fp = None
        if not self.quiet and path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.fp = open(path, "a")

    def close(self) -> None:
        if self.fp:
            self.fp.close()
            self.fp = None

    def add_line(self, content: str) -> None:
        if self.quiet:
            return
        print(content, flush=True)
        if self.fp:
            self.fp.write(content + "\n")
            self.fp.flush()

    def log_config(self, cfg) -> None:
        """Full config dump at startup (reference utils/main_utils.py:51-58)."""
        self.add_line("=" * 30 + "   Config   " + "=" * 30)

        def walk(d, indent=""):
            for k, v in d.items():
                if isinstance(v, dict):
                    self.add_line(f"{indent}{k}")
                    walk(v, indent + "  ")
                else:
                    self.add_line(f"{indent}{k}: {v}")

        walk(dict(cfg))


def parameter_description(model) -> str:
    """Per-parameter table: name | shape | #elements, plus the total
    (reference utils/main_utils.py:334-340 logs this at startup)."""
    lines, total = [], 0
    for name, leaf in model.named_parameters():
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        total += n
        shape = " x ".join(str(s) for s in leaf.shape) or "scalar"
        lines.append(f"{name:70} | {shape:30} | {n}")
    lines.append(f"{'TOTAL':70} | {'':30} | {total}")
    return "\n".join(lines)


class AverageMeter:
    """Running / windowed average (reference: utils/metrics_utils.py:29-58)."""

    def __init__(self, name: str, fmt: str = ":f", window_size: int = 0):
        self.name = name
        self.fmt = fmt
        self.window = deque(maxlen=window_size) if window_size > 0 else None
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        if self.window is not None:
            self.window.clear()

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        if self.window is not None:
            self.window.append((float(val), n))
        else:
            self.sum += float(val) * n
            self.count += n

    @property
    def avg(self) -> float:
        if self.window is not None:
            if not self.window:
                return 0.0
            tot = sum(v * n for v, n in self.window)
            cnt = sum(n for _, n in self.window)
            return tot / max(cnt, 1)
        return self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )


class ProgressMeter:
    """Per-batch progress lines (reference: utils/logger.py:43-65)."""

    def __init__(self, num_batches: int, meters: Iterable[AverageMeter],
                 phase: str = "train", epoch: Optional[int] = None,
                 logger: Optional[Logger] = None):
        self.num_batches = num_batches
        self.meters = list(meters)
        self.phase = phase
        self.epoch = epoch
        self.logger = logger

    def display(self, batch: int) -> None:
        ep = f"[{self.epoch}]" if self.epoch is not None else ""
        head = f"{self.phase}{ep}[{batch}/{self.num_batches}]"
        line = "\t".join([head] + [str(m) for m in self.meters])
        if self.logger:
            self.logger.add_line(line)
        else:
            print(line, flush=True)

    def synchronize_meters(self, world: World) -> None:
        """Each meter's average, averaged over the ranks of ``world``
        (reference intent, utils/logger.py:73-79); every rank must call
        it. A no-op in a one-process world."""
        if not world.distributed:
            return
        for m in self.meters:
            v = sync_float(m.avg, world)
            m.reset()
            m.update(v)


def accuracy(logits: np.ndarray, labels: np.ndarray, topk=(1,)):
    """Top-k accuracy in percent (reference: utils/metrics_utils.py:12-26)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == labels[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


class TensorBoardWriter:
    """Scalar logging to TensorBoard event files through
    ``torch.utils.tensorboard`` when the ``tensorboard`` package is
    installed, else to ``scalars.jsonl`` in the same directory (reference:
    SummaryWriter usage utils/main_utils.py:56-63, main-avid.py:190-201).
    Writes on rank 0 only; ``enabled=False`` writes nothing."""

    def __init__(self, logdir: str, enabled: bool = True, rank: int = 0):
        self.enabled = enabled and rank == 0
        self._tb = None
        self._fp = None
        if not self.enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: the JSONL file
            self._fp = open(os.path.join(logdir, "scalars.jsonl"), "a")
        else:
            self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        elif self._fp is not None:
            self._fp.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
            self._fp.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, val in scalars.items():
            self.add_scalar(tag, val, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._fp is not None:
            self._fp.close()
        self._tb = self._fp = None
