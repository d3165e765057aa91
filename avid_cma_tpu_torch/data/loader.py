"""Host data loader: sharded sampling, threaded prefetch, batching
(counterpart of avid_cma_tpu/data/loader.py).

Capability reference: torch DataLoader + DistributedSampler usage
(utils/main_utils.py:214-228): per-process shard of a globally shuffled
index sequence, drop_last, worker pool, epoch-seeded shuffling.

One process feeds the device: the loader yields numpy batches of RAW
decode output (uint8 frames + waveforms); device-side preprocessing (see
pipelines.py) replaces the reference's 36-72 CPU worker processes doing
PIL/librosa work (main config num_workers). A native C++ shared-memory
ring (avid_cma_tpu_torch/native) can be slotted in as the executor.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class ShardedBatchSampler:
    """Epoch-seeded global shuffle -> per-process contiguous shard ->
    batches (DistributedSampler semantics, torch sampler parity)."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 0,
    ):
        if batch_size < 1:
            raise ValueError(
                f"per-shard batch_size must be >= 1, got {batch_size} "
                f"(global batch too small for num_shards={num_shards}?)"
            )
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # pad so every shard sees the same count (DistributedSampler
        # semantics: repeat the sequence as many times as needed — with
        # num_shards > dataset_len, pad exceeds len(idx) and a plain
        # idx[:pad] would leave shards unequal, desynchronizing multihost
        # step counts)
        per_shard = -(-self.dataset_len // self.num_shards)
        pad = per_shard * self.num_shards - self.dataset_len
        if pad:
            reps = -(-pad // max(len(idx), 1))
            idx = np.concatenate([idx] + [idx] * reps)[: per_shard * self.num_shards]
        idx = idx[self.shard_index :: self.num_shards]
        n_batches = (
            len(idx) // self.batch_size
            if self.drop_last
            else -(-len(idx) // self.batch_size)
        )
        for b in range(n_batches):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def __len__(self) -> int:
        per_shard = -(-self.dataset_len // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if np.ndim(vals[0]) else np.asarray(vals)
    return out


class DataLoader:
    """Threaded prefetching loader yielding collated numpy batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.sampler = ShardedBatchSampler(
            len(dataset), batch_size, shuffle, drop_last, num_shards, shard_index, seed
        )
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def set_start_batch(self, n: int) -> None:
        """Skip the first `n` batches of the NEXT iteration only (consumed
        on first __iter__). Mid-epoch resume: skipping at the index level
        costs nothing, while discarding yielded batches would pay a full
        decode for every already-trained batch."""
        self._start_batch = int(n)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self.sampler)
        start = getattr(self, "_start_batch", 0)
        self._start_batch = 0
        if start:
            batches = batches[start:]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """Bounded put that aborts when the consumer is gone — an
            abandoned iterator must not leave workers blocked forever
            holding full batches."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        # producers may run at most `window` batches ahead of the
        # consumer: without this, one slow worker lets the others race
        # arbitrarily far ahead and the out-of-order reorder buffer
        # (`pending`) grows unboundedly in host memory
        window = max(4, 2 * self.num_workers)
        ahead = threading.Condition()
        consumed = [0]

        def produce(worker_id: int):
            for bi in range(worker_id, len(batches), self.num_workers):
                with ahead:
                    while bi - consumed[0] >= window and not stop.is_set():
                        ahead.wait(0.2)
                if stop.is_set():
                    return
                try:
                    batch = _collate([self.dataset[i] for i in batches[bi]])
                    if not put_checked((bi, batch)):
                        return
                except Exception as e:  # surface errors to the consumer
                    if not put_checked((bi, e)):
                        return
            put_checked((None, worker_id))

        workers = [
            threading.Thread(target=produce, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for w in workers:
            w.start()

        try:
            pending: Dict[int, object] = {}
            next_bi, done_workers = 0, 0
            while next_bi < len(batches):
                if next_bi in pending:
                    item = pending.pop(next_bi)
                else:
                    bi, item = out_q.get()
                    if bi is None:
                        done_workers += 1
                        if done_workers == len(workers) and next_bi < len(batches):
                            raise RuntimeError("loader workers exited early")
                        continue
                    if bi != next_bi:
                        pending[bi] = item
                        continue
                if isinstance(item, Exception):
                    raise item
                yield item
                next_bi += 1
                with ahead:
                    consumed[0] = next_bi
                    ahead.notify_all()
        finally:
            stop.set()
            with ahead:
                ahead.notify_all()
            # drain so any worker blocked in put() can observe stop
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            for w in workers:
                w.join(timeout=1.0)


class CachedDataLoader:
    """Decode-once, replay-from-RAM wrapper around any loader.

    The first full drain (per start-batch offset 0) stores the collated
    batches; later epochs replay them from host memory with zero decode
    cost. Trades the inner loader's per-epoch reshuffle and augmentation
    re-draws for decode-free epochs — the right trade when (a) the
    corpus is small enough to hold decoded (host decode is the
    bottleneck, e.g. few-class probes on a weak host), or (b) measuring
    the train loop itself at device rate (the reference has no analogue;
    its DataLoader re-decodes every epoch, utils/main_utils.py:214-228).
    Augmentation randomness is NOT frozen: device-side preprocessing
    draws afresh each step either way (data/pipelines.py), only the raw
    decoded clips repeat.

    Memory: one epoch of raw batches (frames uint8 + waveforms f32);
    e.g. 2048 clips @ 8x256x320x3 + 2 s audio ~ 4.4 GB.
    """

    def __init__(self, inner):
        self.inner = inner
        self.dataset = inner.dataset
        self._cache: Optional[list] = None
        self._start_batch = 0

    def set_epoch(self, epoch: int) -> None:
        # only reaches the inner loader before the cache is filled (the
        # fill epoch's sampler order is the one replayed)
        if self._cache is None:
            self.inner.set_epoch(epoch)

    def set_start_batch(self, n: int) -> None:
        self._start_batch = int(n)

    def __len__(self) -> int:
        return len(self._cache) if self._cache is not None else len(self.inner)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        start = self._start_batch
        self._start_batch = 0
        if self._cache is None:
            if start:
                # a resume mid-fill would cache a truncated epoch and
                # silently shrink every later epoch; fill whole, skip
                # while yielding
                cache: list = []
                for b in self.inner:
                    cache.append(b)
                self._cache = cache
                yield from cache[start:]
                return
            cache = []
            for b in self.inner:
                cache.append(b)
                yield b
            self._cache = cache
            return
        yield from self._cache[start:]


class MultiprocessDataLoader:
    """Process-based loader over the native C++ shared-memory ring
    (avid_cma_tpu_torch/native): producer processes decode + collate and memcpy
    raw batch bytes into fixed shm slots; the consumer maps the same
    pages — no pickling, no pipe syscalls per element. This is the
    native-runtime replacement for torch DataLoader worker IPC
    (reference: utils/main_utils.py:214-228).

    Requires a fork-capable platform and g++: when the ring's library
    cannot be built, the constructor raises with the compiler's message
    (use the threaded DataLoader instead; nothing falls back to it).
    The producers are forked: they run only numpy and the dataset's
    decode, never CUDA, so a parent that holds a CUDA context is safe.

    Producers gate on the ring header's consumed counter
    (ring_wait_window, native/shm_ring.cc): like the threaded loader,
    they run at most `window` batches ahead of the consumer's yield
    point, so the out-of-order reorder buffer is hard-capped.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 2,
        slot_mb: int = 256,
        n_slots: int = 4,
        num_shards: int = 1,
        shard_index: int = 0,
        seed: int = 0,
    ):
        from avid_cma_tpu_torch import native

        native.load()  # raises with the compiler's message
        self._native = native
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.slot_bytes = slot_mb << 20
        self.n_slots = n_slots
        self.sampler = ShardedBatchSampler(
            len(dataset), batch_size, shuffle, drop_last, num_shards,
            shard_index, seed,
        )

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def set_start_batch(self, n: int) -> None:
        """One-shot batch skip for the next iteration (see
        DataLoader.set_start_batch)."""
        self._start_batch = int(n)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import os

        # captured up front: if this generator is finalized during
        # interpreter shutdown, the os module's attributes may already be
        # torn down (None) when the finally block runs
        _kill, _waitpid = os.kill, os.waitpid
        import uuid

        batches = list(self.sampler)
        start = getattr(self, "_start_batch", 0)
        self._start_batch = 0
        if start:
            batches = batches[start:]
        # uuid, not id(self): object ids are 16-byte aligned (~12 useful
        # bits), and two live loaders in one process (train + in-training
        # eval) colliding on a name would destroy each other's ring
        name = f"/avid_ring_{os.getpid()}_{uuid.uuid4().hex[:16]}"
        ring = self._native.ShmRing(
            name, n_slots=self.n_slots, slot_bytes=self.slot_bytes
        )
        pids = []
        # producers may run at most `window` batches ahead of the
        # consumer's yield point (same bound as the threaded loader);
        # enforced through the ring header's consumed counter
        window = max(4, 2 * self.num_workers)
        try:
            for w in range(self.num_workers):
                pid = os.fork()
                if pid == 0:  # child producer
                    code = 0
                    try:
                        child = self._native.ShmRing(name, create=False)
                        for bi in range(w, len(batches), self.num_workers):
                            if not child.wait_window(bi, window,
                                                     timeout_ms=600_000):
                                raise TimeoutError("consumer stalled")
                            batch = _collate(
                                [self.dataset[i] for i in batches[bi]]
                            )
                            batch["__batch_index__"] = np.int64(bi)
                            child.push_batch(batch, timeout_ms=60_000)
                    except Exception:
                        code = 1
                    os._exit(code)
                pids.append(pid)

            def reap_failed() -> None:
                for i, pid in enumerate(pids):
                    if pid == 0:
                        continue
                    done, status = os.waitpid(pid, os.WNOHANG)
                    if done:
                        pids[i] = 0
                        if os.waitstatus_to_exitcode(status) != 0:
                            raise RuntimeError(
                                "loader producer process failed (batch too "
                                "large for slot_mb, or dataset error)"
                            )

            pending: Dict[int, Dict[str, np.ndarray]] = {}
            for next_bi in range(len(batches)):
                while next_bi not in pending:
                    try:
                        batch = ring.pop_batch(timeout_ms=2_000)
                    except TimeoutError:
                        reap_failed()  # raises if a producer died
                        continue
                    if batch is None:
                        raise RuntimeError("ring closed before completion")
                    bi = int(np.asarray(batch.pop("__batch_index__")).reshape(-1)[0])
                    pending[bi] = batch
                yield pending.pop(next_bi)
                ring.set_consumed(next_bi + 1)  # wakes window-gated producers
        finally:
            for pid in pids:
                if pid <= 0:  # already reaped; os.kill(0, ...) would
                    continue  # signal the whole process group
                try:
                    _kill(pid, 9)
                except (ProcessLookupError, PermissionError):
                    pass
                try:
                    _waitpid(pid, 0)
                except ChildProcessError:
                    pass
            ring.free()
