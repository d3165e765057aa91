"""Native runtime components (C++): shared-memory ring buffer data plane
(counterpart of avid_cma_tpu/native; ``shm_ring.cc`` is a copy of its
source).

``load()`` builds the library with g++ into ``avid_cma_tpu_torch/_build/``
at first use (named by a hash of the source, so an edit rebuilds) and
raises with the compiler's message when that fails; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "shm_ring.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = ["g++", "-O2", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    """Compile the ring unless a library of the same source hash exists;
    return its path. Raises with the compiler's output on failure."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libshm_ring_{digest}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([*CXX, "-o", tmp, _SRC, "-lpthread", "-lrt"],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native shm ring: cannot run g++ ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native shm ring: g++ failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The ring's library, built on first call; raises when it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64]
        lib.ring_open.restype = ctypes.c_void_p
        lib.ring_open.argtypes = [ctypes.c_char_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_long]
        lib.ring_pop.restype = ctypes.c_longlong
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64, ctypes.c_long]
        lib.ring_close_producer.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_uint32
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_free.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ring_wait_window.restype = ctypes.c_int
        lib.ring_wait_window.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_uint64, ctypes.c_long]
        lib.ring_set_consumed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.ring_unlink.restype = ctypes.c_int
        lib.ring_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


class ShmRing:
    """Fixed-slot shared-memory queue usable across processes."""

    def __init__(self, name: str, n_slots: int = 8,
                 slot_bytes: int = 64 << 20, create: bool = True):
        lib = load()
        self._lib = lib
        self.name = name.encode()
        self.slot_bytes = slot_bytes
        if create:
            self._h = lib.ring_create(self.name, n_slots, slot_bytes)
            if not self._h:
                # a leftover segment with our name can only be stale (a
                # crashed run with a recycled pid): ring_create itself
                # never unlinks — clobbering a LIVE ring is the caller's
                # explicit call to make, so make it here, once
                lib.ring_unlink(self.name)
                self._h = lib.ring_create(self.name, n_slots, slot_bytes)
        else:
            self._h = lib.ring_open(self.name)
        if not self._h:
            raise RuntimeError(f"ring_{'create' if create else 'open'} failed: {name}")
        self._owner = create
        self._pop_buf = None  # lazily allocated, reused (single consumer)

    def push_bytes(self, data: bytes, timeout_ms: int = 10_000) -> None:
        rc = self._lib.ring_push(self._h, data, len(data), timeout_ms)
        if rc == -3:
            raise ValueError(f"payload {len(data)}B exceeds slot {self.slot_bytes}B")
        if rc != 0:
            raise TimeoutError("ring_push timed out")

    def _pop_view(self, timeout_ms: int) -> Optional[memoryview]:
        """Pop into the reused per-instance buffer; returns a view valid
        until the next pop (single-consumer). Avoids a fresh slot_bytes
        malloc+memset per batch (256 MB at the loader's default slot_mb)."""
        if self._pop_buf is None:
            self._pop_buf = ctypes.create_string_buffer(self.slot_bytes)
        n = self._lib.ring_pop(self._h, self._pop_buf, self.slot_bytes,
                               timeout_ms)
        if n == -2:
            return None
        if n == -1:
            raise TimeoutError("ring_pop timed out")
        if n < 0:
            raise RuntimeError(f"ring_pop error {n}")
        return memoryview(self._pop_buf)[:n]

    def pop_bytes(self, timeout_ms: int = 10_000) -> Optional[bytes]:
        """None when the ring is closed and drained."""
        view = self._pop_view(timeout_ms)
        return None if view is None else bytes(view)

    # -- numpy batch framing ------------------------------------------------

    def push_batch(self, batch: Dict[str, np.ndarray], timeout_ms: int = 10_000):
        self.push_bytes(encode_batch(batch), timeout_ms)

    def pop_batch(self, timeout_ms: int = 10_000) -> Optional[Dict[str, np.ndarray]]:
        view = self._pop_view(timeout_ms)  # decode copies out of the view
        return None if view is None else decode_batch(view)

    def wait_window(self, batch_index: int, window: int,
                    timeout_ms: int = 60_000) -> bool:
        """Producer-side gate: block until `batch_index` is within
        `window` of the consumer's yielded count (bounds the consumer's
        out-of-order reorder buffer). False on timeout."""
        return self._lib.ring_wait_window(
            self._h, batch_index, window, timeout_ms
        ) == 0

    def set_consumed(self, consumed: int) -> None:
        """Consumer progress (batches YIELDED in order), wakes gated
        producers."""
        self._lib.ring_set_consumed(self._h, consumed)

    def close_producer(self) -> None:
        self._lib.ring_close_producer(self._h)

    def __len__(self) -> int:
        return int(self._lib.ring_size(self._h))

    def free(self) -> None:
        if self._h:
            self._lib.ring_free(self._h, 1 if self._owner else 0)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def encode_batch(batch: Dict[str, np.ndarray]) -> bytes:
    """Self-describing little header + raw array bytes (no pickle)."""
    import json

    header = {}
    payload = []
    offset = 0
    for k, v in batch.items():
        v = np.ascontiguousarray(v)
        header[k] = {"dtype": v.dtype.str, "shape": list(v.shape), "offset": offset}
        b = v.tobytes()
        payload.append(b)
        offset += len(b)
    hjson = json.dumps(header).encode()
    return len(hjson).to_bytes(4, "little") + hjson + b"".join(payload)


def decode_batch(raw) -> Dict[str, np.ndarray]:
    """raw: bytes or a memoryview (the arrays are copied out either way)."""
    import json

    hlen = int.from_bytes(raw[:4], "little")
    header = json.loads(bytes(raw[4 : 4 + hlen]))
    base = 4 + hlen
    out = {}
    for k, meta in header.items():
        dt = np.dtype(meta["dtype"])
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        start = base + meta["offset"]
        arr = np.frombuffer(raw, dtype=dt, count=n, offset=start)
        out[k] = arr.reshape(meta["shape"]).copy()
    return out
