"""Build, load and count the port's CUDA kernels.

The sources under ``avid_cma_tpu_torch/csrc/`` have a plain C interface
(no PyTorch headers), so ``nvcc`` builds them in seconds: one ``nvcc -c``
per source, all started together, then one link into a shared library
under ``avid_cma_tpu_torch/_build/`` named by a hash of the sources and
flags. The library is built at first use and loaded with ``ctypes``;
nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels. ``reset_launches`` zeroes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("spectrogram.cu", "stem_pool.cu", "nce_gather.cu", "r2p1d_pair.cu",
           "r2p1d_pair_mma.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {
    "spectrogram": 0,
    "stem_pool_fwd": 0,
    "stem_pool_bwd": 0,
    "stem_pool_fwd_f32": 0,
    "stem_pool_bwd_f32": 0,
    "nce_gather": 0,
    "r2p1d_pair": 0,
}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (csrc/*.cu); every function returns a cudaError_t as int
_SIGNATURES = {
    # B, T, frame_len -> floats of the scratch avid_spectrogram needs
    "avid_spectrogram_scratch": [_I] * 3,
    # sig, basis, mean, std, out, scratch, B, L, T, frame_len, hop, top_db,
    # use_top_db, normalize, stream
    "avid_spectrogram": [_VP] * 6 + [_I] * 5 + [_F, _I, _I, _VP],
    # y, a, b, out, N, H, W, C, stream
    "avid_stem_pool_fwd": [_VP] * 4 + [_I] * 4 + [_VP],
    # N, H, W, C -> rows of the da/db partial sums avid_stem_pool_bwd needs
    "avid_stem_pool_bwd_parts": [_I] * 4,
    # y, a, b, g, dy, da_part, db_part, da, db, N, H, W, C, parts, stream
    "avid_stem_pool_bwd": [_VP] * 9 + [_I] * 5 + [_VP],
    # the f32 forms: y, a, b, out, N, H, W, C, stream
    "avid_stem_pool_fwd_f32": [_VP] * 4 + [_I] * 4 + [_VP],
    # N, H, W, C -> rows of the f64 partial sums avid_stem_pool_bwd_f32 needs
    "avid_stem_pool_bwd_f32_parts": [_I] * 4,
    # y, a, b, g, dy, code, part, da, db, N, H, W, C, parts, stream
    "avid_stem_pool_bwd_f32": [_VP] * 9 + [_I] * 5 + [_VP],
    # bank, idx, q, out, B, K, N, D, temperature, stream
    "avid_nce_scores": [_VP] * 4 + [_I] * 4 + [_F, _VP],
    # x, w_spatial, w_temporal, scale, bias, out, B, T, H, W, C, stream (f32)
    "avid_r2p1d_pair_f32": [_VP] * 6 + [_I] * 5 + [_VP],
    # x, w_spatial, w_temporal, scale, bias, out, B, T, H, W, C, tile_h,
    # frames, smem_bytes, stream (bf16; the plan of r2p1d_pair.plan_bf16)
    "avid_r2p1d_pair_bf16": [_VP] * 6 + [_I] * 8 + [_VP],
}

_lib: Optional[ctypes.CDLL] = None
build_log: List[str] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library of the same source hash exists;
    return its path. Raises with the compiler's output on failure."""
    so = BUILD_DIR / f"libavid_kernels_{_source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        build_log.append(f"== nvcc {name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(build_log))
    tmp = BUILD_DIR / f"{so.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    build_log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
