"""K1: fused log-power spectrogram (``csrc/spectrogram.cu``).

Replaces ``log_spectrogram_pallas`` / ``_spectrogram_kernel``
(avid_cma_tpu/ops/pallas/spectrogram.py:49-80,120). On this card the
kernel is bound by its f32 operations (about 13.4 GFLOP at the Kinetics
shape, kept off the tensor cores because log10 amplifies rounding). The
plain PyTorch version is ``ops.stft.log_spectrogram``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from avid_cma_tpu_torch.ops import stft
from avid_cma_tpu_torch.ops.kernels import _lib

plain_log_spectrogram = stft.log_spectrogram


def packed_basis(frame_len: int) -> np.ndarray:
    """The windowed real-DFT basis in K1's column order, (frame_len,
    frame_len) float32: column 4q+e holds, for e = 0, 1, 2, 3, the cos and
    sin of bin 2q+1, then of bin 2q+2, times the Hann window, so that each
    group of four columns is one folded output bin q+1. The sin of bins 0
    and frame_len/2 is zero, so the last group's fourth column (the sin of
    the Nyquist bin) carries the cos of bin 0 instead: 513 bins of (re, im)
    in 1024 columns."""
    cos, sin = stft.dft_matrices(frame_len)
    basis = np.empty((frame_len, frame_len // 4, 4), np.float32)
    basis[:, :, 0] = cos[:, 1::2]
    basis[:, :, 1] = sin[:, 1::2]
    basis[:, :, 2] = cos[:, 2::2]
    basis[:, :, 3] = sin[:, 2::2]
    basis[:, -1, 3] = cos[:, 0]
    basis *= stft.hann_periodic(frame_len)[:, None, None]
    return basis.reshape(frame_len, frame_len)


@functools.lru_cache(maxsize=None)
def _constants(frame_len: int, n_fft: int, sample_rate: int, normalize: bool,
               device: torch.device) -> Tuple[torch.Tensor, ...]:
    if normalize:
        mean, std = stft.load_norm_stats(n_fft, sample_rate)
    else:  # not read by the kernel
        mean = std = np.zeros(n_fft // 2 + 1, np.float32)
    arrays = (packed_basis(frame_len), mean, std)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def log_spectrogram_kernel(
    sig: torch.Tensor,
    sample_rate: int = 24000,
    n_fft: int = 512,
    hop_size: float = 0.005,
    duration: Optional[float] = None,
    normalize: bool = True,
    top_db: Optional[float] = 100.0,
) -> torch.Tensor:
    """(B, L) float32 waveform -> (B, T, n_fft//2 + 1, 1) float32.

    A CUDA tensor runs kernel K1; a CPU tensor runs the plain version."""
    if sig.device.type == "cpu":
        return plain_log_spectrogram(sig, sample_rate, n_fft, hop_size,
                                     duration, normalize, top_db)
    frame_len = n_fft * 2
    hop = int(hop_size * sample_rate)
    if sig.dim() != 2:
        raise ValueError(f"sig: expected (B, L), got {tuple(sig.shape)}")
    bsz, length = sig.shape
    _lib.require(sig, "sig", torch.float32)
    if length <= frame_len // 2:
        raise ValueError(f"reflect padding needs L > {frame_len // 2}, got {length}")
    t = stft.num_frames(length, hop, duration, hop_size)
    kernels = _lib.lib()
    n_scratch = kernels.avid_spectrogram_scratch(bsz, t, frame_len)
    if n_scratch < 1:
        raise ValueError(f"kernel K1 takes n_fft a multiple of 64, got {n_fft}")
    basis, mean, std = _constants(frame_len, n_fft, sample_rate, normalize, sig.device)
    out = torch.empty((bsz, t, n_fft // 2 + 1), dtype=torch.float32, device=sig.device)
    # each frame's max dB per tile of columns, for the per-sample top_db max
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=sig.device)
    err = kernels.avid_spectrogram(
        sig.data_ptr(), basis.data_ptr(), mean.data_ptr(), std.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), bsz, length, t, frame_len, hop,
        float(top_db if top_db is not None else 0.0), int(top_db is not None),
        int(normalize), _lib.stream(),
    )
    _lib.check(err, "avid_spectrogram")
    _lib.LAUNCHES["spectrogram"] += 1
    return out[..., None]
