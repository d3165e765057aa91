"""Device and compute-dtype resolution for the port's entry points.

Counterpart of ``resolve_compute_dtype`` (avid_cma_tpu/train/builders.py:
20-42): parameters stay float32; convolutions compute in bfloat16 on the
card and float32 on the CPU, where the parity tests run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    no card is present. Nothing falls back to the CPU: the CPU is used
    only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(device: torch.device) -> torch.dtype:
    """Convolution compute dtype: bfloat16 on CUDA (the stem kernels take
    bf16 only), float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def set_full_f32_precision() -> None:
    """Turn TF32 off for f32 matmuls and convolutions. The f32 projection
    heads, the loss and the spectrogram's dB error budget assume true
    f32 arithmetic (avid_cma_tpu/ops/pallas/spectrogram.py:62-63)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def prepare_device(device: str | torch.device = "cuda") -> torch.device:
    """``resolve_device``, then the backend state every entry point runs
    under: TF32 off and, on the card, cuDNN's autotuner on (the shapes of
    a run are fixed, so each convolution is tuned once)."""
    dev = resolve_device(device)
    set_full_f32_precision()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    return dev
