"""Device and compute-dtype resolution for the port's entry points.

Counterpart of ``resolve_compute_dtype`` (avid_cma_tpu/train/builders.py:
20-42): parameters stay float32; the convolutions and the video
preprocessing compute in the dtype ``model.dtype`` names: ``auto`` is
bfloat16 on the card and float32 on the CPU, where the parity tests run;
``float32`` is float32 on both; ``bfloat16`` is the card's only.
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


_SPECS = {"auto": None, "float32": torch.float32, "f32": torch.float32,
               "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype(device: str | torch.device, spec=None) -> torch.dtype:
    """The compute dtype of ``model.dtype`` = ``spec`` on ``device``:
    ``auto`` (or None) is bfloat16 on CUDA and float32 on the CPU;
    ``float32`` is float32 everywhere; ``bfloat16`` is bfloat16 on CUDA
    and raises on the CPU, whose path computes f32 only. Nothing falls
    back to another dtype."""
    spec = "auto" if spec is None else str(spec)
    if spec not in _SPECS:
        raise ValueError(f"unknown model.dtype {spec!r}: expected auto|float32|bfloat16")
    cuda = torch.device(device).type == "cuda"
    want = _SPECS[spec]
    if want is None:
        return torch.bfloat16 if cuda else torch.float32
    if want == torch.bfloat16 and not cuda:
        raise NotImplementedError(
            "model.dtype=bfloat16 on the CPU is not ported: the CPU path computes "
            "f32; use model.dtype=auto or float32")
    return want


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
