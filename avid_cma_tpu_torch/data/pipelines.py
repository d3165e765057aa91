"""Device preprocessing: raw batches -> model inputs (counterpart of
avid_cma_tpu/data/pipelines.py): the train and eval paths of
``msc+color`` and ``crop+color``.

uint8 frames (B, T, H, W, 3) and f32 waveforms (B, L) in; normalized
clips (B, T, S, S, 3) and spectrograms (B, T', F, 1) out. Every random
draw of the train path comes from one ``torch.Generator`` on the batch's
device; the eval path draws nothing. The spectrogram goes through kernel
K1 on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from avid_cma_tpu_torch.device import compute_dtype
from avid_cma_tpu_torch.ops import video_aug
from avid_cma_tpu_torch.ops.kernels.spectrogram import log_spectrogram_kernel


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    transform: str = "msc+color"  # or "crop+color"
    crop_size: int = 224
    min_area: float = 0.08
    color: Tuple[float, float, float, float] = (0.4, 0.4, 0.4, 0.2)
    resize: Tuple[int, int] = (256, 256)  # crop+color's exact Resize target
    # "canonical": brightness -> contrast -> saturation -> hue; "random":
    # a permutation of the active ops per clip, as the reference draws it
    jitter_order: str = "canonical"
    audio_fps: int = 24000
    n_fft: int = 512
    spectrogram_fps: float = 100.0
    audio_clip_duration: float = 2.0
    volume_jitter: float = 0.1
    normalize_spectrogram: bool = True
    # the clips' dtype, the model's (``model.dtype``; ``device.compute_dtype``)
    model_dtype: str = "auto"

    def __post_init__(self):
        if self.transform not in ("msc+color", "crop+color"):
            raise ValueError(
                f"unknown transform {self.transform!r}: expected 'msc+color' or "
                "'crop+color'")
        if self.jitter_order not in ("canonical", "random"):
            raise ValueError(
                f"jitter order must be 'random' or 'canonical', got {self.jitter_order!r}")

    @property
    def hop_size(self) -> float:
        return 1.0 / self.spectrogram_fps


def augment_clips_train(frames: torch.Tensor, u: torch.Tensor,
                        cfg: PreprocessConfig, dtype: torch.dtype,
                        perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> normalized (B, T, S, S, 3) in ``dtype``,
    given uniform draws u (B, 2*CROP_ATTEMPTS + 7): crop areas, crop log
    ratios, top, left, flip, and the four jitter factors; ``perm`` (B, 4)
    the jitter order of each clip (None: canonical)."""
    _, _, h, w, _ = frames.shape
    na = video_aug.CROP_ATTEMPTS
    top, left, ch, cw = video_aug.sample_crop_box(
        u[:, :na], u[:, na:2 * na], u[:, 2 * na], u[:, 2 * na + 1], h, w,
        (cfg.min_area, 1.0))
    out = video_aug.crop_resize(frames, top, left, ch, cw,
                                (cfg.crop_size, cfg.crop_size), dtype)
    out = out / 255.0
    out = video_aug.flip(out, u[:, 2 * na + 2] < 0.5)
    out = video_aug.color_jitter(out, *video_aug.jitter_factors(u[:, 2 * na + 3:], cfg.color),
                                 perm=perm)
    return video_aug.normalize_clip(out)


def _train_clips(frames: torch.Tensor, cfg: PreprocessConfig,
                 generator: Optional[torch.Generator], dtype: torch.dtype) -> torch.Tensor:
    """Draw the train path's random numbers from ``generator`` and run it."""
    b, dev = frames.shape[0], frames.device
    perm = None
    if cfg.jitter_order == "random":
        perm = torch.argsort(torch.rand((b, 4), generator=generator, device=dev), dim=1)
    if cfg.transform == "msc+color":
        u = torch.rand((b, 2 * video_aug.CROP_ATTEMPTS + 7), generator=generator, device=dev)
        return augment_clips_train(frames, u, cfg, dtype, perm)
    rh, rw = cfg.resize
    top = torch.randint(0, rh - cfg.crop_size + 1, (b,), generator=generator, device=dev)
    left = torch.randint(0, rw - cfg.crop_size + 1, (b,), generator=generator, device=dev)
    u = torch.rand((b, 5), generator=generator, device=dev)
    return video_aug.crop_augment_clips_train(
        frames, top, left, u[:, 0] < 0.5, u[:, 1:], perm, cfg.crop_size, cfg.resize,
        cfg.color, dtype)


def preprocess_batch(batch: Dict[str, torch.Tensor], cfg: PreprocessConfig,
                     generator: Optional[torch.Generator] = None,
                     train: bool = True) -> Dict[str, torch.Tensor]:
    """{frames: uint8 (B,T,H,W,3), audio: f32 (B,L), index} ->
    {frames: (B,T,S,S,3) in the model's dtype, audio: f32 (B,T',F,1),
    index}. The train path
    draws from ``generator``; the eval path (``train=False``) has no
    randomness and no volume jitter."""
    out = dict(batch)
    if "frames" in batch:
        frames = batch["frames"]
        # the model's compute dtype; by default bf16 on the card, whose
        # 8-bit mantissa matches the 8-bit source frames
        dtype = compute_dtype(frames.device, cfg.model_dtype)
        if train:
            out["frames"] = _train_clips(frames, cfg, generator, dtype)
        elif cfg.transform == "crop+color":
            out["frames"] = video_aug.crop_augment_clips_eval(
                frames, cfg.crop_size, cfg.resize, dtype)
        else:
            out["frames"] = video_aug.augment_clips_eval(frames, cfg.crop_size, dtype=dtype)
    if "audio" in batch:
        wav = batch["audio"]
        if train and cfg.volume_jitter > 0:
            u = torch.rand((wav.shape[0], 1), generator=generator, device=wav.device)
            wav = wav * video_aug.uniform(u, 1.0 - cfg.volume_jitter, 1.0 + cfg.volume_jitter)
        out["audio"] = log_spectrogram_kernel(
            wav, sample_rate=cfg.audio_fps, n_fft=cfg.n_fft,
            hop_size=cfg.hop_size, duration=cfg.audio_clip_duration,
            normalize=cfg.normalize_spectrogram)
    return out
