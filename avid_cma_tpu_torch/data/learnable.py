"""Learnable synthetic A/V dataset: the repo's end-to-end learning proof
(counterpart of avid_cma_tpu/data/learnable.py).

The reference's de-facto integration test is its published accuracy table
(reference README.md:21-26) — unavailable here (no media, no codecs). This
module replaces it with a dataset whose labels are recoverable from either
modality and whose two modalities share a per-instance latent, so a short
AVID pretrain on this host must produce (a) above-chance linear-probe
accuracy and (b) far-above-chance cross-modal retrieval — catching
sign/wiring bugs that parity tests structurally cannot.

Signal design (all cues chosen to survive the production augmentations):

  per clip i with class c = i % C and instance latent u ~ U[0,1):
    video: * global luminance oscillation at f_c = 1..7 Hz  (class cue;
             invariant to crop/flip/scale; below the 8 Hz Nyquist of
             16 fps clips)
           * per-channel color gains keyed to c                (class cue;
             survives mild color jitter)
           * diagonal grating drifting at v(u) cycles/s      (instance cue;
             crop/flip change phase/sign, not |speed|)
    audio: * tone at f_a(c) = 1500 * 2^(c/C) Hz               (class cue)
           * tone at f_u(u) = 250 * 2^(2u) Hz                (instance cue)
           * tremolo at the video's f_c                   (redundant bind)

  offsync augmentation shifts the audio window in time — pure-tone
  frequencies are unaffected. Cross-modal instance discrimination (AVID)
  is learnable because (c, u) parameterize both modalities.

Not part of the reference surface; this is test/benchmark infrastructure.
"""

from __future__ import annotations

import hashlib
import re
from typing import Optional, Tuple

import numpy as np

from avid_cma_tpu_torch.data.decode import DecodeBackend, VideoMeta
from avid_cma_tpu_torch.data.video_db import VideoDataset
from avid_cma_tpu_torch.registry import DATASETS


def _seed(path: str) -> int:
    return int.from_bytes(
        hashlib.blake2s(path.encode(), digest_size=4).digest(), "little"
    )


def _params(path: str, num_classes: int):
    """(class, instance latent u, phase rng) — pure function of the path."""
    m = re.search(r"_c(\d+)_", path)
    if m is None:
        raise ValueError(f"not a learnable-AV path (no _c<label>_): {path}")
    c = int(m.group(1)) % num_classes
    rng = np.random.default_rng(_seed(path))
    u = float(rng.uniform())
    return c, u, rng


class LearnableAVBackend(DecodeBackend):
    """Deterministic class+instance-coded clips (see module docstring)."""

    def __init__(
        self,
        num_classes: int = 8,
        duration: float = 10.0,
        video_fps: float = 16.0,
        audio_fps: int = 24000,
        height: int = 64,
        width: int = 80,
    ):
        self.num_classes = int(num_classes)
        self.meta = VideoMeta(duration, video_fps, audio_fps, width, height)
        self.frame_hw = (height, width)

    def get_meta(self, path: str) -> VideoMeta:
        return self.meta

    # class-cue frequency: 1..7 Hz, linear in class index
    def _f_class(self, c: int) -> float:
        denom = max(self.num_classes - 1, 1)
        return 1.0 + 6.0 * c / denom

    def load_video(self, path, start, duration, fps) -> np.ndarray:
        c, u, rng = _params(path, self.num_classes)
        n = int(np.ceil(duration * fps))
        h, w = self.meta.height, self.meta.width
        f_c = self._f_class(c)
        v_u = 0.5 + 3.5 * u  # grating drift, cycles/s
        phase = rng.uniform(0, 2 * np.pi, size=2)
        t = (start + np.arange(n) / fps)[:, None, None]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        diag = (xx / w + yy / h)[None]  # (1, H, W)
        lum = 0.35 + 0.25 * np.sin(2 * np.pi * f_c * t + phase[0])
        grating = 0.4 * np.sin(
            2 * np.pi * (3.0 * diag - v_u * t) + phase[1]
        )
        base = np.clip(lum + grating + 0.2, 0.0, 1.0)  # (T, H, W)
        gains = 0.5 + 0.5 * np.sin(
            2 * np.pi * (c / self.num_classes + np.arange(3) / 3.0)
        )
        frames = base[..., None] * gains[None, None, None, :]
        return (np.clip(frames, 0, 1) * 255).astype(np.uint8)

    def load_audio(self, path, start, duration, sample_rate) -> np.ndarray:
        c, u, rng = _params(path, self.num_classes)
        n = int(duration * sample_rate)
        f_c = self._f_class(c)
        f_a = 1500.0 * 2.0 ** (c / self.num_classes)
        f_u = 250.0 * 2.0 ** (2.0 * u)
        phase = rng.uniform(0, 2 * np.pi, size=3)
        t = start + np.arange(n) / sample_rate
        tremolo = 0.6 + 0.4 * np.sin(2 * np.pi * f_c * t + phase[0])
        sig = (
            0.4 * np.sin(2 * np.pi * f_u * t + phase[1]) * tremolo
            + 0.3 * np.sin(2 * np.pi * f_a * t + phase[2])
        )
        return sig.astype(np.float32)


@DATASETS.register("synthetic_av")
class LearnableAV(VideoDataset):
    """Learnable synthetic A/V dataset (labels from either modality,
    instance latent shared across modalities). Splits are disjoint
    path namespaces; class-balanced labels i % num_classes."""

    def __init__(
        self,
        subset: str,
        num_classes: int = 8,
        synthetic_size: int = 128,
        root: Optional[str] = None,  # accepted for builder compat, unused
        backend=None,  # ignored: content IS the backend
        decode_size: Optional[Tuple[int, int]] = None,
        **kwargs,
    ):
        self.name = "LearnableAV dataset"
        self.subset = subset
        self.num_classes = int(num_classes)
        be_kwargs = {}
        if decode_size is not None:
            be_kwargs = {
                "height": int(decode_size[0]), "width": int(decode_size[1])
            }
        be = LearnableAVBackend(num_classes=self.num_classes, **be_kwargs)
        labels = [i % self.num_classes for i in range(synthetic_size)]
        fns = [
            f"synthetic_av/{subset}/_c{labels[i]:02d}_v{i:06d}.mp4"
            for i in range(synthetic_size)
        ]
        self.classes = [f"class_{i}" for i in range(self.num_classes)]
        self.num_videos = len(fns)
        super().__init__(backend=be, video_fns=fns, labels=labels, **kwargs)
