"""A/V decode backends feeding the host->device input pipeline
(counterpart of avid_cma_tpu/data/decode.py).

Capability reference: utils/ioutils/av_wrappers.py (PyAV decode):
  * av_load_video (17-54): seek, decode frames in [start, start+duration)
    at `fps`, duplicating frames when target fps > source fps
  * av_laod_audio (57-113, typo'd in the de-facto API): resample to s16
    mono at `audio_fps`, trim/pad to duration, int16 -> [-1, 1] float

Decode runs on the host, with pluggable backends (PyAV / ffmpeg CLI when
present, synthetic always); ``cv2`` and ``av`` are imported only by the
code that needs them, and a missing one raises an error that names it. The
synthetic backend generates deterministic per-clip content so tests and
benchmarks exercise the full pipeline without media files or codecs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np


def fps_grid_indices(
    times: np.ndarray, start: float, n_target: int, fps: float
) -> np.ndarray:
    """Map decoded frame timestamps onto the target fps grid, duplicating
    frames when the target fps exceeds the source rate (semantics of
    av_wrappers.py:31-53). Returns, for each of the n_target grid points
    start + k/fps, the index of the latest decoded frame at-or-before it
    (clamped to the decoded range)."""
    times = np.asarray(times)
    want = start + np.arange(n_target) / fps
    return np.clip(
        np.searchsorted(times, want, side="right") - 1, 0, len(times) - 1
    )


def scale_crop_frames(
    frames: np.ndarray, out_hw: Tuple[int, int]
) -> np.ndarray:
    """Cover-scale (short side fills the target) + center-crop each frame
    to exactly `out_hw`. A FIXED decode size is what keeps the raw->device
    pipeline fixed-shape (batch collate + device preprocessing) across
    heterogeneous real media, and it cuts loader/ring bytes ~10x for
    high-res sources (SURVEY hard part #1: input throughput). The crop
    field the device-side random-resized-crop then samples from is the
    covered center region rather than the full frame — size `decode_size`
    generously (e.g. 1.14x crop_size, matching the synthetic backend's
    256x320 for 224 crops)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "scale_crop_frames needs OpenCV (package 'opencv-python', module "
            "'cv2') to resize decoded frames") from e

    oh, ow = int(out_hw[0]), int(out_hw[1])
    t, h, w = frames.shape[:3]
    if (h, w) == (oh, ow):
        return frames
    s = max(oh / h, ow / w)
    nh = max(int(round(h * s)), oh)
    nw = max(int(round(w * s)), ow)
    y0, x0 = (nh - oh) // 2, (nw - ow) // 2
    interp = cv2.INTER_AREA if s < 1.0 else cv2.INTER_LINEAR
    out = np.empty((t, oh, ow) + frames.shape[3:], frames.dtype)
    for i in range(t):
        r = cv2.resize(frames[i], (nw, nh), interpolation=interp)
        out[i] = r[y0 : y0 + oh, x0 : x0 + ow]
    return out


def trim_pad_audio(
    sig: np.ndarray, decode_start: float, start: float,
    sample_rate: int, n_target: int,
) -> np.ndarray:
    """Align a decoded waveform that began at `decode_start` (seek lands
    at-or-before `start`) to exactly [start, start + n_target/sample_rate):
    trim the lead-in, cut/zero-pad the tail (av_wrappers.py:99-111)."""
    skip = max(0, int(round((start - decode_start) * sample_rate)))
    sig = np.asarray(sig)[skip:]
    if sig.size > n_target:
        return sig[:n_target]
    if sig.size < n_target:
        return np.pad(sig, (0, n_target - sig.size))
    return sig


@dataclasses.dataclass
class VideoMeta:
    duration: float  # seconds
    video_fps: float
    audio_fps: int
    width: int = 0
    height: int = 0


class DecodeBackend:
    """Interface: open/metadata + ranged frame/audio decode.

    `frame_hw` is the fixed (H, W) every decoded frame has, or None when
    output size varies per file (native-resolution decode). Fixed-shape
    consumers (device preprocessing, dense-eval batch assembly) rely on it
    for failure-path fallbacks."""

    frame_hw: Optional[Tuple[int, int]] = None

    def get_meta(self, path: str) -> VideoMeta:
        raise NotImplementedError

    def load_video(
        self, path: str, start: float, duration: float, fps: float
    ) -> np.ndarray:
        """-> uint8 (T, H, W, 3) with T = ceil(duration * fps)."""
        raise NotImplementedError

    def load_audio(
        self, path: str, start: float, duration: float, sample_rate: int
    ) -> np.ndarray:
        """-> float32 (L,) mono in [-1, 1], L = duration * sample_rate,
        zero-padded when the stream runs short (av_wrappers.py:99-111)."""
        raise NotImplementedError


class SyntheticBackend(DecodeBackend):
    """Deterministic synthetic clips: content is a pure function of
    (path, start). Moving gradient frames + per-clip mixture-of-sines
    audio, so temporal sampling/augmentation/spectrograms see non-trivial
    structure."""

    def __init__(
        self,
        duration: float = 10.0,
        video_fps: float = 16.0,
        audio_fps: int = 24000,
        height: int = 256,
        width: int = 320,
    ):
        self.meta = VideoMeta(duration, video_fps, audio_fps, width, height)
        self.frame_hw = (height, width)

    def _seed(self, path: str) -> int:
        return int.from_bytes(
            hashlib.blake2s(path.encode(), digest_size=4).digest(), "little"
        )

    def get_meta(self, path: str) -> VideoMeta:
        return self.meta

    def load_video(self, path, start, duration, fps) -> np.ndarray:
        n = int(np.ceil(duration * fps))
        h, w = self.meta.height, self.meta.width
        rng = np.random.default_rng(self._seed(path))
        phase = rng.uniform(0, 2 * np.pi, size=3)
        speed = rng.uniform(0.5, 2.0, size=3)
        t = start + np.arange(n) / fps
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        frames = np.empty((n, h, w, 3), np.uint8)
        for i, ti in enumerate(t):
            for c in range(3):
                val = 0.5 + 0.5 * np.sin(
                    2 * np.pi * (xx / w + yy / h) + phase[c] + speed[c] * ti
                )
                frames[i, :, :, c] = (val * 255).astype(np.uint8)
        return frames

    def load_audio(self, path, start, duration, sample_rate) -> np.ndarray:
        n = int(duration * sample_rate)
        rng = np.random.default_rng(self._seed(path) ^ 0xA5A5)
        freqs = rng.uniform(80, 4000, size=4)
        amps = rng.uniform(0.1, 0.3, size=4)
        t = start + np.arange(n) / sample_rate
        sig = sum(a * np.sin(2 * np.pi * f * t) for a, f in zip(amps, freqs))
        return sig.astype(np.float32)


class PyAVBackend(DecodeBackend):
    """PyAV/FFmpeg decode (semantics of av_wrappers.py:17-113).

    `out_hw=(H, W)` cover-scales + center-crops every frame at decode
    time (see scale_crop_frames) so output shapes are fixed across
    heterogeneous media; None keeps native resolution."""

    def __init__(self, out_hw: Optional[Tuple[int, int]] = None):
        try:
            import av
        except ImportError as e:
            raise ImportError("the 'pyav' decode backend needs PyAV (module 'av')") from e

        self._av = av
        self.out_hw = tuple(out_hw) if out_hw is not None else None
        self.frame_hw = self.out_hw

    def get_meta(self, path: str) -> VideoMeta:
        with self._av.open(path) as c:
            v = c.streams.video[0]
            a = c.streams.audio[0] if c.streams.audio else None
            if v.duration:
                duration = float(v.duration * v.time_base)
            elif c.duration:  # stream lacks a duration field (common in
                # mkv): fall back to the container clock, else every clip
                # would silently sample from t=0
                duration = float(c.duration / self._av.time_base)
            else:
                duration = 0.0
            return VideoMeta(
                duration=duration,
                video_fps=float(v.average_rate),
                audio_fps=int(a.rate) if a else 0,
                width=v.width,
                height=v.height,
            )

    def load_video(self, path, start, duration, fps) -> np.ndarray:
        av = self._av
        n_target = int(np.ceil(duration * fps))
        with av.open(path) as container:
            stream = container.streams.video[0]
            container.seek(int(start / stream.time_base), stream=stream)
            frames, times = [], []
            end = start + duration
            for frame in container.decode(video=0):
                t = float(frame.pts * stream.time_base)
                if t < start - 1.0 / fps:
                    continue
                if t >= end:
                    break
                frames.append(frame.to_ndarray(format="rgb24"))
                times.append(t)
        if not frames:
            raise RuntimeError(f"no frames decoded from {path} @ {start}")
        idx = fps_grid_indices(times, start, n_target, fps)
        out = np.stack([frames[i] for i in idx])
        if self.out_hw is not None:
            out = scale_crop_frames(out, self.out_hw)
        return out

    def load_audio(self, path, start, duration, sample_rate) -> np.ndarray:
        av = self._av
        n_target = int(duration * sample_rate)
        first_pts = None
        with av.open(path) as container:
            stream = container.streams.audio[0]
            resampler = av.AudioResampler(format="s16", layout="mono", rate=sample_rate)
            container.seek(int(start / stream.time_base), stream=stream)
            chunks = []
            total = 0
            # seeking lands at-or-before `start`; record where decode
            # actually began so the window can be trimmed to `start`
            # (reference: av_wrappers.py:100-108)
            skip = 0
            for frame in container.decode(audio=0):
                if first_pts is None and frame.pts is not None:
                    first_t = float(frame.pts * stream.time_base)
                    first_pts = first_t
                    skip = max(0, int(round((start - first_t) * sample_rate)))
                out = resampler.resample(frame)
                out = out if isinstance(out, list) else [out]
                for o in out:
                    arr = o.to_ndarray().reshape(-1)
                    chunks.append(arr)
                    total += arr.size
                if total >= skip + n_target + sample_rate // 10:
                    break
            else:
                # stream ended before the requested window: flush samples
                # still buffered inside the resampler, or the clip tail is
                # silently zero-padded over real audio
                try:
                    for o in resampler.resample(None) or []:
                        chunks.append(o.to_ndarray().reshape(-1))
                except Exception:
                    pass  # older PyAV has no flush support
        sig = (
            np.concatenate(chunks) if chunks else np.zeros(n_target, np.int16)
        ).astype(np.float32) / 32768.0
        return trim_pad_audio(
            sig, first_pts if first_pts is not None else start,
            start, sample_rate, n_target,
        )


class FFmpegCLIBackend(DecodeBackend):
    """ffmpeg-binary decode for hosts without PyAV."""

    # per-path metadata cache cap: unbounded growth over an AudioSet-2M
    # epoch would hold ~2M VideoMeta entries (+ path keys) per worker —
    # order of a GB of host RAM, multiplied across loader processes
    META_CACHE_MAX = 200_000

    def __init__(self, out_hw: Optional[Tuple[int, int]] = None):
        if shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None:
            raise RuntimeError("the 'ffmpeg' decode backend needs the ffmpeg and "
                               "ffprobe programs on PATH")
        # fixed output size implemented INSIDE the filter graph (cover
        # scale + centered crop): besides making shapes static, it cuts
        # the rawvideo bytes crossing the pipe for high-res sources
        self.out_hw = tuple(out_hw) if out_hw is not None else None
        self.frame_hw = self.out_hw
        # per-path metadata LRU: get_meta spawns an ffprobe subprocess,
        # and every clip load of the same file needs the same answer
        # (clip-mode training probes each file once per epoch otherwise,
        # dense eval 25+ times)
        from collections import OrderedDict

        self._meta_cache: "OrderedDict[str, VideoMeta]" = OrderedDict()

    def get_meta(self, path: str) -> VideoMeta:
        import json

        cached = self._meta_cache.get(path)
        if cached is not None:
            self._meta_cache.move_to_end(path)
            return cached
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-print_format", "json",
             "-show_streams", "-show_format", path],
            capture_output=True, check=True,
        )
        info = json.loads(out.stdout)
        v = next(s for s in info["streams"] if s["codec_type"] == "video")
        a = next((s for s in info["streams"] if s["codec_type"] == "audio"), None)
        num, den = v["avg_frame_rate"].split("/")
        meta = VideoMeta(
            duration=float(info["format"]["duration"]),
            video_fps=float(num) / float(den),
            audio_fps=int(a["sample_rate"]) if a else 0,
            width=int(v["width"]),
            height=int(v["height"]),
        )
        self._meta_cache[path] = meta
        if len(self._meta_cache) > self.META_CACHE_MAX:
            self._meta_cache.popitem(last=False)
        return meta

    def load_video(self, path, start, duration, fps) -> np.ndarray:
        meta = self.get_meta(path)
        n = int(np.ceil(duration * fps))
        vf = f"fps={fps}"
        if self.out_hw is not None:
            oh, ow = self.out_hw
            # cover scale (ceil: crop needs input >= output) + center crop
            expr = f"max({ow}/iw\\,{oh}/ih)"
            vf += (f",scale='ceil(iw*{expr})':'ceil(ih*{expr})'"
                   f",crop={ow}:{oh}")
            out_h, out_w = oh, ow
        else:
            out_h, out_w = meta.height, meta.width
        cmd = [
            # -noautorotate: the reshape below uses ffprobe's coded w/h;
            # ffmpeg's default displaymatrix rotation would emit swapped
            # dims for portrait videos and silently garble every frame
            # (PyAV's to_ndarray doesn't rotate either, matching the
            # reference's av_wrappers.py behavior)
            "ffmpeg", "-v", "error", "-noautorotate",
            "-ss", str(start), "-t", str(duration),
            "-i", path, "-vf", vf, "-pix_fmt", "rgb24",
            "-f", "rawvideo", "-",
        ]
        raw = subprocess.run(cmd, capture_output=True, check=True).stdout
        frame_bytes = out_w * out_h * 3
        got = len(raw) // frame_bytes
        frames = np.frombuffer(raw[: got * frame_bytes], np.uint8).reshape(
            got, meta.height, meta.width, 3
        )
        if got == 0:
            raise RuntimeError(f"no frames decoded from {path}")
        if got < n:  # pad by repeating the last frame
            frames = np.concatenate([frames, np.repeat(frames[-1:], n - got, 0)])
        return frames[:n]

    def load_audio(self, path, start, duration, sample_rate) -> np.ndarray:
        n = int(duration * sample_rate)
        cmd = [
            "ffmpeg", "-v", "error", "-ss", str(start), "-t", str(duration),
            "-i", path, "-ac", "1", "-ar", str(sample_rate),
            "-f", "s16le", "-",
        ]
        raw = subprocess.run(cmd, capture_output=True, check=True).stdout
        sig = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if sig.size > n:
            sig = sig[:n]
        elif sig.size < n:
            sig = np.pad(sig, (0, n - sig.size))
        return sig


def make_backend(
    name: str = "auto",
    out_hw: Optional[Tuple[int, int]] = None,
    **kwargs,
) -> DecodeBackend:
    """`out_hw=(H, W)`: fixed decode size — real backends cover-scale +
    center-crop at decode time (config surface: dataset.decode_size);
    the synthetic backend generates at that size directly."""
    if name == "synthetic":
        if out_hw is not None:
            kwargs.setdefault("height", int(out_hw[0]))
            kwargs.setdefault("width", int(out_hw[1]))
        return SyntheticBackend(**kwargs)
    if name == "pyav":
        return PyAVBackend(out_hw=out_hw)
    if name == "ffmpeg":
        return FFmpegCLIBackend(out_hw=out_hw)
    if name == "auto":
        for cls in (PyAVBackend, FFmpegCLIBackend):
            try:
                return cls(out_hw=out_hw)
            except Exception:
                continue
        # no real decoder available: fall back to synthetic, but LOUDLY —
        # silently fabricating frames on a host with real media mounted
        # would produce plausible-looking but fake training/eval numbers
        import warnings

        warnings.warn(
            "decode backend 'auto': neither PyAV nor ffmpeg is available; "
            "falling back to the SYNTHETIC backend (procedurally generated "
            "frames/audio). Set dataset.backend explicitly to silence this."
        )
        if out_hw is not None:
            kwargs.setdefault("height", int(out_hw[0]))
            kwargs.setdefault("width", int(out_hw[1]))
        return SyntheticBackend(**kwargs)
    raise ValueError(f"unknown decode backend '{name}'")
