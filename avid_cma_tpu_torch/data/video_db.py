"""Generic A/V dataset: temporal clip sampling + dense-eval chunking
(counterpart of avid_cma_tpu/data/video_db.py).

Capability reference: datasets/video_db.py:23-265 (VideoDataset):
  * mode='clip': random temporal snippet with audio/video off-sync jitter
    <= max_offsync_augm (:186-217) and skip-to-next-index on decode
    failure (:96-107); len = num_samples * clips_per_video (:238-242)
  * mode='video': whole video split into clips_per_video uniformly spaced
    fixed-size chunks for dense eval (:109-151)

Split of responsibilities: the dataset emits RAW uint8 frames and
float32 waveforms (host work = decode only); crop/flip/jitter and the
spectrogram run on the device (data/pipelines.py).
Set `host_transform` to perform preprocessing host-side instead (parity
testing, CPU-only runs).
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from avid_cma_tpu_torch.data.decode import DecodeBackend


class VideoDataset:
    def __init__(
        self,
        backend: DecodeBackend,
        video_fns: Sequence[str],
        labels: Optional[Sequence] = None,
        mode: str = "clip",
        return_video: bool = True,
        video_clip_duration: float = 0.5,
        video_fps: float = 16.0,
        return_audio: bool = True,
        audio_clip_duration: float = 2.0,
        audio_fps: int = 24000,
        max_offsync_augm: float = 0.0,
        return_labels: bool = False,
        return_index: bool = True,
        mode_clips_per_video: int = 1,
        host_video_transform: Optional[Callable] = None,
        host_audio_transform: Optional[Callable] = None,
        max_retries: int = 100,
        seed: Optional[int] = 0,
    ):
        assert mode in ("clip", "video")
        self.backend = backend
        # np bytes array instead of a python list of str: avoids DataLoader
        # copy-on-write bloat (reference: datasets/video_db.py:16-20).
        # Explicit utf-8 encode — numpy's str->bytes cast is ASCII-only and
        # would crash on accented filenames; __getitem__ decodes as utf-8.
        self.video_fns = np.asarray(
            [f.encode("utf-8") if isinstance(f, str) else bytes(f)
             for f in video_fns],
            dtype=np.bytes_,
        )
        self.labels = None if labels is None else np.asarray(labels)
        self.mode = mode
        self.return_video = return_video
        self.video_clip_duration = video_clip_duration
        self.video_fps = video_fps
        self.return_audio = return_audio
        self.audio_clip_duration = audio_clip_duration
        self.audio_fps = audio_fps
        self.max_offsync_augm = max_offsync_augm
        self.return_labels = return_labels
        self.return_index = return_index
        self.clips_per_video = mode_clips_per_video
        self.host_video_transform = host_video_transform
        self.host_audio_transform = host_audio_transform
        self.max_retries = max_retries
        self.num_samples = len(self.video_fns)
        self.decode_failures = 0  # dense-mode videos scored as zeros
        # deterministic per-(seed, epoch, index) snippet sampling: exact
        # resume/test_only reproducibility (the reference relies on global
        # torch/python RNG state, main-avid.py:52-60 seeding). seed=None
        # falls back to the global `random` stream.
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Vary clip sampling across epochs (loader propagates this)."""
        self._epoch = epoch

    # -- temporal sampling ------------------------------------------------

    def _item_rng(self, index: int, attempt: int):
        if self.seed is None:
            return random
        # stable integer mix (hash() is salted per-process and would break
        # determinism across loader worker processes / restarts)
        mix = ((int(self.seed) + 1) * 1_000_003 + int(self._epoch)) * 1_000_003
        return random.Random((mix + int(index)) * 131 + int(attempt))

    def _sample_snippet(self, duration: float, rng=random) -> Tuple[float, float]:
        """(video_start, audio_start) within a stream of `duration` secs
        (reference: video_db.py:186-217)."""
        if not self.return_audio:
            if self.video_clip_duration > duration:
                return 0.0, 0.0
            ss = rng.uniform(0.0, duration - self.video_clip_duration)
            return ss, ss

        long_d = max(self.audio_clip_duration, self.video_clip_duration)
        short_d = min(self.audio_clip_duration, self.video_clip_duration)
        max_ss = duration - long_d
        if max_ss <= 0:
            return 0.0, 0.0
        ss_long = rng.uniform(0.0, max_ss)
        win_min = max(ss_long - self.max_offsync_augm, 0.0)
        win_max = min(
            ss_long + long_d + self.max_offsync_augm - short_d, duration - short_d
        )
        ss_short = rng.uniform(win_min, max(win_max, win_min))
        if self.audio_clip_duration >= self.video_clip_duration:
            return ss_short, ss_long
        return ss_long, ss_short

    # -- item access ------------------------------------------------------

    def __len__(self) -> int:
        if self.mode == "clip":
            return self.num_samples * self.clips_per_video
        return self.num_samples

    def _decode(self, fn: str, v_ss: float, a_ss: float, v_dur: float, a_dur: float):
        sample: Dict[str, np.ndarray] = {}
        if self.return_video:
            frames = self.backend.load_video(fn, v_ss, v_dur, self.video_fps)
            if self.host_video_transform is not None:
                frames = self.host_video_transform(frames)
            sample["frames"] = frames
        if self.return_audio:
            wav = self.backend.load_audio(fn, a_ss, a_dur, self.audio_fps)
            if self.host_audio_transform is not None:
                wav = self.host_audio_transform(wav, self.audio_fps)
            sample["audio"] = wav
        return sample

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.mode == "clip":
            for attempt in range(self.max_retries):
                sample_idx = (index + attempt) % self.num_samples
                fn = self.video_fns[sample_idx].decode()
                try:
                    meta = self.backend.get_meta(fn)
                except Exception:
                    continue  # skip to next index (video_db.py:96-107)
                v_ss, a_ss = self._sample_snippet(
                    meta.duration, self._item_rng(index, attempt)
                )
                try:
                    sample = self._decode(
                        fn, v_ss, a_ss,
                        self.video_clip_duration, self.audio_clip_duration,
                    )
                except Exception:
                    continue  # decode failure: retry the next index
                if self.return_labels:
                    sample["label"] = self.labels[sample_idx]
                if self.return_index:
                    sample["index"] = np.int32(sample_idx)
                return sample
            raise RuntimeError(f"no decodable sample near index {index}")

        # dense 'video' mode (video_db.py:109-151). Unlike the reference
        # (which crashes the whole dense eval on one corrupt test video),
        # decode failures yield zero-filled chunks with the correct label
        # and a loud warning — the video scores as a miss instead of
        # killing the run after hours of finetuning.
        fn = self.video_fns[index].decode()
        try:
            meta = self.backend.get_meta(fn)
            duration = meta.duration
            sample = self._decode(fn, 0.0, 0.0, duration, duration)
        except Exception as e:
            import warnings

            warnings.warn(
                f"dense decode failed for {fn!r} ({type(e).__name__}: {e}); "
                "scoring it as zeros"
            )
            self.decode_failures += 1
            # zero frames must match healthy videos' post-transform shape,
            # or the dense-eval batch stack dies on the very crash this
            # fallback exists to avoid: use the backend's fixed frame size
            # when it has one, and run the zeros through the same host
            # transform healthy frames get
            hw = getattr(self.backend, "frame_hw", None) or (16, 16)
            n_frames = max(int(self.video_clip_duration * self.video_fps), 1)
            frames = np.zeros((n_frames, hw[0], hw[1], 3), np.uint8)
            if self.host_video_transform is not None:
                frames = self.host_video_transform(frames)
            wav = np.zeros(
                (max(int(self.audio_clip_duration * self.audio_fps), 1),),
                np.float32,
            )
            if self.return_audio and self.host_audio_transform is not None:
                wav = self.host_audio_transform(wav, self.audio_fps)
            sample = {"frames": frames, "audio": wav}
        chunks: Dict[str, np.ndarray] = {}
        if self.return_video:
            frames = sample["frames"]
            chunk = int(self.video_clip_duration * self.video_fps)
            chunks["frames"] = self._chunk(frames, chunk, axis=0)
        if self.return_audio:
            wav = sample["audio"]
            chunk = int(self.audio_clip_duration * self.audio_fps)
            chunks["audio"] = self._chunk(wav, chunk, axis=0)
        if self.return_labels:
            chunks["label"] = self.labels[index]
        if self.return_index:
            chunks["index"] = np.full(self.clips_per_video, index, np.int32)
        return chunks

    def _chunk(self, arr: np.ndarray, chunk_size: int, axis: int) -> np.ndarray:
        """Fixed-shape dense chunking. Videos shorter than one clip are
        padded by looping to chunk_size (the reference returns the short
        array and relies on its transforms' pad-by-loop,
        preprocessing.py:53-59 — padding here keeps every video's chunk
        tensor the same shape, so every eval batch has one shape)."""
        n = arr.shape[axis]
        if chunk_size >= n:
            reps = -(-chunk_size // n)
            tiled = np.concatenate([arr] * reps, axis=axis)
            tiled = np.take(tiled, np.arange(chunk_size), axis=axis)
            return np.stack([tiled] * self.clips_per_video)
        starts = np.linspace(0, max(n - chunk_size, 1), self.clips_per_video).astype(int)
        return np.stack(
            [np.take(arr, np.arange(s, s + chunk_size), axis=axis) for s in starts]
        )
