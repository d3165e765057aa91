"""Concrete datasets: Kinetics, AudioSet, UCF-101, HMDB-51 (counterpart
of avid_cma_tpu/data/datasets.py).

Capability reference: datasets/kinetics.py:17-69 (class-per-directory
scan), datasets/audioset.py:34-91 (cache-list + availability filter, no
labels), datasets/ucf.py:14-56 / datasets/hmdb.py:15-62 (official split
files, 3 folds, video-only).

Divergences (deliberate):
  * dataset roots are config/constructor arguments, not module globals
    (the reference hardcodes DATA_PATH at datasets/kinetics.py:13 etc.)
  * a `backend='synthetic'` mode manufactures a deterministic listing so
    every pipeline stage runs without media files (see data/decode.py)
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Optional

from avid_cma_tpu_torch.data.decode import DecodeBackend, SyntheticBackend, make_backend
from avid_cma_tpu_torch.data.video_db import VideoDataset
from avid_cma_tpu_torch.registry import DATASETS


def _resolve_backend(backend, **synth_kwargs) -> DecodeBackend:
    if isinstance(backend, DecodeBackend):
        return backend
    return make_backend(backend or "auto", **synth_kwargs)


def _guard_real_listing(be: DecodeBackend, backend_arg) -> None:
    """Refuse to pair a REAL media listing with an implicitly-resolved
    synthetic decoder: 'auto' on a codec-less host would otherwise
    fabricate frames from path hashes and produce plausible but fake
    metrics against the real labels. Explicit backend='synthetic' (or a
    passed-in SyntheticBackend instance) remains allowed for tests."""
    explicit = backend_arg == "synthetic" or isinstance(
        backend_arg, SyntheticBackend
    )
    if isinstance(be, SyntheticBackend) and not explicit:
        raise RuntimeError(
            "dataset has a real media listing but no real decoder is "
            "available (PyAV/ffmpeg missing). Refusing to decode real "
            "files with the synthetic backend; install a decoder or set "
            "dataset.backend=synthetic explicitly."
        )


def _synthetic_listing(prefix: str, n: int, n_classes: int = 0):
    fns = [f"{prefix}/video_{i:06d}.mp4" for i in range(n)]
    labels = [i % n_classes for i in range(n)] if n_classes else None
    return fns, labels


@DATASETS.register("kinetics")
class Kinetics(VideoDataset):
    """reference: datasets/kinetics.py:17-69."""

    NUM_CLASSES = 400

    def __init__(
        self,
        subset: str,
        root: Optional[str] = None,
        backend="auto",
        synthetic_size: int = 1000,
        **kwargs,
    ):
        self.name = "Kinetics dataset"
        self.subset = subset
        be = _resolve_backend(backend, out_hw=kwargs.pop("decode_size", None))
        if root and os.path.isdir(os.path.join(root, subset)):
            _guard_real_listing(be, backend)
            base = os.path.join(root, subset)
            # directories only: a stray file (README, .DS_Store) would
            # shift every label index after it out of the 400-class range
            classes = sorted(
                d for d in os.listdir(base)
                if os.path.isdir(os.path.join(base, d))
            )
            fns = sorted(glob.glob(f"{base}/*/*.mp4"))
            class_idx = {c: i for i, c in enumerate(classes)}
            labels = [class_idx[fn.split("/")[-2]] for fn in fns]
            self.classes = classes
        else:
            if not isinstance(be, SyntheticBackend):
                raise FileNotFoundError(f"kinetics root not found: {root}")
            fns, labels = _synthetic_listing(
                f"kinetics/{subset}", synthetic_size, self.NUM_CLASSES
            )
            self.classes = [f"class_{i}" for i in range(self.NUM_CLASSES)]
        self.num_videos = len(fns)
        self.num_classes = len(self.classes)
        super().__init__(backend=be, video_fns=fns, labels=labels, **kwargs)


#: AudioSet cache lists shipped with the package (a copy of the JAX
#: package's assets/cache/audioset; reference datasets/cache/audioset/)
AUDIOSET_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "cache", "audioset",
)


class AudioSetClasses:
    """527-class AudioSet label table from class_labels_indices.csv
    (reference: datasets/audioset.py:17-31)."""

    def __init__(self, cache_path: Optional[str] = None):
        path = os.path.join(cache_path or AUDIOSET_CACHE,
                            "class_labels_indices.csv")
        with open(path) as f:
            rows = list(csv.DictReader(f))
        self.display_names = [r["display_name"] for r in rows]
        self.ids = [r["mid"] for r in rows]
        self._by_id = {r["mid"]: int(r["index"]) for r in rows}

    def __len__(self) -> int:
        return len(self.ids)

    def class_label(self, mid: str) -> int:
        return self._by_id[mid]

    def class_name(self, index: int) -> str:
        return self.display_names[index]


@DATASETS.register("audioset")
class AudioSet(VideoDataset):
    """reference: datasets/audioset.py:34-91. Labels unsupported
    (audioset.py:59). With no explicit cache_path, the package-shipped
    cache lists (assets/cache/audioset) provide the reference's exact
    instance indexing."""

    def __init__(
        self,
        subset: str,
        root: Optional[str] = None,
        cache_path: Optional[str] = None,
        backend="auto",
        synthetic_size: int = 2000,
        **kwargs,
    ):
        assert not kwargs.get("return_labels"), "AudioSet has no labels"
        self.name = "AudioSet dataset"
        self.subset = subset
        be = _resolve_backend(backend, out_hw=kwargs.pop("decode_size", None))
        if cache_path is None and os.path.isfile(
            os.path.join(AUDIOSET_CACHE, f"{subset}.txt")
        ) and not isinstance(be, SyntheticBackend):
            cache_path = AUDIOSET_CACHE
        if cache_path and os.path.isfile(os.path.join(cache_path, f"{subset}.txt")):
            _guard_real_listing(be, backend)
            with open(os.path.join(cache_path, f"{subset}.txt")) as f:
                fns = [ln.strip().split()[0] for ln in f if ln.strip()]
            if root and os.path.isdir(root):
                avail = {
                    os.path.basename(p).split(".")[0] for p in glob.glob(f"{root}/*")
                }
                fns = [fn for fn in fns if fn.split(".")[0] in avail]
                fns = [os.path.join(root, fn) for fn in fns]
        else:
            if not isinstance(be, SyntheticBackend):
                raise FileNotFoundError(f"audioset cache not found: {cache_path}")
            fns, _ = _synthetic_listing(f"audioset/{subset}", synthetic_size)
        self.num_videos = len(fns)
        super().__init__(backend=be, video_fns=fns, labels=None, **kwargs)


class _SplitFileDataset(VideoDataset):
    """UCF/HMDB shared logic: class list + per-fold split files."""

    NUM_CLASSES = 0

    def __init__(
        self,
        subset: str,
        root: Optional[str],
        anno_path: Optional[str],
        backend,
        synthetic_size: int,
        name: str,
        **kwargs,
    ):
        assert not kwargs.get("return_audio", False), f"{name} is video-only"
        self.name = name
        self.subset = subset
        be = _resolve_backend(backend, out_hw=kwargs.pop("decode_size", None))
        self._backend_arg = backend
        fns, labels = self._load_split(root, anno_path, subset, be, synthetic_size)
        self.num_videos = len(fns)
        self.num_classes = len(self.classes)
        kwargs.setdefault("return_audio", False)
        super().__init__(backend=be, video_fns=fns, labels=labels, **kwargs)

    def _load_split(self, root, anno_path, subset, be, synthetic_size):
        raise NotImplementedError


@DATASETS.register("ucf101")
class UCF(_SplitFileDataset):
    """reference: datasets/ucf.py:14-56. Splits: trainlist{fold:02d} /
    testlist{fold:02d}."""

    NUM_CLASSES = 101

    def __init__(self, subset, root=None, anno_path=None, backend="auto",
                 synthetic_size=400, **kwargs):
        super().__init__(subset, root, anno_path, backend, synthetic_size,
                         name="UCF-101", **kwargs)

    def _load_split(self, root, anno_path, subset, be, synthetic_size):
        if anno_path and os.path.isfile(os.path.join(anno_path, f"{subset}.txt")):
            _guard_real_listing(be, self._backend_arg)
            with open(os.path.join(anno_path, "classInd.txt")) as f:
                self.classes = [ln.strip().split()[1] for ln in f if ln.strip()]
            with open(os.path.join(anno_path, f"{subset}.txt")) as f:
                fns = [ln.strip().split()[0] for ln in f if ln.strip()]
            class_idx = {c: i for i, c in enumerate(self.classes)}
            labels = [class_idx[fn.split("/")[0]] for fn in fns]
            fns = [os.path.join(root, fn) for fn in fns] if root else fns
            return fns, labels
        if not isinstance(be, SyntheticBackend):
            raise FileNotFoundError(f"ucf101 annotations not found: {anno_path}")
        self.classes = [f"action_{i}" for i in range(self.NUM_CLASSES)]
        return _synthetic_listing(f"ucf101/{subset}", synthetic_size, self.NUM_CLASSES)


@DATASETS.register("hmdb51")
class HMDB(_SplitFileDataset):
    """reference: datasets/hmdb.py:15-62. Split files
    <class>_test_split<fold>.txt with tags 1=train, 2=test."""

    NUM_CLASSES = 51

    def __init__(self, subset, root=None, anno_path=None, backend="auto",
                 synthetic_size=300, **kwargs):
        super().__init__(subset, root, anno_path, backend, synthetic_size,
                         name="HMDB-51", **kwargs)

    def _load_split(self, root, anno_path, subset, be, synthetic_size):
        # subset format: "train-split1" | "test-split1" (main_utils builds
        # these from the benchmark configs)
        if anno_path and os.path.isdir(anno_path):
            _guard_real_listing(be, self._backend_arg)
            which, split = subset.split("-")
            tag = "1" if which == "train" else "2"
            split_files = sorted(
                glob.glob(os.path.join(anno_path, f"*_test_{split}.txt"))
            )
            self.classes = [
                os.path.basename(p).split(f"_test_{split}")[0] for p in split_files
            ]
            fns, labels = [], []
            for lbl, sf in enumerate(split_files):
                with open(sf) as f:
                    for ln in f:
                        parts = ln.strip().split()
                        if len(parts) >= 2 and parts[1] == tag:
                            fn = os.path.join(self.classes[lbl], parts[0])
                            fns.append(os.path.join(root, fn) if root else fn)
                            labels.append(lbl)
            return fns, labels
        if not isinstance(be, SyntheticBackend):
            raise FileNotFoundError(f"hmdb51 annotations not found: {anno_path}")
        self.classes = [f"action_{i}" for i in range(self.NUM_CLASSES)]
        return _synthetic_listing(f"hmdb51/{subset}", synthetic_size, self.NUM_CLASSES)
