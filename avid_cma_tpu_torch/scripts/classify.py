"""Classify video files with a finetuned model (counterpart of
scripts/classify.py, the serve path).

    python -m avid_cma_tpu_torch.scripts.classify \\
        configs/benchmark/ucf/8at16-fold1.yaml \\
        configs/main/avid/kinetics/Cross-N1024.yaml \\
        video1.mp4 video2.avi \\
        [--fold 1] [--ckpt best|last] [--clips 10] [--topk 5] \\
        [--classes names.txt] [--set key=value ...] [--device cuda|cpu]

Restores the finetuned model of a port eval run
(``<model_dir>/<name>/eval-<benchmark>/fold-NN``, as
``eval_action_recg_torch.py`` writes it: ``checkpoints_best``, the best
clip top-1, or ``checkpoints``, the newest epoch) and classifies each
file with the dense protocol: uniformly spaced clips, the eval
preprocessing, a softmax per clip, the mean over the video's clips, the
top-k (reference eval-action-recg.py:101-110, utils/eval_utils.py:
154-157). Decoding goes through the configured ``dataset.backend``
(PyAV, the ffmpeg CLI, or ``synthetic``; ``dataset.decode_size``
applies); PyAV is imported only when it is asked for, and its absence
raises naming it. Class names come from ``--classes`` (one a line), else
the benchmark dataset's listing when ``dataset.root`` is readable, else
bare indices. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.config import Config
from avid_cma_tpu_torch.data.datasets import _guard_real_listing, _resolve_backend
from avid_cma_tpu_torch.data.pipelines import preprocess_batch
from avid_cma_tpu_torch.data.video_db import VideoDataset
from avid_cma_tpu_torch.device import prepare_device
from avid_cma_tpu_torch.models.eval_wrappers import ClassificationWrapper
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train.checkpoint import import_model_run
from avid_cma_tpu_torch.train.eval_loop import video_backbone
from avid_cma_tpu_torch.train.step import evaluating


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("eval_cfg", help="benchmark YAML the model was finetuned with")
    p.add_argument("model_cfg", help="pretraining YAML naming the run directory")
    p.add_argument("videos", nargs="+", help="video files to classify")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--ckpt", choices=["best", "last"], default="best",
                   help="best: the best clip top-1 on the benchmark's test split; "
                        "last: the newest epoch")
    p.add_argument("--clips", type=int, default=None,
                   help="clips a video (default: the config's test_dense "
                        "clips_per_video, else 10)")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--classes", default=None, help="class-name file, one name a line")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p


def restore_finetuned(eval_dir: str, which: str) -> Tuple[dict, str]:
    """The model state_dict of an eval run's newest checkpoint in
    ``checkpoints_best`` (then ``checkpoints``) for ``best``, in
    ``checkpoints`` for ``last``, and the directory's name."""
    for d in (["checkpoints_best", "checkpoints"] if which == "best" else ["checkpoints"]):
        try:
            return import_model_run(os.path.join(eval_dir, d)), d
        except FileNotFoundError:
            continue
    raise FileNotFoundError(f"no finetuned checkpoint under {eval_dir} "
                            "(run eval_action_recg_torch.py first)")


def class_names(eval_cfg: Config, fold: int, n_classes: int) -> List[str]:
    """The benchmark dataset's class names, else class_<i>."""
    try:
        ds = builders.build_dataset(eval_cfg.dataset, eval_cfg.dataset.test,
                                    return_audio=False, return_labels=True, fold=fold)
        names = list(getattr(ds, "classes", []))
        if len(names) == n_classes:
            return names
    except (FileNotFoundError, OSError, ValueError, KeyError):
        pass
    return [f"class_{i}" for i in range(n_classes)]


def classify_videos(eval_cfg: Config, model_cfg: Config, paths: Sequence[str],
                    fold: Optional[int] = None, which: str = "best",
                    clips: Optional[int] = None, device: str | torch.device = "cuda"
                    ) -> Tuple[np.ndarray, str]:
    """(probs (N, n_classes) float32, one row a file, the checkpoint's
    directory name): the softmax averaged over ``clips`` uniformly spaced
    clips of each file."""
    dev = prepare_device(device)
    db = eval_cfg.dataset
    fold = fold if fold is not None else int(db.get("fold", 1))
    eval_dir = os.path.join(model_cfg["model_dir"], model_cfg["name"],
                            f"eval-{eval_cfg.benchmark['name']}", f"fold-{fold:02d}")
    state, kind = restore_finetuned(eval_dir, which)

    backend_arg = db.get("backend", "auto")
    be = _resolve_backend(backend_arg, out_hw=(tuple(int(x) for x in db["decode_size"])
                                               if db.get("decode_size") is not None else None))
    _guard_real_listing(be, backend_arg)
    ds = VideoDataset(
        backend=be, video_fns=list(paths), mode="video",
        video_clip_duration=float(db.get("video_clip_duration", db.get("clip_duration", 0.5))),
        video_fps=float(db.get("video_fps", 16.0)), return_audio=False, return_labels=False,
        mode_clips_per_video=int(clips if clips is not None
                                 else db.get("test_dense", {}).get("clips_per_video", 10)))
    pp_cfg = builders.build_preprocess_config(db, model_cfg.get("dtype"))

    # the architecture only: the weights are the finetuned run's
    margs = eval_cfg.model["args"]
    backbone = video_backbone(model_cfg, dev).to(dev)
    frames0 = np.asarray(ds[0]["frames"]) if len(ds) else None
    clip_shape = (frames0.shape[1] if frames0 is not None else 1, pp_cfg.crop_size,
                  pp_cfg.crop_size)
    model = ClassificationWrapper(
        backbone, int(margs["n_classes"]), clip_shape,
        feat_name=margs.get("feat_name", "pool"), pooling_op=margs.get("pooling_op"),
        use_dropout=bool(margs.get("use_dropout", False)),
        dropout=float(margs.get("dropout", 0.5))).to(dev)
    model.load_state_dict(state, strict=True)

    probs = []
    with evaluating(model):
        for i in range(len(ds)):
            frames = frames0 if i == 0 else np.asarray(ds[i]["frames"])  # (clips, T, H, W, 3)
            pp = preprocess_batch({"frames": torch.from_numpy(frames).to(dev)}, pp_cfg,
                                  train=False)
            p = torch.softmax(model(pp["frames"]).float(), dim=-1)
            probs.append(p.mean(dim=0).cpu().numpy())  # the dense protocol: the clips' mean
    return np.stack(probs).astype(np.float32), kind


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    eval_cfg = config_lib.load(args.eval_cfg, overrides=args.overrides)
    model_cfg = config_lib.load(args.model_cfg).model
    # one fold for the checkpoint and the class names
    fold = args.fold if args.fold is not None else int(eval_cfg.dataset.get("fold", 1))
    probs, kind = classify_videos(eval_cfg, model_cfg, args.videos, fold=fold,
                                  which=args.ckpt, clips=args.clips, device=args.device)
    if args.classes:
        with open(args.classes) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        if len(names) != probs.shape[1]:
            raise SystemExit(f"--classes {args.classes} has {len(names)} names but the "
                             f"model outputs {probs.shape[1]} classes")
    else:
        names = class_names(eval_cfg, fold, probs.shape[1])
    print(f"checkpoint: {kind}")
    for path, p in zip(args.videos, probs):
        order = np.argsort(p)[::-1][: args.topk]
        print(f"{path}: " + ", ".join(f"{names[i]}={p[i]:.3f}" for i in order))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
