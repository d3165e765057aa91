"""Feature extraction: a pretrained backbone's embeddings of a dataset
split, written to an .npz (counterpart of scripts/extract_features.py).

    python -m avid_cma_tpu_torch.scripts.extract_features \\
        <data_cfg.yaml> <model_cfg.yaml> \\
        --split test --taps pool conv5x --out feats.npz \\
        [--space taps|nce] [--fold 1] [--max-items N] [--batch-size B] \\
        [--set key=value ...] [--device cuda|cpu]

``data_cfg`` is any config with a ``dataset`` block (the benchmark YAMLs
work as they are); ``model_cfg`` is a pretraining config whose run
directory, ``<model.model_dir>/<model.name>``, holds a
``checkpoint.pth.tar`` or a port pretraining run. Without either it
raises: random weights are no features.

``--space taps`` (default): the video backbone's taps, conv taps reduced
to vectors by a max over (T, H, W) (the backbone's own head pooling),
``pool`` already a vector. ``--space nce``: the L2-normalized
projection-head embeddings of both modalities (keys ``video`` and
``audio``), the space the memory banks are built in and cross-modal
retrieval works in; it needs a dataset that returns audio. A split in
``video`` mode (dense) gives one row a video, the mean over its
uniformly spaced clips. The .npz holds ``feat_<name>``, ``index`` and,
where the dataset has labels, ``label``.

Runs on the card unless ``--device cpu``; the clips and the backbone
compute in the model config's ``model.dtype``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from avid_cma_tpu_torch import config as config_lib
from avid_cma_tpu_torch.config import Config
from avid_cma_tpu_torch.data.loader import DataLoader
from avid_cma_tpu_torch.data.pipelines import preprocess_batch
from avid_cma_tpu_torch.device import prepare_device
from avid_cma_tpu_torch.models.av_wrapper import AVWrapper, av_wrapper
from avid_cma_tpu_torch.train import builders
from avid_cma_tpu_torch.train.eval_loop import load_backbone, pretrained_state
from avid_cma_tpu_torch.train.step import evaluating


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data_cfg")
    p.add_argument("model_cfg")
    p.add_argument("--split", default="test", help="dataset split block to read (train/test/...)")
    p.add_argument("--taps", nargs="+", default=["pool"],
                   help="backbone taps: conv1 conv2x..conv5x pool")
    p.add_argument("--space", choices=["taps", "nce"], default="taps",
                   help="'taps': the video backbone's taps; 'nce': the L2-normalized "
                        "projection-head embeddings of both modalities (cross-modal retrieval)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="override dataset.batch_size for extraction")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--set", dest="overrides", action="append", default=[])
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p


def load_full_model(model_cfg: Config, device: torch.device
                    ) -> Tuple[AVWrapper, Optional[str]]:
    """The pretrained ``AVWrapper`` (both backbones and the projection
    heads) on ``device``, and where its weights came from
    (``pretrained_state``), else None (random weights)."""
    args = model_cfg["args"]
    model = av_wrapper(
        args["video_backbone"], dict(args.get("video_backbone_args", {})),
        args.get("audio_backbone", "Conv2D"), dict(args.get("audio_backbone_args", {})),
        proj_dim=args.get("proj_dim", 128), seed=int(model_cfg.get("seed", 0)),
        device=device, dtype=model_cfg.get("dtype"))
    state, source = pretrained_state(model_cfg)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model, source


def extract_features(data_cfg: Config, model_cfg: Config, split: str = "test",
                     taps: Sequence[str] = ("pool",), space: str = "taps",
                     fold: Optional[int] = None, batch_size: Optional[int] = None,
                     max_items: Optional[int] = None, num_workers: int = 4,
                     device: str | torch.device = "cuda"
                     ) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray], np.ndarray]:
    """({name: (N, D) float32}, labels (N,) or None, the dataset indices
    (N,) extracted). ``space='taps'``: names are video-backbone taps;
    ``space='nce'``: 'video' and 'audio', the L2-normalized head
    embeddings. Raises when the model's run directory holds no weights."""
    dev = prepare_device(device)
    nce = space == "nce"
    db = data_cfg.dataset
    split_cfg = db[split]
    ds = builders.build_dataset(db, split_cfg, return_audio=nce,
                                return_labels=db["name"] not in ("audioset",), fold=fold)
    model, source = (load_full_model if nce else load_backbone)(model_cfg, dev)
    if source is None:
        raise FileNotFoundError("no checkpoint.pth.tar or port run under "
                                f"{os.path.join(model_cfg['model_dir'], model_cfg['name'])}")
    pp_cfg = builders.build_preprocess_config(db, model_cfg.get("dtype"))
    names = ["video", "audio"] if nce else list(taps)
    dense = split_cfg.get("mode", "clip") == "video"
    # dense: one video a row, its clips fill the forward
    loader = DataLoader(ds, batch_size=1 if dense else int(batch_size or db.get("batch_size", 8)),
                        shuffle=False, drop_last=False, num_workers=max(num_workers, 1))

    def flat(x: np.ndarray) -> torch.Tensor:
        """(B, clips, ...) -> (B * clips, ...) on the device in dense mode."""
        x = torch.from_numpy(np.asarray(x))
        return (x.reshape(-1, *x.shape[2:]) if dense else x).to(dev)

    def mean_clips(e: torch.Tensor, b: int) -> np.ndarray:
        e = e.float()
        return (e.reshape(b, -1, e.shape[-1]).mean(dim=1) if dense else e).cpu().numpy()

    feats = {t: [] for t in names}
    labels, indices = [], []
    seen = 0
    with evaluating(model):
        for batch in loader:
            b = np.asarray(batch["frames"]).shape[0]
            raw = {"frames": flat(batch["frames"])}
            if nce:
                raw["audio"] = flat(batch["audio"])
            pp = preprocess_batch(raw, pp_cfg, train=False)
            if nce:
                for t, e in zip(names, model(pp["frames"], pp["audio"])):
                    e = e.float()
                    feats[t].append(mean_clips(
                        e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(1e-12),
                        b))
            else:
                embs = model(pp["frames"], return_embs=True)
                for t in names:
                    e = embs[t]
                    if e.dim() > 2:  # conv tap (B', T, H, W, C) -> (B', C)
                        e = e.amax(dim=tuple(range(1, e.dim() - 1)))
                    feats[t].append(mean_clips(e, b))
            if "label" in batch:
                labels.append(np.asarray(batch["label"]).reshape(-1))
            idx = np.asarray(batch["index"])
            if idx.ndim > 1:  # dense mode: one index a clip, one video a row
                idx = idx[:, 0]
            indices.append(idx.reshape(-1))
            seen += int(idx.size)
            if max_items is not None and seen >= max_items:
                break
    out = {t: np.concatenate(v)[:max_items] for t, v in feats.items()}
    labels_arr = np.concatenate(labels)[:max_items] if labels else None
    return out, labels_arr, np.concatenate(indices)[:max_items]


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    data_cfg = config_lib.load(args.data_cfg, overrides=args.overrides)
    model_cfg = config_lib.load(args.model_cfg).model
    feats, labels, indices = extract_features(
        data_cfg, model_cfg, split=args.split, taps=args.taps, space=args.space,
        fold=args.fold, batch_size=args.batch_size, max_items=args.max_items,
        num_workers=args.num_workers, device=args.device)
    payload = {f"feat_{t}": v for t, v in feats.items()}
    payload["index"] = indices
    if labels is not None:
        payload["label"] = labels
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **payload)
    dims = {t: v.shape[1:] for t, v in feats.items()}
    print(f"wrote {args.out}: {indices.shape[0]} items, taps {dims}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
