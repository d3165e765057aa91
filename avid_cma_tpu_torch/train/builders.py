"""Config-driven builders (counterpart of avid_cma_tpu/train/builders.py).

``pretrain_config(cfg)`` turns a loaded YAML ``Config`` into the frozen
``PretrainConfig`` the step builders take; ``kinetics_cross_n1024()`` and
``kinetics_cma()`` are the published Kinetics recipes
``configs/main/avid/kinetics/Cross-N1024.yaml`` and
``configs/main/avid-cma/kinetics/InstX-N1024-PosW-N64-Top32.yaml`` written
out as ones (CPU tests hold them to their YAML).
``build_pretrain`` wires model, optimizer, banks and the fused step on a
device; ``build_eval`` the same state with the fused eval-loss step and
the embed fn. ``build_preprocess_config``, ``build_dataset`` and
``build_dataloader`` wire the YAML's ``dataset`` section to the host data
layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

import avid_cma_tpu_torch.data  # noqa: F401  (registers the datasets)
from avid_cma_tpu_torch.config import Config
from avid_cma_tpu_torch.criterions.avid import AVIDConfig
from avid_cma_tpu_torch.criterions.avid_cma import AVIDCMAConfig
from avid_cma_tpu_torch.data.loader import CachedDataLoader, DataLoader, MultiprocessDataLoader
from avid_cma_tpu_torch.data.pipelines import PreprocessConfig
from avid_cma_tpu_torch.registry import DATASETS
from avid_cma_tpu_torch.device import compute_dtype, prepare_device
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.parallel.sharding import BankLayout
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import (
    init_train_state,
    make_embed_fn,
    make_fused_eval_step,
    make_fused_train_step,
)

LOSSES = ("AVID", "AVID_CMA")


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    seed: int
    # dataset
    global_batch_size: int      # over the reference's replicas
    num_replicas: int           # GPUs the published recipe ran on
    video_clip_duration: float
    video_fps: float
    crop_size: int
    audio_clip_duration: float
    audio_fps: int
    spectrogram_fps: float
    n_fft: int
    transform: str
    # optimizer
    optimizer: str
    weight_decay: float
    base_lr: float
    gamma: float
    milestones: Tuple[int, ...]
    # model
    proj_dim: Tuple[int, ...]
    video_backbone: str
    video_depth: int
    audio_backbone: str
    audio_depth: int
    # loss: AVID or AVID_CMA
    loss: str = "AVID"
    num_data: int = 232067
    num_negatives: int = 1024
    momentum: float = 0.5
    xModal_coeff: float = 1.0
    wModal_coeff: float = 0.0
    # AVID-CMA only: the four heads' coefficients and the mining
    num_negatives_within: Optional[int] = 64
    xModalInstCoeff: float = 1.0
    wModalInstCoeff: float = 0.0
    xModalPosCoeff: float = 0.0
    wModalPosCoeff: float = 1.0
    pos_k: int = 32
    sampling_type: str = "consensus"
    mining_exact: bool = True
    resample_freq: int = -1
    # video augmentation (PreprocessConfig's defaults)
    min_area: float = 0.08
    color: Tuple[float, float, float, float] = (0.4, 0.4, 0.4, 0.2)
    resize: Tuple[int, int] = (256, 256)
    jitter_order: str = "canonical"
    # model.dtype: the convolutions' and the clips' compute dtype
    model_dtype: str = "auto"

    @property
    def batch_size(self) -> int:
        """Clips per chip per step."""
        return self.global_batch_size // self.num_replicas

    @property
    def num_frames(self) -> int:
        return int(round(self.video_clip_duration * self.video_fps))

    def preprocess(self) -> PreprocessConfig:
        return PreprocessConfig(
            transform=self.transform, crop_size=self.crop_size,
            min_area=self.min_area, color=self.color, resize=self.resize,
            jitter_order=self.jitter_order,
            audio_fps=self.audio_fps, n_fft=self.n_fft,
            spectrogram_fps=self.spectrogram_fps,
            audio_clip_duration=self.audio_clip_duration, model_dtype=self.model_dtype)

    def criterion(self, embedding_dim: int) -> Union[AVIDConfig, AVIDCMAConfig]:
        if self.loss == "AVID_CMA":
            return AVIDCMAConfig(
                num_data=self.num_data, embedding_dim=embedding_dim,
                num_negatives=self.num_negatives,
                num_negatives_within=self.num_negatives_within, momentum=self.momentum,
                xModalInstCoeff=self.xModalInstCoeff, wModalInstCoeff=self.wModalInstCoeff,
                xModalPosCoeff=self.xModalPosCoeff, wModalPosCoeff=self.wModalPosCoeff,
                pos_k=self.pos_k, sampling_type=self.sampling_type,
                mining_exact=self.mining_exact, resample_freq=self.resample_freq)
        return AVIDConfig(
            num_data=self.num_data, embedding_dim=embedding_dim,
            num_negatives=self.num_negatives, momentum=self.momentum,
            xModal_coeff=self.xModal_coeff, wModal_coeff=self.wModal_coeff)


def kinetics_cross_n1024() -> PretrainConfig:
    """configs/main/avid/kinetics/Cross-N1024.yaml: 256 clips over 8 GPUs
    (32 per chip), 8 frames at 224^2, 2 s of 24 kHz audio, R2Plus1D-18 +
    Conv2D-10 with [512, 512, 128] heads, N = 232,067 bank rows, 1024
    negatives, momentum 0.5, Adam 2e-4 with wd 1e-5 and gamma 1."""
    return PretrainConfig(
        seed=0,
        global_batch_size=256, num_replicas=8,
        video_clip_duration=0.5, video_fps=16.0, crop_size=224,
        audio_clip_duration=2.0, audio_fps=24000, spectrogram_fps=100.0,
        n_fft=512, transform="msc+color",
        optimizer="adam", weight_decay=1e-5, base_lr=2e-4,
        gamma=1.0, milestones=(5, 10, 15, 20, 25, 30),
        proj_dim=(512, 512, 128), video_backbone="R2Plus1D", video_depth=18,
        audio_backbone="Conv2D", audio_depth=10,
        num_data=232067, num_negatives=1024, momentum=0.5,
        xModal_coeff=1.0, wModal_coeff=0.0,
    )


def kinetics_cma() -> PretrainConfig:
    """configs/main/avid-cma/kinetics/InstX-N1024-PosW-N64-Top32.yaml: the
    Cross-N1024 model, data and optimizer (32 clips per chip), 20 epochs
    with milestones 5, 10, 15, and the AVID-CMA loss: cross-modal instance
    discrimination plus within-modal positives, 1024 negatives (64 within),
    the top-32 consensus positives re-mined every 5 epochs."""
    return dataclasses.replace(
        kinetics_cross_n1024(), milestones=(5, 10, 15), loss="AVID_CMA",
        num_negatives_within=64, xModalInstCoeff=1.0, wModalInstCoeff=0.0,
        xModalPosCoeff=0.0, wModalPosCoeff=1.0, pos_k=32, sampling_type="consensus",
        mining_exact=True, resample_freq=5)


def check_model_dtype(spec, device: str | torch.device) -> None:
    """Raise unless ``model.dtype`` = ``spec`` runs on ``device``
    (avid_cma_tpu/train/builders.py:20-42): ``auto``, ``float32`` and
    ``bfloat16`` on the card (the stem kernels K2/K3 and K5 have bf16 and
    f32 forms); ``auto`` and ``float32`` on the CPU, whose path computes
    f32 only (``bfloat16`` raises there). ``compute_dtype`` gives the
    dtype."""
    compute_dtype(device, spec)


def build_preprocess_config(db_cfg: Config, model_dtype=None) -> PreprocessConfig:
    """Dispatch on the dataset's ``transform:``/``transforms:`` key
    (reference: utils/eval_utils.py:70-87, utils/main_utils.py:151-165;
    unknown values raise there and here). The clips come out in the
    compute dtype of ``model_dtype``, the model's ``model.dtype``.

    Reference quirk kept: for 'crop+color' the reference dispatch passes
    ONLY crop/num_frames/pad_missing/augment (utils/eval_utils.py:80-85),
    so VideoPrep_Crop_CJ runs its default color (0.4, 0.4, 0.4, 0.2) and
    the config's ``color:`` is ignored; ``resize:`` is honoured (it
    matches the default in every shipped config)."""
    transform = str(db_cfg.get("transform", db_cfg.get("transforms", "msc+color"))).strip()
    if transform not in ("msc+color", "crop+color"):
        raise ValueError(
            f"unknown dataset transform {transform!r}: expected 'msc+color' or "
            "'crop+color' (reference raises too, utils/eval_utils.py:86-87)")
    if transform == "crop+color":
        resize = db_cfg.get("resize", 256)
        if isinstance(resize, (list, tuple)):
            resize = tuple(int(r) for r in resize)
        else:
            resize = (int(resize), int(resize))
        color = (0.4, 0.4, 0.4, 0.2)
    else:
        resize = (256, 256)
        color = tuple(float(c) for c in db_cfg.get("color", (0.4, 0.4, 0.4, 0.2)))
    return PreprocessConfig(
        transform=transform,
        crop_size=int(db_cfg.get("crop_size", 224)),
        min_area=float(db_cfg.get("min_area", 0.08)),
        color=color,
        resize=resize,
        jitter_order=str(db_cfg.get("jitter_order", "canonical")),
        audio_fps=int(db_cfg.get("audio_fps", 24000)),
        n_fft=int(db_cfg.get("n_fft", 512)),
        spectrogram_fps=float(db_cfg.get("spectrogram_fps", 100.0)),
        audio_clip_duration=float(db_cfg.get("audio_clip_duration", 2.0)),
        model_dtype="auto" if model_dtype is None else str(model_dtype),
    )


def pretrain_config(cfg: Config, num_data: Optional[int] = None) -> PretrainConfig:
    """The ``PretrainConfig`` of a loaded pretraining YAML, for one card
    taking ``dataset.batch_size`` clips a step (the loop splits the
    global batch over its ranks itself). ``num_data`` overrides
    ``loss.args.num_data`` (the loop passes the dataset's size). Raises
    for what the port does not build: another ``model.arch`` than
    av_wrapper, another loss than AVID and AVID_CMA (or AVID-CMA)."""
    if str(cfg.model.get("arch", "av_wrapper")) != "av_wrapper":
        raise ValueError(f"model.arch {cfg.model.get('arch')!r}: the port builds av_wrapper only")
    loss_name = str(cfg.loss["name"]).replace("-", "_")
    if loss_name not in LOSSES:
        raise ValueError(f"loss.name {cfg.loss['name']!r}: expected one of {LOSSES}")
    db, opt, args = cfg.dataset, cfg.optimizer, cfg.model.get("args", {})
    loss = cfg.loss.get("args", {})
    sampling = loss.get("sampling_args", {}) or {}
    within = loss.get("num_negatives_within", 64)
    pp = build_preprocess_config(db, cfg.model.get("dtype"))
    proj = args.get("proj_dim", 128)
    return PretrainConfig(
        seed=int(cfg.get("seed", 0)),
        global_batch_size=int(db["batch_size"]), num_replicas=1,
        video_clip_duration=float(db.get("video_clip_duration", db.get("clip_duration", 0.5))),
        video_fps=float(db.get("video_fps", 16.0)),
        crop_size=pp.crop_size,
        audio_clip_duration=pp.audio_clip_duration, audio_fps=pp.audio_fps,
        spectrogram_fps=pp.spectrogram_fps, n_fft=pp.n_fft, transform=pp.transform,
        optimizer=str(opt.get("name", "adam")),
        weight_decay=float(opt.get("weight_decay", 0.0)),
        base_lr=float(opt["lr"]["base_lr"]),
        gamma=float(opt["lr"].get("gamma", 1.0)),
        milestones=tuple(int(m) for m in opt["lr"].get("milestones", ())),
        proj_dim=tuple(int(p) for p in (proj if isinstance(proj, (list, tuple)) else [proj])),
        video_backbone=str(args.get("video_backbone", "R2Plus1D")),
        video_depth=int(args.get("video_backbone_args", {}).get("depth", 18)),
        audio_backbone=str(args.get("audio_backbone", "Conv2D")),
        audio_depth=int(args.get("audio_backbone_args", {}).get("depth", 10)),
        loss=loss_name,
        num_data=int(num_data if num_data is not None else loss["num_data"]),
        num_negatives=int(loss.get("num_negatives", 1024)),
        momentum=float(loss.get("momentum", 0.5)),
        xModal_coeff=float(loss.get("xModal_coeff", 1.0)),
        wModal_coeff=float(loss.get("wModal_coeff", 0.0)),
        num_negatives_within=None if within is None else int(within),
        xModalInstCoeff=float(loss.get("xModalInstCoeff", 1.0)),
        wModalInstCoeff=float(loss.get("wModalInstCoeff", 0.0)),
        xModalPosCoeff=float(loss.get("xModalPosCoeff", 0.0)),
        wModalPosCoeff=float(loss.get("wModalPosCoeff", 1.0)),
        pos_k=int(sampling.get("pos_k", 32)),
        sampling_type=str(sampling.get("type", "consensus")),
        mining_exact=bool(sampling.get("exact", True)),
        resample_freq=int(loss.get("resample_freq", -1)),
        min_area=pp.min_area, color=pp.color, resize=pp.resize,
        jitter_order=pp.jitter_order, model_dtype=pp.model_dtype,
    )


def build_dataset(db_cfg: Config, split_cfg: Config, mode: Optional[str] = None,
                  return_audio: bool = True, return_labels: bool = False,
                  fold: Optional[int] = None):
    """reference: utils/main_utils.py:138-212 (transform + dataset
    assembly) and utils/eval_utils.py:67-128 (benchmark variants).
    Decode-only on the host; device preprocessing replaces the transform
    objects."""
    name = db_cfg["name"]
    split = split_cfg["split"]
    if fold is not None:
        split = split.format(fold=fold)
    kwargs = dict(
        subset=split,
        root=db_cfg.get("root"),
        backend=db_cfg.get("backend", "auto"),
        mode=mode or split_cfg.get("mode", "clip"),
        return_video=True,
        video_clip_duration=float(
            db_cfg.get("video_clip_duration", db_cfg.get("clip_duration", 0.5))),
        video_fps=float(db_cfg.get("video_fps", 16.0)),
        return_audio=return_audio,
        return_labels=return_labels,
        return_index=True,
        max_offsync_augm=0.5 if split_cfg.get("use_augmentation") and return_audio else 0.0,
        mode_clips_per_video=int(split_cfg.get("clips_per_video", 1)),
    )
    if return_audio:
        kwargs.update(
            audio_clip_duration=float(db_cfg.get("audio_clip_duration", 2.0)),
            audio_fps=int(db_cfg.get("audio_fps", 24000)),
        )
    if "synthetic_size" in db_cfg:
        kwargs["synthetic_size"] = int(db_cfg["synthetic_size"])
    if name == "synthetic_av" and "num_classes" in db_cfg:
        # only the learnable synthetic dataset takes this constructor arg
        kwargs["num_classes"] = int(db_cfg["num_classes"])
    if db_cfg.get("decode_size") is not None:
        # fixed decode size (H, W): real backends cover-scale+crop at
        # decode time, so heterogeneous media gives one batch shape
        kwargs["decode_size"] = tuple(int(x) for x in db_cfg["decode_size"])
    if db_cfg.get("anno_path") is not None:
        kwargs["anno_path"] = db_cfg["anno_path"]
    if db_cfg.get("cache_path") is not None and name == "audioset":
        kwargs["cache_path"] = db_cfg["cache_path"]
        kwargs.pop("anno_path", None)
    if name == "audioset":
        kwargs["return_labels"] = False  # AudioSet has no labels here
    return DATASETS.get(name)(**kwargs)


def build_dataloader(dataset, db_cfg: Config, split_cfg: Config, num_workers: int = 4,
                     num_shards: int = 1, shard_index: int = 0, seed: int = 0,
                     kind: str = "threaded"):
    """reference: utils/main_utils.py:214-228 (DataLoader +
    DistributedSampler, per-process batch division). ``kind`` (the
    config's top-level ``loader:``): 'threaded', the in-process
    prefetcher; 'native', producer processes over the C++ shared-memory
    ring (raises when g++ cannot build it); 'cached', decode once and
    replay from host memory."""
    common = dict(
        batch_size=int(db_cfg["batch_size"]) // max(num_shards, 1),
        shuffle=bool(split_cfg.get("use_shuffle", split_cfg.get("use_augmentation", True))),
        drop_last=bool(split_cfg.get("drop_last", True)),
        num_workers=num_workers,
        num_shards=num_shards,
        shard_index=shard_index,
        seed=seed,
    )
    if kind == "native":
        loader = MultiprocessDataLoader(dataset, **common)
    elif kind == "threaded":
        loader = DataLoader(dataset, **common)
    elif kind == "cached":
        loader = CachedDataLoader(DataLoader(dataset, **common))
    else:
        raise ValueError(f"unknown loader kind '{kind}' (threaded|native|cached)")
    if len(loader) == 0:
        raise ValueError(
            f"empty loader: dataset has {len(dataset)} items but "
            f"batch_size={common['batch_size']} with "
            f"drop_last={common['drop_last']} yields zero batches")
    return loader


def _build_state(cfg: PretrainConfig, device: str | torch.device,
                 layout: Optional[BankLayout] = None
                 ) -> Tuple[TrainState, Union[AVIDConfig, AVIDCMAConfig]]:
    dev = prepare_device(device)
    model = av_wrapper(
        cfg.video_backbone, {"depth": cfg.video_depth},
        cfg.audio_backbone, {"depth": cfg.audio_depth},
        proj_dim=list(cfg.proj_dim), seed=cfg.seed,
        device=dev, dtype=cfg.model_dtype)
    optimizer = build_optimizer(model.parameters(), cfg.optimizer, cfg.base_lr,
                                weight_decay=cfg.weight_decay)
    scheduler = multistep_scheduler(optimizer, cfg.milestones, cfg.gamma)
    criterion = cfg.criterion(model.out_dim)
    return (init_train_state(model, optimizer, scheduler, criterion, cfg.seed, layout),
            criterion)


def build_pretrain(cfg: PretrainConfig, device: str | torch.device = "cuda",
                   layout: Optional[BankLayout] = None) -> Tuple[TrainState, Callable]:
    """(state, fused_step) for AVID or AVID-CMA pretraining on ``device``
    (for AVID-CMA the state's positive set is zeroed: mine it with
    ``criterions.mining.mine_positives`` before the first step); call
    ``fused_step(state, raw_batch, step_i)`` with raw batches
    {frames: uint8 (B,T,H,W,3), audio: f32 (B,L), index: (B,)} on the
    device. ``layout`` (``parallel.sharding.BankLayout``; default one
    process, replicated) places the banks over the ranks. Raises when
    ``device`` is CUDA and no card is present."""
    state, criterion = _build_state(cfg, device, layout)
    return state, make_fused_train_step(criterion, cfg.preprocess(), cfg.seed)


def build_eval(cfg: PretrainConfig, device: str | torch.device = "cuda"
               ) -> Tuple[TrainState, Callable, Callable]:
    """(state, fused_eval_step, embed) for held-out evaluation of the
    model on ``device``, the state built as ``build_pretrain``'s. Call
    ``fused_eval_step(state, raw_batch, batch_idx)`` with raw batches as
    for the train step (the eval preprocessing: resize and centre crop,
    no volume jitter), and ``embed(video, audio)`` with preprocessed
    inputs. Neither changes the state. Raises when ``device`` is CUDA and
    no card is present."""
    state, criterion = _build_state(cfg, device)
    return (state, make_fused_eval_step(criterion, cfg.preprocess(), cfg.seed),
            make_embed_fn(state.model))
