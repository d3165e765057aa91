"""The slice's configuration and its builder.

``kinetics_cross_n1024()`` holds the values of the published Kinetics
recipe ``configs/main/avid/kinetics/Cross-N1024.yaml`` that this slice
uses, as a frozen dataclass (the card host has no ``yaml``; a CPU test
holds the two together). ``build_pretrain`` wires model, optimizer,
banks and the fused step on a device; ``build_eval`` the same state with
the fused eval-loss step and the embed fn.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from avid_cma_tpu_torch.criterions.avid import AVIDConfig
from avid_cma_tpu_torch.data.pipelines import PreprocessConfig
from avid_cma_tpu_torch.device import resolve_device, set_full_f32_precision
from avid_cma_tpu_torch.models.av_wrapper import av_wrapper
from avid_cma_tpu_torch.train.optim import build_optimizer, multistep_scheduler
from avid_cma_tpu_torch.train.state import TrainState
from avid_cma_tpu_torch.train.step import (
    init_train_state,
    make_embed_fn,
    make_fused_eval_step,
    make_fused_train_step,
)


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
    # loss
    num_data: int = 232067
    num_negatives: int = 1024
    momentum: float = 0.5
    xModal_coeff: float = 1.0
    wModal_coeff: float = 0.0

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
            audio_fps=self.audio_fps, n_fft=self.n_fft,
            spectrogram_fps=self.spectrogram_fps,
            audio_clip_duration=self.audio_clip_duration)

    def criterion(self, embedding_dim: int) -> AVIDConfig:
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


def _build_state(cfg: PretrainConfig, device: str | torch.device
                 ) -> Tuple[TrainState, AVIDConfig]:
    dev = resolve_device(device)
    set_full_f32_precision()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: tune once
    model = av_wrapper(
        cfg.video_backbone, {"depth": cfg.video_depth},
        cfg.audio_backbone, {"depth": cfg.audio_depth},
        proj_dim=list(cfg.proj_dim), seed=cfg.seed,
        device=dev)
    optimizer = build_optimizer(model.parameters(), cfg.optimizer, cfg.base_lr,
                                weight_decay=cfg.weight_decay)
    scheduler = multistep_scheduler(optimizer, cfg.milestones, cfg.gamma)
    criterion = cfg.criterion(model.out_dim)
    return init_train_state(model, optimizer, scheduler, criterion, cfg.seed), criterion


def build_pretrain(cfg: PretrainConfig, device: str | torch.device = "cuda"
                   ) -> Tuple[TrainState, Callable]:
    """(state, fused_step) for AVID pretraining on ``device``; call
    ``fused_step(state, raw_batch, step_i)`` with raw batches
    {frames: uint8 (B,T,H,W,3), audio: f32 (B,L), index: (B,)} on the
    device. Raises when ``device`` is CUDA and no card is present."""
    state, criterion = _build_state(cfg, device)
    return state, make_fused_train_step(criterion, cfg.preprocess(), cfg.seed)


def build_eval(cfg: PretrainConfig, device: str | torch.device = "cuda"
               ) -> Tuple[TrainState, Callable, Callable]:
    """(state, fused_eval_step, embed) for held-out evaluation of the AVID
    model on ``device``, the state built as ``build_pretrain``'s. Call
    ``fused_eval_step(state, raw_batch, batch_idx)`` with raw batches as
    for the train step (the eval preprocessing: resize and centre crop,
    no volume jitter), and ``embed(video, audio)`` with preprocessed
    inputs. Neither changes the state. Raises when ``device`` is CUDA and
    no card is present."""
    state, criterion = _build_state(cfg, device)
    return (state, make_fused_eval_step(criterion, cfg.preprocess(), cfg.seed),
            make_embed_fn(state.model))
