"""Audio-visual wrapper: two backbones + per-modality MLP projection heads
(counterpart of avid_cma_tpu/models/av_wrapper.py and the backbone
registry of avid_cma_tpu/registry.py).

Module names give the reference state-dict keys
(``video_model.conv1.0.weight``, ``video_proj.projection.<i>.weight``), so
``train.checkpoint.flax_to_port_state`` output loads with strict=True.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn as nn

from avid_cma_tpu_torch.device import compute_dtype, resolve_device
from avid_cma_tpu_torch.models.audio import Conv2D
from avid_cma_tpu_torch.models.blocks import Conv2DLayer
from avid_cma_tpu_torch.models.video import R2Plus1D
from avid_cma_tpu_torch.ops.conv3d import Conv3D, lecun_normal_

BACKBONES = {"R2Plus1D": R2Plus1D, "Conv2D": Conv2D}


class Head(nn.Module):
    """MLP projection head, ReLU between layers. Always computes in f32,
    whatever dtype the backbones run at: bf16 unit embeddings quantize
    cosines to ~0.004 steps, enough to collapse instance discrimination
    (models/av_wrapper.py:18-48 of the JAX package)."""

    def __init__(self, in_dim: int, proj_dims: Sequence[int]):
        super().__init__()
        layers = []
        for i, d in enumerate(proj_dims):
            layers.append(nn.Linear(in_dim, d))
            if i < len(proj_dims) - 1:
                layers.append(nn.ReLU())
            in_dim = d
        self.projection = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(x.float())


class AVWrapper(nn.Module):
    """forward(video, audio) -> (video_emb, audio_emb), each (B, proj[-1])."""

    def __init__(self, video_model: nn.Module, audio_model: nn.Module,
                 proj_dim: Union[int, Sequence[int]] = 128):
        super().__init__()
        self.video_model = video_model
        self.audio_model = audio_model
        dims = list(proj_dim) if isinstance(proj_dim, (list, tuple)) else [proj_dim]
        self.video_proj = Head(video_model.out_dim, dims)
        self.audio_proj = Head(audio_model.out_dim, dims)
        self.out_dim = dims[-1]

    def forward(self, video: torch.Tensor, audio: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.video_proj(self.video_model(video)),
                self.audio_proj(self.audio_model(audio)))

    def embeddings(self, video: torch.Tensor, audio: torch.Tensor
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Intermediate taps of both backbones."""
        return {
            "video": self.video_model(video, return_embs=True),
            "audio": self.audio_model(audio, return_embs=True),
        }


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers: lecun_normal conv and dense kernels,
    zero dense biases (BatchNorm starts at scale 1, bias 0)."""
    for m in model.modules():
        if isinstance(m, (Conv3D, Conv2DLayer, nn.Linear)):
            lecun_normal_(m.weight, generator)
        if isinstance(m, nn.Linear):
            nn.init.zeros_(m.bias)


def av_wrapper(
    video_backbone: str,
    video_backbone_args: dict | None = None,
    audio_backbone: str = "Conv2D",
    audio_backbone_args: dict | None = None,
    proj_dim: Union[int, Sequence[int]] = 128,
    seed: int = 0,
    device: str | torch.device = "cuda",
    dtype=None,
) -> AVWrapper:
    """Build the AV model with weights initialized from ``seed`` (on the
    CPU, then moved), on ``device``; raises when ``device`` is CUDA and no
    card is present. Convolutions compute in the dtype of ``model.dtype``
    = ``dtype`` (``compute_dtype``: by default bf16 on CUDA and f32 on
    the CPU); parameters are always f32."""
    dev = resolve_device(device)
    cdt = compute_dtype(dev, dtype)
    model = AVWrapper(
        BACKBONES[video_backbone](**dict(video_backbone_args or {}), dtype=cdt),
        BACKBONES[audio_backbone](**dict(audio_backbone_args or {}), dtype=cdt),
        proj_dim=proj_dim,
    )
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev)
