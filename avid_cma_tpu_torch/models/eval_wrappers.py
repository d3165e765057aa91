"""Eval wrappers: the full-finetune classification head and the
multi-tap frozen linear probes (counterpart of
avid_cma_tpu/models/eval_wrappers.py).

- ``ClassificationWrapper``: backbone tap -> optional pooling -> flatten
  -> optional dropout -> Linear. It finetunes end to end on UCF/HMDB; the
  warmup phase trains the classifier only (``classifier_parameters``).
- ``Classifier``: the probe head over a frozen feature: [dropout] ->
  [l2norm] -> pooling -> BatchNorm over (B, F) -> Linear.
- ``MOSTModel``: a frozen extractor emitting several taps, one
  ``Classifier`` per tap. The extractor always runs in eval mode (BN
  running stats, K5 on its stride-1 pairs on the card) and under
  ``torch.no_grad``, whatever ``train()`` the caller sets: the reference
  built it in eval mode, but ``model.train(True)`` flipped its BN layers
  back to batch statistics (the JAX package's deliberate divergence,
  kept here).

Taps are channels-last (B, T, H, W, C) and are flattened in (T, H, W, C)
order, as the JAX package's reshape of channels-last maps, so carried
over Linear weights mean the same thing. Module names follow the flax
tree (``feature_extractor``, ``classifier``, ``classifier_<tap>.bn``,
``classifier_<tap>.classifier``), the keys
``train.checkpoint.flax_eval_to_port_state`` emits. The heads compute in
float32 whatever dtype the backbone runs at: the taps are cast before
the head, so logits and the cross-entropy are f32 on the card too.

Dropout draws its mask from the generator passed to ``forward`` (the
train step's, seeded by the step), so a resumed run repeats the straight
run.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from avid_cma_tpu_torch.criterions.avid import l2_normalize
from avid_cma_tpu_torch.models.blocks import BatchNorm
from avid_cma_tpu_torch.ops.conv3d import lecun_normal_
from avid_cma_tpu_torch.ops.pooling import apply_pooling_op, pooled_shape


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator``: each
    element kept with probability 1 - p and scaled by 1 / (1 - p)."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def tap_shapes(feature_extractor: nn.Module, clip_shape: Tuple[int, int, int]
               ) -> Dict[str, Tuple[int, ...]]:
    """The per-clip shape of each tap of ``feature_extractor(x,
    return_embs=True)`` for clips of ``clip_shape`` (T, H, W): read from one
    forward of a zero clip on the extractor's device, in eval mode and
    without gradients, so that its BN running stats stay as they are."""
    device = next(feature_extractor.parameters()).device
    mode = feature_extractor.training
    feature_extractor.eval()
    try:
        with torch.no_grad():
            taps = feature_extractor(torch.zeros((1, *clip_shape, 3), device=device),
                                     return_embs=True)
    finally:
        feature_extractor.train(mode)
    return {name: tuple(t.shape[1:]) for name, t in taps.items()}


def _linear(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    """flax Dense's default init: lecun_normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class ClassificationWrapper(nn.Module):
    """forward(x (B, T, H, W, 3)) -> f32 logits (B, n_classes).
    ``clip_shape`` (T, H, W) sizes the classifier's input."""

    def __init__(self, feature_extractor: nn.Module, n_classes: int,
                 clip_shape: Tuple[int, int, int], feat_name: str = "pool",
                 pooling_op: Optional[str] = None, use_dropout: bool = False,
                 dropout: float = 0.5, seed: int = 0):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.feat_name = feat_name
        self.pooling_op = pooling_op
        self.use_dropout = use_dropout
        self.dropout = dropout
        shape = pooled_shape(tap_shapes(feature_extractor, clip_shape)[feat_name], pooling_op)
        self.classifier = _linear(math.prod(shape), n_classes,
                                  torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.feature_extractor(x, return_embs=True)[self.feat_name]
        emb = apply_pooling_op(emb, self.pooling_op).float().reshape(x.shape[0], -1)
        if self.use_dropout and self.training:
            emb = dropout(emb, self.dropout, generator)
        return self.classifier(emb)


class Classifier(nn.Module):
    """Per-tap probe head over a detached feature (B, F) or map
    (B, T, H, W, C), computed in f32: only the BatchNorm and the Linear
    train; the Linear's weights are drawn from ``generator``."""

    def __init__(self, feat_shape: Tuple[int, ...], n_classes: int, generator: torch.Generator,
                 pooling: Optional[str] = None, l2_norm: bool = False,
                 use_bn: bool = True, use_dropout: bool = False):
        super().__init__()
        self.pooling = pooling
        self.l2_norm = l2_norm
        self.use_dropout = use_dropout
        shape = pooled_shape(feat_shape, pooling) if len(feat_shape) > 1 else feat_shape
        features = math.prod(shape)
        self.bn = BatchNorm(features) if use_bn else None
        self.classifier = _linear(features, n_classes, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.detach()
        if self.use_dropout and self.training:
            x = dropout(x.float(), 0.5, generator)
        if self.l2_norm:
            x = l2_normalize(x.float())
        if x.dim() > 2:
            # a max commutes with the exact bf16 -> f32 cast: pool first
            x = apply_pooling_op(x, self.pooling)
        x = x.float().reshape(x.shape[0], -1)
        if self.bn is not None:
            x = self.bn(x)
        return self.classifier(x)


class MOSTModel(nn.Module):
    """Multi-Output-Single-Tap probes over a frozen extractor:
    forward(x) -> {tap: f32 logits (B, n_classes)}. ``l2_norm`` is None,
    one bool for every tap, or one per tap."""

    def __init__(self, feature_extractor: nn.Module, n_classes: int,
                 feat_names: Sequence[str], pooling_ops: Sequence[Optional[str]],
                 clip_shape: Tuple[int, int, int],
                 l2_norm: Union[None, bool, Sequence[bool]] = None,
                 use_bn: bool = False, use_dropout: bool = False, seed: int = 0):
        super().__init__()
        if len(pooling_ops) != len(feat_names):
            raise ValueError(f"{len(feat_names)} taps but {len(pooling_ops)} pooling ops")
        if l2_norm is None:
            l2 = [False] * len(feat_names)
        elif isinstance(l2_norm, (list, tuple)):
            l2 = [bool(v) for v in l2_norm]
        else:
            l2 = [bool(l2_norm)] * len(feat_names)
        self.feature_extractor = feature_extractor.requires_grad_(False)
        self.feat_names = list(feat_names)
        shapes = tap_shapes(feature_extractor, clip_shape)
        gen = torch.Generator().manual_seed(seed)
        for ft, pool, norm in zip(self.feat_names, pooling_ops, l2):
            self.add_module(f"classifier_{ft}", Classifier(
                shapes[ft], n_classes, gen, pooling=pool, l2_norm=norm, use_bn=use_bn,
                use_dropout=use_dropout))
        self.feature_extractor.eval()

    def train(self, mode: bool = True) -> "MOSTModel":
        super().train(mode)
        self.feature_extractor.eval()  # frozen: running stats, whatever the mode
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            embs = self.feature_extractor(x, return_embs=True)
        return {ft: getattr(self, f"classifier_{ft}")(embs[ft], generator)
                for ft in self.feat_names}


def classifier_parameters(model: nn.Module) -> Iterator[nn.Parameter]:
    """The parameters the warmup and the probe train: every one outside
    ``feature_extractor`` (the reference's filter, eval-action-recg.py:77)."""
    return (p for name, p in model.named_parameters()
            if not name.startswith("feature_extractor."))
