"""AVID-CMA criterion: instance discrimination plus positive-set
discrimination against the dual memory banks (counterpart of
avid_cma_tpu/criterions/avid_cma.py).

Per step (reference: criterions/avid_cma.py:150-194), the active heads:

- inst-v2a / inst-a2v (``xModalInstCoeff``): the self bank row of the
  other modality against K negatives;
- inst-v2v / inst-a2a (``wModalInstCoeff``): the same within a modality;
- pos-v2a / pos-a2v (``xModalPosCoeff``): the mined positives of the
  other modality against K negatives;
- pos-v2v / pos-a2a (``wModalPosCoeff``): the mined positives within a
  modality against the first ``num_negatives_within`` negatives.

Every score goes through ``gather_scores`` (kernel K4 on the card; with
row-sharded banks ``scores_sharded``, K4 on each shard): the
self row is ``y[:, None]``, the positives ``positive_set[y]`` (B, pos_k),
the negatives (B, K), the within-modal negatives a contiguous copy of
their first columns (K4 takes contiguous indices only). Negatives are
drawn uniformly past each row's sorted positive set (rank shift), so,
like the reference, they exclude the positives but not the self index.
Z freezes from the first active head's negatives, in the order inst-x,
inst-w, pos-x, pos-w; the four losses combine with the normalized
coefficients (avid_cma.py:338-359); the banks take the EMA of the
embeddings.

As the JAX function, the embeddings are not cast to f32 on entry (the
heads emit f32 on the main path, so nothing changes there), and
``wModalInst`` scores within a modality as its name says, not the
reference's dead code that recomputes the cross-modal scores
(avid_cma.py:175-177).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from avid_cma_tpu_torch.criterions.avid import (
    TEMPERATURE,
    BankState,
    bank_scorer,
    update_banks,
)
from avid_cma_tpu_torch.criterions.nce import l2_normalize, nce_loss, resolve_partition
from avid_cma_tpu_torch.ops.sampling import draw_negatives_avoid_sorted
from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.sharding import BankLayout, gather_values_sharded


@dataclasses.dataclass(frozen=True)
class AVIDCMAConfig:
    num_data: int
    embedding_dim: int = 128
    num_negatives: int = 1024
    num_negatives_within: Optional[int] = 64
    momentum: Tuple[float, float] = (0.5, 0.5)
    xModalInstCoeff: float = 1.0
    wModalInstCoeff: float = 0.0
    xModalPosCoeff: float = 0.0
    wModalPosCoeff: float = 1.0
    pos_k: int = 32
    sampling_type: str = "consensus"
    mining_exact: bool = True  # False (approx_max_k) is not ported: mining raises
    resample_freq: int = -1
    temperature: float = TEMPERATURE

    def __post_init__(self):
        mom = self.momentum
        object.__setattr__(
            self, "momentum",
            tuple(mom) if isinstance(mom, (tuple, list)) else (mom, mom))

    @classmethod
    def from_config(cls, args: dict, embedding_dim: int = 128) -> "AVIDCMAConfig":
        """YAML ``loss.args`` -> config; the mining knobs nest under
        ``sampling_args`` (configs/main/avid-cma/*/*.yaml)."""
        args = dict(args)
        sampling = args.pop("sampling_args", {}) or {}
        return cls(
            embedding_dim=embedding_dim,
            pos_k=sampling.get("pos_k", 32),
            sampling_type=sampling.get("type", "consensus"),
            mining_exact=bool(sampling.get("exact", True)),
            **args,
        )

    @property
    def coeffs(self) -> Tuple[float, float, float, float]:
        s = (self.xModalInstCoeff + self.wModalInstCoeff
             + self.xModalPosCoeff + self.wModalPosCoeff)
        return (self.xModalInstCoeff / s, self.wModalInstCoeff / s,
                self.xModalPosCoeff / s, self.wModalPosCoeff / s)


@dataclasses.dataclass
class CMAState(BankState):
    """``BankState`` plus the mined positive set (N, pos_k) int64, each
    row sorted ascending."""

    positive_set: torch.Tensor


def cma_state_from_bank(bank: BankState, positive_set: torch.Tensor) -> CMAState:
    return CMAState(view1_mem=bank.view1_mem, view2_mem=bank.view2_mem, z=bank.z,
                    positive_set=positive_set.to(bank.view1_mem.device, torch.int64))


def should_resample(epoch: int, resample_freq: int) -> bool:
    """reference: criterions/avid_cma.py:361-364."""
    return resample_freq > 0 and epoch > 0 and epoch % resample_freq == 0


_GROUPS = {"inst-v2a": 0, "inst-a2v": 0, "inst-v2v": 1, "inst-a2a": 1,
           "pos-v2a": 2, "pos-a2v": 2, "pos-v2v": 3, "pos-a2a": 3}


def cma_forward(
    state: CMAState,
    video_emb: torch.Tensor,
    audio_emb: torch.Tensor,
    y: torch.Tensor,
    cfg: AVIDCMAConfig,
    neg_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    layout: Optional[BankLayout] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], CMAState]:
    """One AVID-CMA criterion step: (total_loss, logs, new_state).
    Differentiable in the embeddings. Negatives are ``neg_idx`` (B, K)
    when given, else drawn from ``generator`` past the positives.
    ``layout`` as in ``avid_forward``; with sharded banks the positive
    set is sharded too and its rows come through
    ``gather_values_sharded``."""
    video_emb = l2_normalize(video_emb)
    audio_emb = l2_normalize(audio_emb)
    bank_v, bank_a = state.view1_mem, state.view2_mem
    sharded = layout is not None and layout.sharded

    # (B, pos_k), rows sorted
    pos_idx = (gather_values_sharded(state.positive_set, y, layout) if sharded
               else state.positive_set[y])
    if neg_idx is None:
        neg_idx = draw_negatives_avoid_sorted(pos_idx, cfg.num_negatives, cfg.num_data,
                                              generator)
    kw = cfg.num_negatives_within
    neg_w = neg_idx[:, :kw].contiguous() if kw is not None else neg_idx
    y1 = y[:, None]

    sc = bank_scorer(cfg.temperature, layout)

    scores: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    if cfg.xModalInstCoeff > 0:
        scores["inst-v2a"] = (sc(video_emb, bank_a, y1), sc(video_emb, bank_a, neg_idx))
        scores["inst-a2v"] = (sc(audio_emb, bank_v, y1), sc(audio_emb, bank_v, neg_idx))
    if cfg.wModalInstCoeff > 0:
        scores["inst-v2v"] = (sc(video_emb, bank_v, y1), sc(video_emb, bank_v, neg_idx))
        scores["inst-a2a"] = (sc(audio_emb, bank_a, y1), sc(audio_emb, bank_a, neg_idx))
    if cfg.xModalPosCoeff > 0:
        scores["pos-v2a"] = (sc(video_emb, bank_a, pos_idx), sc(video_emb, bank_a, neg_idx))
        scores["pos-a2v"] = (sc(audio_emb, bank_v, pos_idx), sc(audio_emb, bank_v, neg_idx))
    if cfg.wModalPosCoeff > 0:
        scores["pos-v2v"] = (sc(video_emb, bank_v, pos_idx), sc(video_emb, bank_v, neg_w))
        scores["pos-a2a"] = (sc(audio_emb, bank_a, pos_idx), sc(audio_emb, bank_a, neg_w))

    # Z freezes from the first active head's negatives
    first_head = next(iter(scores))
    world = layout.world if layout is not None else World()
    z = resolve_partition(state.z, torch.exp(scores[first_head][1]), world)

    losses = [torch.zeros((), device=video_emb.device) for _ in range(4)]
    logs: Dict[str, torch.Tensor] = {}
    for head, (s_pos, s_neg) in scores.items():
        loss = nce_loss(s_pos, s_neg, z)
        losses[_GROUPS[head]] = losses[_GROUPS[head]] + loss / 2.0
        logs[f"Loss/{head}"] = loss.detach()
    total = sum(l * c for l, c in zip(losses, cfg.coeffs))
    for name, l in zip(("xModalInst", "wModalInst", "xModalPos", "wModalPos"), losses):
        logs[f"Loss/{name}"] = l.detach()

    new_state = update_banks(dataclasses.replace(state, z=z), video_emb, audio_emb, y,
                             cfg.momentum, layout)
    return total, logs, new_state
