"""AVID criterion: cross/within-modal NCE against dual memory banks
(counterpart of avid_cma_tpu/criterions/avid.py).

Scores go through ``gather_scores`` (kernel K4 on the card), or, with
row-sharded banks, ``parallel.sharding.scores_sharded`` (K4 on each
rank's shard, the scores reduce-scattered). Over several ranks the bank
update takes the all_gathered batch, as the JAX step does. The bank
update is functional: ``avid_forward`` returns a new ``BankState`` and
leaves the old banks untouched, because the score backward reads the
old bank rows after the forward (the autograd op saves the bank, and an
in-place update would invalidate it). The copy costs two bank-sized
writes per step (2 x 119 MB at N = 232,067), small beside the step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from avid_cma_tpu_torch.criterions.nce import l2_normalize, nce_loss, resolve_partition
from avid_cma_tpu_torch.ops.kernels.nce_gather import gather_scores
from avid_cma_tpu_torch.ops.sampling import draw_negatives_uniform
from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import all_gather
from avid_cma_tpu_torch.parallel.sharding import (
    BankLayout,
    ema_update_rows_sharded,
    scores_sharded,
)

TEMPERATURE = 0.07


@dataclasses.dataclass
class BankState:
    """view1_mem (N, D) video bank, view2_mem (N, D) audio bank, both f32;
    z the frozen NCE partition function (0-d tensor, -1 = not yet set)."""

    view1_mem: torch.Tensor
    view2_mem: torch.Tensor
    z: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AVIDConfig:
    num_data: int
    embedding_dim: int = 128
    num_negatives: int = 1024
    momentum: Union[float, Tuple[float, float]] = (0.5, 0.5)
    xModal_coeff: float = 1.0
    wModal_coeff: float = 0.0
    temperature: float = TEMPERATURE

    def __post_init__(self):
        mom = self.momentum
        object.__setattr__(
            self, "momentum",
            tuple(mom) if isinstance(mom, (tuple, list)) else (mom, mom))

    @property
    def coeffs(self) -> Tuple[float, float]:
        s = self.xModal_coeff + self.wModal_coeff
        return self.xModal_coeff / s, self.wModal_coeff / s


def init_bank_state(num_data: int, embedding_dim: int,
                    generator: torch.Generator) -> BankState:
    """randn banks, L2-normalized, on the generator's device."""
    dev = generator.device

    def bank():
        v = torch.randn((num_data, embedding_dim), generator=generator, device=dev)
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)

    v1 = bank()
    v2 = bank()
    return BankState(view1_mem=v1, view2_mem=v2,
                     z=torch.tensor(-1.0, device=dev))


def bank_scorer(temperature: float, layout: Optional[BankLayout]):
    """sc(query, bank, idx) -> (B, K) scores / temperature: K4 on the full
    bank, or ``scores_sharded`` (K4 on each shard) for a sharded layout."""
    if layout is not None and layout.sharded:
        return lambda query, bank, idx: scores_sharded(bank, idx, query, layout, temperature)
    return lambda query, bank, idx: gather_scores(bank, idx, query, temperature)


def _last_occurrence(y: torch.Tensor) -> torch.Tensor:
    """For each position i, the last position j with y[j] == y[i]."""
    pos = torch.arange(y.shape[0], device=y.device)
    same = y[:, None] == y[None, :]
    return torch.where(same, pos[None, :], -1).amax(dim=1)


def update_banks(state: BankState, video_emb: torch.Tensor,
                 audio_emb: torch.Tensor, y: torch.Tensor,
                 momentum: Tuple[float, float],
                 layout: Optional[BankLayout] = None) -> BankState:
    """EMA + renorm of the rows ``y`` into NEW bank tensors (the old ones
    are left as they are), in a state of ``state``'s type (a CMA state
    keeps its positive set). Over more than one rank the embeddings and
    ``y`` are all_gathered first, rank-major, so every rank applies the
    same update; with a sharded ``layout`` each rank writes only the rows
    it owns. Duplicate indices resolve last-write-wins over the gathered
    batch: every duplicate writes the value of its last occurrence, so
    the order in which the scatter lands them does not matter (CUDA's
    ``index_put_`` fixes no order among duplicates)."""
    world = layout.world if layout is not None else World()
    video_emb = all_gather(video_emb.detach(), world)
    audio_emb = all_gather(audio_emb.detach(), world)
    y = all_gather(y, world)
    last = _last_occurrence(y)

    def ema(mem, emb, mom):
        if layout is not None and layout.sharded:
            return ema_update_rows_sharded(mem, y, emb, mom, layout, last)
        new = l2_normalize(mem[y] * mom + emb * (1.0 - mom))
        return mem.clone().index_put_((y,), new[last])

    return dataclasses.replace(
        state,
        view1_mem=ema(state.view1_mem, video_emb, momentum[0]),
        view2_mem=ema(state.view2_mem, audio_emb, momentum[1]),
    )


def avid_forward(
    state: BankState,
    video_emb: torch.Tensor,
    audio_emb: torch.Tensor,
    y: torch.Tensor,
    cfg: AVIDConfig,
    neg_idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    layout: Optional[BankLayout] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], BankState]:
    """One criterion step: (total_loss, logs, new_state). Differentiable in
    the embeddings. Negatives are ``neg_idx`` (B, K) when given, else drawn
    from ``generator``. ``layout`` (default: one process, replicated)
    says how the banks are held: row-sharded banks are scored through
    ``scores_sharded``; over several ranks Z freezes from the batch mean
    averaged over the ranks, and the banks take the gathered batch."""
    xmodal, wmodal = cfg.xModal_coeff > 0, cfg.wModal_coeff > 0
    # the loss is always f32 (bf16 unit embeddings collapse instance
    # discrimination; see models/av_wrapper.py Head)
    video_emb = l2_normalize(video_emb.float())
    audio_emb = l2_normalize(audio_emb.float())
    bank_v, bank_a = state.view1_mem, state.view2_mem

    if neg_idx is None:
        neg_idx = draw_negatives_uniform(y, cfg.num_negatives, cfg.num_data, generator)

    sc = bank_scorer(cfg.temperature, layout)

    y1 = y[:, None]
    scores: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    if xmodal:
        scores["v2a"] = (sc(video_emb, bank_a, y1), sc(video_emb, bank_a, neg_idx))
        scores["a2v"] = (sc(audio_emb, bank_v, y1), sc(audio_emb, bank_v, neg_idx))
    if wmodal:
        scores["v2v"] = (sc(video_emb, bank_v, y1), sc(video_emb, bank_v, neg_idx))
        scores["a2a"] = (sc(audio_emb, bank_a, y1), sc(audio_emb, bank_a, neg_idx))

    # Z freezes from the first head's negatives on the first step
    first_head = "v2a" if xmodal else "v2v"
    world = layout.world if layout is not None else World()
    z = resolve_partition(state.z, torch.exp(scores[first_head][1]), world)

    logs: Dict[str, torch.Tensor] = {}
    xmodal_loss = torch.zeros((), device=video_emb.device)
    wmodal_loss = torch.zeros((), device=video_emb.device)
    for head, (s_pos, s_neg) in scores.items():
        loss = nce_loss(s_pos, s_neg, z)
        if head in ("v2a", "a2v"):
            xmodal_loss = xmodal_loss + loss / 2.0
        else:
            wmodal_loss = wmodal_loss + loss / 2.0
        logs[f"Loss/{head}"] = loss.detach()
    logs["Loss/xModal"] = xmodal_loss.detach()
    logs["Loss/wModal"] = wmodal_loss.detach()

    xc, wc = cfg.coeffs
    total = xmodal_loss * xc + wmodal_loss * wc
    new_state = update_banks(
        dataclasses.replace(state, z=z), video_emb, audio_emb, y, cfg.momentum, layout)
    return total, logs, new_state
