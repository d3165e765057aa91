"""The train step (counterpart of avid_cma_tpu/train/step.py).

``make_train_step`` returns ``step(state, batch, neg_idx=None)``: model
forward in train mode (BN running stats update), the criterion (AVID or
AVID-CMA, by the type of its config, as ``criterion_fn``), backward,
optimizer step, and the new banks. ``make_fused_train_step``
puts the device preprocessing in front: ``fused(state, raw_batch, step_i)``.
``make_eval_loss_step`` / ``make_fused_eval_step`` give the held-out
criterion loss without changing the state, and ``make_embed_fn`` the
eval-mode embeddings. PyTorch runs eagerly, so there is no program to
compile; the step is the same sequence of launches every call.

Over several ranks (``state.layout.world``; the JAX step is one
``shard_map`` program, avid_cma_tpu/train/step.py:108-170) each rank runs
the step on its own rows: its generator is seeded with the rank folded in
(``fold_rank``, as ``fold_in(key, axis_index)``), so ranks draw their own
crops and negatives; after the backward the gradients are averaged with
one flat all_reduce; BatchNorm normalizes with each rank's own batch
statistics and its running stats are averaged after the step (PARITY.md
divergence 5); the metrics are averaged on the device. No DDP: its
default broadcast of rank 0's buffers before each forward is not the JAX
package's average.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from avid_cma_tpu_torch.criterions.avid import AVIDConfig, avid_forward, init_bank_state
from avid_cma_tpu_torch.criterions.avid_cma import (
    AVIDCMAConfig,
    cma_forward,
    cma_state_from_bank,
)
from avid_cma_tpu_torch.data.pipelines import PreprocessConfig, preprocess_batch
from avid_cma_tpu_torch.models.blocks import BatchNorm
from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import all_reduce_mean_
from avid_cma_tpu_torch.parallel.sharding import BankLayout, shard_bank
from avid_cma_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
CriterionConfig = Union[AVIDConfig, AVIDCMAConfig]


def criterion_fn(cfg: CriterionConfig) -> Callable:
    """The criterion of a config: ``avid_forward`` or ``cma_forward``,
    both called as ``(bank, v_emb, a_emb, y, cfg, neg_idx=, generator=)``."""
    if isinstance(cfg, AVIDCMAConfig):
        return cma_forward
    if isinstance(cfg, AVIDConfig):
        return avid_forward
    raise TypeError(f"unknown criterion config {type(cfg)}")


def fold_rank(seed: int, rank: int) -> int:
    """The generator seed of ``rank`` for a step seeded ``seed``: the seed
    itself on rank 0 (a one-process run draws as it always did), apart
    by the 64-bit golden-ratio increment on every other rank."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**63


def init_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     scheduler, criterion_cfg: CriterionConfig, seed: int,
                     layout: Optional[BankLayout] = None) -> TrainState:
    """Banks and the step generator on the model's device, from ``seed``.
    For AVID-CMA the positive set starts zeroed: the caller mines it.
    Under a sharded ``layout`` every rank draws the full banks, as one
    process would, and keeps its shard: its rows are the replicated
    initialization's, bit for bit."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = layout or BankLayout(n=criterion_cfg.num_data)
    if layout.n != criterion_cfg.num_data:
        raise ValueError(f"layout of {layout.n} rows for num_data={criterion_cfg.num_data}")
    bank = shard_bank(init_bank_state(criterion_cfg.num_data, criterion_cfg.embedding_dim, gen),
                      layout)
    if isinstance(criterion_cfg, AVIDCMAConfig):
        bank = cma_state_from_bank(bank, torch.zeros(
            (bank.view1_mem.shape[0], criterion_cfg.pos_k), dtype=torch.int64, device=dev))
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      bank=bank, generator=gen, layout=layout)


def bn_running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def average_metrics(metrics: Dict[str, torch.Tensor], world: World) -> Dict[str, torch.Tensor]:
    """The metrics averaged over the ranks, on the device (one
    all_reduce, no host sync); as they are in a one-process world."""
    if not world.distributed:
        return metrics
    names = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in names])
    all_reduce_mean_([vals], world)
    return dict(zip(names, vals.unbind()))


def make_train_step(criterion_cfg: CriterionConfig
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(state, batch, neg_idx=None) -> metrics (0-d device tensors,
    averaged over the ranks). ``batch`` holds this rank's rows. Negatives
    come from ``neg_idx`` (B, K) when given, else from the state's
    generator. Updates ``state`` in place."""
    criterion = criterion_fn(criterion_cfg)

    def step(state: TrainState, batch: Batch,
             neg_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model, world = state.model, state.world
        model.train()
        y = batch["index"].long()
        v_emb, a_emb = model(batch["frames"], batch["audio"])
        loss, logs, new_bank = criterion(
            state.bank, v_emb, a_emb, y, criterion_cfg,
            neg_idx=neg_idx, generator=state.generator, layout=state.layout)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None], world)
        state.optimizer.step()
        all_reduce_mean_(bn_running_stats(model), world)
        state.bank = new_bank
        state.step += 1
        return average_metrics({**logs, "loss": loss.detach()}, world)

    return step


def make_fused_train_step(criterion_cfg: CriterionConfig, pp_cfg: PreprocessConfig,
                          seed: int) -> Callable[[TrainState, Batch, int], Dict[str, torch.Tensor]]:
    """fused(state, raw_batch, step_i): preprocess on the device, then the
    train step. The state's generator is reseeded from (seed, step_i,
    rank) at each call, so a step's draws (crop, flip, jitter, volume,
    negatives) depend only on its number and the rank, as the JAX step
    folds step_i and the mesh index into its key."""
    inner = make_train_step(criterion_cfg)

    def fused(state: TrainState, raw_batch: Batch, step_i: int) -> Dict[str, torch.Tensor]:
        state.generator.manual_seed(
            fold_rank((seed + 1) * 1_000_003 + int(step_i), state.world.rank))
        batch = preprocess_batch(raw_batch, pp_cfg, state.generator)
        return inner(state, batch)

    return fused


@contextlib.contextmanager
def evaluating(model: torch.nn.Module) -> Iterator[None]:
    """Eval mode under ``torch.inference_mode``; the model's train/eval
    mode is restored on exit."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def make_eval_loss_step(criterion_cfg: CriterionConfig, seed: int
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(state, batch, batch_idx=0, neg_idx=None) -> metrics: the
    criterion loss of a held-out batch with the model in eval mode, under
    ``torch.inference_mode``. The state is left exactly as it was (params,
    BN running stats, banks, Z, ``step``, ``generator``, train/eval mode):
    the criterion's new banks are dropped (PARITY.md divergence #2: the
    reference's test phase would corrupt the train banks). Negatives come
    from ``neg_idx`` when given, else from a generator of the step's own,
    seeded from (seed, batch_idx, rank), so successive held-out batches
    draw different negatives. The metrics are averaged over the ranks."""
    criterion = criterion_fn(criterion_cfg)

    def step(state: TrainState, batch: Batch, batch_idx: int = 0,
             neg_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        world = state.world
        with evaluating(state.model):
            y = batch["index"].long()
            v_emb, a_emb = state.model(batch["frames"], batch["audio"])
            gen = None
            if neg_idx is None:
                gen = torch.Generator(device=y.device).manual_seed(
                    fold_rank((seed + 3) * 1_000_003 + int(batch_idx), world.rank))
            loss, logs, _ = criterion(state.bank, v_emb, a_emb, y, criterion_cfg,
                                      neg_idx=neg_idx, generator=gen, layout=state.layout)
            return average_metrics({**logs, "loss": loss}, world)

    return step


def make_fused_eval_step(criterion_cfg: CriterionConfig, pp_cfg: PreprocessConfig,
                         seed: int) -> Callable[[TrainState, Batch, int], Dict[str, torch.Tensor]]:
    """fused(state, raw_batch, batch_idx): the eval preprocessing
    (``preprocess_batch(train=False)``), then the eval-loss step."""
    inner = make_eval_loss_step(criterion_cfg, seed)

    def fused(state: TrainState, raw_batch: Batch, batch_idx: int = 0) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            batch = preprocess_batch(raw_batch, pp_cfg, train=False)
        return inner(state, batch, batch_idx)

    return fused


def make_embed_fn(model: torch.nn.Module
                  ) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """embed(video, audio) -> (video_emb, audio_emb) from the eval-mode
    forward under ``torch.inference_mode``; the model's mode is restored."""

    def embed(video: torch.Tensor, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with evaluating(model):
            return model(video, audio)

    return embed
