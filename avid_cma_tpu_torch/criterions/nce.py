"""NCE loss with a constant partition function (counterpart of
avid_cma_tpu/criterions/nce.py), and the L2 normalization of embeddings
and bank rows."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import all_reduce_sum


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def resolve_partition(z: torch.Tensor, exp_neg_scores: torch.Tensor,
                      world: World = World()) -> torch.Tensor:
    """The partition function for this step: ``z`` if it is already frozen
    (z > 0), else the mean of exp(negative scores), averaged over the
    ranks of ``world``, which the caller then stores (the freeze). Stays
    on the device: no host sync."""
    batch_mean = exp_neg_scores.mean().detach()
    if world.distributed:
        batch_mean = all_reduce_sum(batch_mean, world) / world.size
    return torch.where(z > 0, z, batch_mean)


def nce_loss(scores_pos: torch.Tensor, scores_neg: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """NCE loss of one head in log space:
    -log P(model) = softplus(log(KZ) - s_pos), -log P(noise) =
    softplus(s_neg - log(KZ)); mean over the batch of the mean over
    positives plus the sum over negatives."""
    log_kz = torch.log(scores_neg.shape[1] * z)
    ln_pmt = F.softplus(log_kz - scores_pos).mean(dim=-1)
    ln_pon = F.softplus(scores_neg - log_kz).sum(dim=-1)
    return (ln_pmt + ln_pon).mean()
