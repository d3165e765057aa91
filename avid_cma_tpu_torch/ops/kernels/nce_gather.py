"""K4: fused NCE bank-row gather + score (``csrc/nce_gather.cu``).

Replaces ``_kernel`` / ``_pallas_scores``
(avid_cma_tpu/ops/pallas/nce_gather.py:50-85,113). Bound by bytes on this
card: the B*K scattered 512-byte bank rows, which the kernel reads once
and never writes out as a gathered tensor. Its rows are cold in L2 on the
main path (fresh negatives every step from a bank larger than L2), and a
random-row gather runs at about its bytes in flight over the memory
latency: a warp per score, few enough registers that each SM holds its
full 64 warps (``csrc/nce_gather.cu``).

``gather_scores`` is the autograd op the criterion calls. Only the query
carries a gradient; the backward is plain PyTorch (``index_select`` +
einsum), as the JAX package's XLA backward (nce_gather.py:157-164), and
``dq`` takes the query's dtype.
"""

from __future__ import annotations

import torch

from avid_cma_tpu_torch.ops.kernels import _lib


def plain_scores(bank: torch.Tensor, idx: torch.Tensor, query: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """Plain version of K4: gather + einsum in f32, (B, K) scores."""
    rows = bank[idx]
    return torch.einsum("bd,bkd->bk", query.float(), rows) / temperature


def scores(bank: torch.Tensor, idx: torch.Tensor, query: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """scores[b, k] = <bank[idx[b, k]], f32(query[b])> / temperature.

    Kernel K4 for CUDA tensors, the plain version for CPU tensors."""
    if bank.device.type == "cpu":
        return plain_scores(bank, idx, query, temperature)
    if bank.dim() != 2 or idx.dim() != 2 or query.dim() != 2:
        raise ValueError("expected bank (N, D), idx (B, K), query (B, D)")
    n, d = bank.shape
    bsz, k = idx.shape
    q = query.float().contiguous()
    _lib.require(bank, "bank", torch.float32)
    _lib.require(idx, "idx", torch.int64)
    _lib.require(q, "query", torch.float32, (bsz, d))
    if d % 4 or bank.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("bank and query rows must be float4-aligned (D % 4 == 0)")
    if bsz * k >= 2**31 - 64:  # the kernel counts scores in 32 bits
        raise ValueError(f"idx: {bsz * k} scores in one call, more than the kernel takes")
    out = torch.empty((bsz, k), dtype=torch.float32, device=bank.device)
    err = _lib.lib().avid_nce_scores(
        bank.data_ptr(), idx.data_ptr(), q.data_ptr(), out.data_ptr(),
        bsz, k, n, d, float(temperature), _lib.stream())
    _lib.check(err, "avid_nce_scores")
    _lib.LAUNCHES["nce_gather"] += 1
    return out


def scores_vjp(g: torch.Tensor, rows: torch.Tensor, temperature: float,
               q_dtype: torch.dtype) -> torch.Tensor:
    """dq of the scores: g (B, K) against the scored rows (B, K, D), in
    the query's dtype (the replicated and the row-sharded scores share it,
    so both give the same bits from the same rows)."""
    return (torch.einsum("bk,bkd->bd", g, rows) / temperature).to(q_dtype)


class GatherScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bank, idx, query, temperature):
        ctx.save_for_backward(bank, idx)
        ctx.temperature = temperature
        ctx.q_dtype = query.dtype
        return scores(bank, idx, query, temperature)

    @staticmethod
    def backward(ctx, g):
        bank, idx = ctx.saved_tensors
        rows = bank.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
        return None, None, scores_vjp(g, rows, ctx.temperature, ctx.q_dtype), None


def gather_scores(bank: torch.Tensor, idx: torch.Tensor, query: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Differentiable in ``query`` only; bank (N, D) f32, idx (B, K)
    int64, query (B, D) -> (B, K) f32."""
    return GatherScores.apply(bank, idx, query, temperature)
