"""Row-sharded memory banks (counterpart of avid_cma_tpu/parallel/sharding.py).

The layout is the JAX package's: with N rows over ``world`` ranks,
``n_local = ceil(N / world)``, rank r owns rows [r * n_local, (r + 1) *
n_local), and the last rank's tail past N is zero. Each rank stores its
shard as (n_local + 1, ...): one more row, at local index ``n_local``,
that is zero and is never kept written. Every global index a rank does
not own maps to that row (``local_index``), so a rank's part of a gather
or a score is a plain gather over its shard in which the rows it does not
own give exactly 0, and one collective adds the ranks' parts: since
x + 0 == x, the sums are the replicated values bit for bit.

Each function below is a rank-local part (``*_local``, taking the rank
and the shard; the CPU tests call these for every rank and combine them
as the collective would) plus one collective over the ``World``:

- ``gather_rows_sharded``: bank[idx] (all_gather of idx, the masked local
  gather, reduce_scatter; with indices equal on every rank, one
  all_reduce). ``gather_values_sharded`` is the same for the positive set.
- ``scores_sharded``: query . bank[idx] / T, differentiable in the query.
  The local part is one launch of kernel K4 over the all_gathered indices
  and queries; the (world * B, K) scores are reduce-scattered. Its
  backward gathers the same rows the same way and takes the replicated
  backward's product, so dq equals the replicated dq bit for bit (a
  reduce-scatter of per-rank partial dq sums would add in another order).
- ``update_rows_sharded`` / ``ema_update_rows_sharded``: the bank EMA of
  the all_gathered batch; each rank writes only the rows it owns.
- ``shard_rows`` / ``unshard_rows`` and their ``BankState`` forms move a
  bank between the full (N, ...) layout and the shards.
"""

from __future__ import annotations

import dataclasses

import torch

from avid_cma_tpu_torch.criterions.nce import l2_normalize
from avid_cma_tpu_torch.ops.kernels import nce_gather
from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import all_gather, all_reduce_sum, reduce_scatter

BANK_FIELDS = ("view1_mem", "view2_mem", "positive_set")


@dataclasses.dataclass(frozen=True)
class BankLayout:
    """How a run holds its banks: over ``world``, ``n`` rows, replicated
    (every rank all n rows) or row-sharded (``n_local`` rows a rank,
    from rank * n_local, stored with the zero sentinel row)."""

    n: int
    world: World = World()
    sharded: bool = False

    @property
    def n_local(self) -> int:
        return -(-self.n // self.world.size) if self.sharded else self.n


def parse_bank_sharding(value) -> bool:
    """``loss.bank_sharding``: 'replicated' (the default) or 'sharded'; a
    typo raises rather than silently replicating AudioSet-size banks."""
    value = "replicated" if value is None else str(value)
    if value not in ("replicated", "sharded"):
        raise ValueError(f"unknown bank_sharding {value!r} (replicated|sharded)")
    return value == "sharded"


def local_index(idx: torch.Tensor, rank: int, n_local: int) -> torch.Tensor:
    """Global row ids -> indices into rank ``rank``'s shard: the row's
    local index where the rank owns it, else ``n_local`` (the zero row).
    int64, idx's shape."""
    local = idx.long() - rank * n_local
    owned = (local >= 0) & (local < n_local)
    return torch.where(owned, local, n_local)


def shard_rows(full: torch.Tensor, rank: int, world_size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of a full (N, ...) table: its n_local rows,
    zero past N, and the zero sentinel row: (n_local + 1, ...), a new
    tensor on full's device."""
    n = full.shape[0]
    n_local = -(-n // world_size)
    out = full.new_zeros((n_local + 1, *full.shape[1:]))
    lo = min(rank * n_local, n)
    hi = min(lo + n_local, n)
    out[:hi - lo] = full[lo:hi]
    return out


def unshard_rows(shard: torch.Tensor, layout: BankLayout) -> torch.Tensor:
    """The full (N, ...) table from every rank's shard (one all_gather;
    every rank gets it)."""
    return all_gather(shard[:layout.n_local], layout.world)[:layout.n]


def shard_bank(bank, layout: BankLayout):
    """A full bank state (``BankState`` or ``CMAState``, every row) ->
    this rank's state under ``layout``: its shards of the banks and of
    the positive set, Z as it is. Replicated layouts keep the full
    tables."""
    if not layout.sharded:
        return bank
    return dataclasses.replace(bank, **{
        f: shard_rows(getattr(bank, f), layout.world.rank, layout.world.size)
        for f in BANK_FIELDS if hasattr(bank, f)})


def unshard_bank(bank, layout: BankLayout):
    """This rank's bank state -> the full state (N rows): a collective
    under a sharded layout, the state itself under a replicated one."""
    if not layout.sharded:
        return bank
    return dataclasses.replace(bank, **{
        f: unshard_rows(getattr(bank, f), layout) for f in BANK_FIELDS if hasattr(bank, f)})


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def gather_rows_local(shard: torch.Tensor, idx: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of bank[idx]: its rows, 0 for the rows it does
    not own; idx.shape + shard.shape[1:]."""
    n_local = shard.shape[0] - 1
    return shard[local_index(idx, rank, n_local)]


def gather_rows_sharded(shard: torch.Tensor, idx: torch.Tensor, layout: BankLayout,
                        replicated_idx: bool = False) -> torch.Tensor:
    """bank[idx] from row shards; idx holds global row ids of any shape.
    ``replicated_idx``: every rank passes the same idx (one all_reduce of
    the parts); else each rank its own (all_gather of idx, then a
    reduce_scatter, each rank keeping its slot)."""
    world = layout.world
    if replicated_idx:
        return all_reduce_sum(gather_rows_local(shard, idx, world.rank), world)
    idx_g = all_gather(idx, world)
    return reduce_scatter(gather_rows_local(shard, idx_g, world.rank), world)


def gather_values_sharded(table: torch.Tensor, idx: torch.Tensor, layout: BankLayout,
                          replicated_idx: bool = False) -> torch.Tensor:
    """``gather_rows_sharded`` for integer tables (the CMA positive set)."""
    return gather_rows_sharded(table, idx, layout, replicated_idx)


# ---------------------------------------------------------------------------
# scores (kernel K4)
# ---------------------------------------------------------------------------

def scores_local(shard: torch.Tensor, idx_g: torch.Tensor, q_g: torch.Tensor, rank: int,
                 temperature: float) -> torch.Tensor:
    """Rank ``rank``'s part of the scores of the all_gathered indices
    ``idx_g`` (world * B, K) and queries ``q_g`` (world * B, D): one K4
    launch over its shard, 0 where it does not own the row."""
    n_local = shard.shape[0] - 1
    return nce_gather.scores(shard, local_index(idx_g, rank, n_local), q_g, temperature)


class ScoresSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, idx, query, layout, temperature):
        world = layout.world
        idx_g = all_gather(idx, world)
        q_g = all_gather(query.float(), world)
        ctx.save_for_backward(shard, idx_g)
        ctx.layout, ctx.temperature, ctx.q_dtype = layout, temperature, query.dtype
        return reduce_scatter(scores_local(shard, idx_g, q_g, world.rank, temperature), world)

    @staticmethod
    def backward(ctx, g):
        shard, idx_g = ctx.saved_tensors
        world = ctx.layout.world
        rows = reduce_scatter(gather_rows_local(shard, idx_g, world.rank), world)
        return None, None, nce_gather.scores_vjp(g, rows, ctx.temperature, ctx.q_dtype), \
            None, None


def scores_sharded(shard: torch.Tensor, idx: torch.Tensor, query: torch.Tensor,
                   layout: BankLayout, temperature: float) -> torch.Tensor:
    """query . bank[idx] / temperature with the bank row-sharded and idx
    (B, K) and query (B, D) this rank's own: (B, K) f32, differentiable
    in the query only (dq in the query's dtype)."""
    return ScoresSharded.apply(shard, idx, query, layout, temperature)


# ---------------------------------------------------------------------------
# the bank update
# ---------------------------------------------------------------------------

def update_rows_local(shard: torch.Tensor, y: torch.Tensor, new_rows: torch.Tensor,
                      rank: int) -> torch.Tensor:
    """A new shard with bank[y] = new_rows where rank ``rank`` owns y,
    from the all_gathered (every rank's equal) y and new_rows. Duplicate
    ids must carry equal rows (the caller resolves them). The rows a rank
    does not own land on the sentinel, which is zeroed again."""
    n_local = shard.shape[0] - 1
    out = shard.clone().index_put_((local_index(y, rank, n_local),),
                                   new_rows.to(shard.dtype))
    out[n_local].zero_()
    return out


def update_rows_sharded(shard: torch.Tensor, y: torch.Tensor, new_rows: torch.Tensor,
                        layout: BankLayout) -> torch.Tensor:
    return update_rows_local(shard, y, new_rows, layout.world.rank)


def ema_update_rows_sharded(shard: torch.Tensor, y: torch.Tensor, emb: torch.Tensor,
                            momentum: float, layout: BankLayout,
                            last: torch.Tensor) -> torch.Tensor:
    """The bank EMA from the all_gathered batch y (M,), emb (M, D): the
    old rows (one all_reduce of the ranks' parts), EMA toward emb,
    renorm, each rank writing the rows it owns; ``last`` maps each
    position to the last one with its id (last-write-wins)."""
    old = gather_rows_sharded(shard, y, layout, replicated_idx=True)
    new = l2_normalize(old * momentum + emb * (1.0 - momentum))
    return update_rows_sharded(shard, y, new[last], layout)
