"""CMA positive-set mining: a blocked agreement top-k sweep over the banks
(counterpart of avid_cma_tpu/criterions/mining.py).

Per tile of queries (bank rows), ``sim_v = q_v @ bank_v.T`` and
``sim_a = q_a @ bank_a.T`` in true f32 (TF32 off, as the JAX package's
``Precision.HIGHEST``: near-ties at the k-th agreement decide who is in a
set), the agreement of the two (``consensus`` min, ``union`` max, or one
modality), the query's own column set to -inf (exact self removal), the
exact top-k, then each row sorted ascending, which the rank-shift
negative draw requires. A plain matrix product and top-k, which the JAX
package also computes outside any Pallas kernel.

Over several ranks (the JAX package's mesh sweeps): with replicated
banks ``mine_positives_mesh`` splits the queries over the ranks, each
sweeping its ceil(N / world) rows against the full banks, and
all_gathers the sets; with row-sharded banks ``mine_positives_sharded``
all_gathers the banks for the sweep only, each rank sweeping the rows it
owns into its shard of the positive set. The gathered banks hold the N
real rows only, so the zero rows that pad the last shard are never
candidates. Both are exact: each query's set is what ``sweep`` gives it
on one device.

Not ported: ``exact=False`` (``lax.approx_max_k``, the AudioSet recipe's
``sampling_args.exact: false``) has no torch counterpart and raises
(ROADMAP A8.5).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from avid_cma_tpu_torch.parallel.mesh import World
from avid_cma_tpu_torch.parallel.multihost import all_gather
from avid_cma_tpu_torch.parallel.sharding import BankLayout, unshard_rows

AGREEMENT_TYPES = ("consensus", "union", "video", "audio")
# the transient of one tile on the card: its (tile, N) f32 similarity and
# agreement matrices
CARD_TILE_BYTES = 3 << 30


def agreement(sim_v: torch.Tensor, sim_a: torch.Tensor, kind: str) -> torch.Tensor:
    """reference: criterions/avid_cma.py:56-65. ``consensus`` and
    ``union`` write into ``sim_v``."""
    if kind == "consensus":
        return torch.minimum(sim_v, sim_a, out=sim_v)
    if kind == "union":
        return torch.maximum(sim_v, sim_a, out=sim_v)
    if kind == "video":
        return sim_v
    if kind == "audio":
        return sim_a
    raise ValueError(f"unknown agreement type {kind!r}; one of {AGREEMENT_TYPES}")


@contextlib.contextmanager
def _full_f32_matmul() -> Iterator[None]:
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def default_tile(n: int, device: torch.device) -> int:
    """Queries per tile: 256 on the CPU (the JAX default); on the card as
    many as keep a tile's three (tile, N) f32 matrices within
    ``CARD_TILE_BYTES``, a multiple of 256 where that is at least 256
    (1024 at N = 232,067)."""
    if torch.device(device).type != "cuda":
        return 256
    tile = CARD_TILE_BYTES // (3 * 4 * n)
    return tile // 256 * 256 if tile >= 256 else max(1, tile)


def sweep(bank_v: torch.Tensor, bank_a: torch.Tensor, q_index: torch.Tensor,
          pos_k: int, kind: str = "consensus", tile: Optional[int] = None,
          exact: bool = True) -> torch.Tensor:
    """The top-``pos_k`` agreement indices of the bank rows ``q_index``
    (Q,) against the full banks (N, D): (Q, pos_k) int64 on the banks'
    device, each row sorted ascending, the query's own index never in its
    row."""
    if not exact:
        raise NotImplementedError(
            "sampling_args.exact: false (approximate top-k mining, the JAX package's "
            "lax.approx_max_k) has no torch counterpart; the port mines exactly "
            "(ROADMAP A8)")
    if kind not in AGREEMENT_TYPES:
        raise ValueError(f"unknown agreement type {kind!r}; one of {AGREEMENT_TYPES}")
    n = bank_v.shape[0]
    if not 0 < pos_k < n:
        raise ValueError(f"pos_k {pos_k} must lie in [1, {n - 1}] for {n} bank rows")
    tile = tile or default_tile(n, bank_v.device)
    q_index = q_index.to(bank_v.device, torch.int64)
    out = torch.empty((q_index.shape[0], pos_k), dtype=torch.int64, device=bank_v.device)
    with _full_f32_matmul():
        for s in range(0, q_index.shape[0], tile):
            qi = q_index[s:s + tile]
            sim_v = bank_v[qi] @ bank_v.T
            sim_a = bank_a[qi] @ bank_a.T
            agree = agreement(sim_v, sim_a, kind)  # (tile, N)
            agree[torch.arange(qi.shape[0], device=qi.device), qi] = -torch.inf
            idx = torch.topk(agree, pos_k, dim=1, sorted=False).indices
            out[s:s + tile] = torch.sort(idx, dim=1).values
            del sim_v, sim_a, agree
    return out


def mine_positives(bank_v: torch.Tensor, bank_a: torch.Tensor, pos_k: int,
                   kind: str = "consensus", tile: Optional[int] = None,
                   exact: bool = True) -> torch.Tensor:
    """The (N, pos_k) positive set of replicated (N, D) banks, every bank
    row a query. ``exact=False`` raises (see ``sweep``)."""
    n = bank_v.shape[0]
    return sweep(bank_v, bank_a, torch.arange(n, device=bank_v.device), pos_k, kind,
                 tile, exact)


def _sweep_rows(bank_v: torch.Tensor, bank_a: torch.Tensor, lo: int, hi: int, rows: int,
                pos_k: int, kind: str, tile: Optional[int], exact: bool) -> torch.Tensor:
    """The sets of queries [lo, hi) in a (rows, pos_k) block, zero past them."""
    out = torch.zeros((rows, pos_k), dtype=torch.int64, device=bank_v.device)
    if hi > lo:
        out[:hi - lo] = sweep(bank_v, bank_a, torch.arange(lo, hi, device=bank_v.device),
                              pos_k, kind, tile, exact)
    return out


def mine_block_mesh(bank_v: torch.Tensor, bank_a: torch.Tensor, pos_k: int, rank: int,
                    size: int, kind: str = "consensus", tile: Optional[int] = None,
                    exact: bool = True) -> torch.Tensor:
    """Rank ``rank``'s part of ``mine_positives_mesh``: the sets of its
    ceil(N / size) queries from the full (N, D) banks, zero past N."""
    n = bank_v.shape[0]
    q_local = -(-n // size)
    lo = min(rank * q_local, n)
    return _sweep_rows(bank_v, bank_a, lo, min(lo + q_local, n), q_local, pos_k, kind, tile,
                       exact)


def mine_positives_mesh(bank_v: torch.Tensor, bank_a: torch.Tensor, pos_k: int,
                        world: World, kind: str = "consensus", tile: Optional[int] = None,
                        exact: bool = True) -> torch.Tensor:
    """The (N, pos_k) positive set of replicated (N, D) banks, the queries
    split over the ranks of ``world`` (each sweeps ceil(N / world) of
    them; every rank gets the whole set)."""
    part = mine_block_mesh(bank_v, bank_a, pos_k, world.rank, world.size, kind, tile, exact)
    return all_gather(part, world)[:bank_v.shape[0]]


def mine_block_sharded(bank_v: torch.Tensor, bank_a: torch.Tensor, pos_k: int, rank: int,
                       size: int, kind: str = "consensus", tile: Optional[int] = None,
                       exact: bool = True) -> torch.Tensor:
    """Rank ``rank``'s shard (n_local + 1, pos_k) of the positive set,
    from the full (N, D) banks: the sets of the rows it owns, its padded
    rows and the sentinel row 0."""
    n = bank_v.shape[0]
    n_local = -(-n // size)
    lo = min(rank * n_local, n)
    return _sweep_rows(bank_v, bank_a, lo, min(lo + n_local, n), n_local + 1, pos_k, kind,
                       tile, exact)


def mine_positives_sharded(shard_v: torch.Tensor, shard_a: torch.Tensor, layout: BankLayout,
                           pos_k: int, kind: str = "consensus", tile: Optional[int] = None,
                           exact: bool = True) -> torch.Tensor:
    """This rank's shard (n_local + 1, pos_k) of the positive set of
    row-sharded banks (``parallel.sharding``'s layout): the banks are
    all_gathered (their N real rows) for the sweep only, and the rank
    sweeps the rows it owns."""
    world = layout.world
    return mine_block_sharded(unshard_rows(shard_v, layout), unshard_rows(shard_a, layout),
                              pos_k, world.rank, world.size, kind, tile, exact)


def boundary_gap(bank_v: torch.Tensor, bank_a: torch.Tensor, q_index: torch.Tensor,
                 pos_k: int, kind: str = "consensus") -> torch.Tensor:
    """For holding one mining against another (the card's against the
    CPU's): per query row, the gap between its ``pos_k``-th and
    (``pos_k`` + 1)-th largest agreement, the query's own column left out,
    recomputed in f64 on the CPU. Where the gap is below the error of f32
    products, two correct sweeps that sum in other orders may pick
    different sets. (Q,) f64 on the CPU."""
    bv, ba = bank_v.detach().cpu().double(), bank_a.detach().cpu().double()
    qi = q_index.detach().cpu().long()
    agree = agreement(bv[qi] @ bv.T, ba[qi] @ ba.T, kind)
    agree[torch.arange(qi.shape[0]), qi] = -torch.inf
    top = torch.topk(agree, pos_k + 1, dim=1).values
    return top[:, pos_k - 1] - top[:, pos_k]
