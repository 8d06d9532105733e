"""Halo exchange plans for row-sharded sparse matvec.

Counterpart of ``hypredrive_tpu/parallel/halo.py`` (numpy only, copied):
hypre's ParCSR communication package as a *static* schedule of shard
shifts built on the host when a matrix is built.

For each distinct shard distance d in the sparsity pattern, one shift
moves a padded send buffer from every shard i to shard (i+d) mod n at once
(``torch.roll`` of the buffer stack by d, see ``dist_matrix.py``).  Column
indices are remapped into an extended local vector layout

    x_ext = [ x_local (padded) | recv(d₁) | recv(d₂) | ... ]

so the local SpMV is a plain sparse matvec afterwards.  Buffer sizes are
static (the largest over the shards for each distance).

When the shards are spread over ranks (``mesh.py``), each shift is split
for one rank by :func:`rank_exchange`: the buffers whose source shard is
on the same rank move inside it, the others cross to their rank (the
boundary rows of hypre's communication package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class HaloPlan:
    """Static exchange schedule for one (row-partition → col-partition)
    pair.

    offsets:    shard distances d (sorted), one shift each
    send_idx:   per offset: (n_shards, S_d) local indices into the owner's
                local x to pack (padded with 0)
    ext_size:   length of x_ext (local_max + Σ S_d)
    local_max:  padded local vector length
    """

    offsets: Tuple[int, ...]
    send_idx: Tuple[np.ndarray, ...]
    ext_size: int
    local_max: int


def build_halo_plan(n_shards: int, col_offsets: np.ndarray,
                    needed_cols_per_shard: List[np.ndarray]):
    """Build the exchange schedule.

    col_offsets: (n_shards+1,) global column partition (owner boundaries)
    needed_cols_per_shard[s]: sorted unique global columns shard s reads
        (including its own — locals are filtered out here)

    Returns (plan: HaloPlan, remap[s]: dict global col → x_ext position).
    """
    local_max = int(np.max(col_offsets[1:] - col_offsets[:-1]))
    owners = lambda cols: np.searchsorted(col_offsets, cols, side="right") - 1

    # per (shard, offset): sorted list of global cols shard needs from
    # owner (shard - d) mod n
    need: Dict[int, List[np.ndarray]] = {}
    for s in range(n_shards):
        cols = np.asarray(needed_cols_per_shard[s], dtype=np.int64)
        if cols.size:
            own = owners(cols)
            remote = cols[own != s]
            own = own[own != s]
        else:
            remote, own = cols, cols
        d_arr = (s - own) % n_shards
        for d in np.unique(d_arr):
            need.setdefault(int(d), [np.empty(0, np.int64)] * n_shards)
            need[int(d)][s] = np.sort(remote[d_arr == d])

    offsets = tuple(sorted(need.keys()))
    send_idx_list = []
    for d in offsets:
        S_d = max((len(v) for v in need[d]), default=0)
        S_d = max(S_d, 1)
        idx = np.zeros((n_shards, S_d), dtype=np.int32)
        for i in range(n_shards):
            # shard i sends to shard (i+d)%n what that shard needs from i
            dst = (i + d) % n_shards
            req = need[d][dst]
            idx[i, :len(req)] = req - col_offsets[i]  # i-local positions
        send_idx_list.append(idx)

    # x_ext positions: locals are positional (g − col_offsets[s]);
    # remote positions start after local_max, laid out offset-by-offset
    cursor = local_max
    recv_pos: List[Dict[int, int]] = [dict() for _ in range(n_shards)]
    for k, d in enumerate(offsets):
        S_d = send_idx_list[k].shape[1]
        for s in range(n_shards):
            req = need[d][s]
            for j, g in enumerate(req):
                recv_pos[s][int(g)] = cursor + j
        cursor += S_d

    ext_size = cursor
    plan = HaloPlan(offsets=offsets,
                    send_idx=tuple(send_idx_list),
                    ext_size=ext_size,
                    local_max=local_max)
    return plan, recv_pos


def remap_column(g: int, shard: int, col_offsets: np.ndarray,
                 recv_pos: Dict[int, int]) -> int:
    """Global column → x_ext position for one shard."""
    lo, hi = col_offsets[shard], col_offsets[shard + 1]
    if lo <= g < hi:
        return int(g - lo)
    return recv_pos[int(g)]


@dataclass
class RankExchange:
    """One halo distance d seen from one rank of k consecutive shards.

    send_rows:  the rank's send-buffer rows (local shards) whose target
                shard (i + d) mod n lies on another rank, in target-rank
                order
    send_split: rows sent to each rank
    recv_split: rows received from each rank (in source-rank order, each
                rank's rows in its send order)
    recv_src:   per local shard, its receive buffer's row in
                ``[send buffer rows | received rows]``
    """

    send_rows: np.ndarray
    send_split: Tuple[int, ...]
    recv_split: Tuple[int, ...]
    recv_src: np.ndarray


def rank_exchange(n_shards: int, world: int, rank: int,
                  d: int) -> RankExchange:
    """Split the shift by d (shard i sends to (i + d) mod n) for ``rank``
    of ``world`` ranks, each holding ``n_shards / world`` consecutive
    shards."""
    k = n_shards // world
    lo = rank * k
    j = np.arange(k)
    dst_rank = ((lo + j + d) % n_shards) // k
    cross = dst_rank != rank
    order = np.lexsort((j[cross], dst_rank[cross]))
    send_rows = j[cross][order]
    src = (lo + j - d) % n_shards
    src_rank = src // k
    here = src_rank == rank
    recv_src = np.empty(k, dtype=np.int64)
    recv_src[here] = src[here] - lo
    away = np.flatnonzero(~here)
    away = away[np.lexsort((src[away], src_rank[away]))]
    recv_src[away] = k + np.arange(len(away))
    return RankExchange(
        send_rows=send_rows.astype(np.int64),
        send_split=tuple(int(c) for c in np.bincount(
            dst_rank[cross], minlength=world)),
        recv_split=tuple(int(c) for c in np.bincount(
            src_rank[~here], minlength=world)),
        recv_src=recv_src)
