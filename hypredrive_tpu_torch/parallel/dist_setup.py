"""Distributed AMG hierarchy setup over row-sharded matrix parts.

Counterpart of ``hypredrive_tpu/parallel/dist_setup.py``: the host half
(numpy/scipy) is copied, so both packages build the same C/F splits and
the same P, R and A_c bit for bit; :func:`setup_hierarchy_dist` uploads
each level's A, P and R as a :class:`~.dist_matrix.DistEllMatrix` and the
smoother vectors as the rank's rows of the padded level, on the mesh's
device (every rank runs the same host setup).  Every phase
works on per-shard row blocks (the reference's ParCSR BoomerAMG setup
decomposition, ref: src/internal/amg.c:864 delegating to
HYPRE_BoomerAMGSetup) and the global matrix is never assembled:

* strength      — row-local (each shard runs strength_graph on its block)
* PMIS/HMIS     — synchronized rounds with boundary-state exchange; the
                  splitmix64 measure hash is a function of the GLOBAL row
                  index, so the C/F split is bit-identical to the
                  host-global ``coarsen``
* interpolation — each shard builds its P rows on an *extended local
                  block* (owned rows + one-ring halo rows, columns
                  compressed to the distance-2 set) with the same serial
                  row builders as the host path, then drops the halo rows
* RAP           — local triple products (P_s)ᵀ·(A_s·P) per shard plus
                  boundary-row accumulation onto the coarse owners

Exchanges are per-part slicing in one process, as in the JAX package.
Vectors (measures, states, λmax power iterates) exist globally on the
host; only O(nnz) objects stay per shard.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ..ops.csr import row_partition
from ..precon.amg.strength import strength_graph
from ..precon.amg.coarsen import _hash_random
from ..precon.amg.interp import build_interpolation


def split_rows(A: sp.csr_matrix, n_parts: int) -> List[sp.csr_matrix]:
    """Utility: split a global CSR into balanced row blocks (tests and
    drivers that still start from one host matrix)."""
    off = row_partition(A.shape[0], n_parts)
    return [sp.csr_matrix(A[int(off[s]):int(off[s + 1])])
            for s in range(n_parts)]


def offsets_of(parts: Sequence[sp.csr_matrix]) -> np.ndarray:
    off = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([p.shape[0] for p in parts], out=off[1:])
    return off


def _owner_of(gids: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    return np.searchsorted(offsets, gids, side="right") - 1


def _fetch_rows(parts: Sequence[sp.csr_matrix], offsets: np.ndarray,
                gids: np.ndarray) -> sp.csr_matrix:
    """Halo-row exchange: return the global rows ``gids`` (sorted,
    unique) stacked as one CSR with global columns.  One-ring payload —
    exactly what a rank would receive from its neighbors."""
    gids = np.asarray(gids, dtype=np.int64)
    if len(gids) == 0:
        ncols = parts[0].shape[1]
        return sp.csr_matrix((0, ncols))
    own = _owner_of(gids, offsets)
    blocks = []
    for s in np.unique(own):
        local = gids[own == s] - offsets[s]
        blocks.append(parts[s][local])
    return sp.csr_matrix(sp.vstack(blocks))


# ---------------------------------------------------------------------------
# distributed PMIS / HMIS
# ---------------------------------------------------------------------------

def pmis_dist(S_parts: Sequence[sp.csr_matrix], offsets: np.ndarray,
              seed: int = 0,
              measure_boost: Optional[np.ndarray] = None
              ) -> List[np.ndarray]:
    """Distributed PMIS, bit-identical to ``coarsen.pmis`` on the
    assembled graph.

    Round structure matches the host loop exactly: (1) independent-set
    selection over the undirected S∪Sᵀ edges (both endpoints undecided,
    w strictly maximal), (2) C-state exchange, (3) F-propagation along
    S edges into new C points.  Stalemate guard = global argmax
    reduction, as on host.
    """
    n_sh = len(S_parts)
    n = int(offsets[-1])

    # per-shard outgoing S edges (global endpoint ids)
    edges_out = []     # (i_global, j_global) with i owned
    for s in range(n_sh):
        Sp = S_parts[s]
        i_g = np.repeat(np.arange(Sp.shape[0], dtype=np.int64)
                        + offsets[s], np.diff(Sp.indptr))
        edges_out.append((i_g, Sp.indices.astype(np.int64)))

    # influence(j) = global in-degree: shards send per-column counts to
    # the owner, owner sums (one Allreduce-by-owner)
    influence = np.zeros(n, dtype=np.float64)
    for i_g, j_g in edges_out:
        np.add.at(influence, j_g, 1.0)
    if measure_boost is not None:
        influence = influence + measure_boost
    w = influence + _hash_random(n, seed)

    # reverse edges: shard owning j learns (j, i) for every S edge i→j
    # (the transpose exchange hypre does when building ST)
    rev_i: List[List[np.ndarray]] = [[] for _ in range(n_sh)]
    rev_j: List[List[np.ndarray]] = [[] for _ in range(n_sh)]
    for i_g, j_g in edges_out:
        own = _owner_of(j_g, offsets)
        for t in np.unique(own):
            m = own == t
            rev_i[t].append(j_g[m])
            rev_j[t].append(i_g[m])

    UNDECIDED, C, F = 0, 1, -1
    state = np.zeros(n, dtype=np.int8)   # replicated boundary copy; a
    # real deployment keeps owned + halo slices — O(n) host vector here

    # per-shard undirected adjacency (G = S ∪ Sᵀ edges incident to owned)
    g_edges = []
    s_edges = []
    for s in range(n_sh):
        i_out, j_out = edges_out[s]
        i_in = (np.concatenate(rev_i[s]) if rev_i[s]
                else np.empty(0, np.int64))
        j_in = (np.concatenate(rev_j[s]) if rev_j[s]
                else np.empty(0, np.int64))
        g_edges.append((np.concatenate([i_out, i_in]),
                        np.concatenate([j_out, j_in])))
        s_edges.append((i_out, j_out))
        # isolated owned points: no S row entries and no incoming edges
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        out_deg = np.zeros(hi - lo)
        np.add.at(out_deg, i_out - lo, 1.0)
        in_deg = np.zeros(hi - lo)
        if len(i_in):
            np.add.at(in_deg, i_in - lo, 1.0)
        iso = (out_deg == 0) & (in_deg == 0)
        sl = slice(lo, hi)
        st = state[sl]
        st[iso] = F
        st[(influence[sl] == 0) & ~iso & (st == 0)] = F
        state[sl] = st

    while (state == UNDECIDED).any():
        # round: local independent-set selection per shard
        any_c = False
        new_c_all = np.zeros(n, dtype=bool)
        for s in range(n_sh):
            lo, hi = int(offsets[s]), int(offsets[s + 1])
            gi, gj = g_edges[s]
            act = (state[gi] == UNDECIDED) & (state[gj] == UNDECIDED)
            r, c = gi[act], gj[act]
            lose = np.zeros(n, dtype=bool)
            bad = w[r] <= w[c]
            lose[r[bad]] = True
            local_und = np.zeros(n, dtype=bool)
            local_und[lo:hi] = state[lo:hi] == UNDECIDED
            new_c = local_und & ~lose
            if new_c.any():
                any_c = True
            new_c_all |= new_c
        if not any_c:
            # global stalemate guard (host: argmax over undecided)
            und = np.flatnonzero(state == UNDECIDED)
            new_c_all[:] = False
            new_c_all[und[np.argmax(w[und])]] = True
        state[new_c_all] = C          # C-state exchange
        # F-propagation with the post-exchange states
        for s in range(n_sh):
            si, sj = s_edges[s]
            dep = (state[si] == UNDECIDED) & (state[sj] == C)
            state[si[dep]] = F

    return [state[int(offsets[s]):int(offsets[s + 1])].astype(np.int8)
            for s in range(len(S_parts))]


def hmis_dist(S_parts, offsets, seed=0) -> List[np.ndarray]:
    """HMIS = PMIS with the RS measure boost (host twin: coarsen.hmis).
    The boost needs the global influence vector and its median — both
    O(n) reductions."""
    n = int(offsets[-1])
    influence = np.zeros(n)
    for s, Sp in enumerate(S_parts):
        np.add.at(influence, Sp.indices.astype(np.int64), 1.0)
    boost = np.zeros(n)
    nnz_total = sum(Sp.nnz for Sp in S_parts)
    if nnz_total:
        hot = influence > np.median(influence)
        # boost(j) = 0.5 * |{i : j ∈ Sᵀ(j), hot(i)}| — Sᵀ row sums of
        # the hot indicator = per-column sums of hot rows
        for s, Sp in enumerate(S_parts):
            i_g = np.repeat(np.arange(Sp.shape[0], dtype=np.int64)
                            + offsets[s], np.diff(Sp.indptr))
            hot_i = hot[i_g]
            np.add.at(boost, Sp.indices[hot_i].astype(np.int64), 0.5)
    return pmis_dist(S_parts, offsets, seed, measure_boost=boost)


# ---------------------------------------------------------------------------
# distributed interpolation (extended local block)
# ---------------------------------------------------------------------------

def build_P_dist(A_parts, S_parts, offsets, cf_parts,
                 prolongation_type: int, trunc_factor: float,
                 max_nnz_row: int) -> Tuple[List[sp.csr_matrix], np.ndarray]:
    """Per-shard interpolation rows; returns (P_parts, coarse_offsets).

    P_parts[s]: (n_s × nC_global) rows for shard s's fine rows, columns
    in the GLOBAL coarse numbering (C points keep their global order, so
    the coarse numbering is the shard-prefix + local rank — hypre's
    ParCSR coarse numbering).
    """
    n_sh = len(A_parts)
    cf_global = np.concatenate(cf_parts)          # O(n) host vector
    c_counts = np.array([(cf > 0).sum() for cf in cf_parts], np.int64)
    c_offsets = np.zeros(n_sh + 1, np.int64)
    np.cumsum(c_counts, out=c_offsets[1:])
    # global coarse index of global point g (−1 for F):
    coarse_idx = np.cumsum(cf_global > 0) - 1
    coarse_idx[cf_global <= 0] = -1

    P_parts = []
    for s in range(n_sh):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        A_s, S_s = A_parts[s], S_parts[s]
        own_rows = np.arange(lo, hi, dtype=np.int64)
        # one-ring: rows whose A/S rows the serial builders touch
        ring = np.unique(np.concatenate([
            A_s.indices.astype(np.int64), S_s.indices.astype(np.int64)]))
        ring = ring[(ring < lo) | (ring >= hi)]
        ext_rows = np.concatenate([own_rows, ring])
        A_ext = sp.csr_matrix(sp.vstack([
            A_s, _fetch_rows(A_parts, offsets, ring)]))
        S_ext = sp.csr_matrix(sp.vstack([
            S_s, _fetch_rows(S_parts, offsets, ring)]))
        # distance-2 column set (compressed square index space)
        union = np.unique(np.concatenate([
            ext_rows, A_ext.indices.astype(np.int64),
            S_ext.indices.astype(np.int64)]))
        remap = {int(g): k for k, g in enumerate(union)}
        pos_rows = np.searchsorted(union, ext_rows)
        nU = len(union)

        def compress(M):
            ind = np.searchsorted(union, M.indices.astype(np.int64))
            rows_local = np.repeat(pos_rows, np.diff(M.indptr))
            return sp.csr_matrix(
                (M.data, (rows_local, ind)), shape=(nU, nU))

        A_sq = compress(A_ext)
        S_sq = compress(S_ext)
        cf_ext = cf_global[union]
        P_sq = build_interpolation(
            A_sq, S_sq, cf_ext,
            prolongation_type=prolongation_type,
            trunc_factor=trunc_factor, max_nnz_row=max_nnz_row)
        # keep owned rows; remap columns (ranks within union-C) to the
        # global coarse numbering
        C_union = union[cf_ext > 0]
        col_map = coarse_idx[C_union]
        P_own = sp.csr_matrix(P_sq[pos_rows[:hi - lo]])
        P_own = sp.csr_matrix(
            (P_own.data, col_map[P_own.indices], P_own.indptr),
            shape=(hi - lo, int(c_offsets[-1])))
        P_own.sort_indices()
        P_parts.append(P_own)
    return P_parts, c_offsets


# ---------------------------------------------------------------------------
# distributed Galerkin RAP
# ---------------------------------------------------------------------------

def rap_dist(A_parts, P_parts, offsets, c_offsets) -> List[sp.csr_matrix]:
    """A_c = Pᵀ·A·P as per-shard coarse row blocks.

    Shard s computes (P_s)ᵀ·(A_s·P); the product's rows land on every
    coarse point interpolated from shard-s fine rows, so boundary rows
    are exchanged to their coarse owner and summed — hypre's RAP
    boundary accumulation."""
    n_sh = len(A_parts)
    nC = int(c_offsets[-1])
    contribs = []
    for s in range(n_sh):
        A_s = A_parts[s]
        # P rows for A_s's column one-ring, as a (n_global × nC) sparse
        # with only the needed rows filled (storage stays O(halo nnz))
        need = np.unique(A_s.indices.astype(np.int64))
        P_need = _fetch_rows(P_parts, offsets, need)
        indptr = np.zeros(int(offsets[-1]) + 1, np.int64)
        counts = np.diff(P_need.indptr)
        indptr_rows = np.zeros(int(offsets[-1]), np.int64)
        indptr_rows[need] = counts
        np.cumsum(indptr_rows, out=indptr[1:])
        P_glob = sp.csr_matrix(
            (P_need.data, P_need.indices, indptr),
            shape=(int(offsets[-1]), nC))
        X_s = sp.csr_matrix(A_s @ P_glob)          # (n_s × nC)
        C_s = sp.csr_matrix(P_parts[s].T @ X_s)    # (nC × nC)
        contribs.append(C_s)
    # boundary accumulation: owner t sums every shard's coarse row block
    Ac_parts = []
    for t in range(n_sh):
        c0, c1 = int(c_offsets[t]), int(c_offsets[t + 1])
        acc = None
        for s in range(n_sh):
            blk = contribs[s][c0:c1]
            acc = blk if acc is None else acc + blk
        acc = sp.csr_matrix(acc)
        acc.sort_indices()
        Ac_parts.append(acc)
    return Ac_parts


# ---------------------------------------------------------------------------
# repartition (coarse rows: owner-contiguous → balanced equal blocks)
# ---------------------------------------------------------------------------

def repartition_rows(parts: Sequence[sp.csr_matrix],
                     old_offsets: np.ndarray,
                     new_offsets: np.ndarray,
                     n_rows_pad: Optional[int] = None,
                     pad_identity: bool = True) -> List[sp.csr_matrix]:
    """Move rows between shards so the partition matches
    ``new_offsets``; rows beyond the old global size (bucket pad) become
    identity rows (exact no-ops, cf. hierarchy._pad_level)."""
    n_old = int(old_offsets[-1])
    ncols = parts[0].shape[1] if parts else 0
    if n_rows_pad is None:
        n_rows_pad = int(new_offsets[-1])
    ncols_pad = max(ncols, n_rows_pad) if pad_identity else ncols
    out = []
    for t in range(len(new_offsets) - 1):
        lo, hi = int(new_offsets[t]), int(new_offsets[t + 1])
        real_hi = min(hi, n_old)
        blocks = []
        if lo < n_old:
            gids = np.arange(lo, real_hi, dtype=np.int64)
            blk = _fetch_rows(parts, old_offsets, gids)
            blk = sp.csr_matrix(blk, shape=(real_hi - lo, ncols))
            blk.resize((real_hi - lo, ncols_pad))
            blocks.append(blk)
        ext = hi - max(lo, n_old)
        if ext > 0:
            if pad_identity:
                rows = np.arange(ext)
                cols = np.arange(max(lo, n_old), hi)
                blocks.append(sp.csr_matrix(
                    (np.ones(ext), (rows, cols)), shape=(ext, ncols_pad)))
            else:
                blocks.append(sp.csr_matrix((ext, ncols_pad)))
        out.append(sp.csr_matrix(sp.vstack(blocks)) if len(blocks) > 1
                   else sp.csr_matrix(blocks[0]))
    return out


def transpose_parts(P_parts, offsets, c_offsets) -> List[sp.csr_matrix]:
    """R = Pᵀ as coarse-row blocks: each fine shard contributes its
    entries with coarse row in the target range (column exchange)."""
    n_fine = int(offsets[-1])
    out = []
    for t in range(len(c_offsets) - 1):
        c0, c1 = int(c_offsets[t]), int(c_offsets[t + 1])
        blocks = []
        for s, P_s in enumerate(P_parts):
            coo = P_s.tocoo()
            m = (coo.col >= c0) & (coo.col < c1)
            blocks.append(sp.coo_matrix(
                (coo.data[m], (coo.col[m] - c0,
                               coo.row[m] + int(offsets[s]))),
                shape=(c1 - c0, n_fine)))
        R_t = sp.csr_matrix(sum(b.tocsr() for b in blocks))
        R_t.sort_indices()
        out.append(R_t)
    return out


# ---------------------------------------------------------------------------
# full distributed hierarchy setup
# ---------------------------------------------------------------------------

def _bucket_pad(n: int, n_shards: int) -> int:
    from ..precon.amg.hierarchy import _bucket_rows

    npad = _bucket_rows(n)
    return -(-npad // n_shards) * n_shards


def _diag_of_parts(A_parts, offsets) -> np.ndarray:
    """Global diagonal from row blocks (diag entry: col == global row)."""
    out = np.zeros(int(offsets[-1]))
    for s, A_s in enumerate(A_parts):
        lo = int(offsets[s])
        rows = np.repeat(np.arange(A_s.shape[0]), np.diff(A_s.indptr))
        m = A_s.indices == rows + lo
        out[rows[m] + lo] = A_s.data[m]
    return out


def _matvec_parts(A_parts, v: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(A_s @ v).ravel() for A_s in A_parts])


def _l1_of_parts(A_parts) -> np.ndarray:
    return np.concatenate([
        np.asarray(np.abs(A_s).sum(axis=1)).ravel() for A_s in A_parts])


def supports_dist_setup(amg_args) -> bool:
    """Config subset with a distributed setup path: PMIS/HMIS coarsening,
    direct/ext+i/one-point interpolation, Galerkin Pᵀ or AIR
    restriction, aggressive (two-stage) coarsening, multi-function dofs
    (dof_func threaded through strength/interp).  Still outside the
    subset: RBMs, per-level FSAI smoothers, CF relax order.  Everything
    else falls back to the host-global setup (the solve side is
    distributed either way)."""
    csn = amg_args.coarsening
    itp = amg_args.interpolation
    rlx = amg_args.relaxation
    kinds = {0, 7, 18, 16}          # jacobi / l1-jacobi / chebyshev
    rtypes = [int(rlx.type)] if int(rlx.type) >= 0 else \
        [int(rlx.down_type), int(rlx.up_type)]
    return (int(csn.type) in (8, 10)
            and int(itp.restriction_type) in (0, 1, 2, 3, 4, 5, 15)
            and int(itp.prolongation_type) in (3, 6, 8, 100)
            and int(amg_args.smoother.num_levels) == 0
            and int(rlx.points) in (0, 1)
            and int(rlx.order) == 0
            and all(t in kinds for t in rtypes))


def build_R_dist(A_parts, offsets, cf_parts, c_offsets,
                 restriction_type: int, strong_th: float,
                 filter_th: float) -> List[sp.csr_matrix]:
    """Per-shard AIR restriction rows (owner-contiguous coarse order).

    Each shard builds the R rows of its OWN C points from the same
    compressed 2-ring subproblem build_P_dist uses — lAIR/Neumann
    stencils reach distance ≤ 2, which the own+ring row set covers
    (ref: hypre par_restr.c decomposition)."""
    from ..precon.amg.air import build_restriction

    n_sh = len(A_parts)
    cf_global = np.concatenate(cf_parts)
    n_glob = int(offsets[-1])
    R_parts = []
    for s in range(n_sh):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        A_s = A_parts[s]
        own_rows = np.arange(lo, hi, dtype=np.int64)
        ring1 = np.unique(A_s.indices.astype(np.int64))
        ring1 = ring1[(ring1 < lo) | (ring1 >= hi)]
        A_r1 = _fetch_rows(A_parts, offsets, ring1)
        # lAIR distance-2 / Neumann stencils read the A rows of F points
        # up to two hops from the C point — fetch the second ring too
        ring2 = np.unique(A_r1.indices.astype(np.int64))
        ring2 = np.setdiff1d(ring2, np.concatenate([own_rows, ring1]),
                             assume_unique=False)
        ring = np.concatenate([ring1, ring2])
        ext_rows = np.concatenate([own_rows, ring])
        A_ext = sp.csr_matrix(sp.vstack([
            A_s, A_r1, _fetch_rows(A_parts, offsets, ring2)]))
        union = np.unique(np.concatenate([
            ext_rows, A_ext.indices.astype(np.int64)]))
        pos_rows = np.searchsorted(union, ext_rows)
        nU = len(union)
        ind = np.searchsorted(union, A_ext.indices.astype(np.int64))
        rows_local = np.repeat(pos_rows, np.diff(A_ext.indptr))
        A_sq = sp.csr_matrix((A_ext.data, (rows_local, ind)),
                             shape=(nU, nU))
        cf_ext = cf_global[union]
        R_sq = build_restriction(A_sq, cf_ext, restriction_type,
                                 strong_th, filter_th)
        if R_sq is None:
            raise ValueError("build_R_dist called with p_transpose type")
        # R_sq rows are ranks within union-C; keep rows whose C point is
        # OWNED by this shard, remap rows to global coarse ids and
        # columns back to global fine ids
        C_union = union[cf_ext > 0]
        own_c = (C_union >= lo) & (C_union < hi)
        R_own = sp.csr_matrix(R_sq[np.flatnonzero(own_c)])
        R_own = sp.csr_matrix(
            (R_own.data, union[R_own.indices], R_own.indptr),
            shape=(R_own.shape[0], n_glob))
        R_own.sort_indices()
        R_parts.append(R_own)
    return R_parts


def rap_petrov_dist(A_parts, P_parts, R_parts, offsets,
                    c_offsets) -> List[sp.csr_matrix]:
    """A_c = R·A·P with an explicit (AIR) restriction: shard s computes
    X_s = A_s·P, then each coarse owner t contracts its R rows against
    the X rows it touches (same boundary exchange as rap_dist)."""
    n_sh = len(A_parts)
    nC = int(c_offsets[-1])
    n_glob = int(offsets[-1])
    X_parts = []
    for s in range(n_sh):
        A_s = A_parts[s]
        need = np.unique(A_s.indices.astype(np.int64))
        P_need = _fetch_rows(P_parts, offsets, need)
        indptr = np.zeros(n_glob + 1, np.int64)
        cnt = np.zeros(n_glob, np.int64)
        cnt[need] = np.diff(P_need.indptr)
        np.cumsum(cnt, out=indptr[1:])
        P_glob = sp.csr_matrix((P_need.data, P_need.indices, indptr),
                               shape=(n_glob, nC))
        X_parts.append(sp.csr_matrix(A_s @ P_glob))
    Ac_parts = []
    for t in range(n_sh):
        R_t = R_parts[t]
        need = np.unique(R_t.indices.astype(np.int64))
        X_need = _fetch_rows(X_parts, offsets, need)
        indptr = np.zeros(n_glob + 1, np.int64)
        cnt = np.zeros(n_glob, np.int64)
        cnt[need] = np.diff(X_need.indptr)
        np.cumsum(cnt, out=indptr[1:])
        X_glob = sp.csr_matrix((X_need.data, X_need.indices, indptr),
                               shape=(n_glob, nC))
        Ac_t = sp.csr_matrix(R_t @ X_glob)
        Ac_t.sort_indices()
        Ac_parts.append(Ac_t)
    return Ac_parts


def setup_hierarchy_dist(A_parts: Sequence[sp.csr_matrix], amg_args,
                         mesh, dtype=None, dof_func=None):
    """Distributed twin of hierarchy.setup_hierarchy: consumes per-shard
    row blocks (global columns) and returns an AMGState whose levels are
    row-sharded DistEllMatrix operators — no global matrix is ever
    assembled.  Covers ``dof_func`` (num_functions > 1), aggressive
    (two-stage) coarsening on the first ``aggressive.num_levels`` levels
    and AIR restriction with the F/C relax schedule."""
    import torch

    from ..precon.amg.hierarchy import AMGLevel, AMGState
    from ..precon.chebyshev import cheby_coefficients
    from .dist_matrix import DistEllMatrix

    if dtype is None:
        dtype = torch.float64
    if not supports_dist_setup(amg_args):
        raise ValueError(
            "AMG config outside the distributed-setup subset "
            "(see supports_dist_setup)")

    n_sh = mesh.n_shards
    if len(A_parts) != n_sh:
        raise ValueError(f"need {n_sh} parts for this mesh")
    csn = amg_args.coarsening
    itp = amg_args.interpolation
    rlx = amg_args.relaxation
    theta = float(csn.strong_th)
    sabs = bool(csn.sabs)
    max_levels = int(csn.max_levels)
    max_coarse = max(1, int(csn.max_coarse_size))
    min_coarse = int(csn.min_coarse_size)
    agg_levels = int(amg_args.aggressive.num_levels)
    restriction_type = int(itp.restriction_type)
    restrict_th = float(itp.restrict_strong_th)
    restrict_filter = float(itp.restrict_filter_th)
    if int(rlx.type) >= 0:
        kind_code = int(rlx.type)
    else:
        kind_code = int(rlx.down_type)
    kind = {0: "jacobi", 7: "jacobi", 18: "l1-jacobi",
            16: "chebyshev"}.get(kind_code, "l1-jacobi")
    air_points = int(rlx.points) == 1
    if air_points and kind != "chebyshev":
        kind = "air-" + ("jacobi" if kind == "jacobi" else "l1-jacobi")
    num_sweeps = max(1, int(rlx.num_sweeps))
    pre = int(rlx.down_sweeps) if int(rlx.down_sweeps) >= 0 else num_sweeps
    post = int(rlx.up_sweeps) if int(rlx.up_sweeps) >= 0 else num_sweeps
    weight = float(rlx.weight)

    # balance + pad the fine level so every level size divides n_shards
    off_in = offsets_of(A_parts)
    n0 = int(off_in[-1])
    n0_pad = -(-n0 // n_sh) * n_sh
    new_off = row_partition(n0_pad, n_sh)
    A_parts = repartition_rows(A_parts, off_in, new_off, n_rows_pad=n0_pad)
    off = new_off
    n_real = n0
    func_l = None
    if dof_func is not None and int(csn.num_functions) > 1:
        func_l = np.full(n0_pad, -1, dtype=np.int64)
        func_l[:n0] = np.asarray(dof_func)

    def vec(a):
        # this rank's rows of a per-row vector of the padded level
        return torch.as_tensor(mesh.local(np.asarray(a)), dtype=dtype,
                               device=mesh.device)

    def smoother_arrays(A_parts, off, n_pad, fmask=None):
        if kind == "chebyshev":
            order = int(rlx.chebyshev.get("order", 2)) \
                if rlx.chebyshev else 2
            fraction = float(rlx.chebyshev.get("fraction", 0.3)) \
                if rlx.chebyshev else 0.3
            eig_iters = int(rlx.chebyshev.get("eig_est", 10)) \
                if rlx.chebyshev else 10
            diag = _diag_of_parts(A_parts, off)
            d_inv = np.where(diag != 0, 1.0 / diag, 1.0)
            rng = np.random.default_rng(0)
            v = rng.standard_normal(n_pad)
            lam = 1.0
            for _ in range(max(1, eig_iters)):
                w_ = d_inv * _matvec_parts(A_parts, v)
                lam = np.linalg.norm(w_)
                if lam == 0:
                    lam = 1.0
                    break
                v = w_ / lam
            theta_c, delta, rhos = cheby_coefficients(
                float(lam) * 1.1, fraction, order)
            return (vec(d_inv), float(theta_c), float(delta),
                    tuple(float(r) for r in rhos))
        if kind.endswith("jacobi") and not kind.endswith("l1-jacobi"):
            diag = _diag_of_parts(A_parts, off)
            base = (vec(np.where(diag != 0, weight / diag, 1.0)),)
        else:
            l1 = _l1_of_parts(A_parts)
            base = (vec(np.where(l1 != 0, weight / l1, 1.0)),)
        if kind.startswith("air-"):
            if fmask is None:
                fmask = np.ones(n_pad)
            base = base + (vec(fmask),)
        return base

    def one_stage(A_parts, off, seed, func):
        """strength → PMIS/HMIS → P; returns (S_parts, cf_parts,
        P_parts, c_off_owner) or None when coarsening degenerates."""
        S_parts = [strength_graph(A_parts[s], theta=theta, sabs=sabs,
                                  dof_func=func, row_offset=int(off[s]))
                   for s in range(n_sh)]
        if sum(S.nnz for S in S_parts) == 0:
            return None
        if int(csn.type) == 10:
            cf_parts = hmis_dist(S_parts, off, seed=seed)
        else:
            cf_parts = pmis_dist(S_parts, off, seed=seed)
        nC = int(sum((cf > 0).sum() for cf in cf_parts))
        if nC == 0:
            return None
        P_parts, c_off_owner = build_P_dist(
            A_parts, S_parts, off, cf_parts,
            prolongation_type=int(itp.prolongation_type),
            trunc_factor=float(itp.trunc_factor),
            max_nnz_row=int(itp.max_nnz_row))
        return S_parts, cf_parts, P_parts, c_off_owner

    levels = []
    for lvl in range(max_levels - 1):
        if n_real <= max_coarse or (min_coarse and n_real <= min_coarse):
            break
        n_pad = int(off[-1])
        seed = lvl + int(getattr(csn, "rand_seed", 0))
        stage = one_stage(A_parts, off, seed, func_l)
        if stage is None:
            break
        S_parts, cf_parts, P_parts, c_off_owner = stage
        nC = int(c_off_owner[-1])
        if nC >= n_real:
            break
        cf_global = np.concatenate(cf_parts)
        func_c = func_l[cf_global > 0] if func_l is not None else None

        if lvl < agg_levels:
            # aggressive (two-stage) coarsening: PMIS → P₁ → Galerkin
            # A₁ → PMIS → P₂, fused P = P₁·P₂ (the host path's
            # hierarchy._aggressive_interpolation from the dist primitives)
            A1_owner = rap_dist(A_parts, P_parts, off, c_off_owner)
            stage2 = one_stage(A1_owner, c_off_owner, 1000 + seed, func_c)
            if stage2 is not None:
                _, cf2_parts, P2_parts, c2_off_owner = stage2
                nC2 = int(c2_off_owner[-1])
                if 0 < nC2 < nC:
                    # fuse P = P1 @ P2 per fine shard
                    n1 = int(c_off_owner[-1])
                    fused = []
                    for s in range(n_sh):
                        P1_s = P_parts[s]
                        need = np.unique(P1_s.indices.astype(np.int64))
                        P2_need = _fetch_rows(P2_parts, c_off_owner, need)
                        indptr = np.zeros(n1 + 1, np.int64)
                        cnt = np.zeros(n1, np.int64)
                        cnt[need] = np.diff(P2_need.indptr)
                        np.cumsum(cnt, out=indptr[1:])
                        P2_glob = sp.csr_matrix(
                            (P2_need.data, P2_need.indices, indptr),
                            shape=(n1, nC2))
                        Pf = sp.csr_matrix(P1_s @ P2_glob)
                        Pf.sort_indices()
                        fused.append(Pf)
                    P_parts = fused
                    c_off_owner = c2_off_owner
                    nC = nC2
                    # combined CF marks: stage-1 C demoted where stage-2
                    # marked F
                    cf2_global = np.concatenate(cf2_parts)
                    c1_ids = np.flatnonzero(cf_global > 0)
                    cf_global = cf_global.copy()
                    cf_global[c1_ids[cf2_global < 0]] = -1
                    func_c = func_c[cf2_global > 0] \
                        if func_c is not None else None

        R_air_owner = None
        if restriction_type != 0:
            cf_parts_now = [
                cf_global[int(off[s]):int(off[s + 1])]
                for s in range(n_sh)]
            R_air_owner = build_R_dist(
                A_parts, off, cf_parts_now, c_off_owner,
                restriction_type, restrict_th, restrict_filter)
            Ac_owner = rap_petrov_dist(A_parts, P_parts, R_air_owner,
                                       off, c_off_owner)
        else:
            Ac_owner = rap_dist(A_parts, P_parts, off, c_off_owner)

        npad_c = _bucket_pad(nC, n_sh)
        c_off_new = row_partition(npad_c, n_sh)
        Ac_parts = repartition_rows(Ac_owner, c_off_owner, c_off_new,
                                    n_rows_pad=npad_c)
        # P: fine rows, coarse columns extended to the padded size
        P_padded = []
        for P_s in P_parts:
            P_s = P_s.copy()
            P_s.resize((P_s.shape[0], npad_c))
            P_padded.append(sp.csr_matrix(P_s))
        if R_air_owner is not None:
            # AIR R rows re-blocked to the new padded coarse layout (pad
            # rows are exact zeros — the padded coarse values they produce
            # multiply P's zero pad columns)
            R_parts = repartition_rows(R_air_owner, c_off_owner,
                                       c_off_new, pad_identity=False)
        else:
            # R = Pᵀ rows partitioned by the NEW coarse layout (pad rows
            # of R are exactly zero — cf. hierarchy._pad_level)
            R_parts = transpose_parts(P_padded, off, c_off_new)

        fmask = (cf_global < 0).astype(np.float64) \
            if kind.startswith("air-") else None
        sm = smoother_arrays(A_parts, off, n_pad, fmask)
        levels.append(AMGLevel(
            A=DistEllMatrix.from_parts(A_parts, mesh, n_pad, dtype=dtype),
            P=DistEllMatrix.from_parts(P_padded, mesh, npad_c, dtype=dtype),
            R=DistEllMatrix.from_parts(R_parts, mesh, n_pad, dtype=dtype),
            smooth_arrays=sm, smoother=kind,
            pre_sweeps=pre, post_sweeps=post,
        ))
        A_parts = Ac_parts
        off = c_off_new
        n_real = nC
        if func_c is not None:
            func_l = np.full(npad_c, -1, dtype=np.int64)
            func_l[:nC] = func_c
        if nC <= max_coarse:
            break

    # coarsest level: tiny — gather to a dense inverse, exactly like the
    # host path (ref coarse_type 9 = Gaussian elimination), replicated on
    # every rank (the cycle gathers the coarse residual to apply it)
    n_pad = int(off[-1])
    sm_c = smoother_arrays(A_parts, off, n_pad)
    levels.append(AMGLevel(
        A=DistEllMatrix.from_parts(A_parts, mesh, n_pad, dtype=dtype),
        P=None, R=None, smooth_arrays=sm_c,
        smoother=kind, pre_sweeps=pre, post_sweeps=post,
    ))
    dense = np.asarray(sp.vstack(A_parts).todense())
    try:
        inv = np.linalg.inv(dense)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(dense)

    return AMGState(
        levels=tuple(levels),
        coarse_inv=torch.as_tensor(inv, dtype=dtype, device=mesh.device),
        cycle_type=0 if int(getattr(amg_args, "cycle_type", 1)) <= 1 else 1,
        max_iter=max(1, int(amg_args.max_iter)),
        mesh=mesh,
    )
