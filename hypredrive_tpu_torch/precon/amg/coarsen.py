"""Parallel coarsening: PMIS / HMIS (+ fallbacks).

Reference behavior: BoomerAMG coarsening types (ref: amg.c:303-309
cljp|rs|rs3|falgout|pmis|hmis).  PMIS (Parallel Modified Independent Set,
De Sterck-Yang-Heys) is the device-friendly default; it is deterministic
here via a hash-based tiebreak on the *global* row index, so the C/F
split is independent of partitioning (the property the reference gets
from hypre's deterministic RNG seeds).

HMIS runs one pass of Ruge-Stüben first-pass on the host (serial per
shard in the reference; here global) and PMIS on the remainder — we
implement it as PMIS on the 2-stage measure, which reproduces its
"aggressive-but-safe" coarsening rate.

Returns cf_marker: +1 for C-points, -1 for F-points.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _hash_random(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic per-index uniform(0,1) via splitmix64 hashing —
    partition-independent tiebreak."""
    idx = np.arange(n, dtype=np.uint64) + np.uint64(
        (seed * 0x9E3779B97F4A7C15) % (1 << 64))
    z = idx + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def pmis(S: sp.csr_matrix, seed: int = 0,
         measure_boost: np.ndarray | None = None) -> np.ndarray:
    """PMIS C/F splitting on strength graph S (S[i,j]: i depends on j)."""
    n = S.shape[0]
    try:
        from ...io.native import amg_pmis

        nat = amg_pmis(S.indptr, S.indices, seed, measure_boost)
    except Exception:
        nat = None
    if nat is not None:
        return nat
    ST = S.T.tocsr()  # ST[j,i]: j influences i → row j lists dependents

    # measure = number of points this point strongly influences + rand
    influence = np.diff(ST.indptr).astype(np.float64)
    if measure_boost is not None:
        influence = influence + measure_boost
    w = influence + _hash_random(n, seed)

    # undirected adjacency for the independent-set comparisons
    G = (S + ST).tocsr()

    UNDECIDED, C, F = 0, 1, -1
    state = np.zeros(n, dtype=np.int8)

    # points with no strong connections at all: F immediately (they don't
    # need coarse correction — nothing strongly influences them)
    iso = (np.diff(S.indptr) == 0) & (np.diff(ST.indptr) == 0)
    state[iso] = F
    # points that influence nobody and have measure < 1: F (hypre PMIS)
    state[(influence == 0) & ~iso] = F

    # edge lists materialized ONCE; each round filters its active subset
    # (the sets shrink geometrically, so total work is ~2-3x nnz instead
    # of rounds x nnz)
    g_rows = np.repeat(np.arange(n), np.diff(G.indptr))
    g_cols = G.indices
    s_rows = np.repeat(np.arange(n), np.diff(S.indptr))
    s_cols = S.indices
    g_active = np.flatnonzero((state[g_rows] == UNDECIDED)
                              & (state[g_cols] == UNDECIDED))
    s_active = np.flatnonzero(state[s_rows] == UNDECIDED)

    while (state == UNDECIDED).any():
        r, c = g_rows[g_active], g_cols[g_active]
        lose = np.zeros(n, dtype=bool)
        bad = w[r] <= w[c]
        lose[r[bad]] = True
        new_c = (state == UNDECIDED) & ~lose
        if not new_c.any():
            # numerical tie stalemate cannot happen with distinct hashes,
            # but guard anyway: promote the max-w undecided point
            undecided = np.flatnonzero(state == UNDECIDED)
            new_c = np.zeros(n, dtype=bool)
            new_c[undecided[np.argmax(w[undecided])]] = True
        state[new_c] = C
        # any undecided point strongly depending on a new C becomes F
        sr, sc = s_rows[s_active], s_cols[s_active]
        dep = (state[sr] == UNDECIDED) & (state[sc] == C)
        state[sr[dep]] = F
        # shrink the active edge sets
        g_active = g_active[(state[r] == UNDECIDED)
                            & (state[c] == UNDECIDED)]
        s_active = s_active[state[sr] == UNDECIDED]

    return state.astype(np.int8)


def hmis(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """HMIS: PMIS with a Ruge-Stüben-style first-pass measure boost.

    The serial RS first pass favors points that influence many F-points;
    we emulate the hybrid by boosting the PMIS measure with the RS
    second-round weights, yielding HMIS-like (sparser) grids.
    """
    ST = S.T.tocsr()
    influence = np.diff(ST.indptr).astype(np.float64)
    # one Jacobi-like smoothing of the influence measure over the graph
    boost = np.zeros_like(influence)
    if S.nnz:
        boost = np.asarray(ST @ (influence > np.median(influence)),
                           dtype=np.float64).ravel() * 0.5
    return pmis(S, seed=seed, measure_boost=boost)


def cljp(S: sp.csr_matrix, seed: int = 0,
         init_cf: np.ndarray | None = None,
         active: np.ndarray | None = None) -> np.ndarray:
    """CLJP coarsening (Cleary-Luby-Jones-Plassmann; ref vocab cljp=0,
    amg.c:303-309): iterative independent-set selection with S-edge
    weight updates — unlike PMIS, edges are *consumed* as C-points are
    chosen, so the grids are denser and partition-independent.

    Measures: w(j) = |Sᵀ(j)| + rand.  Per round, the independent set of
    local maxima becomes C; then the two classical heuristics update
    weights over the remaining edges:
      H1 — for each new C point c and edge (c → j): j influences a C
           point, so w(j) -= 1 and the edge is removed;
      H2 — for each j depending on a new C point c, any k ∈ S(j) that
           also depends on c has its edge (j → k) removed and w(k) -= 1.
    Points whose weight drops below 1 become F.

    ``init_cf``/``active`` support the Falgout composite: entries with
    init_cf=+1 enter as C, and only ``active`` points are (re)decided.
    Fully vectorized over edge lists.
    """
    n = S.shape[0]
    ST = S.T.tocsr()
    influence = np.diff(ST.indptr).astype(np.float64)
    w = influence + _hash_random(n, seed)

    UNDECIDED, C, F = 0, 1, -1
    state = np.zeros(n, dtype=np.int8)
    if init_cf is not None:
        state[init_cf > 0] = C
        state[init_cf < 0] = F
    if active is None:
        active_mask = np.ones(n, dtype=bool)
    else:
        active_mask = np.asarray(active, bool).copy()
    # never re-decide preset C points
    if init_cf is not None:
        active_mask &= ~(init_cf > 0)
    # isolated active points -> F
    iso = (np.diff(S.indptr) == 0) & (np.diff(ST.indptr) == 0)
    state[iso & active_mask] = F

    # live edge list of S (i depends on j)
    e_i = np.repeat(np.arange(n), np.diff(S.indptr))
    e_j = S.indices.astype(np.int64)

    # preset C points consume their edges once (H1/H2 with the preset set)
    def _apply_updates(new_c_mask, e_i, e_j, w):
        # H1: edges (c -> j): w(j) -= 1, remove
        h1 = new_c_mask[e_i]
        if h1.any():
            np.subtract.at(w, e_j[h1], 1.0)
        # H2: for edges (j -> c) with c new C, mark "j depends on new C";
        # then any live edge (j -> k) with k also depending on the same c
        # is removed and w(k) -= 1.  Exact common-c pairing needs the
        # per-c neighbor sets; we realize it by joining on sorted
        # (depender, c) pairs.
        dep = new_c_mask[e_j]          # edges j -> c
        keep = ~(h1 | dep)
        if dep.any():
            # for every live edge (j -> k): does k depend on a new C that
            # j also depends on?  Build the per-point set of new-C
            # parents, then intersect via matrix product on the pattern:
            D = sp.csr_matrix(
                (np.ones(int(dep.sum())), (e_i[dep], e_j[dep])),
                shape=(n, n))            # D[j, c] = 1
            # common-parent count for pairs (j, k): (D @ D.T)[j, k]
            ji, ki = e_i[keep], e_j[keep]
            # query common parents only for live edges (vectorized dot
            # of D rows): use D indexed rows multiply — do it by hashing
            # pairs through a sparse product restricted to the edge set
            common = np.asarray(
                D[ji].multiply(D[ki]).sum(axis=1)).ravel()
            h2 = common > 0
            if h2.any():
                np.subtract.at(w, ki[h2], 1.0)
                live = np.ones(len(ji), bool)
                live[h2] = False
                ji, ki = ji[live], ki[live]
            e_i, e_j = ji, ki
        else:
            e_i, e_j = e_i[keep], e_j[keep]
        return e_i, e_j, w

    if init_cf is not None and (state == C).any():
        preset = state == C
        e_i, e_j, w = _apply_updates(preset, e_i, e_j, w)

    # inactive points keep their (init) state; drop their edges from the
    # decision graph but keep edges TO them for weight bookkeeping
    if active is not None:
        keep = active_mask[e_i]
        e_i, e_j = e_i[keep], e_j[keep]

    max_rounds = 10 * int(np.log2(n + 2)) + 20
    for _ in range(max_rounds):
        undecided = active_mask & (state == UNDECIDED)
        if not undecided.any():
            break
        # F when weight exhausted
        newf = undecided & (w < 1.0)
        state[newf] = F
        undecided = active_mask & (state == UNDECIDED)
        if not undecided.any():
            break
        # independent set: w(i) strictly maximal over live edges in
        # either direction (both endpoints undecided)
        both = undecided[e_i] & undecided[e_j]
        bi, bj = e_i[both], e_j[both]
        is_max = undecided.copy()
        lose = np.zeros(n, bool)
        bad_i = w[bi] <= w[bj]
        lose[bi[bad_i]] = True
        lose[bj[~bad_i]] = True
        new_c = is_max & ~lose
        if not new_c.any():
            cand = np.flatnonzero(undecided)
            new_c = np.zeros(n, bool)
            new_c[cand[np.argmax(w[cand])]] = True
        state[new_c] = C
        e_i, e_j, w = _apply_updates(new_c, e_i, e_j, w)
        # drop edges out of decided points
        live = (state[e_i] == UNDECIDED)
        e_i, e_j = e_i[live], e_j[live]
    state[active_mask & (state == UNDECIDED)] = F
    return state.astype(np.int8)


def falgout(S: sp.csr_matrix, seed: int = 0,
            boundary: np.ndarray | None = None) -> np.ndarray:
    """Falgout coarsening (ref vocab falgout=6): the serial Ruge-Stüben
    first pass on the (processor-)interior, then CLJP on the partition
    boundary seeded with the RS C-points (hypre's hybrid; on a single
    part the boundary is empty and Falgout IS classical RS).

    ``boundary``: boolean mask of partition-boundary points (the
    distributed layer passes the halo rows); None ⇒ all interior."""
    cf = ruge_stuben(S)
    if boundary is None or not np.asarray(boundary, bool).any():
        return cf
    boundary = np.asarray(boundary, bool)
    # keep RS decisions in the interior; re-decide the boundary with
    # CLJP, seeded by interior C's (they consume boundary edges)
    init = cf.copy()
    init[boundary] = 0
    return cljp(S, seed=seed, init_cf=init, active=boundary)


def ruge_stuben(S: sp.csr_matrix) -> np.ndarray:
    """Classical Ruge-Stüben first-pass coarsening (ref vocab rs=1,
    rs3=3; hypre's serial host algorithm).  Setup runs on host anyway
    (the framework's latency/throughput split), so the sequential pass
    is admissible when explicitly requested.

    measure(i) = #points i strongly influences; repeatedly promote the
    max-measure point to C, make its dependents F, and bump the measure
    of points those dependents still depend on (classical update)."""
    import heapq

    n = S.shape[0]
    ST = S.T.tocsr()
    w = np.diff(ST.indptr).astype(np.int64).copy()
    state = np.zeros(n, dtype=np.int8)  # 0 undecided, 1 C, -1 F

    # isolated points (no strong connections either way): F
    iso = (np.diff(S.indptr) == 0) & (np.diff(ST.indptr) == 0)
    state[iso] = -1

    heap = [(-w[i], i) for i in np.flatnonzero(state == 0)]
    heapq.heapify(heap)
    while heap:
        neg_wi, i = heapq.heappop(heap)
        if state[i] != 0 or -neg_wi != w[i]:
            continue  # stale heap entry (lazy deletion)
        state[i] = 1  # C-point
        # dependents of i become F; their dependencies gain measure
        for j in ST.indices[ST.indptr[i]:ST.indptr[i + 1]]:
            if state[j] != 0:
                continue
            state[j] = -1
            for k in S.indices[S.indptr[j]:S.indptr[j + 1]]:
                if state[k] == 0:
                    w[k] += 1
                    heapq.heappush(heap, (-w[k], k))
        # i's own dependencies lose one potential dependent
        for j in S.indices[S.indptr[i]:S.indptr[i + 1]]:
            if state[j] == 0:
                w[j] -= 1
                heapq.heappush(heap, (-w[j], j))
    state[state == 0] = -1
    return state


def coarsen(S: sp.csr_matrix, ctype: int = 8, seed: int = 0,
            boundary: np.ndarray | None = None) -> np.ndarray:
    """Dispatch on the coarsening.type code (ref vocab: cljp=0, rs=1,
    rs3=3, falgout=6, pmis=8, hmis=10).  cljp is the real CLJP
    independent-set algorithm with edge-weight updates; falgout = serial
    RS on the interior + CLJP on the partition ``boundary`` (empty on a
    single part, matching hypre); rs/rs3 run the classical Ruge-Stüben
    host pass; hmis = PMIS with the RS measure boost."""
    if ctype == 0:
        return cljp(S, seed)
    if ctype == 10:
        return hmis(S, seed)
    if ctype == 6:
        return falgout(S, seed, boundary=boundary)
    if ctype in (1, 3):
        return ruge_stuben(S)
    return pmis(S, seed)
