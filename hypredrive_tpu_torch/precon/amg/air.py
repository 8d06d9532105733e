"""Approximate ideal restriction (AIR) operators.

For strongly nonsymmetric operators (upwind advection) the Galerkin
choice R = Pᵀ degrades; AIR instead approximates the *ideal* restriction
R = [-A_cf·A_ff⁻¹, I], which annihilates F-point error after F-relaxation
(Manteuffel-Ruge-Southworth, SIAM J. Sci. Comput. 2018).

Reference surface: ``interpolation.restriction_type`` ∈ air_1 / air_2 /
air_1.5 / neumann_air_{0,1,2} with ``restrict_strong_th`` /
``restrict_filter_th`` (ref: src/internal/amg.c:276-284,870-877), paired
with the F/C relaxation schedule of ``relaxation.points: air``
(ref: src/internal/amg.c:986-1015).

TPU-first construction: local AIR (lAIR) is a batched dense solve — all
C-rows with the same stencil size are gathered into one (g, m, m) batch
and solved with a single vectorized ``np.linalg.solve`` on host during
setup (the reference's own host/device split: setup latency-bound,
solve throughput-bound).  Neumann AIR is pure SpGEMM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from .strength import strength_graph


def _csr_fetch(M: sp.csr_matrix, r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Vectorized lookup of M[r, c] (0.0 where the entry is absent).

    Uses the global sorted key trick: CSR with sorted indices makes
    ``row*ncols + col`` globally sorted over the nnz array.
    """
    M = M.tocsr()
    M.sort_indices()
    n_rows, n_cols = M.shape
    nnz_rows = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(M.indptr))
    keys = nnz_rows * n_cols + M.indices
    q = r.astype(np.int64) * n_cols + c.astype(np.int64)
    pos = np.searchsorted(keys, q.ravel())
    pos_c = np.minimum(pos, max(len(keys) - 1, 0))
    found = (len(keys) > 0) & (pos < len(keys)) & (keys[pos_c] == q.ravel())
    vals = np.where(found, M.data[pos_c] if len(keys) else 0.0, 0.0)
    return vals.reshape(r.shape)


def _restrict_pattern(A: sp.csr_matrix, cf: np.ndarray, strong_th: float,
                      distance: int, max_stencil: int = 128):
    """(rows, cols) pattern of the Z block: for each C-point, the F-points
    it eliminates — strong F-neighbors at the given graph distance."""
    S = strength_graph(A, theta=strong_th, sabs=True)
    F = np.flatnonzero(cf < 0)
    C = np.flatnonzero(cf > 0)
    S_cf = sp.csr_matrix(S[C][:, F], dtype=np.float64)
    if distance >= 2:
        S_ff = sp.csr_matrix(S[F][:, F], dtype=np.float64).astype(bool)
        pat = (S_cf.astype(bool) + S_cf.astype(bool) @ S_ff).tocsr()
    else:
        pat = S_cf.astype(bool).tocsr()
    pat.sort_indices()

    # cap pathological stencils at max_stencil strongest connections,
    # ranked by |A| magnitude on the pattern (distance-2 fill-ins that
    # have no A entry rank by strength value instead)
    counts = np.diff(pat.indptr)
    if counts.size and counts.max() > max_stencil:
        rows = np.repeat(np.arange(pat.shape[0]), counts)
        mag = np.abs(_csr_fetch(sp.csr_matrix(A[C][:, F]), rows, pat.indices))
        mag = mag + 1e-300  # keep zero-A fill-ins below real entries
        order = np.lexsort((-mag, rows))
        starts = np.repeat(pat.indptr[:-1], counts)
        rank = np.arange(pat.nnz) - starts
        keep = np.zeros(pat.nnz, dtype=bool)
        keep[order] = rank < max_stencil
        indptr = np.zeros(pat.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows[keep], minlength=pat.shape[0]),
                  out=indptr[1:])
        pat = sp.csr_matrix((np.ones(int(keep.sum())), pat.indices[keep],
                             indptr), shape=pat.shape)
        pat.sort_indices()
    return pat, F, C


def lair_restriction(A: sp.csr_matrix, cf: np.ndarray,
                     strong_th: float = 0.25, distance: int = 1,
                     filter_th: float = 0.0) -> sp.csr_matrix:
    """Local AIR: per C-row solve  z·A_ff[J,J] = A_cf[i,J]  on the strong
    stencil J, batched over rows with equal |J|; R = [-z rows, I]."""
    n = A.shape[0]
    A = sp.csr_matrix(A, dtype=np.float64)
    pat, F, C = _restrict_pattern(A, cf, strong_th, distance)
    nC, nF = len(C), len(F)
    A_ff = sp.csr_matrix(A[F][:, F])
    A_cf = sp.csr_matrix(A[C][:, F])

    counts = np.diff(pat.indptr)
    z_data = np.zeros(pat.nnz)
    for m in np.unique(counts):
        if m == 0:
            continue
        grp = np.flatnonzero(counts == m)          # C-rows with stencil m
        # gather stencils: J[g, p] = p-th F-neighbor of group row g
        starts = pat.indptr[grp]
        J = pat.indices[(starts[:, None] + np.arange(m)[None, :])]
        # T[g, p, q] = A_ff[J_p, J_q];  rhs[g, p] = A_cf[i, J_p]
        T = _csr_fetch(A_ff, np.repeat(J, m, axis=1),
                       np.tile(J, (1, m))).reshape(len(grp), m, m)
        rhs = _csr_fetch(A_cf, np.broadcast_to(grp[:, None], J.shape), J)
        # constraint (Z = A_cf·A_ff⁻¹ restricted to J):
        #   Σ_k z_k A_ff[k, j] = A_cf[i, j]  ∀ j ∈ J
        # ⇔ (A_loc)ᵀ z = rhs  with A_loc[p, q] = A_ff[J_p, J_q];
        # the −Z sign enters in _assemble_R
        Tt = np.ascontiguousarray(np.swapaxes(T, 1, 2))
        try:
            z = np.linalg.solve(Tt, rhs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            # singular stencil(s) in the batch: least-squares per row
            # (a single merged lstsq would wrongly couple the rows)
            z = np.empty((len(grp), m))
            for g in range(len(grp)):
                z[g] = np.linalg.lstsq(Tt[g], rhs[g], rcond=None)[0]
        z = np.where(np.isfinite(z), z, 0.0)
        idx = (starts[:, None] + np.arange(m)[None, :]).ravel()
        z_data[idx] = z.ravel()

    Z = sp.csr_matrix((z_data, pat.indices, pat.indptr), shape=(nC, nF))
    if filter_th > 0:
        Z = _filter_rows(Z, filter_th)
    return _assemble_R(Z, F, C, n)


def neumann_restriction(A: sp.csr_matrix, cf: np.ndarray, degree: int = 0,
                        filter_th: float = 0.0) -> sp.csr_matrix:
    """Neumann AIR: A_ff⁻¹ ≈ (Σ_{k≤d} Nᵏ)·D⁻¹ with N = I − D⁻¹A_ff,
    so Z = A_cf·(Σ Nᵏ)·D⁻¹ — pure SpGEMM, no local solves."""
    n = A.shape[0]
    A = sp.csr_matrix(A, dtype=np.float64)
    F = np.flatnonzero(cf < 0)
    C = np.flatnonzero(cf > 0)
    A_ff = sp.csr_matrix(A[F][:, F])
    A_cf = sp.csr_matrix(A[C][:, F])
    d = A_ff.diagonal()
    d_inv = sp.diags(np.where(d != 0, 1.0 / d, 1.0))
    N = (sp.eye(len(F), format="csr") - d_inv @ A_ff).tocsr()
    acc = sp.eye(len(F), format="csr")
    term = sp.eye(len(F), format="csr")
    for _ in range(degree):
        term = (term @ N).tocsr()
        acc = (acc + term).tocsr()
    Z = (A_cf @ acc @ d_inv).tocsr()
    if filter_th > 0:
        Z = _filter_rows(Z, filter_th)
    return _assemble_R(Z, F, C, n)


def _filter_rows(Z: sp.csr_matrix, filter_th: float) -> sp.csr_matrix:
    """Drop |z| < filter_th·rowmax (no rescale — rescaling would break the
    R·A ≈ 0 annihilation property the local solves established)."""
    Z = Z.tocsr()
    counts = np.diff(Z.indptr)
    rows = np.repeat(np.arange(Z.shape[0]), counts)
    absd = np.abs(Z.data)
    rowmax = np.zeros(Z.shape[0])
    np.maximum.at(rowmax, rows, absd)
    keep = absd >= filter_th * rowmax[rows]
    indptr = np.zeros(Z.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=Z.shape[0]), out=indptr[1:])
    out = sp.csr_matrix((Z.data[keep], Z.indices[keep], indptr),
                        shape=Z.shape)
    out.sort_indices()
    return out


def _assemble_R(Z: sp.csr_matrix, F: np.ndarray, C: np.ndarray,
                n: int) -> sp.csr_matrix:
    """R (nC × n): identity at the C columns, −Z at the F columns."""
    nC = len(C)
    Zc = Z.tocoo()
    rows = np.concatenate([np.arange(nC), Zc.row])
    cols = np.concatenate([C, F[Zc.col]])
    vals = np.concatenate([np.ones(nC), -Zc.data])
    R = sp.csr_matrix((vals, (rows, cols)), shape=(nC, n))
    R.sort_indices()
    return R


def build_restriction(A: sp.csr_matrix, cf: np.ndarray,
                      restriction_type: int, strong_th: float = 0.25,
                      filter_th: float = 0.0,
                      P: Optional[sp.csr_matrix] = None
                      ) -> Optional[sp.csr_matrix]:
    """Dispatch on restriction_type (ref vocab amg.c:276-284).

    0 = p_transpose → None (caller uses Pᵀ); 1/2 = lAIR distance 1/2;
    15 = air_1.5 → distance-2 pattern (the 1.5 refinement collapses to
    distance-2 here since stencils are already capped);
    3/4/5 = Neumann AIR degree 0/1/2.
    """
    if restriction_type == 0:
        return None
    if restriction_type in (1, 2, 15):
        distance = 1 if restriction_type == 1 else 2
        return lair_restriction(A, cf, strong_th, distance, filter_th)
    if restriction_type in (3, 4, 5):
        return neumann_restriction(A, cf, restriction_type - 3, filter_th)
    return None
