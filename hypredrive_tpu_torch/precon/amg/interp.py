"""Interpolation operators: direct and extended+i (MM form).

Reference behavior: BoomerAMG prolongation types (ref: amg.c:250-274);
the default is extended+i (6), the right choice for PMIS grids where
F-F pairs without a common C-point occur (De Sterck-Yang-Heys).

TPU-first construction: instead of hypre's per-row C loops, both
interpolations are built from *matrix products* on host scipy CSR (the
"MM" formulation hypre itself uses on GPUs — mm_extended+i):

  ext:    W = -D_α⁻¹ (Â_FC + Â_FF D_β⁻¹ Â_FC)
  ext+i:  W = -(D_α + D_γ)⁻¹ (Â_FC + Â_FF D_β⁻¹ Â_FC)

with Â_* the strong-connection blocks, β_k the interpolatory row sums,
γ_i the distance-two feedback Σ_k Â_FF[i,k]·A[k,i]/β_k, and α_i the
diagonal with weak couplings lumped in.  Truncation (trunc_factor /
max_nnz_row) rescales rows to preserve row sums, as hypre does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def _split_blocks(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray):
    """Return (A_FF_strong, A_FC_strong, A_FC_all, diag, weak_rowsum_F)."""
    n = A.shape[0]
    F = np.flatnonzero(cf < 0)
    C = np.flatnonzero(cf > 0)
    diag = A.diagonal()

    # strong off-diag entries (values of A on the S pattern)
    A_strong = sp.csr_matrix(A.multiply(S.astype(bool)))
    # weak off-diagonal row sums = rowsum(A) − diag − rowsum(strong)
    weak_rowsum = (np.asarray(A.sum(axis=1)).ravel() - diag
                   - np.asarray(A_strong.sum(axis=1)).ravel())
    A_FF = A_strong[F][:, F]
    A_FC = A_strong[F][:, C]
    return A_FF, A_FC, diag, weak_rowsum, F, C


def direct_interpolation(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                         trunc_factor: float = 0.0, max_nnz_row: int = 4
                         ) -> sp.csr_matrix:
    """Classical direct interpolation (hypre type 3/direct):
    P_ij = -(a_ij / α_i) with α scaled so row sums are preserved."""
    A_FF, A_FC, diag, weak_rowsum, F, C = _split_blocks(A, S, cf)
    nF = len(F)

    # total off-diagonal sums vs strong-C sums (negative/positive split)
    full_neg = np.zeros(A.shape[0])
    full_pos = np.zeros(A.shape[0])
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    offd = rows != A.indices
    np.add.at(full_neg, rows[offd & (A.data < 0)], A.data[offd & (A.data < 0)])
    np.add.at(full_pos, rows[offd & (A.data > 0)], A.data[offd & (A.data > 0)])

    fc = A_FC.tocoo()
    c_neg = np.zeros(nF)
    c_pos = np.zeros(nF)
    np.add.at(c_neg, fc.row[fc.data < 0], fc.data[fc.data < 0])
    np.add.at(c_pos, fc.row[fc.data > 0], fc.data[fc.data > 0])

    dF = diag[F].copy()
    # lump positives into the diagonal when no positive C-connections
    no_pos = c_pos == 0
    dF = dF + np.where(no_pos, full_pos[F], 0.0)

    scale_neg = np.divide(full_neg[F], c_neg, out=np.zeros(nF),
                          where=c_neg != 0)
    scale_pos = np.divide(full_pos[F], c_pos, out=np.zeros(nF),
                          where=c_pos != 0)

    w = np.where(fc.data < 0, fc.data * scale_neg[fc.row],
                 fc.data * scale_pos[fc.row])
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -w / dF[fc.row]
    w = np.where(np.isfinite(w), w, 0.0)

    W = sp.csr_matrix((w, (fc.row, fc.col)), shape=(nF, len(C)))
    W = _truncate(W, trunc_factor, max_nnz_row)
    return _assemble_P(W, cf, F, C)


def extended_i_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                             cf: np.ndarray, trunc_factor: float = 0.0,
                             max_nnz_row: int = 4,
                             plus_i: bool = True) -> sp.csr_matrix:
    """Extended(+i) interpolation in matrix-matrix form (hypre mm-ext+i)."""
    if sp.csr_matrix(A).has_sorted_indices:
        try:
            from ...io.native import amg_interp_ext_i

            nat = amg_interp_ext_i(sp.csr_matrix(A), S.indptr, S.indices,
                                   cf, plus_i, trunc_factor, max_nnz_row)
        except Exception:
            nat = None
        if nat is not None:
            return nat
    A_FF, A_FC, diag, weak_rowsum, F, C = _split_blocks(A, S, cf)
    nF = len(F)

    # β_k: interpolatory sums of F-point k — its strong-C connections are
    # all members of the extended set Ĉ_i, so β_k = rowsum(Â_FC)_k.
    beta = np.asarray(A_FC.sum(axis=1)).ravel()

    # Per-pair distribution denominators β̂_{k,i} = β_k + ā_ki (the "+i":
    # point i itself joins k's interpolatory set — De Sterck-Yang-Heys).
    Pat = sp.csr_matrix(A_FF)
    Pat.sort_indices()
    if plus_i:
        # values ā_ki looked up at the (i,k) positions of Â_FF via sorted
        # (row,col) keys (transpose pattern may differ, missing → 0)
        AT = sp.csr_matrix(A_FF.T)
        AT.sort_indices()
        rows_at = np.repeat(np.arange(nF), np.diff(AT.indptr)).astype(np.int64)
        keys_at = rows_at * nF + AT.indices
        rows_q = np.repeat(np.arange(nF), np.diff(Pat.indptr)).astype(np.int64)
        keys_q = rows_q * nF + Pat.indices
        pos = np.searchsorted(keys_at, keys_q)
        pos_c = np.minimum(pos, max(len(keys_at) - 1, 0))
        found = (len(keys_at) > 0) & (pos < len(keys_at)) \
            & (keys_at[pos_c] == keys_q)
        a_ki = np.where(found, AT.data[pos_c] if len(keys_at) else 0.0, 0.0)
    else:
        a_ki = np.zeros_like(Pat.data)

    denom_pair = beta[Pat.indices] + a_ki
    denom_pair = np.where(denom_pair != 0, denom_pair, 1.0)
    G = sp.csr_matrix((Pat.data / denom_pair, Pat.indices, Pat.indptr),
                      shape=Pat.shape)

    # numerator: Â_FC + G·Â_FC   (distance-2 extension)
    N = (A_FC + G @ A_FC).tocsr()

    # denominator: ã_ii = a_ii + Σ_weak a_in + Σ_k a_ik ā_ki / β̂_{k,i}
    alpha = diag[F] + weak_rowsum[F]
    if plus_i:
        gamma = np.zeros(nF)
        rows_g = np.repeat(np.arange(nF), np.diff(Pat.indptr))
        np.add.at(gamma, rows_g, G.data * a_ki)
        denom = alpha + gamma
    else:
        denom = alpha

    denom = np.where(denom != 0, denom, 1.0)
    W = sp.csr_matrix(sp.diags(-1.0 / denom) @ N)
    W = _truncate(W, trunc_factor, max_nnz_row)
    return _assemble_P(W, cf, F, C)


def _truncate(W: sp.csr_matrix, trunc_factor: float, max_nnz_row: int
              ) -> sp.csr_matrix:
    """Drop small entries / keep the largest ``max_nnz_row`` per row,
    rescaling rows to preserve their sums (hypre truncation semantics).
    Fully vectorized — runs on million-row interpolation operators."""
    if trunc_factor <= 0 and (max_nnz_row is None or max_nnz_row <= 0):
        return W
    W = W.tocsr()
    W.sum_duplicates()
    n = W.shape[0]
    counts = np.diff(W.indptr)
    rows = np.repeat(np.arange(n), counts)
    absd = np.abs(W.data)

    keep = np.ones(W.nnz, dtype=bool)
    if trunc_factor > 0:
        rowmax = np.zeros(n)
        np.maximum.at(rowmax, rows, absd)
        keep = absd >= trunc_factor * rowmax[rows]

    if max_nnz_row and max_nnz_row > 0:
        # top-k by |value| within each row, batched over rows of equal
        # length with one argpartition per group (O(nnz) total — replaces
        # a global lexsort, the former setup hot spot)
        key_abs = np.where(keep, absd, -1.0)
        keep = np.zeros(W.nnz, dtype=bool)
        k = max_nnz_row
        for m in np.unique(counts):
            if m == 0:
                continue
            grp = np.flatnonzero(counts == m)
            idx = W.indptr[grp][:, None] + np.arange(m)[None, :]
            a = key_abs[idx]
            if m <= k:
                keep[idx.ravel()] = (a >= 0).ravel()
                continue
            part = np.argpartition(-a, k - 1, axis=1)[:, :k]
            sel = np.take_along_axis(idx, part, axis=1)
            good = np.take_along_axis(a, part, axis=1) >= 0
            keep[sel[good]] = True

    orig_sums = np.bincount(rows, weights=W.data, minlength=n)
    new_sums = np.bincount(rows[keep], weights=W.data[keep], minlength=n)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where((new_sums != 0) & (orig_sums != 0),
                         orig_sums / new_sums, 1.0)
    data = W.data[keep] * scale[rows[keep]]
    out = sp.csr_matrix((data, W.indices[keep],
                         _indptr_from(rows[keep], n)), shape=W.shape)
    out.sort_indices()
    return out


def _indptr_from(rows_kept: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(rows_kept, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def _assemble_P(W: sp.csr_matrix, cf: np.ndarray, F: np.ndarray,
                C: np.ndarray) -> sp.csr_matrix:
    """P: C-points identity rows, F-points the weight rows."""
    n = len(cf)
    nC = len(C)
    Wc = W.tocoo()
    rows = np.concatenate([C, F[Wc.row]])
    cols = np.concatenate([np.arange(nC), Wc.col])
    vals = np.concatenate([np.ones(nC), Wc.data])
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, nC))
    P.sort_indices()
    return P


def one_point_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                            cf: np.ndarray) -> sp.csr_matrix:
    """One-point injection (hypre type 100): each F-point takes its
    strongest C-neighbor with weight 1 — the textbook AIR companion."""
    n = A.shape[0]
    F = np.flatnonzero(cf < 0)
    C = np.flatnonzero(cf > 0)
    cmap = -np.ones(n, dtype=np.int64)
    cmap[C] = np.arange(len(C))

    A_sc = sp.csr_matrix(abs(A).multiply(S.astype(bool)))[F][:, C].tocsr()
    counts = np.diff(A_sc.indptr)
    has = counts > 0
    # argmax |a_ij| within each F row of the strong-C block: mark row
    # maxima, then np.unique keeps the first maximal entry per row
    rows = np.repeat(np.arange(len(F)), counts)
    best = np.zeros(len(F), dtype=np.int64)
    bestv = np.full(len(F), -1.0)
    np.maximum.at(bestv, rows, A_sc.data)
    is_best = np.flatnonzero(A_sc.data == bestv[rows])
    _, first_pos = np.unique(rows[is_best], return_index=True)
    sel = is_best[first_pos]
    best[rows[sel]] = A_sc.indices[sel]
    rowsP = np.concatenate([C, F[has]])
    colsP = np.concatenate([np.arange(len(C)), best[has]])
    vals = np.ones(len(rowsP))
    P = sp.csr_matrix((vals, (rowsP, colsP)), shape=(n, len(C)))
    P.sort_indices()
    return P


def build_interpolation(A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray,
                        prolongation_type: int = 6, trunc_factor: float = 0.0,
                        max_nnz_row: int = 4) -> sp.csr_matrix:
    """Dispatch on prolongation_type (ref vocab amg.c:250-274).

    Types map onto the native builders: direct-family codes (0-3,
    8-9) → direct; extended family (6,7,14,16,17,18) → ext(+i);
    100 → one-point injection; anything else falls back to ext+i (the
    reference default and the robust choice on PMIS grids).
    """
    if prolongation_type == 100:
        return one_point_interpolation(A, S, cf)
    if prolongation_type in (3, 15):  # direct / direct_sep_weights
        return direct_interpolation(A, S, cf, trunc_factor, max_nnz_row)
    if prolongation_type in (14, 16):  # extended (no +i)
        return extended_i_interpolation(A, S, cf, trunc_factor, max_nnz_row,
                                        plus_i=False)
    # 6 = extended+i (default), 17/18 = mm variants, others → robust default
    return extended_i_interpolation(A, S, cf, trunc_factor, max_nnz_row,
                                    plus_i=True)
