"""FSAI — factored sparse approximate inverse.

Counterpart of ``hypredrive_tpu/precon/fsai.py`` (ref: src/internal/fsai.c;
algo bj-afsai/bj-sfsai; max_steps, max_step_size, max_nnz_row, threshold,
kap_tolerance).  The setup is the JAX package's host code, with its batched
(n, k, k) row solves done in compiled code (``csrc/fsai_solve.cpp``) by
the LAPACK and BLAS calls that ``jax.vmap(jnp.linalg.solve)`` makes on the
CPU, so G is the JAX package's bit for bit: on a Laplacian several Kaporin
candidates tie in exact arithmetic, and the last bits of the solve pick
among them.

For SPD A, find lower-triangular G ≈ L⁻¹ (A = LLᵀ) by minimizing
‖I − GL‖_F over a sparsity pattern: each row i solves the small dense
system A[J_i,J_i] y = e_i (J_i = chosen lower-triangle pattern ∪ {i}), then
scales so (GAGᵀ)_ii = 1.  Static FSAI keeps the max_nnz_row largest strong
lower-triangle entries; adaptive FSAI grows each pattern by max_steps ×
max_step_size Kaporin-gradient candidates.

Apply, on the system's device: z = Gᵀ(G r) — two matvecs (DIA + CSR
kernels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..io.native import fsai_solve
from ..ops.device_matrix import EllMatrix
from .base import Preconditioner, precon_matrix


@dataclass
class FSAIState:
    G: EllMatrix        # lower-triangular G ≈ L⁻¹
    GT: EllMatrix       # Gᵀ


def fsai_apply(state: FSAIState, r):
    return state.GT.matvec(state.G.matvec(r))


def batched_solve_plain(sub: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """(n, k, k) · y = (n, k) row by row in Python: dgetrf, the pivots'
    swaps on the right-hand side, then a unit-lower and an upper dtrsm on
    it as a (k, 1) column -- the plain version of the compiled
    ``io/native.py::fsai_solve``, with the same SciPy routines."""
    from scipy.linalg import blas, lu_factor

    y = np.array(rhs, dtype=np.float64)
    for i in range(len(y)):
        lu, piv = lu_factor(sub[i], check_finite=False)
        x = y[i]
        for r, p in enumerate(piv):
            x[r], x[p] = x[p], x[r]
        x = blas.dtrsm(1.0, lu, x[:, None], side=0, lower=1, diag=1)
        y[i] = blas.dtrsm(1.0, lu, x, side=0, lower=0, diag=0)[:, 0]
    return y


def _upload(G: sp.csr_matrix, dtype, device) -> FSAIState:
    G.sort_indices()
    GT = sp.csr_matrix(G.T)
    GT.sort_indices()
    return FSAIState(EllMatrix.from_csr(G, dtype=dtype, device=device),
                     EllMatrix.from_csr(GT, dtype=dtype, device=device))


def build_fsai(A_host: sp.csr_matrix, max_nnz_row: int = 3,
               threshold: float = 1e-3, dtype=torch.float64,
               device: torch.device = torch.device("cpu")) -> FSAIState:
    """Construct G (and Gᵀ) as device EllMatrices."""
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    n = A.shape[0]
    diag = A.diagonal()

    # pattern: per row, the largest |a_ij| entries with j < i (strict
    # lower), thresholded relative to the row max, capped at max_nnz_row
    counts = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), counts)
    cols = A.indices
    vals = A.data
    lower = cols < rows
    absv = np.abs(vals)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, np.where(lower, absv, 0.0))
    keep = lower & (absv >= threshold * np.maximum(rowmax[rows], 1e-300))
    # rank by |value| within row, keep top max_nnz_row
    key = np.where(keep, absv, -1.0)
    order = np.lexsort((-key, rows))
    starts = np.repeat(A.indptr[:-1], counts)
    rank = np.arange(A.nnz) - starts
    keep_sorted = keep[order] & (rank < max_nnz_row)
    keep = np.zeros(A.nnz, dtype=bool)
    keep[order] = keep_sorted

    # per-row pattern arrays, padded to k
    k = max_nnz_row + 1  # + the diagonal position
    pat = np.full((n, k), -1, dtype=np.int64)
    kept_rows = rows[keep]
    kept_cols = cols[keep]
    order2 = np.lexsort((kept_cols, kept_rows))
    kept_rows, kept_cols = kept_rows[order2], kept_cols[order2]
    starts_per_row = np.searchsorted(kept_rows, np.arange(n))
    for_pos = np.arange(len(kept_rows)) - starts_per_row[kept_rows]
    pat[kept_rows, for_pos] = kept_cols
    pat_count = np.bincount(kept_rows, minlength=n)
    pat[np.arange(n), pat_count] = np.arange(n)  # diagonal last
    sizes = pat_count + 1

    # gather padded dense submatrices A[J,J] — identity on pad slots
    safe_pat = np.where(pat >= 0, pat, 0)
    # dense lookup via row-wise searchsorted into CSR
    sub = np.zeros((n, k, k))
    valid = np.arange(k)[None, :] < sizes[:, None]
    # build (n, k, k) by looking up A[pat[i,a], pat[i,b]]
    # vectorized CSR lookup with (row,col) keys
    keys = rows.astype(np.int64) * n + cols
    # ensure keys sorted (CSR with sorted indices is sorted by (row, col))
    qa = np.repeat(safe_pat[:, :, None], k, axis=2)     # row index
    qb = np.repeat(safe_pat[:, None, :], k, axis=1)     # col index
    q = qa.astype(np.int64) * n + qb
    posq = np.searchsorted(keys, q.ravel())
    posq = np.minimum(posq, max(len(keys) - 1, 0))
    found = (keys[posq] == q.ravel()) if len(keys) else np.zeros(
        q.size, bool)
    sub = np.where(found, vals[posq], 0.0).reshape(n, k, k)
    pad_mask = ~(valid[:, :, None] & valid[:, None, :])
    eye = np.eye(k)[None, :, :]
    sub = np.where(pad_mask, np.broadcast_to(eye, sub.shape), sub)

    # batched solve A[J,J] y = e_last(valid)
    e = np.zeros((n, k))
    e[np.arange(n), sizes - 1] = 1.0
    y = fsai_solve(sub, e)

    # scale: G_ii = sqrt(1 / y_i) so that (G A Gᵀ)_ii = 1
    y_diag = y[np.arange(n), sizes - 1]
    y_diag = np.where(y_diag > 0, y_diag, 1.0 / np.maximum(diag, 1e-300))
    scale = 1.0 / np.sqrt(np.abs(y_diag))
    G_vals = y * scale[:, None]

    # assemble CSR G
    rws = np.repeat(np.arange(n), sizes)
    flat_cols = pat[valid]
    flat_vals = G_vals[valid]
    G = sp.csr_matrix((flat_vals, (rws, flat_cols)), shape=(n, n))
    return _upload(G, dtype, device)


def build_fsai_adaptive(A_host: sp.csr_matrix, max_steps: int = 5,
                        max_step_size: int = 3, kap_tolerance: float = 1e-3,
                        dtype=torch.float64,
                        device: torch.device = torch.device("cpu")
                        ) -> FSAIState:
    """Adaptive FSAI (hypre algo_type 1, bj-afsai): grow each row's
    pattern by the largest Kaporin-gradient candidates.

    Per step, with current pattern J_i and weights y_i solving
    A[J,J] y = −A[J,i]:  the gradient of the Kaporin number w.r.t.
    adding column j is 2·(A[j,J]·y + a_ji) — computed for ALL rows at
    once as R = Ŷ·Aᵀ (Ŷ rows = [y_i; 1] over J_i ∪ {i}); each row adds
    its ``max_step_size`` largest |gradient| lower-triangle candidates
    and stops when the Kaporin ratio improvement drops under
    ``kap_tolerance`` (ref: fsai.c field list algo_type/max_steps/
    max_step_size/kap_tolerance).

    All per-step dense solves are one batched (n, k, k) solve — the
    row-independence that makes FSAI the TPU-native preconditioner.
    """
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    n = A.shape[0]
    AT = sp.csr_matrix(A.T)
    AT.sort_indices()
    diag = A.diagonal()
    kmax = max(1, int(max_steps) * int(max_step_size))

    pat = np.full((n, kmax), -1, dtype=np.int64)
    sizes = np.zeros(n, dtype=np.int64)
    kap_prev = np.where(diag > 0, diag, 1.0)   # Kaporin ~ a_ii - yᵀA[J,i]
    active = np.ones(n, dtype=bool)

    def _solve_rows(pat, sizes):
        """Batched y solving A[J,J] y = −A[J,i]; returns (y, kap) where
        kap_i = a_ii + A[i,J]·y (the denominator of the G scaling)."""
        k = int(sizes.max()) if len(sizes) else 0
        if k == 0:
            return np.zeros((n, 0)), np.where(diag > 0, diag, 1.0)
        patk = pat[:, :k]
        safe = np.where(patk >= 0, patk, 0)
        valid = np.arange(k)[None, :] < sizes[:, None]
        rowsA = np.repeat(np.arange(n), np.diff(A.indptr))
        keys = rowsA.astype(np.int64) * n + A.indices
        qa = np.repeat(safe[:, :, None], k, axis=2)
        qb = np.repeat(safe[:, None, :], k, axis=1)
        q = (qa.astype(np.int64) * n + qb).ravel()
        pos = np.minimum(np.searchsorted(keys, q), max(len(keys) - 1, 0))
        found = keys[pos] == q
        sub = np.where(found, A.data[pos], 0.0).reshape(n, k, k)
        pad = ~(valid[:, :, None] & valid[:, None, :])
        sub = np.where(pad, np.broadcast_to(np.eye(k), sub.shape), sub)
        # rhs = −A[J, i] = −A[i, J] for symmetric patterns; use A[J,i]
        qr = (safe.astype(np.int64) * n + np.arange(n)[:, None]).ravel()
        posr = np.minimum(np.searchsorted(keys, qr), max(len(keys) - 1, 0))
        foundr = keys[posr] == qr
        rhs = -np.where(foundr, A.data[posr], 0.0).reshape(n, k)
        rhs = np.where(valid, rhs, 0.0)
        y = fsai_solve(sub, rhs)
        y = np.where(valid, y, 0.0)
        kap = diag + np.einsum("nk,nk->n", -rhs, y)
        return y, kap

    y = np.zeros((n, 0))
    for step in range(max(1, int(max_steps))):
        if not active.any():
            break
        # gradient scores: R = Ŷ·A with Ŷ rows = [y; 1] at J ∪ {i}
        k = y.shape[1]
        r_idx = [np.arange(n)]
        c_idx = [np.arange(n)]
        v_idx = [np.ones(n)]
        if k:
            valid = (np.arange(k)[None, :] < sizes[:, None]) & (y != 0.0)
            rr, cc = np.nonzero(valid)
            r_idx.append(rr)
            c_idx.append(pat[rr, cc])
            v_idx.append(y[rr, cc])
        Y = sp.csr_matrix(
            (np.concatenate(v_idx),
             (np.concatenate(r_idx), np.concatenate(c_idx))), shape=(n, n))
        R = sp.csr_matrix(Y @ AT)      # R[i, j] = A[j, :]·ŷ_i (A ~ Aᵀ ok)
        R.sort_indices()
        rows_r = np.repeat(np.arange(n), np.diff(R.indptr))
        cols_r = R.indices
        # candidates: strict lower triangle, active rows, not already in J
        in_pat = np.zeros(R.nnz, dtype=bool)
        if k:
            # membership check via sorted per-row patterns
            srt = np.sort(np.where(pat[:, :k] >= 0, pat[:, :k],
                                   np.iinfo(np.int64).max), axis=1)
            for c in range(k):     # k ≤ kmax small
                in_pat |= srt[rows_r, c] == cols_r
        cand = (cols_r < rows_r) & active[rows_r] & ~in_pat
        score = np.where(cand, np.abs(R.data), -1.0)
        # top max_step_size per row
        take = np.zeros(R.nnz, dtype=bool)
        counts_r = np.diff(R.indptr)
        for m in np.unique(counts_r):
            if m == 0:
                continue
            grp = np.flatnonzero(counts_r == m)
            idx = R.indptr[grp][:, None] + np.arange(m)[None, :]
            a = score[idx]
            s = min(int(max_step_size), m)
            part = np.argpartition(-a, s - 1, axis=1)[:, :s]
            sel = np.take_along_axis(idx, part, axis=1)
            good = np.take_along_axis(a, part, axis=1) > 0
            take[sel[good]] = True
        add_rows = rows_r[take]
        add_cols = cols_r[take]
        if len(add_rows) == 0:
            break
        order = np.argsort(add_rows, kind="stable")
        add_rows, add_cols = add_rows[order], add_cols[order]
        starts = np.searchsorted(add_rows, np.arange(n))
        posr = np.arange(len(add_rows)) - starts[add_rows]
        dest = sizes[add_rows] + posr
        ok = dest < kmax
        pat[add_rows[ok], dest[ok]] = add_cols[ok]
        new_sizes = sizes.copy()
        np.add.at(new_sizes, add_rows[ok], 1)
        sizes = new_sizes
        y, kap = _solve_rows(pat, sizes)
        # Kaporin stop: relative improvement below tolerance
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(kap_prev > 0, kap / kap_prev, 1.0)
        active = active & (ratio < 1.0 - float(kap_tolerance))
        kap_prev = np.where(kap > 0, kap, kap_prev)

    if y.shape[1] == 0:
        y, kap = _solve_rows(pat, sizes)
    else:
        kap = kap_prev
    # G rows: [y, 1] at [J, i], scaled so (G A Gᵀ)_ii = 1:
    # row scale = 1/sqrt(kap) with kap = a_ii + A[i,J]·y
    kap = np.where(kap > 0, kap, np.where(diag > 0, diag, 1.0))
    scale = 1.0 / np.sqrt(kap)
    k = y.shape[1]
    valid = (np.arange(k)[None, :] < sizes[:, None]) if k else \
        np.zeros((n, 0), bool)
    rws = [np.arange(n)]
    cls = [np.arange(n)]
    vls = [scale]
    if k:
        rr, cc = np.nonzero(valid)
        rws.append(rr)
        cls.append(pat[rr, cc])
        vls.append(y[rr, cc] * scale[rr])
    G = sp.csr_matrix((np.concatenate(vls),
                       (np.concatenate(rws), np.concatenate(cls))),
                      shape=(n, n))
    return _upload(G, dtype, device)


class FSAIPrecon(Preconditioner):
    method = "fsai"

    def setup(self, system):
        A_host, _ = precon_matrix(system)
        if int(self.args.get("algo_type", 1)) in (1, 3):
            # adaptive pattern growth (hypre bj-afsai, the default)
            self.state = build_fsai_adaptive(
                A_host,
                max_steps=int(self.args.get("max_steps", 5)),
                max_step_size=int(self.args.get("max_step_size", 3)),
                kap_tolerance=float(self.args.get("kap_tolerance", 1e-3)),
                dtype=system.dtype, device=system.device)
        else:
            # static pattern (hypre bj-sfsai): hypre bounds nnz by
            # max_steps·max_step_size, capped by max_nnz_row
            budget = min(int(self.args.get("max_steps", 5))
                         * int(self.args.get("max_step_size", 3)),
                         int(self.args.get("max_nnz_row", 15)))
            self.state = build_fsai(
                A_host,
                max_nnz_row=max(1, budget),
                threshold=float(self.args.get("threshold", 1e-3)),
                dtype=system.dtype, device=system.device)
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return fsai_apply(self.state, r)
