"""Strength-of-connection graph (classical).

Reference behavior: BoomerAMG's CreateS — point i strongly depends on j
when  -a_ij ≥ θ · max_{k≠i}(-a_ik)  (or |a_ij| ≥ θ·max|a_ik| with the
``sabs`` option), with num_functions filtering connections to the same
dof function (ref: coarsening.strong_th / sabs / num_functions /
filter_functions keys, src/internal/amg.c:131-156).

Host-side numpy/scipy: the strength graph feeds coarsening and
interpolation (setup phase).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp


def strength_graph(A: sp.csr_matrix, theta: float = 0.25, sabs: bool = False,
                   dof_func: Optional[np.ndarray] = None,
                   row_offset: int = 0) -> sp.csr_matrix:
    """Boolean CSR S: S[i,j]=1 ⇔ i strongly depends on j (j≠i).

    ``row_offset``: global id of local row 0 — lets a distributed
    row-block (local rows, global columns) identify its diagonal
    entries; strength is otherwise row-local (ParCSR decomposition)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if A.has_sorted_indices and row_offset == 0 and A.shape[0] == A.shape[1]:
        try:
            from ...io.native import amg_strength

            nat = amg_strength(A, theta, sabs, dof_func)
        except Exception:
            nat = None
        if nat is not None:
            s_indptr, s_indices = nat
            return sp.csr_matrix(
                (np.ones(len(s_indices), dtype=np.int8),
                 s_indices, s_indptr), shape=A.shape)
    indptr, indices, data = A.indptr, A.indices, A.data

    rows = np.repeat(np.arange(n), np.diff(indptr))
    offdiag = indices != (rows + row_offset if row_offset else rows)
    if dof_func is not None:
        # dof_func is indexed in the COLUMN (global) space
        same_func = dof_func[rows + row_offset] == dof_func[indices]
        offdiag = offdiag & same_func

    if sabs:
        vals = np.abs(data)
    else:
        vals = -data  # classical: only negative couplings count
    vals = np.where(offdiag, vals, -np.inf)

    # row-wise max of candidate strengths
    row_max = np.full(n, -np.inf)
    np.maximum.at(row_max, rows, vals)
    row_max = np.where(np.isfinite(row_max), row_max, 0.0)

    strong = offdiag & (vals >= theta * row_max[rows]) & (vals > 0)
    S = sp.csr_matrix(
        (np.ones(strong.sum(), dtype=np.int8),
         indices[strong], _compress_indptr(indptr, strong)),
        shape=A.shape)
    return S


def _compress_indptr(indptr: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """New indptr after filtering entries by mask."""
    counts = np.add.reduceat(mask.astype(np.int64), indptr[:-1]) \
        if len(mask) else np.zeros(len(indptr) - 1, dtype=np.int64)
    # reduceat quirk: empty rows at the end — recompute robustly
    n = len(indptr) - 1
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    counts = np.bincount(row_of[mask], minlength=n)
    out = np.zeros(n + 1, dtype=indptr.dtype)
    np.cumsum(counts, out=out[1:])
    return out
