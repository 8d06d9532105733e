"""ILU preconditioners: bj-ilu0 / bj-iluk / bj-ilut, GMRES-Schur, NSH, RAS.

Counterpart of ``hypredrive_tpu/precon/ilu.py`` (ref: src/internal/ilu.c).
The factorization runs on the host with the JAX package's arithmetic:

  * ilu0  — the IKJ ILU(0) on the CSR pattern.  ``csrc/ilu0.cpp`` is that
    loop compiled (``g++ -ffp-contract=off``, built at first use with the
    other host helpers by ``io/native.py``); it gives the Python loop's
    factors bit for bit.  The Python loop stays as the plain version,
    used where the helpers cannot be built;
  * iluk/ilut — SuperLU's ILUTP via ``scipy.sparse.linalg.spilu`` with
    natural ordering, as in the JAX package.

Apply, on the system's device: z = U⁻¹(L⁻¹ r) with each triangular solve
replaced by Jacobi sweeps (hypre's GPU path, ``tri_solve: off`` +
``lower_jac_iters``/``upper_jac_iters``; with ``tri_solve`` on at least 10
sweeps each).  L (strict part) and U are
:class:`~hypredrive_tpu_torch.ops.device_matrix.EllMatrix`, so every sweep
is one DIA + CSR kernel matvec.  Types 10/11/40/41 add the two-level
GMRES-Schur split, 20/21 the NSH approximate inverse (one matvec), 30/31
restricted additive Schwarz (``schwarz.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..core.errors import ErrorCode, HypredrvError
from ..core.trace import span
from ..ops.device_matrix import EllMatrix
from .base import Preconditioner, precon_matrix

# ---------------------------------------------------------------------------
# ILU(0) factorization (host)
# ---------------------------------------------------------------------------

def _no_diagonal() -> HypredrvError:
    return HypredrvError("ILU(0) requires a full diagonal", ErrorCode.MATRIX)


def _ilu0_data_plain(A: sp.csr_matrix) -> np.ndarray:
    """The JAX package's IKJ loop (one np.intersect1d per lower entry)."""
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    data = A.data.copy()

    # position lookup for (row, col) → data index
    keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)) * n \
        + indices

    def find(r, c):
        q = r * n + c
        p = np.searchsorted(keys, q)
        if p < len(keys) and keys[p] == q:
            return p
        return -1

    diag_pos = np.array([find(i, i) for i in range(n)], dtype=np.int64)
    if (diag_pos < 0).any():
        raise _no_diagonal()

    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        row_cols = indices[lo:hi]
        for kk in range(lo, hi):
            k = indices[kk]
            if k >= i:
                break
            dk = data[diag_pos[k]]
            if dk == 0:
                continue
            lik = data[kk] / dk
            data[kk] = lik
            # subtract lik * U[k, j] for j in row i's pattern, j > k
            uk_lo, uk_hi = indptr[k], indptr[k + 1]
            uk_cols = indices[uk_lo:uk_hi]
            sel = uk_cols > k
            common, ai, bi = np.intersect1d(
                row_cols, uk_cols[sel], return_indices=True)
            if len(common):
                data[lo + ai] -= lik * data[uk_lo + np.flatnonzero(sel)[bi]]
    return data


def ilu0_factor(A: sp.csr_matrix, plain: bool = False):
    """ILU(0): L (unit lower) and U on A's pattern (host, IKJ order).

    The compiled helper runs unless ``plain`` is set or the native helpers
    cannot be built; both give the same factors bit for bit."""
    from ..io import native

    A = sp.csr_matrix(A, dtype=np.float64)
    A.sort_indices()
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    with span("ilu0_factor"):
        data = None
        if not plain:
            try:
                data = native.ilu0_factor_data(indptr, indices, A.data)
            except ValueError:
                raise _no_diagonal() from None
        if data is None:
            data = _ilu0_data_plain(A)
    L = sp.csr_matrix((data.copy(), indices.copy(), indptr.copy()),
                      shape=A.shape)
    U = L.copy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    L.data[indices > rows] = 0.0
    L.data[indices == rows] = 1.0
    U.data[indices < rows] = 0.0
    L.eliminate_zeros()
    U.eliminate_zeros()
    return L.tocsr(), U.tocsr()


def _spilu(A_host: sp.csr_matrix, itype: int, fill: int, droptol: float):
    """ILUT / ILU(k>0) through SuperLU's ILUTP, natural ordering."""
    import scipy.sparse.linalg as spla

    lu = spla.spilu(sp.csc_matrix(A_host),
                    drop_tol=droptol if itype % 10 == 1 else 1e-12,
                    fill_factor=max(1.0, 1.0 + fill * 2.0),
                    permc_spec="NATURAL", diag_pivot_thresh=0.0)
    return sp.csr_matrix(lu.L), sp.csr_matrix(lu.U)


def _factor(A_host: sp.csr_matrix, args):
    itype = int(args.get("type", 0))
    fill = int(args.get("fill_level", 0))
    if itype in (1, 11, 21, 31, 41) or fill > 0:
        return _spilu(A_host, itype, fill, float(args.get("droptol", 1e-2)))
    return ilu0_factor(A_host)


# ---------------------------------------------------------------------------
# device states and applies
# ---------------------------------------------------------------------------

@dataclass
class TriJacobiState:
    """One factorization for the Jacobi-swept triangular solves."""

    L: EllMatrix            # strict lower part of L (unit diagonal)
    U: EllMatrix            # U, diagonal included
    u_dinv: torch.Tensor    # 1 / diag(U)
    l_iters: int
    u_iters: int


def tri_jacobi_apply(state: TriJacobiState, r):
    """z = U⁻¹ L⁻¹ r via Jacobi sweeps on each triangular factor:
        x_{k+1} = r − L_strict x_k       (nilpotent → exact in ≤ depth)
        y_{k+1} = y_k + D_U⁻¹ (x − U y_k)
    """
    x = r
    for _ in range(state.l_iters):
        x = r - state.L.matvec(x)
    y = state.u_dinv * x
    for _ in range(state.u_iters):
        y = y + state.u_dinv * (x - state.U.matvec(y))
    return y


@dataclass
class SchurILUState:
    """Two-level GMRES-Schur ILU (ref: ilu.c gmres-iluk/gmres-ilut, hypre
    ILU types 10/11): interior dofs eliminated with block ILU, the
    interface Schur complement S = C − E B⁻¹ F solved matrix-free with a
    fixed-budget inner GMRES preconditioned by ILU(C)."""

    int_idx: torch.Tensor       # interior rows (int64)
    if_idx: torch.Tensor        # interface rows (int64)
    b_state: TriJacobiState     # ILU factors of B = A[int, int]
    c_state: TriJacobiState     # ILU factors of C = A[if, if]
    E: EllMatrix                # A[if, int]
    F: EllMatrix                # A[int, if]
    C: EllMatrix                # A[if, if]
    schur_max_iter: int


def _schur_apply(state: SchurILUState, r):
    """z = M⁻¹r for M = [B 0; E S][I B⁻¹F; 0 I], S ≈ C − E B⁻¹ F."""
    from ..solvers.gmres import gmres_core

    def b_inv(v):
        return tri_jacobi_apply(state.b_state, v)

    def c_inv(v):
        return tri_jacobi_apply(state.c_state, v)

    def s_mv(v):
        return state.C.matvec(v) - state.E.matvec(b_inv(state.F.matvec(v)))

    z0 = b_inv(r.index_select(0, state.int_idx))
    rs = r.index_select(0, state.if_idx) - state.E.matvec(z0)
    m = state.schur_max_iter
    # one unrolled cycle of m steps (rtol 0), inside the outer graphs; S
    # is held whole by its process, so its dots are too
    z_if, *_ = gmres_core(s_mv, c_inv, rs, torch.zeros_like(rs), 0.0, 0.0,
                          m, m, True, unroll=True, group=None)
    z_int = z0 - b_inv(state.F.matvec(z_if))
    z = torch.zeros_like(r)
    z.index_copy_(0, state.int_idx, z_int)
    z.index_copy_(0, state.if_idx, z_if)
    return z


@dataclass
class NSHState:
    """Newton-Schulz-Hotelling approximate inverse: z = M·r (one matvec;
    ref: ilu.c:42-57 nsh-iluk/nsh-ilut)."""

    M: EllMatrix


def ilu_apply(state, r):
    """Dispatch on the ILU state family."""
    if isinstance(state, NSHState):
        return state.M.matvec(r)
    if isinstance(state, SchurILUState):
        return _schur_apply(state, r)
    if isinstance(state, TriJacobiState):
        return tri_jacobi_apply(state, r)
    # RAS-ILU → Schwarz state (ref: ilu.c ras-iluk/ras-ilut)
    from .schwarz import schwarz_apply

    return schwarz_apply(state, r)


# ---------------------------------------------------------------------------
# setup (host → device)
# ---------------------------------------------------------------------------

def _sweeps(args):
    """(lower, upper) Jacobi sweep counts; at least 10 each with tri_solve
    on (exact sequential solves have no device form: enough sweeps
    converge them, exact in ≤ depth(L))."""
    l_iters = int(args.get("lower_jac_iters", 5))
    u_iters = int(args.get("upper_jac_iters", 5))
    if bool(args.get("tri_solve", True)):
        l_iters = max(l_iters, 10)
        u_iters = max(u_iters, 10)
    return max(1, l_iters), max(1, u_iters)


def _tri_state(L, U, u_diag, args, dtype, device) -> TriJacobiState:
    l_iters, u_iters = _sweeps(args)
    return TriJacobiState(
        L=EllMatrix.from_csr(sp.csr_matrix(sp.tril(L, k=-1)), dtype=dtype,
                             device=device),
        U=EllMatrix.from_csr(sp.csr_matrix(U), dtype=dtype, device=device),
        u_dinv=torch.as_tensor(np.where(u_diag != 0, 1.0 / u_diag, 1.0),
                               dtype=dtype, device=device),
        l_iters=l_iters, u_iters=u_iters)


def _factor_to_state(A_host: sp.csr_matrix, args, dtype, device
                     ) -> TriJacobiState:
    """Tri-solve state for one factorization.

    ``reordering: 1`` applies RCM (hypre's ILU local reordering, ref:
    include/internal/ilu.h:19-34) before factoring; the factors are then
    similarity-permuted back to the original numbering (Pᵀ L P / Pᵀ U P).
    They are no longer triangular, but the Jacobi sweeps only need the
    off-diagonal part to be nilpotent, which the permutation keeps."""
    reorder = int(args.get("reordering", 0))
    perm = None
    if reorder == 1 and A_host.shape[0] > 1:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(
            sp.csr_matrix(A_host), symmetric_mode=False))
        A_host = sp.csr_matrix(A_host[perm][:, perm])
        A_host.sort_indices()
    elif reorder not in (0, 1):
        raise HypredrvError(
            f"ilu.reordering {reorder} not supported (0=none, 1=RCM)",
            ErrorCode.INVALID_ARG)
    L, U = _factor(A_host, args)
    u_diag = U.diagonal()
    Ls = sp.csr_matrix(sp.tril(L, k=-1))
    Us = sp.csr_matrix(U)
    if perm is not None:
        n = A_host.shape[0]
        iperm = np.empty(n, np.int64)
        iperm[perm] = np.arange(n)
        Q = sp.csr_matrix((np.ones(n), (perm, np.arange(n))), shape=(n, n))
        Ls = sp.csr_matrix(Q @ Ls @ Q.T)
        Us = sp.csr_matrix(Q @ Us @ Q.T)
        u_diag = u_diag[iperm]
        Ls.sort_indices()
        Us.sort_indices()
    return _tri_state(Ls, Us, u_diag, args, dtype, device)


def _build_schur_state(A_host: sp.csr_matrix, args, dtype, device,
                       n_blocks: int = 0) -> Optional[SchurILUState]:
    """Interior/interface split by contiguous row blocks (the analogue of
    hypre's per-rank boundary split; ref: ilu.c GMRES-Schur); None when
    the split is degenerate."""
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    n = A.shape[0]
    if n_blocks <= 0:
        n_blocks = max(2, min(16, n // 512))
    blk = (np.arange(n, dtype=np.int64) * n_blocks) // n
    col_blk = blk[A.indices]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cross = col_blk != blk[rows]
    is_if = np.zeros(n, bool)
    is_if[np.unique(rows[cross])] = True
    is_if[np.unique(A.indices[cross])] = True
    if_rows = np.flatnonzero(is_if)
    int_rows = np.flatnonzero(~is_if)
    if len(if_rows) == 0 or len(int_rows) == 0:
        return None

    def block(r, c):
        return sp.csr_matrix(A[r][:, c])

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def upload(M):
        return EllMatrix.from_csr(M, dtype=dtype, device=device)

    C = block(if_rows, if_rows)
    return SchurILUState(
        int_idx=idx(int_rows), if_idx=idx(if_rows),
        b_state=_factor_to_state(block(int_rows, int_rows), args, dtype,
                                 device),
        c_state=_factor_to_state(C, args, dtype, device),
        E=upload(block(if_rows, int_rows)),
        F=upload(block(int_rows, if_rows)),
        C=upload(C),
        schur_max_iter=max(1, int(args.get("schur_max_iter", 5))))


def _nsh_drop(M: sp.csr_matrix, droptol: float, max_row_nnz: int
              ) -> sp.csr_matrix:
    """Row-relative threshold + per-row nnz cap (hypre NSH dropping)."""
    M = sp.csr_matrix(M)
    M.sum_duplicates()
    n = M.shape[0]
    counts = np.diff(M.indptr)
    rows = np.repeat(np.arange(n), counts)
    absd = np.abs(M.data)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, absd)
    keep = absd >= droptol * np.maximum(rowmax[rows], 1e-300)
    # never drop the diagonal
    keep |= rows == M.indices
    if max_row_nnz and max_row_nnz > 0:
        key = np.where(keep, absd, -1.0)
        order = np.lexsort((-key, rows))
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(M.nnz) - np.repeat(starts[:-1], counts)
        keep_sorted = keep[order] & (rank < max_row_nnz)
        keep = np.zeros(M.nnz, bool)
        keep[order] = keep_sorted
        keep |= rows == M.indices
    out = sp.csr_matrix((M.data[keep], M.indices[keep],
                         np.concatenate([[0], np.cumsum(
                             np.bincount(rows[keep], minlength=n))])),
                        shape=M.shape)
    out.sort_indices()
    return out


def _nsh_invert_unit_tri(T: sp.csr_matrix, droptol: float,
                         max_row_nnz: int, iters: int) -> sp.csr_matrix:
    """NSH inverse of a unit-diagonal triangular factor: T = I + N with N
    nilpotent, so X ← X(2I − TX) from X = I squares the error each sweep;
    dropping after each SpGEMM keeps the inverse sparse."""
    n = T.shape[0]
    I = sp.identity(n, format="csr")
    X = sp.csr_matrix(I - (T - I))    # first NSH step from X=I, closed form
    for _ in range(max(0, iters - 1)):
        TX = sp.csr_matrix(T @ X)
        X = sp.csr_matrix(2.0 * X - X @ TX)
        X = _nsh_drop(X, droptol, max_row_nnz)
    return X


def build_nsh_state(A_host: sp.csr_matrix, args, dtype, device) -> NSHState:
    """NSH-ILU (hypre iluType 20/21): factor, build sparse NSH inverses of
    the triangular factors, and collapse the apply into one explicit
    operator M = Ũ⁻¹ D⁻¹ L⁻¹ (ref: ilu.c:42-57, nsh_droptol)."""
    A = sp.csr_matrix(A_host, dtype=np.float64)
    n = A.shape[0]
    nsh_drop = float(args.get("nsh_droptol", 1e-3))
    max_row_nnz = int(args.get("max_row_nnz", 0)) or 0
    iters = max(1, int(args.get("nsh_max_iter",
                                int(np.ceil(np.log2(max(2, n)))))))
    L, U = _factor(A, args)
    u_diag = U.diagonal()
    dinv = np.where(u_diag != 0, 1.0 / u_diag, 1.0)
    U_unit = sp.csr_matrix(sp.diags(dinv) @ U)   # unit upper
    Linv = _nsh_invert_unit_tri(sp.csr_matrix(L), nsh_drop, max_row_nnz,
                                iters)
    Uinv = _nsh_invert_unit_tri(U_unit, nsh_drop, max_row_nnz, iters)
    M = sp.csr_matrix(Uinv @ sp.diags(dinv) @ Linv)
    M = _nsh_drop(M, nsh_drop, max_row_nnz)
    return NSHState(EllMatrix.from_csr(M, dtype=dtype, device=device))


def build_ilu_state(A_host: sp.csr_matrix, args, dtype,
                    device: torch.device = torch.device("cpu")):
    """Factor on the host → apply state on ``device`` (shared with the MGR
    components and the AMG smoothers)."""
    itype = int(args.get("type", 0))
    if itype in (20, 21):
        return build_nsh_state(A_host, args, dtype, device)
    if itype in (10, 11, 40, 41):
        st = _build_schur_state(A_host, args, dtype, device)
        if st is not None:
            return st
    if itype in (30, 31):
        from .schwarz import build_schwarz

        return build_schwarz(A_host, overlap=1, restricted=True,
                             dtype=dtype, device=device)
    L, U = _factor(A_host, args)
    return _tri_state(L, U, U.diagonal(), args, dtype, device)


class ILUPrecon(Preconditioner):
    method = "ilu"

    def setup(self, system):
        A_host, _ = precon_matrix(system)
        self.state = build_ilu_state(A_host, self.args, system.dtype,
                                     system.device)
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return ilu_apply(self.state, r)
