"""Device sparse matrix: DIA part + sorted CSR remainder, or dense when tiny.

Counterpart of ``hypredrive_tpu/ops/device_matrix.py::EllMatrix``.  The
diagonal selection is the same (``DIA_MIN_FRAC``, ``DIA_MAX_DIAGS`` and the
native census), so both packages store the same diagonals.  What differs:

* The entries off the chosen diagonals are one sorted CSR, applied by the
  CSR kernel; the JAX package's ELL + COO tail and its TPU gather plan are
  not carried over.
* Operators of at most ``DENSE_MAX_ELEMENTS`` elements are always stored
  dense (the JAX package does so only on a Pallas backend), so the CPU
  runs the structure the card runs.  They are applied with ``torch.mv``,
  as the JAX package left them to ``jnp.dot``.

On a CUDA tensor every matvec of a sparse operator is the DIA kernel, then
the CSR kernel adding into the same ``y`` (``ops/dia_spmv.py``,
``ops/csr_spmv.py``).  The cycles' methods :meth:`EllMatrix.residual`,
``cheby_step``, ``jacobi_step`` and ``matvec_add`` run the same kernels
with an epilogue on the last one (``ops/epilogue.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..core.trace import count, span
from . import epilogue
from .csr_spmv import csr_spmv, csr_spmv_epilogue, csr_tiles
from .dia_spmv import dia_spmv, dia_spmv_epilogue

# diagonals covering at least this fraction of rows go to the DIA part
DIA_MIN_FRAC = 0.25
DIA_MAX_DIAGS = 48

# operators of at most this many ELEMENTS (rows*cols) are stored dense
DENSE_MAX_ELEMENTS = 1 << 16


def _select_diagonals(A: sp.csr_matrix, dia_offsets):
    """(offsets, dia (D, n) f64 or None, r_rows, r_cols, r_vals): the
    diagonal census/selection/split of the JAX package's ``from_csr``."""
    n_rows, n_cols = A.shape
    if dia_offsets is None and A.nnz:
        # native single-call census + selection + split
        from ..io.native import dia_split

        nat = dia_split(A, max(16, int(DIA_MIN_FRAC * n_rows)),
                        DIA_MAX_DIAGS)
        if nat is not None:
            offs, dia, r_rows, r_cols, r_vals = nat
            if len(offs):
                return tuple(int(o) for o in offs), dia, r_rows, r_cols, r_vals
            return (), None, r_rows, r_cols, r_vals

    rows_all = np.repeat(np.arange(n_rows), np.diff(A.indptr))
    cols_all = A.indices.astype(np.int64, copy=False)
    vals_all = A.data.astype(np.float64, copy=False)
    offs_all = cols_all - rows_all
    if dia_offsets is not None:
        good = np.asarray(sorted(dia_offsets), dtype=np.int64)
    elif A.nnz:
        # O(nnz) diagonal census via bincount over shifted offsets
        cnt = np.bincount(offs_all + (n_rows - 1),
                          minlength=n_rows + n_cols - 1)
        good = np.flatnonzero(cnt >= max(16, int(DIA_MIN_FRAC * n_rows)))
        if len(good) > DIA_MAX_DIAGS:
            good = good[np.argsort(-cnt[good], kind="stable")
                        [:DIA_MAX_DIAGS]]
            good.sort()
        good = good - (n_rows - 1)
    else:
        good = np.empty(0, np.int64)
    if not len(good):
        return (), None, rows_all, cols_all, vals_all
    lut = np.zeros(n_rows + n_cols - 1, dtype=bool)
    lut[good + (n_rows - 1)] = True
    sel = lut[offs_all + (n_rows - 1)]
    data = np.zeros((len(good), n_rows))
    data[np.searchsorted(good, offs_all[sel]), rows_all[sel]] = vals_all[sel]
    rest = ~sel
    return (tuple(int(o) for o in good), data, rows_all[rest],
            cols_all[rest], vals_all[rest])


@dataclass
class EllMatrix:
    """Sparse matrix on one device (square or rectangular).

    dia_data:  (D, n_rows), dia_data[i, r] = A[r, r + dia_offsets[i]]
    indptr/indices/data:  sorted CSR of the remaining entries
                          (int64 / int32 / dtype), None when there are none
    tiles:     the CSR kernel's tile table of that remainder (int32,
               ``ops/csr_spmv.py::csr_tiles``)
    dense:     (n_rows, n_cols) for tiny operators; then nothing else is set
    """

    shape: Tuple[int, int]
    nnz: int
    dtype: torch.dtype
    device: torch.device
    dia_offsets: Tuple[int, ...] = ()
    dia_data: Optional[torch.Tensor] = None
    indptr: Optional[torch.Tensor] = None
    indices: Optional[torch.Tensor] = None
    data: Optional[torch.Tensor] = None
    tiles: Optional[torch.Tensor] = None
    dense: Optional[torch.Tensor] = None

    # -- construction -----------------------------------------------------

    @classmethod
    def from_csr(cls, A, dtype: torch.dtype = torch.float64,
                 device: torch.device = torch.device("cpu"),
                 dia_offsets: Optional[Sequence[int]] = None
                 ) -> "EllMatrix":
        """``dia_offsets`` pins the diagonals (else they are chosen as the
        JAX package chooses them).  The span ``operator_build`` times the
        host conversion and the upload."""
        with span("operator_build"):
            A = sp.csr_matrix(A)
            n_rows, n_cols = A.shape
            device = torch.device(device)
            if n_rows * n_cols <= DENSE_MAX_ELEMENTS and A.nnz > 0:
                return cls(shape=(n_rows, n_cols), nnz=int(A.nnz),
                           dtype=dtype, device=device,
                           dense=torch.as_tensor(np.asarray(A.todense()),
                                                 dtype=dtype, device=device))
            if not A.has_canonical_format:
                A.sum_duplicates()
            if not A.has_sorted_indices:
                A.sort_indices()
            return cls.from_split(A.shape, int(A.nnz),
                                  _select_diagonals(A, dia_offsets), dtype,
                                  device)

    @classmethod
    def from_split(cls, shape: Tuple[int, int], nnz: int, split,
                   dtype: torch.dtype, device: torch.device) -> "EllMatrix":
        """A DIA + CSR matrix, never dense, from ``_select_diagonals``'s
        (offsets, dia, rows, cols, vals) of a canonical CSR."""
        device = torch.device(device)
        offs, dia, r_rows, r_cols, r_vals = split
        E = cls(shape=tuple(shape), nnz=nnz, dtype=dtype, device=device,
                dia_offsets=offs)
        if dia is not None:
            E.dia_data = torch.as_tensor(dia, dtype=dtype, device=device)
        if len(r_rows):
            R = sp.csr_matrix((r_vals, (r_rows, r_cols)), shape=shape)
            R.sort_indices()
            E.indptr = torch.as_tensor(R.indptr.astype(np.int64),
                                       device=device)
            E.indices = torch.as_tensor(R.indices.astype(np.int32),
                                        device=device)
            E.data = torch.as_tensor(R.data, dtype=dtype, device=device)
            E.tiles = torch.as_tensor(csr_tiles(R.indptr), device=device)
        return E

    # -- kernels ----------------------------------------------------------

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: DIA kernel, then CSR kernel adding into y."""
        n_rows, n_cols = self.shape
        if self.dense is not None:
            return torch.mv(self.dense, x)
        y = None
        if self.dia_data is not None:
            y = dia_spmv(self.dia_data, self.dia_offsets, x, n_cols)
        if self.data is not None:
            y = csr_spmv(self.indptr, self.indices, self.data, x, n_rows,
                         self.tiles, out=y)
        if y is None:
            y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
        return y

    # -- the cycles' steps (ops/epilogue.py) ---------------------------

    def _fused(self, x: torch.Tensor) -> bool:
        """Whether the kernels run a step on x: a sparse operator with a
        DIA or CSR part, on a card."""
        return (x.device.type == "cuda" and self.dense is None
                and (self.dia_data is not None or self.data is not None))

    def _matvec_epilogue(self, v: torch.Tensor, kind: int, s0: float = 0.0,
                         s1: float = 0.0, /, **vectors) -> None:
        """The matvec A·v with the epilogue in its last kernel: the DIA
        kernel where there is no CSR remainder, else the CSR kernel,
        adding the DIA part's y where there is one.  Counts the step as
        fused."""
        n_rows, n_cols = self.shape
        ep = epilogue.args(kind, n_rows, v, s0, s1, **vectors)
        if self.data is None:
            dia_spmv_epilogue(self.dia_data, self.dia_offsets, v, n_cols, ep)
        else:
            y = (dia_spmv(self.dia_data, self.dia_offsets, v, n_cols)
                 if self.dia_data is not None else None)
            csr_spmv_epilogue(self.indptr, self.indices, self.data, v,
                              n_rows, self.tiles, y, ep)
        count("epilogue_fused")

    def residual(self, b: torch.Tensor, x: torch.Tensor,
                 u: Optional[torch.Tensor] = None,
                 theta: Optional[float] = None):
        """b − A·x; with ``u`` and ``theta`` the pair (r, u ⊙ r / θ)."""
        if not self._fused(x):
            count("epilogue_plain")
            return epilogue.residual_plain(self, b, x, u, theta)
        r = torch.empty_like(b)
        z0 = None if u is None else torch.empty_like(b)
        self._matvec_epilogue(
            x, epilogue.RESIDUAL,
            0.0 if u is None else epilogue.reciprocal(theta, b.dtype),
            b=b.contiguous(), u=u, out=r, out2=z0)
        return r if u is None else (r, z0)

    def cheby_step(self, r, z, d, u, c1: float, c2: float, x=None,
                   last: bool = False):
        """(z', d') of one inner Chebyshev step with A·z; at the ``last``
        step only x + z' (z' where ``x`` is None)."""
        if not self._fused(z):
            count("epilogue_plain")
            return epilogue.cheby_step_plain(self, r, z, d, u, c1, c2, x,
                                             last)
        out = torch.empty_like(z)
        d_out = None if last else torch.empty_like(z)
        self._matvec_epilogue(z, epilogue.CHEBYSHEV, c1, c2,
                              b=r.contiguous(), u=u, x=z, d=d.contiguous(),
                              x2=None if x is None else x.contiguous(),
                              out=out, out2=d_out)
        return out if last else (out, d_out)

    def jacobi_step(self, x: torch.Tensor, b: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
        """x + u ⊙ (b − A·x)."""
        if not self._fused(x):
            count("epilogue_plain")
            return epilogue.jacobi_step_plain(self, x, b, u)
        out = torch.empty_like(x)
        self._matvec_epilogue(x, epilogue.JACOBI, b=b.contiguous(), u=u,
                              x=x, out=out)
        return out

    def matvec_add(self, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """x + A·e."""
        if not self._fused(e):
            count("epilogue_plain")
            return epilogue.matvec_add_plain(self, x, e)
        out = torch.empty_like(x)
        self._matvec_epilogue(e, epilogue.ADD, x=x.contiguous(), out=out)
        return out

    def _rest_rows(self) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.device),
            self.indptr[1:] - self.indptr[:-1])

    def diagonal(self) -> torch.Tensor:
        """diag(A) on the matrix's device."""
        if self.dense is not None:
            return torch.diagonal(self.dense).clone()
        d = torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)
        if self.dia_data is not None and 0 in self.dia_offsets:
            d += self.dia_data[self.dia_offsets.index(0)]
        if self.data is not None:
            rows = self._rest_rows()
            on = self.indices.long() == rows
            d.index_add_(0, rows[on], self.data[on])
        return d

    def row_l1_norms(self) -> torch.Tensor:
        """Σ_j |a_ij| per row (the ℓ1-Jacobi scaling vector)."""
        if self.dense is not None:
            return self.dense.abs().sum(dim=1)
        y = torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)
        if self.dia_data is not None:
            y += self.dia_data.abs().sum(dim=0)
        if self.data is not None:
            y.index_add_(0, self._rest_rows(), self.data.abs())
        return y

    def scale(self, sl: Optional[torch.Tensor], sr: Optional[torch.Tensor]
              ) -> "EllMatrix":
        """Diagonal scaling Sl·A·Sr as a new matrix (same structure)."""
        n_rows, n_cols = self.shape
        if self.dense is not None:
            d = self.dense
            if sl is not None:
                d = d * sl[:, None]
            if sr is not None:
                d = d * sr[None, :]
            return dataclasses.replace(self, dense=d)
        dia, data = self.dia_data, self.data
        if sl is not None:
            if dia is not None:
                dia = dia * sl[None, :]
            if data is not None:
                data = data * sl[self._rest_rows()]
        if sr is not None:
            if dia is not None:
                lo = max(0, -min(self.dia_offsets))
                hi = max(0, max(self.dia_offsets) + n_rows - n_cols)
                srp = torch.nn.functional.pad(sr, (lo, hi), value=1.0)
                dia = torch.stack([
                    dia[i] * srp[lo + off:lo + off + n_rows]
                    for i, off in enumerate(self.dia_offsets)])
            if data is not None:
                data = data * sr[self.indices.long()]
        return dataclasses.replace(self, dia_data=dia, data=data)

    def to_csr(self) -> sp.csr_matrix:
        """Host round-trip (diagnostics, parity tests)."""
        n_rows, n_cols = self.shape
        if self.dense is not None:
            B = sp.csr_matrix(self.dense.cpu().numpy())
            B.eliminate_zeros()
            B.sort_indices()
            return B
        parts_r, parts_c, parts_v = [], [], []
        if self.dia_data is not None:
            dd = self.dia_data.cpu().numpy()
            r = np.arange(n_rows)
            for i, off in enumerate(self.dia_offsets):
                c = r + off
                ok = (c >= 0) & (c < n_cols) & (dd[i] != 0)
                parts_r.append(r[ok])
                parts_c.append(c[ok])
                parts_v.append(dd[i][ok])
        if self.data is not None:
            R = sp.csr_matrix((self.data.cpu().numpy(),
                               self.indices.cpu().numpy(),
                               self.indptr.cpu().numpy()), shape=self.shape)
            R.eliminate_zeros()
            R = R.tocoo()
            parts_r.append(R.row)
            parts_c.append(R.col)
            parts_v.append(R.data)
        if not parts_r:
            return sp.csr_matrix(self.shape)
        A = sp.coo_matrix(
            (np.concatenate(parts_v),
             (np.concatenate(parts_r), np.concatenate(parts_c))),
            shape=self.shape).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        return A

