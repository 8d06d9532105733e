"""LinearSystem: build matrix/RHS/x0/xref/dofmap from config or API.

Counterpart of ``hypredrive_tpu/linsys/system.py`` (ref:
src/internal/linsys.c: ReadMatrix :1123, RHS modes :1779-1842, init-guess
modes :376-382, filename resolution :833-866): IJ and MatrixMarket files,
lsseq containers (``sequence_filename``), generated Laplacians, elasticity
and multiphysics systems, a separate preconditioning matrix (precmat),
dofmaps (``dofmap_filename``/``dofmap_basename``, ``dof_labels``),
``rhs_mode`` (randsol included), ``x0``, a reference solution (``xref``)
and the solve dtype (float64 by default).  The post-solve tail undoes
scaling, projects an exact null space and reports error norms against
xref.

Device rule: ``exec_policy: host`` (general or linear_system) selects the
CPU; the default ``device`` selects CUDA and raises a typed error when
CUDA is absent.  There is no silent fallback.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..core.errors import ErrorCode, HypredrvError
from ..core.logging import log
from ..io import ij as ij_io
from ..ops import csr as csr_ops
from ..ops.device_matrix import EllMatrix
from ..ops.vectors import norm2


def resolve_dtype(general) -> torch.dtype:
    name = (general.get("dtype") or "float64").lower()
    if name in ("float64", "f64", "double"):
        return torch.float64
    return torch.float32


def resolve_device(general, ls=None) -> torch.device:
    """exec_policy host → cpu, device → cuda (ref: exec_policy plumbing,
    src/HYPREDRV.c:308-349)."""
    # host wins if either section asks for it (the linear_system schema
    # default is device, so general's setting must also be consulted)
    policy = general.get("exec_policy", 1)
    if ls is not None:
        policy = min(policy, ls.get("exec_policy", 1))
    if policy == 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise HypredrvError(
            "exec_policy 'device' needs CUDA, and no CUDA device is "
            "available (set general:exec_policy host to run on the CPU)",
            ErrorCode.EXTERNAL)
    return torch.device("cuda", torch.cuda.current_device())


def resolve_filename(ls_args, ls_id: int, filename: str, basename: str) -> str:
    """ref: LinearSystemDataFilenameResolve (linsys.c:833-866)."""
    def suffix():
        s = ls_args.get("set_suffix", -1)
        if isinstance(s, (list, tuple)) and len(s) > ls_id:
            return int(s[ls_id])
        init = ls_args.get("init_suffix", -1)
        return (init if init >= 0 else 0) + ls_id

    digits = int(ls_args.get("digits_suffix", 5))
    if not filename and not basename:
        return ""
    if ls_args.get("dirname"):
        return os.path.join(
            f"{ls_args.dirname}_{suffix():0{digits}d}", filename or basename)
    if filename:
        return filename
    if basename:
        return f"{basename}_{suffix():0{digits}d}"
    return ""


class LinearSystem:
    """Holds the device matrix and vectors for one solve."""

    def __init__(self, dtype: torch.dtype = torch.float64,
                 device: torch.device = torch.device("cpu")):
        self.dtype = dtype
        self.device = device
        self.A: Optional[EllMatrix] = None
        self.A_host: Optional[sp.csr_matrix] = None
        self.M_host: Optional[sp.csr_matrix] = None   # precon matrix
        self.b = None
        self.x = None
        self.x0 = None
        self.xref = None                           # reference solution
        self.dofmap: Optional[np.ndarray] = None   # per-row dof labels
        self.dof_labels = {}                       # symbolic name → label
        self.nullspace: Optional[np.ndarray] = None       # orthonormal
        self.near_nullspace: Optional[np.ndarray] = None  # AMG RBMs
        self.scaling = None                        # active ScalingContext
        self.ls_id = 0
        self.pattern_id = None      # lsseq sparsity-pattern id
        self._lsseq = None

    @property
    def num_rows(self) -> int:
        return self.A.shape[0] if self.A is not None else 0

    @property
    def nnz(self) -> int:
        return self.A.nnz if self.A is not None else 0

    def _vec(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=self.dtype,
                               device=self.device)

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, input_args, ls_id: int, stats=None, previous=None
              ) -> "LinearSystem":
        ls = input_args.linear_system
        general = input_args.general
        self = cls(dtype=resolve_dtype(general),
                   device=resolve_device(general, ls))
        self.ls_id = ls_id
        self.dof_labels = dict(ls.get("dof_labels") or {})

        if stats:
            stats.annotate_begin("matrix")
        try:
            self._build_matrix(ls, ls_id)
        finally:
            if stats:
                stats.annotate_end("matrix")
        if stats:
            stats.annotate_begin("rhs")
        try:
            self._build_rhs(ls, ls_id)
        finally:
            if stats:
                stats.annotate_end("rhs")
        self._build_x0(ls, ls_id, previous)
        self._build_xref(ls, ls_id)

        if ls.get("dofmap_filename") or ls.get("dofmap_basename"):
            if stats:
                stats.annotate_begin("dofmap")
            try:
                path = resolve_filename(ls, ls_id, ls.dofmap_filename,
                                        ls.dofmap_basename)
                self.dofmap = ij_io.read_dofmap_auto(path)
            finally:
                if stats:
                    stats.annotate_end("dofmap")

        self.reset_initial_guess()
        return self

    def _build_matrix(self, ls, ls_id: int):
        gen = ls.get("generate")
        if ls.get("sequence_filename"):
            # lsseq container (ref: linsys.c lsseq reader path)
            from ..io.lsseq import LSSeqFile

            seq = LSSeqFile(ls.sequence_filename)
            self._lsseq = seq
            self.A_host = seq.read_matrix(ls_id)
            dof = seq.read_dofmap(ls_id)
            if dof is not None:
                self.dofmap = dof
            self.pattern_id = seq.pattern_id(ls_id)
        elif gen and gen.get("kind"):
            self.A_host, dofmap = _generate_matrix(gen)
            if dofmap is not None:
                self.dofmap = dofmap
        else:
            path = resolve_filename(ls, ls_id, ls.matrix_filename,
                                    ls.matrix_basename)
            if not path:
                raise HypredrvError(
                    "linear_system: no matrix source (filename/basename/"
                    "generate)", ErrorCode.MISSING_KEY)
            if ls.type == 3 or path.endswith(".mtx"):
                from .mtx import read_mtx

                self.A_host = read_mtx(path)
            else:
                self.A_host, _ = ij_io.read_matrix_auto(path)
        self.A = EllMatrix.from_csr(self.A_host, dtype=self.dtype,
                                    device=self.device)
        # separate preconditioner matrix (ref: SetPrecMatrix)
        pm = resolve_filename(ls, ls_id, ls.get("precmat_filename", ""),
                              ls.get("precmat_basename", ""))
        if pm:
            self.M_host, _ = ij_io.read_matrix_auto(pm)

    def _build_rhs(self, ls, ls_id: int):
        n = self.num_rows
        mode = ls.rhs_mode
        if self._lsseq is not None:
            self.b = self._vec(self._lsseq.read_rhs(ls_id))
            return
        path = resolve_filename(ls, ls_id, ls.rhs_filename, ls.rhs_basename)
        if path and mode in (0, 2):  # file given (mode default/file)
            vec = ij_io.read_vector_auto(path)
            if len(vec) != n:
                raise HypredrvError(
                    f"rhs size {len(vec)} != matrix rows {n}",
                    ErrorCode.VECTOR)
            self.b = self._vec(vec)
            return
        if mode == 1:  # ones
            self.b = self._vec(np.ones(n))
        elif mode == 3:  # random
            rng = np.random.default_rng(2023 + ls_id)
            self.b = self._vec(rng.uniform(-1, 1, n))
        elif mode == 4:  # randsol: random xref, b = A·xref
            rng = np.random.default_rng(2023 + ls_id)
            self.xref = self._vec(rng.uniform(-1, 1, n))
            self.b = self.A.matvec(self.xref)
        else:  # zeros
            self.b = self._vec(np.zeros(n))

    def _build_x0(self, ls, ls_id: int, previous):
        n = self.num_rows
        mode = ls.init_guess_mode
        path = resolve_filename(ls, ls_id, ls.x0_filename, "")
        if path and mode in (0, 2):
            self.x0 = self._vec(ij_io.read_vector_auto(path))
            return
        if mode == 1:
            self.x0 = self._vec(np.ones(n))
        elif mode == 3:
            rng = np.random.default_rng(777 + ls_id)
            self.x0 = self._vec(rng.uniform(-1, 1, n))
        elif mode == 4 and previous is not None and previous.x is not None \
                and previous.x.shape[0] == n:
            # warm start from previous system's solution
            # (ref: init_guess_mode previous, linsys.c:376-382)
            self.x0 = previous.x.to(dtype=self.dtype, device=self.device)
        else:
            self.x0 = self._vec(np.zeros(n))

    def _build_xref(self, ls, ls_id: int):
        path = resolve_filename(ls, ls_id, ls.get("xref_filename", ""), "")
        if path:
            self.xref = self._vec(ij_io.read_vector_auto(path))

    @classmethod
    def from_csr(cls, input_args, indptr, indices, data, stats=None
                 ) -> "LinearSystem":
        """Library-mode CSR ingestion (ref: linsys.c:1190
        hypredrv_LinearSystemBuildMatrixFromCSR)."""
        general = input_args.general
        self = cls(dtype=resolve_dtype(general),
                   device=resolve_device(general, input_args.linear_system))
        if stats:
            stats.annotate_begin("matrix")
        n = len(indptr) - 1
        A = sp.csr_matrix(
            (np.asarray(data, dtype=np.float64),
             np.asarray(indices), np.asarray(indptr)),
            shape=(n, n))
        A.sort_indices()
        self.A_host = A
        self.A = EllMatrix.from_csr(A, dtype=self.dtype, device=self.device)
        self.b = self._vec(np.zeros(n))
        self.x0 = self._vec(np.zeros(n))
        self.x = self.x0
        if stats:
            stats.annotate_end("matrix")
        return self

    # -- vector setters (library mode) ------------------------------------

    def set_rhs_array(self, values: np.ndarray):
        if len(values) != self.num_rows:
            raise HypredrvError("rhs size mismatch", ErrorCode.VECTOR)
        self.b = self._vec(values)

    def set_x0_array(self, values: np.ndarray):
        if len(values) != self.num_rows:
            raise HypredrvError("x0 size mismatch", ErrorCode.VECTOR)
        self.x0 = self._vec(values)
        self.x = self.x0

    def set_xref_array(self, values: np.ndarray):
        self.xref = self._vec(values)

    def set_dofmap(self, dofmap: np.ndarray):
        self.dofmap = np.asarray(dofmap)

    def reset_initial_guess(self):
        """x ← x0 (ref: HYPREDRV_LinearSystemResetInitialGuess)."""
        self.x = self.x0

    def get_solution(self) -> np.ndarray:
        return self.x.cpu().numpy()

    # -- transforms --------------------------------------------------------

    def apply_scaling(self, scaling_args):
        if not scaling_args or not scaling_args.get("enabled"):
            return
        from .scaling import ScalingContext

        if self.scaling is None:
            self.scaling = ScalingContext.compute(self, scaling_args)
            self.scaling.apply(self)

    def postprocess_solution(self, result):
        """Undo scaling, project the null space, compute error norms
        (ref: HYPREDRV_LinearSolverApply tail, src/HYPREDRV.c:3307-3344)."""
        if self.scaling is not None:
            self.scaling.undo(self)
            self.scaling = None
        if self.nullspace is not None:
            from .nullspace import project_nullspace

            self.x = project_nullspace(self.x, self.nullspace)
        if self.xref is not None:
            e2, xn = (float(v) for v in torch.stack(
                [norm2(self.x - self.xref), norm2(self.xref)]).tolist())
            rel = e2 / xn if xn > 0 else e2
            log(1, f"error norms vs reference solution: "
                   f"L2 {e2:.6e} (rel {rel:.6e})")
            result.error_norm = e2

    # -- diagnostics -------------------------------------------------------

    def block_residual_norms(self, x=None):
        """Per-dof-label residual norms (ref: linsys.h:214-228)."""
        if self.dofmap is None:
            return {}
        x = self.x if x is None else x
        r = (self.b - self.A.matvec(x)).cpu().numpy()
        out = {}
        for label in np.unique(self.dofmap):
            mask = self.dofmap == label
            out[int(label)] = float(np.linalg.norm(r[mask]))
        return out


def _generate_matrix(gen):
    """Deterministic in-memory systems (the JAX package's generator):
    (A, dofmap or None)."""
    kind = gen.get("kind", "")
    nx = int(gen.get("nx", 10))
    ny = int(gen.get("ny", 0)) or None
    nz = int(gen.get("nz", 0)) or None
    if kind in ("laplacian_7pt", "laplacian", "ps3d10pt7"):
        return csr_ops.laplacian_3d_7pt(nx, ny, nz), None
    if kind == "laplacian_27pt":
        return csr_ops.laplacian_3d_27pt(nx, ny, nz), None
    if kind in ("laplacian_5pt", "laplacian_2d"):
        return csr_ops.laplacian_2d_5pt(nx, ny), None
    if kind == "elasticity":
        A, _coords = csr_ops.elasticity_3d(nx, ny, nz)
        return A, (np.arange(A.shape[0]) % 3).astype(np.int64)
    if kind == "multiphysics":
        return csr_ops.multiphysics_block_system(
            int(gen.get("ncell", 100)), int(gen.get("ndof", 3)),
            int(gen.get("seed", 7)))
    raise HypredrvError(f"unknown generate.kind '{kind}'",
                        ErrorCode.INVALID_VAL)
