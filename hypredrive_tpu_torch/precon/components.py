"""Composable solver components for MGR.

Counterpart of ``hypredrive_tpu/precon/components.py``.  MGR's
F-relaxation, global relaxation and coarsest-level solver are each a
component: none / (ℓ1-)Jacobi / Chebyshev / AMG / ILU / FSAI / Schwarz /
dense direct / nested Krylov / nested MGR (ref: src/internal/mgr.c:68-365
wrapper registry +
include/internal/krylov.h nested solvers).  A component is (kind, state):
:func:`build_component` sets it up on the host and uploads it to the
device, :func:`apply_component` applies it there.

The name mapping is the JAX package's: the sequential Gauss-Seidel family
maps to ℓ1-Jacobi, ``blk-jacobi`` to point Jacobi.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..core.errors import ErrorCode, HypredrvError
from ..core.trace import span
from ..ops.device_matrix import EllMatrix


def apply_component(kind: str, state, r):
    """z ≈ B r for the component (kind, state)."""
    if kind == "none" or state is None:
        return r
    if kind in ("jacobi", "l1-jacobi"):
        from .jacobi import jacobi_apply

        return jacobi_apply(state, r)
    if kind == "chebyshev":
        from .chebyshev import cheby_apply

        return cheby_apply(state, r)
    if kind == "amg":
        from .amg.cycle import amg_apply

        return amg_apply(state, r)
    if kind == "ilu":
        from .ilu import ilu_apply

        return ilu_apply(state, r)
    if kind == "fsai":
        from .fsai import fsai_apply

        return fsai_apply(state, r)
    if kind == "schwarz":
        from .schwarz import schwarz_apply

        return schwarz_apply(state, r)
    if kind == "dense":
        return torch.mv(state, r)
    if kind == "krylov":
        return _krylov_apply(state, r)
    if kind == "mgr":
        from .mgr import mgr_apply

        return mgr_apply(state, r)
    raise HypredrvError(f"unknown component kind '{kind}'",
                        ErrorCode.INVALID_PRECON)


# ---------------------------------------------------------------------------
# component construction (host setup → device state)
# ---------------------------------------------------------------------------

def build_component(kind_config, A_host: sp.csr_matrix, dtype,
                    dofmap: Optional[np.ndarray] = None,
                    device: torch.device = torch.device("cpu")
                    ) -> Tuple[str, object]:
    """Build (kind, state) from a config value on ``device``.

    ``kind_config`` may be a string name, an int code, or a nested map
    like ``{amg: {...}}`` / ``{krylov: {...}}`` (ref: mgr.c f_relaxation
    forms).  The span ``component_<name>`` (``core/trace.py``) times it.
    """
    name, sub = _normalize_kind(kind_config)
    with span(f"component_{name}"):
        return _build(name, sub, A_host, dtype, dofmap, device)


def _build(name, sub, A_host, dtype, dofmap, device):
    from ..config.sections import (AMG_SCHEMA, CHEBY_SCHEMA, FSAI_SCHEMA,
                                   ILU_SCHEMA, MGR_KRYLOV_SCHEMA, MGR_SCHEMA,
                                   SCHWARZ_SCHEMA)

    if name in ("none", ""):
        return ("none", None)
    if name in ("single", "jacobi", "blk-jacobi"):
        return ("jacobi", _jacobi_state(A_host, dtype, device, l1=False))
    if name in ("l1-jacobi", "l1-hfgs", "l1-hbgs", "l1-hsgs", "h-fgs",
                "h-bgs", "ch-gs", "h-ssor", "blk-gs", "mixed-gs",
                "2stg-fgs", "2stg-bgs", "v(1,0)"):
        # sequential GS family → ℓ1-Jacobi device equivalent
        return ("jacobi", _jacobi_state(A_host, dtype, device, l1=True))
    if name == "chebyshev":
        args = CHEBY_SCHEMA.parse(sub or {}, "chebyshev", [])
        return ("chebyshev", _cheby_state(A_host, args, dtype, device))
    if name == "amg":
        from .amg.hierarchy import setup_hierarchy

        args = AMG_SCHEMA.parse(sub or {}, "amg", [])
        return ("amg", setup_hierarchy(A_host, args, dtype=dtype,
                                       device=device, dof_func=dofmap))
    if name == "ilu":
        from .ilu import build_ilu_state

        args = ILU_SCHEMA.parse(sub or {}, "ilu", [])
        return ("ilu", build_ilu_state(A_host, args, dtype, device))
    if name == "fsai":
        from .fsai import build_fsai

        args = FSAI_SCHEMA.parse(sub or {}, "fsai", [])
        budget = min(int(args.max_steps) * int(args.max_step_size),
                     int(args.max_nnz_row))
        return ("fsai", build_fsai(A_host, max_nnz_row=max(1, budget),
                                   threshold=float(args.threshold),
                                   dtype=dtype, device=device))
    if name == "schwarz":
        from .schwarz import build_schwarz

        args = SCHWARZ_SCHEMA.parse(sub or {}, "schwarz", [])
        # ras-* variants = restricted additive Schwarz (ref vocab:
        # schwarz.c:44-70; 10/20/30/40 = ras-iluk/ilut/amg/spdirect,
        # 11/21/31/41 = additive)
        return ("schwarz", build_schwarz(
            A_host, overlap=max(0, int(args.overlap)),
            restricted=int(args.variant) in (10, 20, 30, 40),
            relax_weight=float(args.relax_weight), dtype=dtype,
            device=device))
    if name in ("spdirect", "ge", "ge-piv", "ge-inv", "lu_piv", "lu_inv"):
        dense = np.asarray(A_host.todense(), dtype=np.float64)
        try:
            inv = np.linalg.inv(dense)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(dense)
        return ("dense", torch.as_tensor(inv, dtype=dtype, device=device))
    if name == "krylov":
        args = MGR_KRYLOV_SCHEMA.parse(sub or {}, "krylov", [])
        return ("krylov", _krylov_state(A_host, args, dtype, dofmap, device))
    if name == "mgr":
        from .mgr import setup_mgr

        args = MGR_SCHEMA.parse(sub or {}, "mgr", [])
        return ("mgr", setup_mgr(A_host, args, dofmap, dtype, device=device))
    raise HypredrvError(f"unsupported component '{name}'",
                        ErrorCode.INVALID_PRECON)


def _normalize_kind(kind_config):
    from ..config.fields import normalize_name

    if kind_config is None:
        return "none", None
    if isinstance(kind_config, str):
        return normalize_name(kind_config), None
    if isinstance(kind_config, (int, float)):
        # raw int codes from the MGR vocab
        from ..config import vocab as V

        code = int(kind_config)
        for table in (V.MGR_FRELAX, V.MGR_GRELAX, V.MGR_COARSEST):
            if code in table.values:
                return normalize_name(table.name_of(code)), None
        return "none", None
    if isinstance(kind_config, dict):
        items = list(kind_config.items())
        if len(items) != 1:
            raise HypredrvError(
                f"component config must have one method key, got "
                f"{list(kind_config)}", ErrorCode.INVALID_ARG)
        return normalize_name(items[0][0]), items[0][1]
    raise HypredrvError(f"bad component config {kind_config!r}",
                        ErrorCode.INVALID_ARG)


def _jacobi_state(A_host, dtype, device, l1=True):
    if l1:
        d = np.asarray(np.abs(A_host).sum(axis=1)).ravel()
    else:
        d = A_host.diagonal()
    d_inv = torch.as_tensor(np.where(d != 0, 1.0 / d, 1.0), dtype=dtype,
                            device=device)
    return (d_inv, 1, EllMatrix.from_csr(A_host, dtype=dtype,
                                         device=device))


def _cheby_state(A_host, args, dtype, device):
    from .amg.hierarchy import _power_lambda_max
    from .chebyshev import cheby_coefficients

    diag = A_host.diagonal()
    d_inv_np = np.where(diag != 0, 1.0 / diag, 1.0)
    lam = _power_lambda_max(A_host, d_inv_np, int(args.eig_est)) * 1.1
    theta, delta, rhos = cheby_coefficients(lam, float(args.fraction),
                                            int(args.order))
    return (EllMatrix.from_csr(A_host, dtype=dtype, device=device),
            torch.as_tensor(d_inv_np, dtype=dtype, device=device),
            float(theta), float(delta), tuple(float(r) for r in rhos))


# ---------------------------------------------------------------------------
# nested Krylov component (ref: include/internal/krylov.h:16-44)
# ---------------------------------------------------------------------------

@dataclass
class KrylovComponent:
    """Fixed-budget inner Krylov solve as a preconditioner component."""

    A: EllMatrix
    pc_kind: str
    pc_state: object
    method: str
    max_iter: int
    krylov_dim: int
    rtol: float


def _krylov_state(A_host, args, dtype, dofmap, device):
    from ..config.fields import normalize_name

    pc_cfg = args.get("preconditioner")
    if pc_cfg is not None:
        pc_kind, pc_state = build_component(pc_cfg, A_host, dtype, dofmap,
                                            device)
    else:
        pc_kind, pc_state = "none", None
    return KrylovComponent(
        A=EllMatrix.from_csr(A_host, dtype=dtype, device=device),
        pc_kind=pc_kind, pc_state=pc_state,
        method=normalize_name(args.get("type", "gmres")),
        max_iter=int(args.get("max_iter", 20)),
        krylov_dim=int(args.get("krylov_dim", 20)),
        rtol=float(args.get("relative_tol", 0.0)))


def _krylov_apply(state: KrylovComponent, r):
    """The solver cores with plain callables, from x0 = 0 (absolute
    tolerance 0, GMRES trusting its inner estimate), unrolled to their
    fixed budget with the device loop's masks and no host read, so that
    the component runs inside the outer solve's captured graphs."""
    from ..solvers.bicgstab import bicgstab_core
    from ..solvers.fgmres import fgmres_core
    from ..solvers.gmres import gmres_core
    from ..solvers.pcg import pcg_core

    mv = state.A.matvec

    def pc(v):
        return apply_component(state.pc_kind, state.pc_state, v)

    x0 = torch.zeros_like(r)
    m = state.method
    if m == "pcg":
        x, *_ = pcg_core(mv, pc, r, x0, state.rtol, 0.0, state.max_iter,
                         True, 0, unroll=True)
    elif m == "bicgstab":
        x, *_ = bicgstab_core(mv, pc, r, x0, state.rtol, 0.0, state.max_iter,
                              unroll=True)
    elif m == "fgmres":
        x, *_ = fgmres_core(mv, pc, r, x0, state.rtol, 0.0, state.max_iter,
                            state.krylov_dim, unroll=True)
    else:
        x, *_ = gmres_core(mv, pc, r, x0, state.rtol, 0.0, state.max_iter,
                           state.krylov_dim, True, unroll=True)
    return x
