"""Carry the JAX package's objects across to this package, as numpy arrays.

Used by the parity tests: with the same matrix, the same whole AMG
hierarchy or the same MGR setup on both sides, the two packages' device
code can be compared without any difference from setup.  The argument
objects are duck-typed (``hypredrive_tpu.ops.device_matrix.EllMatrix``,
``hypredrive_tpu.precon.amg.hierarchy.AMGState``,
``hypredrive_tpu.precon.mgr.MGRState``, the component states of
``hypredrive_tpu.precon.components``, the ILU, FSAI and Schwarz states and
``hypredrive_tpu.linsys.scaling.ScalingContext``);
this module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.device_matrix import EllMatrix
from .precon.amg.hierarchy import AMGLevel, AMGState


def ell_matrix(E, dtype: torch.dtype = torch.float64,
               device: torch.device = torch.device("cpu")) -> EllMatrix:
    """The JAX package's EllMatrix as this package's, from ``to_csr()`` and
    the same diagonal offsets."""
    out = EllMatrix.from_csr(E.to_csr(), dtype=dtype, device=device,
                             dia_offsets=tuple(E.dia_offsets))
    out.nnz = int(E.nnz)
    return out


def _vec(a, dtype, device):
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def _smoother(kind, arrays, dtype, device):
    if arrays is None:
        return None
    if kind == "chebyshev":
        d_inv, theta, delta, rhos = arrays
        return (_vec(d_inv, dtype, device),
                float(np.asarray(theta)), float(np.asarray(delta)),
                tuple(float(r) for r in np.asarray(rhos)))
    if kind == "fsai":
        G, GT, omega = arrays
        return (ell_matrix(G, dtype, device), ell_matrix(GT, dtype, device),
                float(np.asarray(omega)))
    if kind in ("gs-fwd", "gs-bwd", "gs-sym"):
        d_inv, L, U = arrays
        return (_vec(d_inv, dtype, device),
                ell_matrix(L, dtype, device) if L is not None else None,
                ell_matrix(U, dtype, device) if U is not None else None)
    return tuple(_vec(a, dtype, device) for a in arrays)


def ilu_state(state, dtype: torch.dtype = torch.float64,
              device: torch.device = torch.device("cpu")):
    """One of the JAX package's ILU apply states (``precon/ilu.py``: the
    tri-Jacobi tuple, ``SchurILUState``, ``NSHState``, or the Schwarz
    tuple of the RAS types) as this package's."""
    from .precon import ilu

    if type(state).__name__ == "NSHState":
        return ilu.NSHState(ell_matrix(state.M, dtype, device))
    if type(state).__name__ == "SchurILUState":
        def idx(a):
            return torch.tensor(np.array(a), dtype=torch.int64,
                                device=device)

        return ilu.SchurILUState(
            int_idx=idx(state.int_idx), if_idx=idx(state.if_idx),
            b_state=ilu_state(state.b_state, dtype, device),
            c_state=ilu_state(state.c_state, dtype, device),
            E=ell_matrix(state.E, dtype, device),
            F=ell_matrix(state.F, dtype, device),
            C=ell_matrix(state.C, dtype, device),
            schur_max_iter=int(state.schur_max_iter))
    if len(state) == 4:
        return schwarz_state(state, dtype, device)
    L, U, _l_dinv, u_dinv, l_iters, u_iters = state
    return ilu.TriJacobiState(
        L=ell_matrix(L, dtype, device), U=ell_matrix(U, dtype, device),
        u_dinv=_vec(u_dinv, dtype, device), l_iters=int(l_iters),
        u_iters=int(u_iters))


def schwarz_state(state, dtype: torch.dtype = torch.float64,
                  device: torch.device = torch.device("cpu")):
    """The JAX package's Schwarz tuple (inv, ext_idx, own_mask, weight)."""
    from .precon.schwarz import SchwarzState

    inv, ext_idx, own_mask, weight = state
    return SchwarzState(
        inv=_vec(inv, dtype, device),
        ext_idx=torch.tensor(np.array(ext_idx), dtype=torch.int64,
                             device=device),
        own_mask=torch.tensor(np.array(own_mask), dtype=torch.bool,
                              device=device),
        weight=_vec(weight, dtype, device))


def fsai_state(state, dtype: torch.dtype = torch.float64,
               device: torch.device = torch.device("cpu")):
    """The JAX package's FSAI (G, Gᵀ) pair."""
    from .precon.fsai import FSAIState

    G, GT = state
    return FSAIState(ell_matrix(G, dtype, device),
                     ell_matrix(GT, dtype, device))


def amg_state(state, dtype: torch.dtype = torch.float64,
              device: torch.device = torch.device("cpu")) -> AMGState:
    """The JAX package's single-device AMGState as this package's: every
    level's A, P (the two-stage P₁·P₂ of aggressive levels too) and R (Pᵀ
    or the non-Galerkin AIR R), and the smoother operands by kind (the
    ``cf-*``/``air-*`` kinds as (d_inv, F-point mask))."""
    def mat(E):
        return ell_matrix(E, dtype, device) if E is not None else None

    levels = tuple(
        AMGLevel(A=mat(lv.A), P=mat(lv.P), R=mat(lv.R),
                 smooth_arrays=_smoother(lv.smoother, lv.smooth_arrays,
                                         dtype, device),
                 smoother=lv.smoother, pre_sweeps=int(lv.pre_sweeps),
                 post_sweeps=int(lv.post_sweeps),
                 up_smoother=lv.up_smoother,
                 up_arrays=_smoother(lv.up_smoother, lv.up_arrays,
                                     dtype, device))
        for lv in state.levels)
    return AMGState(
        levels=levels,
        coarse_inv=torch.tensor(np.array(state.coarse_inv), dtype=dtype,
                                device=device),
        cycle_type=int(state.cycle_type), max_iter=int(state.max_iter))


def scaling_state(ctx, dtype: torch.dtype = torch.float64,
                  device: torch.device = torch.device("cpu")):
    """The JAX package's ScalingContext (its Sl and Sr vectors) as this
    package's, before ``apply``."""
    from .linsys.scaling import ScalingContext

    def vec(a):
        return _vec(a, dtype, device) if a is not None else None

    return ScalingContext(sl=vec(ctx.sl), sr=vec(ctx.sr))


def component_state(kind: str, state, dtype: torch.dtype = torch.float64,
                    device: torch.device = torch.device("cpu")):
    """One of the JAX package's MGR component states (``precon/
    components.py``) as this package's, by kind."""
    def vec(a):
        return _vec(a, dtype, device)

    if kind == "none" or state is None:
        return None
    if kind in ("jacobi", "l1-jacobi"):
        d_inv, sweeps, A = state
        return (vec(d_inv), int(sweeps), ell_matrix(A, dtype, device))
    if kind == "chebyshev":
        A, d_inv, theta, delta, rhos = state
        return (ell_matrix(A, dtype, device), vec(d_inv),
                float(np.asarray(theta)), float(np.asarray(delta)),
                tuple(float(r) for r in np.asarray(rhos)))
    if kind == "amg":
        return amg_state(state, dtype, device)
    if kind == "ilu":
        return ilu_state(state, dtype, device)
    if kind == "fsai":
        return fsai_state(state, dtype, device)
    if kind == "schwarz":
        return schwarz_state(state, dtype, device)
    if kind == "dense":
        return vec(state)
    if kind == "krylov":
        from .precon.components import KrylovComponent

        return KrylovComponent(
            A=ell_matrix(state.A, dtype, device), pc_kind=state.pc_kind,
            pc_state=component_state(state.pc_kind, state.pc_state, dtype,
                                     device),
            method=state.method, max_iter=int(state.max_iter),
            krylov_dim=int(state.krylov_dim), rtol=float(state.rtol))
    if kind == "mgr":
        return mgr_state(state, dtype, device)
    raise ValueError(f"component kind '{kind}' has no counterpart here")


def mgr_state(state, dtype: torch.dtype = torch.float64,
              device: torch.device = torch.device("cpu")):
    """The JAX package's single-device MGRState as this package's: every
    level's A, P and R through :func:`ell_matrix`, the F/C indices as
    int64, the components by kind."""
    from .precon.mgr import MGRLevel, MGRState

    def idx(a):
        return torch.tensor(np.array(a), dtype=torch.int64, device=device)

    levels = tuple(
        MGRLevel(A=ell_matrix(lv.A, dtype, device), f_idx=idx(lv.f_idx),
                 c_idx=idx(lv.c_idx), P=ell_matrix(lv.P, dtype, device),
                 R=ell_matrix(lv.R, dtype, device),
                 f_state=component_state(lv.f_kind, lv.f_state, dtype,
                                         device),
                 g_state=component_state(lv.g_kind, lv.g_state, dtype,
                                         device),
                 f_kind=lv.f_kind, g_kind=lv.g_kind,
                 f_sweeps=int(lv.f_sweeps), pre=bool(lv.pre),
                 post=bool(lv.post))
        for lv in state.levels)
    return MGRState(
        levels=levels,
        coarsest_state=component_state(state.coarsest_kind,
                                       state.coarsest_state, dtype, device),
        coarsest_kind=state.coarsest_kind, cycle_type=int(state.cycle_type),
        max_iter=int(state.max_iter))
