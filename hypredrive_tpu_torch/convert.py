"""Carry the JAX package's objects across to this package, as numpy arrays.

Used by the parity tests: with the same matrix, the same whole AMG
hierarchy or the same MGR setup on both sides, the two packages' device
code can be compared without any difference from setup.  The argument
objects are duck-typed (``hypredrive_tpu.ops.device_matrix.EllMatrix``,
``hypredrive_tpu.precon.amg.hierarchy.AMGState``,
``hypredrive_tpu.precon.mgr.MGRState``, the component states of
``hypredrive_tpu.precon.components``, the ILU, FSAI and Schwarz states,
``hypredrive_tpu.precon.ams.AMSState``,
``hypredrive_tpu.linsys.scaling.ScalingContext`` and the mesh states of
``hypredrive_tpu.parallel``: a ``DistEllMatrix`` anywhere in a state
becomes this package's on the ``mesh`` argument); this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
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


def dist_matrix(D, mesh, dtype: torch.dtype = torch.float64):
    """The JAX package's ``DistEllMatrix`` as this package's on ``mesh``:
    each shard's local block rebuilt from its stacked DIA, ELL and COO
    tail arrays (in x_ext columns), with the same ``send_idx``
    schedule; on a mesh across ranks the result holds this rank's slice
    of the shards, as the port's own setup would."""
    from .parallel.dist_matrix import DistEllMatrix

    n_sh = mesh.n_shards
    rows_max = D.shape[0] // n_sh
    ext = int(D.ext_size)
    r = np.arange(rows_max)
    dia = np.asarray(D.dia_data) if D.dia_data is not None else None
    cols, vals = np.asarray(D.cols), np.asarray(D.vals)
    tails = [np.asarray(a) for a in (D.tail_rows, D.tail_cols, D.tail_vals)]
    locals_ext = []
    for s in range(n_sh):
        pr = [np.repeat(r, cols.shape[2]), tails[0][s]]
        pc = [cols[s].ravel(), tails[1][s]]
        pv = [vals[s].ravel(), tails[2][s]]
        for i, off in enumerate(D.dia_offsets if dia is not None else ()):
            pr.append(r)
            pc.append(r + off)
            pv.append(dia[s, i])
        rr, cc, vv = (np.concatenate(a) for a in (pr, pc, pv))
        ok = (vv != 0) & (cc >= 0) & (cc < ext)
        loc = sp.csr_matrix((vv[ok], (rr[ok], cc[ok])), shape=(rows_max, ext))
        loc.sum_duplicates()
        loc.sort_indices()
        locals_ext.append(loc)
    send_idx = tuple(np.array(i, dtype=np.int64) for i in D.send_idx)
    return DistEllMatrix.from_local(
        locals_ext, send_idx, tuple(D.offsets), mesh, D.shape, D.orig_shape,
        int(D.nnz), int(D.local_max), dtype)


def _mat(E, dtype, device, mesh=None):
    """A JAX device matrix (single-device or row-sharded) as this
    package's; None stays None."""
    if E is None:
        return None
    if hasattr(E, "send_idx"):
        return dist_matrix(E, mesh, dtype)
    return ell_matrix(E, dtype, device)


def _vec(a, dtype, device):
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def _smoother(kind, arrays, dtype, device, mesh=None):
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
        return (_vec(d_inv, dtype, device), _mat(L, dtype, device, mesh),
                _mat(U, dtype, device, mesh))
    return tuple(_vec(a, dtype, device) for a in arrays)


def ilu_state(state, dtype: torch.dtype = torch.float64,
              device: torch.device = torch.device("cpu"), mesh=None):
    """One of the JAX package's ILU apply states (``precon/ilu.py``: the
    tri-Jacobi tuple, ``SchurILUState``, ``NSHState``, or the Schwarz
    tuple of the RAS types) as this package's; the tri-Jacobi tuple of
    the mesh's block-Jacobi ILU with its factors on ``mesh``."""
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
        L=_mat(L, dtype, device, mesh), U=_mat(U, dtype, device, mesh),
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
              device: torch.device = torch.device("cpu"),
              mesh=None) -> AMGState:
    """The JAX package's AMGState as this package's: every level's A, P
    (the two-stage P₁·P₂ of aggressive levels too) and R (Pᵀ or the
    non-Galerkin AIR R), and the smoother operands by kind (the
    ``cf-*``/``air-*`` kinds as (d_inv, F-point mask)).  A mesh state's
    levels become row-sharded on ``mesh`` (then its device is used)."""
    if mesh is not None:
        device = mesh.device

    def mat(E):
        return _mat(E, dtype, device, mesh)

    levels = tuple(
        AMGLevel(A=mat(lv.A), P=mat(lv.P), R=mat(lv.R),
                 smooth_arrays=_smoother(lv.smoother, lv.smooth_arrays,
                                         dtype, device, mesh),
                 smoother=lv.smoother, pre_sweeps=int(lv.pre_sweeps),
                 post_sweeps=int(lv.post_sweeps),
                 up_smoother=lv.up_smoother,
                 up_arrays=_smoother(lv.up_smoother, lv.up_arrays,
                                     dtype, device, mesh))
        for lv in state.levels)
    return AMGState(
        levels=levels,
        coarse_inv=torch.tensor(np.array(state.coarse_inv), dtype=dtype,
                                device=device),
        cycle_type=int(state.cycle_type), max_iter=int(state.max_iter),
        mesh=mesh if state.mesh is not None else None)


def ams_state(state, dtype: torch.dtype = torch.float64,
              device: torch.device = torch.device("cpu"), mesh=None):
    """The JAX package's AMSState as this package's: A, G, Gᵀ, Π, Πᵀ and
    the Π_d pairs, the smoother operands, and the auxiliary states (AMG
    hierarchies; ADS's nested AMS on the curl space; None for a skipped
    gradient space); a mesh state's operators on ``mesh``."""
    from .precon.ams import AMSState

    if mesh is not None:
        device = mesh.device

    def mat(E):
        return _mat(E, dtype, device, mesh)

    def amg(st):
        return amg_state(st, dtype, device, mesh)

    bg = state.bg_state
    if isinstance(bg, type(state)):
        bg = ams_state(bg, dtype, device, mesh)
    elif bg is not None:
        bg = amg(bg)
    return AMSState(
        mat(state.A), _smoother(state.smoother, state.smooth, dtype, device),
        mat(state.G), mat(state.GT), mat(state.Pi), mat(state.PiT), bg,
        amg(state.bpi_state),
        comp_spaces=tuple((mat(P), mat(PT), amg(st))
                          for P, PT, st in state.comp_spaces),
        cycle_type=int(state.cycle_type),
        relax_times=int(state.relax_times), smoother=state.smoother)


def scaling_state(ctx, dtype: torch.dtype = torch.float64,
                  device: torch.device = torch.device("cpu")):
    """The JAX package's ScalingContext (its Sl and Sr vectors) as this
    package's, before ``apply``."""
    from .linsys.scaling import ScalingContext

    def vec(a):
        return _vec(a, dtype, device) if a is not None else None

    return ScalingContext(sl=vec(ctx.sl), sr=vec(ctx.sr))


def component_state(kind: str, state, dtype: torch.dtype = torch.float64,
                    device: torch.device = torch.device("cpu"), mesh=None):
    """One of the JAX package's MGR component states (``precon/
    components.py``) as this package's, by kind; the masked F-relaxation
    states and the coarsest AMG of the mesh MGR setup on ``mesh``."""
    def vec(a):
        return _vec(a, dtype, device)

    if kind == "none" or state is None:
        return None
    if kind == "masked-jacobi":
        return (vec(state[0]),)
    if kind in ("masked-amg", "masked-ilu"):
        fmask, sub = state
        return (vec(fmask), component_state(kind.split("-", 1)[1], sub,
                                            dtype, device, mesh))
    if kind in ("jacobi", "l1-jacobi"):
        d_inv, sweeps, A = state
        return (vec(d_inv), int(sweeps), ell_matrix(A, dtype, device))
    if kind == "chebyshev":
        A, d_inv, theta, delta, rhos = state
        return (ell_matrix(A, dtype, device), vec(d_inv),
                float(np.asarray(theta)), float(np.asarray(delta)),
                tuple(float(r) for r in np.asarray(rhos)))
    if kind == "amg":
        return amg_state(state, dtype, device, mesh)
    if kind == "ilu":
        return ilu_state(state, dtype, device, mesh)
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
              device: torch.device = torch.device("cpu"), mesh=None):
    """The JAX package's MGRState as this package's: every level's A, P
    and R (row-sharded on ``mesh`` for the mesh setup's levels), the F/C
    indices as int64, the components by kind."""
    from .precon.mgr import MGRLevel, MGRState

    if mesh is not None:
        device = mesh.device

    def idx(a):
        return torch.tensor(np.array(a), dtype=torch.int64, device=device)

    def mat(E):
        return _mat(E, dtype, device, mesh)

    levels = tuple(
        MGRLevel(A=mat(lv.A), f_idx=idx(lv.f_idx), c_idx=idx(lv.c_idx),
                 P=mat(lv.P), R=mat(lv.R),
                 f_state=component_state(lv.f_kind, lv.f_state, dtype,
                                         device, mesh),
                 g_state=component_state(lv.g_kind, lv.g_state, dtype,
                                         device, mesh),
                 f_kind=lv.f_kind, g_kind=lv.g_kind,
                 f_sweeps=int(lv.f_sweeps), pre=bool(lv.pre),
                 post=bool(lv.post))
        for lv in state.levels)
    return MGRState(
        levels=levels,
        coarsest_state=component_state(state.coarsest_kind,
                                       state.coarsest_state, dtype, device,
                                       mesh),
        coarsest_kind=state.coarsest_kind, cycle_type=int(state.cycle_type),
        max_iter=int(state.max_iter))
