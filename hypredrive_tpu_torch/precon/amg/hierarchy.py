"""AMG hierarchy setup (host) → device levels.

Counterpart of ``hypredrive_tpu/precon/amg/hierarchy.py`` for one device.
The setup runs on the host in numpy/scipy (and the native helpers):

    strength → coarsen (PMIS/HMIS) → interpolation → RAP

per level until max_coarse_size / max_levels, then a dense coarse-grid
inverse (the reference coarse_type default 9 = Gaussian elimination).  The
host arithmetic is the JAX package's, so both packages build the same
levels; only the upload differs.  Each level's A, P and R become
:class:`~hypredrive_tpu_torch.ops.device_matrix.EllMatrix` on the target
device, with the smoother vectors beside them.

Smoothers: Chebyshev (relax type 16, the default), Jacobi (0, 7),
ℓ1-Jacobi (18), hybrid Gauss-Seidel (the ``gs-*`` kinds: the strict
triangular parts as device matrices, each triangular solve replaced by
``GS_TRI_ITERS`` Jacobi corrections), the FSAI complex smoother on the
first ``smoother.num_levels`` levels (the host-sequential ilu/pilut/euclid
types map to it, as in the JAX package), and the F/C-masked (ℓ1-)Jacobi
kinds: ``cf-*`` for ``relaxation.order: 1`` and ``air-*`` for
``relaxation.points: air``, each with the level's {0,1} F-point mask.

Coarsening options: aggressive (two-stage) coarsening on the first
``aggressive.num_levels`` levels (P = P₁·P₂), AIR restriction
(``interpolation.restriction_type`` > 0, a non-Galerkin R from
``air.build_restriction``), and rigid-body-mode interpolation vectors
(``interp_vectors``, GM2 pattern growth and min-norm re-weighting in
``rbm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.device_matrix import EllMatrix
from .air import build_restriction
from .coarsen import coarsen
from .interp import build_interpolation
from .strength import strength_graph

# relax-type codes → smoother kinds (ref vocab: amg.c AMGrlxGetValidValues)
_RELAX_KIND = {
    0: "jacobi", 7: "jacobi", 18: "l1-jacobi",
    3: "gs-fwd", 4: "gs-bwd", 5: "gs-fwd", 6: "gs-sym",
    8: "gs-sym", 10: "gs-fwd", 11: "gs-fwd", 12: "gs-fwd",
    13: "gs-fwd", 14: "gs-bwd", 89: "gs-sym",
    16: "chebyshev",
}

# Jacobi iterations approximating each triangular solve in the hybrid GS
# smoothers (z ← D⁻¹(r − L z) repeated); 2 corrections after the D⁻¹r seed
# reproduce hypre's hybrid-GS iteration counts on the example suite
GS_TRI_ITERS = 2

# smoother.type codes that select the FSAI complex smoother
# (ref vocab: fsai=4, ilu=5, pilut=7, parasails=8, euclid=9)
FSAI_SMOOTHER_TYPES = (4, 5, 7, 8, 9)


@dataclass
class AMGLevel:
    A: EllMatrix
    P: Optional[EllMatrix]          # prolongation (None on coarsest)
    R: Optional[EllMatrix]          # restriction (Pᵀ unless AIR)
    smooth_arrays: Tuple            # operands of the down smoother
    smoother: str = "l1-jacobi"     # down/pre kind
    pre_sweeps: int = 1
    post_sweeps: int = 1
    up_smoother: Optional[str] = None   # None → same as down
    up_arrays: Optional[Tuple] = None


@dataclass
class AMGState:
    levels: Tuple[AMGLevel, ...]
    coarse_inv: Optional[torch.Tensor]  # dense inverse of coarsest A
    cycle_type: int = 0                  # 0=V, 1=W
    max_iter: int = 1


def _galerkin_rap(A_l: sp.csr_matrix, P: sp.csr_matrix,
                  R_air: Optional[sp.csr_matrix] = None) -> sp.csr_matrix:
    """A_c = R·A·P: Pᵀ·A·P (the native fast path when it is built) without
    an AIR restriction, else the non-Galerkin R_air·A·P by scipy."""
    R = R_air
    if R is None:
        from ...io.native import amg_rap

        Ac = amg_rap(sp.csr_matrix(A_l), sp.csr_matrix(P))
        if Ac is not None:
            return Ac
        R = sp.csr_matrix(P.T)
    A_c = sp.csr_matrix(R @ A_l @ P)
    A_c.sort_indices()
    return A_c


def _bucket_rows(n: int) -> int:
    """Shape-stability bucket for coarse-level sizes: round n (above 32)
    up to the next multiple of q = max(32, 2^(bitlen(n)-4)), as the JAX
    package does, so both hierarchies have the same level sizes."""
    if n <= 32:
        return n
    q = max(32, 1 << (int(n).bit_length() - 4))
    return -(-n // q) * q


def _pad_level(A_c: sp.csr_matrix, P: sp.csr_matrix, R: sp.csr_matrix,
               npad: int):
    """Pad the coarse operator to ``npad`` rows with identity rows.

    Exact no-ops: R's pad rows are zero, so padded residuals are always 0
    and the pad solution entries stay 0 through every cycle."""
    ext = npad - A_c.shape[0]
    A_c = sp.bmat([[A_c, None],
                   [None, sp.identity(ext, format="csr",
                                      dtype=A_c.dtype)]],
                  format="csr")
    P = sp.csr_matrix(sp.hstack(
        [P, sp.csr_matrix((P.shape[0], ext), dtype=P.dtype)]))
    R = sp.csr_matrix(sp.vstack(
        [R, sp.csr_matrix((ext, R.shape[1]), dtype=R.dtype)]))
    A_c.sort_indices()
    P.sort_indices()
    R.sort_indices()
    return A_c, P, R


def _power_lambda_max(A_host: sp.csr_matrix, d_inv: np.ndarray,
                      iters: int = 10, seed: int = 0) -> float:
    """Host power iteration on D⁻¹A (setup-phase λmax estimate); draws the
    same numbers as the JAX package."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A_host.shape[0])
    lam = 1.0
    for _ in range(max(1, iters)):
        w = d_inv * (A_host @ v)
        lam = np.linalg.norm(w)
        if lam == 0:
            return 1.0
        v = w / lam
    return float(lam)


def _smoother_arrays(kind: str, A_host: sp.csr_matrix, dtype, device,
                     cheby_args=None, weight: float = 1.0,
                     fmask: Optional[np.ndarray] = None) -> Tuple:
    """Chebyshev: (d_inv, θ, δ, ρ_k); (ℓ1-)Jacobi: (d_inv,); hybrid GS:
    (d_inv, L_strict or None, U_strict or None); the F/C-masked ``cf-*``
    and ``air-*`` kinds: their base kind's (d_inv,) and the {0,1} F-point
    mask (all ones when none is given).  Vectors and matrices are on
    ``device``; the Chebyshev scalars stay Python floats."""
    def vec(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if kind.startswith(("air-", "cf-")):
        base = _smoother_arrays(kind.split("-", 1)[1], A_host, dtype, device,
                                cheby_args, weight)
        if fmask is None:
            fmask = np.ones(A_host.shape[0])
        return base + (vec(fmask),)
    if kind == "chebyshev":
        from ..chebyshev import cheby_coefficients

        order = int(cheby_args.get("order", 2)) if cheby_args else 2
        fraction = float(cheby_args.get("fraction", 0.3)) if cheby_args else 0.3
        eig_iters = int(cheby_args.get("eig_est", 10)) if cheby_args else 10
        diag = A_host.diagonal()
        d_inv_np = np.where(diag != 0, 1.0 / diag, 1.0)
        lam = _power_lambda_max(A_host, d_inv_np, eig_iters) * 1.1
        theta, delta, rhos = cheby_coefficients(lam, fraction, order)
        return (vec(d_inv_np), float(theta), float(delta),
                tuple(float(r) for r in rhos))
    if kind in ("gs-fwd", "gs-bwd", "gs-sym"):
        # hybrid GS: strict triangular parts + the diagonal; the cycle
        # Jacobi-iterates (D + L) z = r
        diag = A_host.diagonal()
        d = vec(np.where(diag != 0, weight / diag, 1.0))
        L = U = None
        if kind in ("gs-fwd", "gs-sym"):
            L = EllMatrix.from_csr(sp.tril(A_host, -1, format="csr"),
                                   dtype=dtype, device=device)
        if kind in ("gs-bwd", "gs-sym"):
            U = EllMatrix.from_csr(sp.triu(A_host, 1, format="csr"),
                                   dtype=dtype, device=device)
        return (d, L, U)
    if kind == "jacobi":
        diag = A_host.diagonal()
        return (vec(np.where(diag != 0, weight / diag, 1.0)),)
    # l1-jacobi: D = Σ_j |a_ij|
    l1 = np.asarray(np.abs(A_host).sum(axis=1)).ravel()
    return (vec(np.where(l1 != 0, weight / l1, 1.0)),)


def _fsai_smoother(A_l: sp.csr_matrix, fs, dtype, device) -> Tuple:
    """(G, Gᵀ, ω) of the FSAI complex smoother on one level: adaptive FSAI
    for algo types 1/3, else static with max_steps·max_step_size entries
    per row; ω = 1/λmax(GᵀG·A) from eig_max_iters host power steps
    (hypre's FSAI smoothing scale, ref fsai.c eig_max_iters)."""
    from ..fsai import build_fsai, build_fsai_adaptive

    if int(fs.algo_type) in (1, 3):
        st = build_fsai_adaptive(A_l, max_steps=int(fs.max_steps),
                                 max_step_size=int(fs.max_step_size),
                                 kap_tolerance=float(fs.kap_tolerance),
                                 dtype=dtype, device=device)
    else:
        st = build_fsai(A_l, max_nnz_row=int(fs.max_steps)
                        * int(fs.max_step_size),
                        threshold=float(fs.kap_tolerance), dtype=dtype,
                        device=device)
    omega = 1.0
    eig_iters = int(fs.eig_max_iters)
    if eig_iters > 0:
        Gh = st.G.to_csr()
        v = np.random.default_rng(0).standard_normal(A_l.shape[0])
        lam = 1.0
        for _ in range(eig_iters):
            w = Gh.T @ (Gh @ (A_l @ v))
            lam = float(np.linalg.norm(w))
            if lam == 0:
                lam = 1.0
                break
            v = w / lam
        omega = 1.0 / lam
    return (st.G, st.GT, omega)


def _smoother_kinds(amg_args) -> Tuple[str, str]:
    """(down kind, up kind) from the relaxation section, as the JAX package
    picks them: ``relaxation.type`` sets both directions; ``points: air``
    turns every kind but Chebyshev into the F/C-masked AIR schedule
    (ref: amg.c:870-877,986-1015); ``order: 1`` turns (ℓ1-)Jacobi into C/F
    relaxation (hypre BoomerAMGSetRelaxOrder, ref amg.c:895)."""
    rlx = amg_args.relaxation
    if int(rlx.type) >= 0:
        down_kind = up_kind = _RELAX_KIND.get(int(rlx.type), "l1-jacobi")
    else:
        down_kind = _RELAX_KIND.get(int(rlx.down_type), "l1-jacobi")
        up_kind = _RELAX_KIND.get(int(rlx.up_type), "l1-jacobi")
    if int(rlx.points) == 1:
        def air(kind):
            if kind == "chebyshev":
                return kind
            return "air-" + ("jacobi" if kind == "jacobi" else "l1-jacobi")
        return air(down_kind), air(up_kind)
    if int(rlx.order) == 1:
        def cf(kind):
            return "cf-" + kind if kind in ("jacobi", "l1-jacobi") else kind
        return cf(down_kind), cf(up_kind)
    return down_kind, up_kind


def _aggressive_interpolation(A_l, S, cf1, itp, lvl, ctype, theta, sabs,
                              func_l, trunc_factor, max_nnz_row):
    """Two-stage (aggressive) coarsening of one level: PMIS → P₁ → Galerkin
    A₁ → PMIS (seeded 1000 + lvl) → P₂; returns (P₁·P₂, the combined C/F
    marks).  The coarse grid of the fused level is the distance-2 C-set
    (ref: amg.c:330-347, hypre's 2-stage aggressive prolongations)."""
    p_type = int(itp.prolongation_type)
    P1 = build_interpolation(A_l, S, cf1, prolongation_type=p_type,
                             trunc_factor=trunc_factor,
                             max_nnz_row=max_nnz_row)
    C1 = np.flatnonzero(cf1 > 0)
    A1 = _galerkin_rap(A_l, P1)
    func1 = func_l[C1] if func_l is not None else None
    S1 = strength_graph(A1, theta=theta, sabs=sabs, dof_func=func1)
    if S1.nnz == 0:
        return P1, cf1
    cf2 = coarsen(S1, ctype=ctype, seed=1000 + lvl)
    if (cf2 > 0).sum() in (0, len(C1)):
        return P1, cf1
    P2 = build_interpolation(A1, S1, cf2, prolongation_type=p_type,
                             trunc_factor=trunc_factor,
                             max_nnz_row=max_nnz_row)
    P = sp.csr_matrix(P1 @ P2)
    P.sort_indices()
    cf = cf1.copy()
    cf[C1[cf2 < 0]] = -1
    return P, cf


def setup_hierarchy(A_host: sp.csr_matrix, amg_args,
                    dtype: torch.dtype = torch.float64,
                    device: torch.device = torch.device("cpu"),
                    fine_matrix: Optional[EllMatrix] = None,
                    dof_func: Optional[np.ndarray] = None,
                    interp_vectors: Optional[np.ndarray] = None) -> AMGState:
    """Build the multigrid hierarchy from the AMG config Args (schema:
    config/sections.py AMG_SCHEMA; ref arg structs amg.h:23-123) and upload
    it to ``device``.  ``fine_matrix`` is reused as the finest level's A
    when it has the right dtype and device.  ``dof_func`` (per-row dof
    labels) restricts strong connections to one function when
    ``coarsening.num_functions`` > 1, and follows the C points down the
    levels.  ``interp_vectors`` (near-null-space modes, (n, k) or (k, n))
    are folded into every level's P when ``interp_vec_variant`` > 0 (ref:
    amg.c:602 AMGSetRBMs); their coarse copies are the C-point
    injection."""
    kind, up_kind = _smoother_kinds(amg_args)
    device = torch.device(device)
    if fine_matrix is not None and (fine_matrix.dtype != dtype
                                    or fine_matrix.device != device):
        fine_matrix = None
    csn = amg_args.coarsening
    itp = amg_args.interpolation
    rlx = amg_args.relaxation

    theta = float(csn.strong_th)
    sabs = bool(csn.sabs)
    seed_base = int(getattr(csn, "rand_seed", 0))
    max_levels = int(csn.max_levels)
    max_coarse = max(1, int(csn.max_coarse_size))
    min_coarse = int(csn.min_coarse_size)
    num_sweeps = max(1, int(rlx.num_sweeps))
    pre = int(rlx.down_sweeps) if int(rlx.down_sweeps) >= 0 else num_sweeps
    post = int(rlx.up_sweeps) if int(rlx.up_sweeps) >= 0 else num_sweeps
    weight = float(rlx.weight)
    num_functions = int(csn.num_functions)
    # complex smoother on the finest levels (ref: amg.c:441-457)
    fsai_levels = (int(amg_args.smoother.num_levels)
                   if int(amg_args.smoother.type) in FSAI_SMOOTHER_TYPES
                   else 0)
    fsai_sweeps = max(1, int(amg_args.smoother.num_sweeps))
    # AIR: non-Galerkin restriction (ref: amg.c:870-877)
    restriction_type = int(itp.restriction_type)
    restrict_th = float(itp.restrict_strong_th)
    restrict_filter = float(itp.restrict_filter_th)
    masked = kind.startswith(("air-", "cf-")) \
        or up_kind.startswith(("air-", "cf-"))
    agg_levels = int(amg_args.aggressive.num_levels)
    agg_trunc = float(amg_args.aggressive.trunc_factor)
    agg_pmax = int(amg_args.aggressive.max_nnz_row)
    # interpolation vectors (RBMs); GM2 pattern growth pins QMax = 4 for
    # variant 2 (ref: amg.c:1025 SetInterpVecQMax(4))
    V_l = None
    qmax = int(getattr(amg_args, "interp_vec_qmax", 0))
    if interp_vectors is not None and int(amg_args.interp_vec_variant) > 0:
        V_l = np.atleast_2d(np.asarray(interp_vectors, dtype=np.float64))
        if V_l.shape[0] != A_host.shape[0]:
            V_l = V_l.T
        if qmax <= 0 and int(amg_args.interp_vec_variant) == 2:
            qmax = 4

    def smoothers(A_l, fmask=None):
        sm = _smoother_arrays(kind, A_l, dtype, device, rlx.chebyshev,
                              weight, fmask)
        if up_kind == kind:
            return sm, None, None
        return sm, up_kind, _smoother_arrays(up_kind, A_l, dtype, device,
                                             rlx.chebyshev, weight, fmask)

    levels: List[AMGLevel] = []
    A_l = sp.csr_matrix(A_host)
    func_l = dof_func if num_functions > 1 else None
    n_real = A_l.shape[0]   # unpadded level size (pad rows do not count
                            # toward the min/max_coarse termination checks)
    for lvl in range(max_levels - 1):
        if n_real <= max_coarse or (min_coarse and n_real <= min_coarse):
            break
        n = A_l.shape[0]
        S = strength_graph(A_l, theta=theta, sabs=sabs, dof_func=func_l)
        if S.nnz == 0:
            break
        cf = coarsen(S, ctype=int(csn.type), seed=lvl + seed_base)
        nC = int((cf > 0).sum())
        if nC == 0 or nC >= n:
            break
        if lvl < agg_levels and restriction_type == 0 and nC > max_coarse:
            # aggressive coarsening: a second PMIS pass fused into this
            # level (ref: amg.c:330-347)
            P, cf = _aggressive_interpolation(
                A_l, S, cf, itp, lvl + seed_base, ctype=int(csn.type),
                theta=theta, sabs=sabs, func_l=func_l,
                trunc_factor=(agg_trunc if agg_trunc > 0
                              else float(itp.trunc_factor)),
                max_nnz_row=(agg_pmax if agg_pmax > 0
                             else int(itp.max_nnz_row)))
        else:
            P = build_interpolation(
                A_l, S, cf,
                prolongation_type=int(itp.prolongation_type),
                trunc_factor=float(itp.trunc_factor),
                max_nnz_row=int(itp.max_nnz_row))
        if V_l is not None:
            from .rbm import augment_interpolation

            P, V_c = augment_interpolation(P, cf, V_l, A=A_l, qmax=qmax)
        R_air = build_restriction(A_l, cf, restriction_type, restrict_th,
                                  restrict_filter)
        R = R_air if R_air is not None else sp.csr_matrix(P.T)
        A_c = _galerkin_rap(A_l, P, R_air)
        # the F-point mask of this level as padded: the previous level's
        # identity pad rows are isolated points, hence F
        fmask = (cf < 0).astype(np.float64) if masked else None
        nC_real = A_c.shape[0]
        npad_c = _bucket_rows(nC_real)
        if npad_c > nC_real:
            A_c, P, R = _pad_level(A_c, P, R, npad_c)

        E = (fine_matrix if lvl == 0 and fine_matrix is not None
             else EllMatrix.from_csr(A_l, dtype=dtype, device=device))
        if lvl < fsai_levels:
            sm = _fsai_smoother(A_l, amg_args.smoother.fsai, dtype, device)
            lvl_kind, lvl_pre, lvl_post = "fsai", fsai_sweeps, fsai_sweeps
            up_k = up_sm = None
        else:
            sm, up_k, up_sm = smoothers(A_l, fmask)
            lvl_kind, lvl_pre, lvl_post = kind, pre, post
        levels.append(AMGLevel(
            A=E,
            P=EllMatrix.from_csr(P, dtype=dtype, device=device),
            R=EllMatrix.from_csr(R, dtype=dtype, device=device),
            smooth_arrays=sm, smoother=lvl_kind,
            pre_sweeps=lvl_pre, post_sweeps=lvl_post,
            up_smoother=up_k, up_arrays=up_sm,
        ))
        if func_l is not None:
            # the coarse level's functions are its C points' (pad rows 0)
            func_l = func_l[cf > 0]
            if npad_c > nC_real:
                func_l = np.concatenate(
                    [func_l, np.zeros(npad_c - nC_real, func_l.dtype)])
        if V_l is not None:
            V_l = V_c
            if npad_c > nC_real:
                V_l = np.vstack([V_l, np.zeros((npad_c - nC_real,
                                                V_l.shape[1]))])
        A_l = A_c
        n_real = nC_real
        if nC_real <= max_coarse:
            break

    # coarsest level: dense inverse (ref coarse_type 9 = GE), uploaded once
    sm_c, _, _ = smoothers(A_l)
    levels.append(AMGLevel(
        A=EllMatrix.from_csr(A_l, dtype=dtype, device=device),
        P=None, R=None, smooth_arrays=sm_c,
        smoother=kind, pre_sweeps=pre, post_sweeps=post,
    ))
    dense = np.asarray(A_l.todense(), dtype=np.float64)
    try:
        inv = np.linalg.inv(dense)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(dense)

    return AMGState(
        levels=tuple(levels),
        coarse_inv=torch.as_tensor(inv, dtype=dtype, device=device),
        cycle_type=0 if int(getattr(amg_args, "cycle_type", 1)) <= 1 else 1,
        max_iter=max(1, int(amg_args.max_iter)),
    )


def hierarchy_summary(state: AMGState) -> str:
    lines = ["AMG hierarchy:"]
    for i, lv in enumerate(state.levels):
        n = lv.A.shape[0]
        lines.append(
            f"  level {i}: n={n} nnz={lv.A.nnz} smoother={lv.smoother} "
            f"(pre={lv.pre_sweeps}, post={lv.post_sweeps})")
    return "\n".join(lines)
