"""V/W multigrid cycles on the device.

Counterpart of ``hypredrive_tpu/precon/amg/cycle.py``.  Eager torch: each
smoother step is a matvec (DIA + CSR kernels, or ``torch.mv`` on the dense
coarse levels) and a few vector ops; grid transfers are the same matvec,
and the coarsest solve is a dense matvec with the uploaded inverse.
``torch.profiler.record_function`` spans ``amg_L{l}_pre/restrict/post``
group device time per level and phase in a profiler trace.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .hierarchy import GS_TRI_ITERS, AMGLevel, AMGState


def _tri_jacobi(d_inv, T, r):
    """z ≈ (D + T)⁻¹ r by Jacobi iteration (T strictly triangular) — the
    matvec-shaped triangular solve (ref: ilu.h tri_solve=off,
    lower/upper_jac_iters)."""
    z = d_inv * r
    for _ in range(GS_TRI_ITERS):
        z = d_inv * (r - T.matvec(z))
    return z


def _smooth(level: AMGLevel, x, b, sweeps: int, phase: str = "pre",
            zero_guess: bool = False):
    """sweeps × (x += B(b − Ax)) with the level's smoother.

    ``phase`` matters only for the C/F and AIR schedules (ref:
    amg.c:895, :986-1015).  ``zero_guess`` marks x == 0 on entry: the first
    sweep's residual is then just b, saving one A-matvec per level per
    cycle.
    """
    if sweeps <= 0:
        return x
    A = level.A

    def resid(x, first):
        # b − A·x, with A·0 elided on the first sweep of a zero guess
        if first and zero_guess:
            return b
        return b - A.matvec(x)

    kind = level.smoother
    arrays = level.smooth_arrays
    if phase == "post" and level.up_smoother is not None:
        kind = level.up_smoother
        arrays = level.up_arrays
    if kind == "fsai":
        # complex smoother (ref: amg.c:441-457): x += ω Gᵀ G (b − A x)
        G, GT, omega = arrays
        for i in range(sweeps):
            x = x + omega * GT.matvec(G.matvec(resid(x, i == 0)))
        return x
    if kind in ("gs-fwd", "gs-bwd", "gs-sym"):
        # hybrid Gauss-Seidel: x += (D+L)⁻¹(b−Ax) with Jacobi-iterated
        # triangular solves (ref: amg.c relax types 3/4/6/8/13/14/89)
        d_inv, L, U = arrays
        for i in range(sweeps):
            if kind in ("gs-fwd", "gs-sym"):
                x = x + _tri_jacobi(d_inv, L, resid(x, i == 0))
            if kind in ("gs-bwd", "gs-sym"):
                x = x + _tri_jacobi(d_inv, U,
                                    resid(x, i == 0 and kind == "gs-bwd"))
        return x
    if kind.startswith("cf-"):
        # relaxation.order = 1 (hypre BoomerAMGSetRelaxOrder): C points
        # then F on the down sweep, F then C on the up sweep, each half
        # against the refreshed residual (ref: amg.c:895)
        d_inv, fmask = arrays
        cmask = 1.0 - fmask
        first, second = ((fmask, cmask) if phase == "post"
                         else (cmask, fmask))
        for k in range(sweeps):
            x = x + first * d_inv * resid(x, k == 0)
            x = x + second * d_inv * resid(x, False)
        return x
    if kind.startswith("air-"):
        # AIR schedule (ref: amg.c:986-1015): the down sweeps relax every
        # point; the up sweeps relax F points, and the last one relaxes C
        # points instead when there are more than two
        d_inv, fmask = arrays
        for k in range(sweeps):
            if phase != "post":
                x = x + d_inv * resid(x, k == 0)
                continue
            mask = (1.0 - fmask) if (sweeps > 2 and k == sweeps - 1) \
                else fmask
            x = x + mask * d_inv * resid(x, k == 0)
        return x
    if kind == "chebyshev":
        d_inv, theta, delta, rhos = arrays
        for i in range(sweeps):
            # Chebyshev on the residual equation A e = r, x += e
            r = resid(x, i == 0)
            z = d_inv * r / theta
            d = z
            rho_prev = rhos[0]
            for k in range(1, len(rhos)):
                rk = d_inv * (r - A.matvec(z))
                d = rhos[k] * rho_prev * d + (2.0 * rhos[k] / delta) * rk
                z = z + d
                rho_prev = rhos[k]
            x = x + z
        return x
    (d_inv,) = arrays   # jacobi, l1-jacobi
    for i in range(sweeps):
        x = x + d_inv * resid(x, i == 0)
    return x


def _cycle(state: AMGState, lvl: int, b):
    """One multigrid cycle on level lvl for A_l e = b, e₀ = 0."""
    levels = state.levels
    level = levels[lvl]
    if lvl == len(levels) - 1:
        return torch.mv(state.coarse_inv, b)

    with record_function(f"amg_L{lvl}_pre"):
        x = torch.zeros_like(b)
        x = _smooth(level, x, b, level.pre_sweeps, phase="pre",
                    zero_guess=True)
        r = b - level.A.matvec(x)
    with record_function(f"amg_L{lvl}_restrict"):
        rc = level.R.matvec(r)
    ec = _cycle(state, lvl + 1, rc)
    if state.cycle_type == 1 and lvl + 1 < len(levels) - 1:
        # W-cycle: second coarse visit
        rc2 = rc - levels[lvl + 1].A.matvec(ec)
        ec = ec + _cycle(state, lvl + 1, rc2)
    with record_function(f"amg_L{lvl}_post"):
        x = x + level.P.matvec(ec)
        x = _smooth(level, x, b, level.post_sweeps, phase="post")
    return x


def amg_apply(state: AMGState, r):
    """z ≈ A⁻¹ r: max_iter cycles (preconditioner default 1)."""
    z = _cycle(state, 0, r)
    for _ in range(state.max_iter - 1):
        resid = r - state.levels[0].A.matvec(z)
        z = z + _cycle(state, 0, resid)
    return z
