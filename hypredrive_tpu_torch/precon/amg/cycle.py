"""V/W multigrid cycles on the device.

Counterpart of ``hypredrive_tpu/precon/amg/cycle.py``.  Eager torch: each
smoother step is a matvec (DIA + CSR kernels, or ``torch.mv`` on the dense
coarse levels) and a few vector ops; grid transfers are the same matvec,
and the coarsest solve is a dense matvec with the uploaded inverse.  The
residuals, the Chebyshev and (ℓ1-)Jacobi steps and the coarse correction
are the level operator's step methods (``ops/epilogue.py``): on a card,
on an ``EllMatrix``, the vector ops run inside the matvec's last kernel.  On a
row-shard mesh the same code runs on ``DistEllMatrix`` levels and the
rank's blocks of padded global vectors (the padded coarsest inverse keeps
pad entries zero); the coarsest solve gathers the coarse residual from
every rank, applies the inverse every rank holds and keeps the rank's
rows, as XLA does for the JAX package's replicated ``coarse_inv``.
"""

from __future__ import annotations

import torch

from ..chebyshev import cheby_steps
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
        return A.residual(b, x)

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
            if i == 0 and zero_guess:
                r, z = b, d_inv * b / theta
            else:
                r, z = A.residual(b, x, d_inv, theta)
            x = cheby_steps(A, d_inv, delta, rhos, r, z, x)
        return x
    (d_inv,) = arrays   # jacobi, l1-jacobi
    for i in range(sweeps):
        x = (x + d_inv * b if i == 0 and zero_guess
             else A.jacobi_step(x, b, d_inv))
    return x


def _cycle(state: AMGState, lvl: int, b):
    """One multigrid cycle on level lvl for A_l e = b, e₀ = 0."""
    levels = state.levels
    level = levels[lvl]
    if lvl == len(levels) - 1:
        mesh = state.mesh
        if mesh is None or mesh.world == 1:
            return torch.mv(state.coarse_inv, b)
        return mesh.local(torch.mv(state.coarse_inv, mesh.gather(b)))

    x = torch.zeros_like(b)
    x = _smooth(level, x, b, level.pre_sweeps, phase="pre", zero_guess=True)
    r = level.A.residual(b, x)
    rc = level.R.matvec(r)
    ec = _cycle(state, lvl + 1, rc)
    if state.cycle_type == 1 and lvl + 1 < len(levels) - 1:
        # W-cycle: second coarse visit
        rc2 = levels[lvl + 1].A.residual(rc, ec)
        ec = ec + _cycle(state, lvl + 1, rc2)
    x = level.P.matvec_add(x, ec)
    x = _smooth(level, x, b, level.post_sweeps, phase="post")
    return x


def amg_apply(state: AMGState, r):
    """z ≈ A⁻¹ r: max_iter cycles (preconditioner default 1)."""
    z = _cycle(state, 0, r)
    for _ in range(state.max_iter - 1):
        resid = state.levels[0].A.residual(r, z)
        z = z + _cycle(state, 0, resid)
    return z
