"""Preconditioned conjugate gradient.

Option surface parity with the reference PCG args (ref: src/internal/
pcg.c:16-27): max_iter, two_norm, relative/absolute tolerances,
recompute_res.  Classical PCG recurrence (hypre_PCGSolve semantics):
convergence on ||r||₂ ≤ max(rtol·||b||₂, atol) when two_norm (the
reference default), else on the M-inner-product norm √⟨r,z⟩.

The loop runs in Python; the scalars stay on the device, and the
convergence test reads one norm to the host per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vectors import dot, norm2
from .base import Solver


def pcg_core(matvec, precon, b, x0, rtol: float, atol: float,
             max_iter: int, two_norm: bool, recompute_res: int):
    """(x, iters, final norm, converged, history of max_iter+1 norms,
    NaN past the last iteration)."""
    def norm_of(r, gamma):
        return norm2(r) if two_norm else torch.sqrt(torch.abs(gamma))

    r = b - matvec(x0)
    z = precon(r)
    gamma = dot(r, z)
    b_norm = norm2(b)
    r_norm0 = norm_of(r, gamma)
    # hypre semantics: if ||b|| == 0, scale by ||r0|| instead
    one = torch.ones((), dtype=b.dtype, device=b.device)
    denom = torch.where(b_norm > 0, b_norm,
                        torch.where(r_norm0 > 0, r_norm0, one))
    threshold = float(torch.maximum(rtol * one * denom, atol * one))

    norm = float(r_norm0)
    history = np.full(max_iter + 1, np.nan)
    history[0] = norm
    done = norm <= threshold
    x, p, i = x0, z, 0
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    while i < max_iter and not done:
        s = matvec(p)
        sp = dot(s, p)
        # guard against breakdown
        alpha = torch.where(sp != 0, gamma / sp, zero)
        x = x + alpha * p
        r = r - alpha * s
        # optional exact-residual recomputation (ref: recompute_res option)
        if recompute_res and (i + 1) % recompute_res == 0:
            r = b - matvec(x)
        z = precon(r)
        gamma_new = dot(r, z)
        beta = torch.where(gamma != 0, gamma_new / gamma, zero)
        p = z + beta * p
        gamma = gamma_new
        norm = float(norm_of(r, gamma))
        i += 1
        history[i] = norm
        done = norm <= threshold
    return x, i, norm, done, history


class PCGSolver(Solver):
    method = "pcg"

    def solve_core(self, A, b, x0):
        a = self.args
        return (*pcg_core(A.matvec, self.precon_apply, b, x0,
                          float(a.relative_tol), float(a.absolute_tol),
                          int(a.max_iter), bool(a.two_norm),
                          int(a.recompute_res)), None)
