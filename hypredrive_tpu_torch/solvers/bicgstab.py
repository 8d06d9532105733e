"""BiCGSTAB (van der Vorst), preconditioned.

Counterpart of ``hypredrive_tpu/solvers/bicgstab.py::_bicgstab_core``
(option parity: ref src/internal/bicgstab.c:16-24).  Convergence on
‖r‖₂ ≤ max(rtol·‖b‖₂, atol), the hypre BiCGSTAB contract; ω = 0 ends the
solve.  The scalars stay on the device; each iteration reads ‖r‖ and ω to
the host in one transfer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vectors import dot, norm2
from .base import Solver
from .gmres import host_dtype, residual_threshold


def bicgstab_core(matvec, precon, b, x0, rtol: float, atol: float,
                  max_iter: int):
    """(x, iters, final norm, converged, history of max_iter+1 norms)."""
    hdt = host_dtype(b)
    r = b - matvec(x0)
    r_hat = r   # shadow residual
    r_norm0, threshold = residual_threshold(b, r, rtol, atol, hdt)
    history = np.full(max_iter + 1, np.nan)
    history[0] = r_norm0
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    i, norm, done = 0, r_norm0, r_norm0 <= threshold
    while i < max_iter and not done:
        rho_new = dot(r_hat, r)
        beta = torch.where((rho != 0) & (omega != 0),
                           (rho_new / rho) * (alpha / omega), zero)
        p = r + beta * (p - omega * v)
        p_hat = precon(p)
        v = matvec(p_hat)
        rhv = dot(r_hat, v)
        alpha = torch.where(rhv != 0, rho_new / rhv, zero)
        s = r - alpha * v
        s_hat = precon(s)
        t = matvec(s_hat)
        tt = dot(t, t)
        omega = torch.where(tt != 0, dot(t, s) / tt, zero)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rho = rho_new
        norm, om = (hdt(v_) for v_ in
                    torch.stack([norm2(r), omega]).tolist())
        i += 1
        history[i] = norm
        done = norm <= threshold or om == 0
    return x, i, float(norm), bool(done), history


class BiCGSTABSolver(Solver):
    method = "bicgstab"

    def solve_core(self, A, b, x0):
        a = self.args
        return (*bicgstab_core(A.matvec, self.precon_apply, b, x0,
                               float(a.relative_tol), float(a.absolute_tol),
                               int(a.max_iter)), None)
