"""Flexible GMRES (right-preconditioned; the preconditioner may change per
iteration, as nested-Krylov MGR components make it).

Counterpart of ``hypredrive_tpu/solvers/fgmres.py::_fgmres_core`` (option
parity: ref src/internal/fgmres.c:16-23).  Keeps the Z basis of
preconditioned directions beside V, so x is rebuilt from Z (Saad's
FGMRES).  The inner test is on the rotation estimate of the true residual;
each cycle ends with a true-residual check.  Device/host split as in
``gmres.py``: one host read per inner iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vectors import norm2
from .base import Solver
from .gmres import (back_substitute, combine, givens_step, host_dtype,
                    mgs_column, residual_threshold)


def fgmres_core(matvec, precon, b, x0, rtol: float, atol: float,
                max_iter: int, m: int):
    """(x, iters, final norm, converged, history of max_iter+1 norms)."""
    hdt = host_dtype(b)
    n = b.shape[0]
    r0_norm, threshold = residual_threshold(b, b - matvec(x0), rtol, atol,
                                            hdt)
    history = np.full(max_iter + 1, np.nan)
    history[0] = r0_norm
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
    Z = torch.empty((m, n), dtype=b.dtype, device=b.device)

    def cycle(x, total):
        r = b - matvec(x)
        beta_t = norm2(r)
        beta = hdt(beta_t.item())
        if beta > 0:
            torch.div(r, beta_t, out=V[0])
        else:
            V[0].copy_(r)
        H = np.zeros((m + 1, m), hdt)
        cs, sn = np.zeros(m, hdt), np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j, done = 0, beta <= threshold
        while j < m and not done:
            Z[j].copy_(precon(V[j]))
            w = matvec(Z[j])
            H[:j + 2, j] = mgs_column(V, w, j)
            norm = givens_step(H, cs, sn, g, j)
            if total + j + 1 <= max_iter:
                history[total + j + 1] = norm
            j += 1
            done = norm <= threshold
        y = back_substitute(H, g, j)
        return x + combine(y, Z, j), j

    x, total, norm = x0, 0, r0_norm
    done = r0_norm <= threshold
    while total < max_iter and not done:
        x, j = cycle(x, total)
        total += j
        norm = hdt(norm2(b - matvec(x)).item())
        done = norm <= threshold or j == 0
    return x, total, float(norm), bool(done), history


class FGMRESSolver(Solver):
    method = "fgmres"

    def solve_core(self, A, b, x0):
        a = self.args
        return (*fgmres_core(A.matvec, self.precon_apply, b, x0,
                             float(a.relative_tol), float(a.absolute_tol),
                             int(a.max_iter), int(a.krylov_dim)), None)
