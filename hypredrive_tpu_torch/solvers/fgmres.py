"""Flexible GMRES (right-preconditioned; the preconditioner may change per
iteration, as nested-Krylov MGR components make it).

Counterpart of ``hypredrive_tpu/solvers/fgmres.py::_fgmres_core`` (option
parity: ref src/internal/fgmres.c:16-23).  Keeps the Z basis of
preconditioned directions beside V, so x is rebuilt from Z (Saad's
FGMRES).  The inner test is on the rotation estimate of the true residual;
each cycle ends with a true-residual check.  It is the restarted Arnoldi
loop of ``gmres.py`` on the device loop, with the flexible variant.
"""

from __future__ import annotations

from ..ops.vectors import FROM_OPERATOR
from .base import Solver
from .gmres import arnoldi_core


def fgmres_core(matvec, precon, b, x0, rtol: float, atol: float,
                max_iter: int, m: int, *, unroll: bool = False,
                group=FROM_OPERATOR):
    """(x, iters, final norm, converged, history of max_iter+1 norms)."""
    return arnoldi_core(matvec, precon, b, x0, rtol, atol, max_iter, m,
                        flexible=True, unroll=unroll, group=group)[:5]


class FGMRESSolver(Solver):
    method = "fgmres"

    def solve_core(self, A, b, x0):
        a = self.args
        return (*fgmres_core(A.matvec, self.precon_fn(), b, x0,
                             float(a.relative_tol), float(a.absolute_tol),
                             int(a.max_iter), int(a.krylov_dim)), None)
