"""BiCGSTAB (van der Vorst), preconditioned.

Counterpart of ``hypredrive_tpu/solvers/bicgstab.py::_bicgstab_core``
(option parity: ref src/internal/bicgstab.c:16-24).  Convergence on
‖r‖₂ ≤ max(rtol·‖b‖₂, atol), the hypre BiCGSTAB contract; ω = 0 ends the
solve.  Run by the device loop (``device_loop.py``): a start body and one
iteration body, masked once converged; on a card each is one CUDA graph,
replayed once an iteration, and both stops are decided on the card.
"""

from __future__ import annotations

import math

import torch

from ..ops.vectors import FROM_OPERATOR, group_of, reductions
from . import device_loop as dl
from .base import Solver
from .gmres import device_threshold


def bicgstab_core(matvec, precon, b, x0, rtol: float, atol: float,
                  max_iter: int, *, unroll: bool = False,
                  group=FROM_OPERATOR):
    """(x, iters, final norm, converged, history of max_iter+1 norms);
    the dots are summed over ``group`` (``ops.vectors.group_of``)."""
    n = b.shape[0]
    # on a mesh across ranks every reduction is summed over its group
    group = group_of(matvec, group)
    dot, norm2 = reductions(group)

    def make():
        L = dl.Loop(b)
        L.b, L.x0, L.x, L.r, L.r_hat, L.p, L.v = (L.vec(n) for _ in range(7))
        L.rho, L.alpha, L.omega, L.norm, L.thr, L.zero = (
            L.scalar() for _ in range(6))
        L.one = L.scalar(fill=1)
        L.i = L.scalar(torch.int64)
        L.done, L.stop = L.flag(), L.flag()
        L.hist = L.vec(max_iter + 1)

        @L.body("start")
        def start():
            L.x.copy_(L.x0)
            r = L.b - matvec(L.x)
            L.r.copy_(r)
            L.r_hat.copy_(r)     # shadow residual
            r_norm0 = norm2(r)
            L.thr.copy_(device_threshold(norm2(L.b), r_norm0, rtol, atol,
                                         L.one))
            L.p.zero_()
            L.v.zero_()
            for s in (L.rho, L.alpha, L.omega):
                s.fill_(1)
            L.norm.copy_(r_norm0)
            L.hist.fill_(math.nan)
            L.hist[:1].copy_(r_norm0.reshape(1))
            L.i.zero_()
            L.done.copy_(r_norm0 <= L.thr)
            L.stop.copy_(L.done | (max_iter <= 0))

        @L.body("step")
        def step():
            active = ~L.done
            rho_new = dot(L.r_hat, L.r)
            beta = torch.where((L.rho != 0) & (L.omega != 0),
                               (rho_new / L.rho) * (L.alpha / L.omega),
                               L.zero)
            p = L.r + beta * (L.p - L.omega * L.v)
            p_hat = precon(p)
            v = matvec(p_hat)
            rhv = dot(L.r_hat, v)
            alpha = torch.where(rhv != 0, rho_new / rhv, L.zero)
            # a masked iteration steps x and r by 0
            a_eff = torch.where(active, alpha, L.zero)
            s = L.r - a_eff * v
            s_hat = precon(s)
            t = matvec(s_hat)
            tt = dot(t, t)
            omega = torch.where(tt != 0, dot(t, s) / tt, L.zero)
            o_eff = torch.where(active, omega, L.zero)
            L.x.add_(a_eff * p_hat)
            L.x.add_(o_eff * s_hat)
            r = s - o_eff * t
            L.r.copy_(r)
            norm = norm2(r)
            for dst, new in ((L.p, p), (L.v, v), (L.rho, rho_new),
                             (L.alpha, alpha), (L.omega, omega),
                             (L.norm, norm)):
                dl.keep(dst, new, active)
            dl.put(L.hist, torch.clamp(L.i + 1, max=max_iter), norm, active)
            dl.keep(L.done, (norm <= L.thr) | (omega == 0), active)
            L.i.add_(active.long())
            L.stop.copy_(L.done | (L.i >= max_iter))
        return L

    def schedule(R, L):
        R.go("start")
        R.mark(L.stop)
        for _ in range(max_iter):
            R.go("step")
            R.mark(L.stop)
            if R.stopped():
                break

    key = ("bicgstab", float(rtol), float(atol), int(max_iter), b.dtype, n,
           group)
    L, mode = dl.run(key, (matvec, precon), make, {"b": b, "x0": x0},
                     schedule, unroll, group)
    x, (hist,), (i, norm, done) = dl.read_out(L.x, [L.hist],
                                              [L.i, L.norm, L.done], mode)
    if mode == "unroll":
        return x, i, norm, done, hist
    return x, int(i), norm, bool(done), hist


class BiCGSTABSolver(Solver):
    method = "bicgstab"

    def solve_core(self, A, b, x0):
        a = self.args
        return (*bicgstab_core(A.matvec, self.precon_fn(), b, x0,
                               float(a.relative_tol), float(a.absolute_tol),
                               int(a.max_iter)), None)
