"""Preconditioned conjugate gradient.

Option surface parity with the reference PCG args (ref: src/internal/
pcg.c:16-27): max_iter, two_norm, relative/absolute tolerances,
recompute_res.  Classical PCG recurrence (hypre_PCGSolve semantics):
convergence on ||r||₂ ≤ max(rtol·||b||₂, atol) when two_norm (the
reference default), else on the M-inner-product norm √⟨r,z⟩.

Counterpart of ``hypredrive_tpu/solvers/pcg.py::_pcg_core``, run by the
device loop (``device_loop.py``): a start body and one iteration body,
masked once converged; on a card each is one CUDA graph, replayed once an
iteration, and the convergence test is decided on the card.  With
``recompute_res`` the iterations that recompute the exact residual are a
second body, so each graph knows its variant.
"""

from __future__ import annotations

import math

import torch

from ..ops.vectors import FROM_OPERATOR, group_of, reductions
from . import device_loop as dl
from .base import Solver


def pcg_core(matvec, precon, b, x0, rtol: float, atol: float,
             max_iter: int, two_norm: bool, recompute_res: int, *,
             unroll: bool = False, group=FROM_OPERATOR):
    """(x, iters, final norm, converged, history of max_iter+1 norms,
    NaN past the last iteration).  ``unroll`` runs the whole budget with
    no host read (a solve nested in a captured body); then the count,
    norm, flag and history stay device tensors.  ``group`` is the process
    group the dots are summed over (``ops.vectors.group_of``: by default
    the mesh's of a bound ``matvec``)."""
    n = b.shape[0]
    # on a mesh across ranks every reduction is summed over its group
    group = group_of(matvec, group)
    dot, norm2 = reductions(group)

    def norm_of(r, gamma):
        return norm2(r) if two_norm else torch.sqrt(torch.abs(gamma))

    def make():
        L = dl.Loop(b)
        L.b, L.x0, L.x, L.r, L.p = (L.vec(n) for _ in range(5))
        L.gamma, L.norm, L.thr = L.scalar(), L.scalar(), L.scalar()
        L.zero, L.one = L.scalar(), L.scalar(fill=1)
        L.i = L.scalar(torch.int64)
        L.done, L.stop = L.flag(), L.flag()
        L.hist = L.vec(max_iter + 1)

        @L.body("start")
        def start():
            L.x.copy_(L.x0)
            r = L.b - matvec(L.x)
            z = precon(r)
            gamma = dot(r, z)
            b_norm = norm2(L.b)
            r_norm0 = norm_of(r, gamma)
            # hypre semantics: if ||b|| == 0, scale by ||r0|| instead
            denom = torch.where(b_norm > 0, b_norm,
                                torch.where(r_norm0 > 0, r_norm0, L.one))
            L.thr.copy_(torch.maximum(rtol * L.one * denom, atol * L.one))
            L.r.copy_(r)
            L.p.copy_(z)
            L.gamma.copy_(gamma)
            L.norm.copy_(r_norm0)
            L.hist.fill_(math.nan)
            L.hist[:1].copy_(r_norm0.reshape(1))
            L.i.zero_()
            L.done.copy_(r_norm0 <= L.thr)
            L.stop.copy_(L.done | (max_iter <= 0))

        def iterate(recompute: bool):
            active = ~L.done
            s = matvec(L.p)
            sp = dot(s, L.p)
            # guard against breakdown; a masked iteration steps by 0
            alpha = torch.where(active & (sp != 0), L.gamma / sp, L.zero)
            L.x.add_(alpha * L.p)
            r = L.r - alpha * s
            if recompute:
                # exact-residual recomputation (ref: recompute_res option)
                r = torch.where(active, L.b - matvec(L.x), r)
            z = precon(r)
            gamma_new = dot(r, z)
            beta = torch.where(L.gamma != 0, gamma_new / L.gamma, L.zero)
            norm = norm_of(r, gamma_new)
            L.r.copy_(r)
            dl.keep(L.p, z + beta * L.p, active)
            dl.keep(L.gamma, gamma_new, active)
            dl.keep(L.norm, norm, active)
            dl.put(L.hist, torch.clamp(L.i + 1, max=max_iter), norm, active)
            dl.keep(L.done, norm <= L.thr, active)
            L.i.add_(active.long())
            L.stop.copy_(L.done | (L.i >= max_iter))

        L.body("step")(lambda: iterate(False))
        if recompute_res:
            L.body("step_r")(lambda: iterate(True))
        return L

    def schedule(R, L):
        R.go("start")
        R.mark(L.stop)
        for t in range(max_iter):
            R.go("step_r" if recompute_res and (t + 1) % recompute_res == 0
                 else "step")
            R.mark(L.stop)
            if R.stopped():
                break

    key = ("pcg", float(rtol), float(atol), int(max_iter), bool(two_norm),
           int(recompute_res), b.dtype, n, group)
    L, mode = dl.run(key, (matvec, precon), make, {"b": b, "x0": x0},
                     schedule, unroll, group)
    x, (hist,), (i, norm, done) = dl.read_out(L.x, [L.hist],
                                              [L.i, L.norm, L.done], mode)
    if mode == "unroll":
        return x, i, norm, done, hist
    return x, int(i), norm, bool(done), hist


class PCGSolver(Solver):
    method = "pcg"

    def solve_core(self, A, b, x0):
        a = self.args
        return (*pcg_core(A.matvec, self.precon_fn(), b, x0,
                          float(a.relative_tol), float(a.absolute_tol),
                          int(a.max_iter), bool(a.two_norm),
                          int(a.recompute_res)), None)
