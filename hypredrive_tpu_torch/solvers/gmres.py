"""Restarted GMRES(m), left-preconditioned (hypre convention), and the
restarted Arnoldi loop it shares with FGMRES.

Counterpart of ``hypredrive_tpu/solvers/gmres.py::_gmres_core``, with the
same option surface (ref: src/internal/gmres.c:16-27) and the same
stopping contract: the inner test runs on the rotation-estimated
preconditioned residual against the cycle-start β scaled by the factor the
true residual still needs; the outer check recomputes the true residual
unless ``skip_real_res_check``; a cycle that makes no step ends the solve.
A cycle runs to m steps or inner convergence even when that passes
``max_iter``, as the JAX package's inner ``while_loop`` does; history
entries past ``max_iter`` are dropped.

The loop runs on the device (``device_loop.py``) as four kinds of body:
the solve's start, a cycle's start, inner step j (one body per j, so each
knows its basis length) and a cycle's end.  On a card each is one CUDA
graph: one replay per inner step, one for each cycle's start and end.
Modified Gram-Schmidt stays on the device; the Givens update and the
back-substitution are two small CUDA kernels (``ops/krylov_small.py``),
in the solve's dtype.

With a reference solution set (``xref``), every inner step also rebuilds
its iterate (the back-substitution and one combination of the basis) and
records the error norm ‖x_k − xref‖ of each dof block, the blocks being
the dofmap's labels (one block without a dofmap): the JAX package's
tagged histories (ref: hypredrv_GMRESSetRefSolution,
src/internal/gmres.c:80-103).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.krylov_small import givens_update, hessenberg_backsolve
from ..ops.vectors import FROM_OPERATOR, group_of, reductions
from . import device_loop as dl
from .base import Solver


def device_threshold(b_norm, r0_norm, rtol: float, atol: float, one):
    """max(rtol·denom, atol) in the solve's dtype on the device; denom is
    ‖b‖, else ‖r0‖, else 1 (hypre semantics)."""
    denom = torch.where(b_norm > 0, b_norm,
                        torch.where(r0_norm > 0, r0_norm, one))
    return torch.maximum(rtol * one * denom, atol * one)


def block_errors(x, xref, tags, num_tags: int):
    """‖x − xref‖ per tag: a segment sum of squares on the device."""
    e = x - xref
    ss = torch.zeros(num_tags, dtype=x.dtype, device=x.device)
    ss.index_add_(0, tags, e * e)
    return torch.sqrt(ss)


def arnoldi_core(matvec, precon, b, x0, rtol: float, atol: float,
                 max_iter: int, m: int, *, flexible: bool,
                 skip_real_res_check: bool = False, xref=None, tags=None,
                 num_tags: int = 0, unroll: bool = False,
                 group=FROM_OPERATOR):
    """Restarted GMRES (``flexible`` False: left-preconditioned, inner
    test against the factor-scaled β) or FGMRES (True: right-
    preconditioned with the Z basis, inner test against the threshold).
    Returns (x, iters, final norm, converged, history, error history or
    None); in ``unroll`` mode the whole budget runs with no host read and
    the count, norm, flag and histories stay device tensors.  The dots are
    summed over ``group`` (``ops.vectors.group_of``)."""
    n = b.shape[0]
    # on a mesh across ranks every reduction is summed over its group
    group = group_of(matvec, group)
    dot, norm2 = reductions(group)
    tagged = num_tags > 0

    def make():
        L = dl.Loop(b)
        L.b, L.x0, L.x = L.vec(n), L.vec(n), L.vec(n)
        # zeroed once: a masked combination multiplies rows past j by 0
        L.V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        L.Z = (torch.zeros((m, n), dtype=b.dtype, device=b.device)
               if flexible else None)
        L.H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        L.cs, L.sn, L.y, L.g = L.vec(m), L.vec(m), L.vec(m), L.vec(m + 1)
        (L.thr, L.r_true, L.inner_thr, L.norm, L.zero) = (
            L.scalar() for _ in range(5))
        L.one = L.scalar(fill=1)
        L.total, L.j = L.scalar(torch.int64), L.scalar(torch.int64)
        L.outer_done, L.outer_stop = L.flag(), L.flag()
        L.cyc_active, L.inner_done = L.flag(), L.flag()
        L.hist = L.vec(max_iter + 1)
        if tagged:
            L.xref = L.vec(n)
            L.tags = L.vec(n, torch.int64)
            L.ehist = torch.zeros((max_iter + 1, num_tags), dtype=b.dtype,
                                  device=b.device)

        @L.body("solve")
        def solve_start():
            L.x.copy_(L.x0)
            r0_norm = norm2(L.b - matvec(L.x))
            L.thr.copy_(device_threshold(norm2(L.b), r0_norm, rtol, atol,
                                         L.one))
            L.hist.fill_(math.nan)
            L.hist[:1].copy_(r0_norm.reshape(1))
            if tagged:
                L.ehist.fill_(math.nan)
                L.ehist[0].copy_(block_errors(L.x, L.xref, L.tags,
                                              num_tags))
            L.total.zero_()
            L.r_true.copy_(r0_norm)
            L.outer_done.copy_(r0_norm <= L.thr)
            L.outer_stop.copy_(L.outer_done | (max_iter <= 0))

        @L.body("cycle")
        def cycle_start():
            active = ~L.outer_stop
            r = L.b - matvec(L.x)
            if not flexible:
                r = precon(r)
            beta = norm2(r)
            if flexible:
                inner_thr = L.thr
            else:
                # shrink the preconditioned estimate by the factor the
                # TRUE residual still needs
                factor = torch.where(L.r_true > 0, L.thr / L.r_true, L.one)
                inner_thr = beta * torch.minimum(factor, L.one)
            dl.keep(L.V[0], torch.where(beta > 0, r / beta, r), active)
            for t in (L.H, L.cs, L.sn, L.g, L.j):
                t.masked_fill_(active, 0)
            dl.keep(L.g[0], beta, active)
            dl.keep(L.inner_thr, inner_thr, active)
            dl.keep(L.norm, beta, active)
            dl.keep(L.inner_done, beta <= inner_thr, active)
            L.cyc_active.copy_(active)

        def step(j: int):
            active = L.cyc_active & ~L.inner_done
            if flexible:
                z = precon(L.V[j])
                dl.keep(L.Z[j], z, active)
                w = matvec(z)
            else:
                w = precon(matvec(L.V[j]))
            # modified Gram-Schmidt against V[0..j]
            hs = []
            for i in range(j + 1):
                h = dot(L.V[i], w)
                w = torch.addcmul(w, L.V[i], h, value=-1.0)
                hs.append(h)
            h_next = norm2(w)
            hs.append(h_next)
            dl.keep(L.V[j + 1], torch.where(h_next > 0, w / h_next, w),
                    active)
            givens_update(L.H, L.cs, L.sn, L.g, torch.stack(hs), j, active,
                          L.norm, L.inner_thr, L.inner_done, L.hist, L.total)
            L.j.add_(active.long())
            if tagged:
                # the current iterate from the updated Hessenberg
                hessenberg_backsolve(L.H, L.g, L.y, L.j, active)
                e = block_errors(L.x + torch.matmul(L.y, L.V[:m]), L.xref,
                                 L.tags, num_tags)
                k = L.total + L.j
                dl.put(L.ehist, torch.clamp(k, max=max_iter), e,
                       active & (k <= max_iter))

        # step j > 0 runs step 0's operations over a longer basis
        for j in range(m):
            L.body(f"step{j}", warm=j == 0)(lambda j=j: step(j))

        @L.body("end")
        def cycle_end():
            active = L.cyc_active
            hessenberg_backsolve(L.H, L.g, L.y, L.j, active)
            L.x.add_(torch.matmul(L.y, L.Z if flexible else L.V[:m]))
            L.total.add_(torch.where(active, L.j, 0))
            if skip_real_res_check:
                # trust the inner estimate (ref: hypre skip_real_r_norm_check)
                norm, done = L.norm, L.inner_done
            else:
                # real-residual check in TRUE units (ref: hypre GMRES
                # "false convergence" guard)
                norm = norm2(L.b - matvec(L.x))
                done = norm <= L.thr
            # no progress this cycle → breakdown, stop
            dl.keep(L.r_true, norm, active)
            dl.keep(L.outer_done, done | (L.j == 0), active)
            L.outer_stop.copy_(L.outer_done | (L.total >= max_iter))
        return L

    # every cycle but the last makes m steps in an unrolled solve: a
    # shorter one converged, which ends a solve that trusts its inner
    # estimate (the nested callers); otherwise each cycle makes one step
    # at least, so max_iter cycles bound the solve
    cycles = -(-max_iter // m) if unroll else max_iter

    def schedule(R, L):
        R.go("solve")
        R.mark(L.outer_stop)
        for _ in range(cycles):
            R.go("cycle")
            R.mark(L.inner_done)
            if R.stopped():
                break
            for j in range(m):
                R.go(f"step{j}")
                if j + 1 < m:
                    R.mark(L.inner_done)
                if R.stopped():
                    break
            R.go("end")
            R.mark(L.outer_stop)

    key = ("fgmres" if flexible else "gmres", float(rtol), float(atol),
           int(max_iter), int(m), bool(skip_real_res_check), num_tags,
           b.dtype, n, group)
    inputs = {"b": b, "x0": x0}
    if tagged:
        inputs.update(xref=xref, tags=tags)
    L, mode = dl.run(key, (matvec, precon), make, inputs, schedule, unroll,
                     group)
    arrays = [L.hist] + ([L.ehist] if tagged else [])
    x, hists, (total, norm, done) = dl.read_out(
        L.x, arrays, [L.total, L.r_true, L.outer_done], mode)
    ehist = hists[1] if tagged else None
    if mode == "unroll":
        return x, total, norm, done, hists[0], ehist
    return x, int(total), norm, bool(done), hists[0], ehist


def gmres_core(matvec, precon, b, x0, rtol: float, atol: float,
               max_iter: int = 300, m: int = 30,
               skip_real_res_check: bool = False, xref=None, tags=None,
               num_tags: int = 0, *, unroll: bool = False,
               group=FROM_OPERATOR):
    """(x, iters, final norm, converged, history of max_iter+1 norms, NaN
    past the last iteration, per-block error history): the last is the
    (max_iter+1, num_tags) error history against ``xref`` (int64 ``tags``
    per row) with ``num_tags`` > 0, else None."""
    return arnoldi_core(matvec, precon, b, x0, rtol, atol, max_iter, m,
                        flexible=False,
                        skip_real_res_check=skip_real_res_check, xref=xref,
                        tags=tags, num_tags=num_tags, unroll=unroll,
                        group=group)


class GMRESSolver(Solver):
    method = "gmres"

    def solve_core(self, A, b, x0):
        a = self.args
        tagged = {}
        system = getattr(self, "_system", None)
        if system is not None and system.xref is not None:
            # tagged reference-solution errors, one tag without a dofmap
            labels = (np.asarray(system.dofmap) if system.dofmap is not None
                      else np.zeros(b.shape[0], np.int64))
            tagged = dict(xref=system.xref.to(b.dtype), num_tags=int(
                labels.max()) + 1, tags=torch.as_tensor(
                    labels, dtype=torch.int64, device=b.device))
        return gmres_core(A.matvec, self.precon_fn(), b, x0,
                          float(a.relative_tol), float(a.absolute_tol),
                          int(a.max_iter), int(a.krylov_dim),
                          bool(a.get("skip_real_res_check", False)), **tagged)
