"""Restarted GMRES(m), left-preconditioned (hypre convention).

Counterpart of ``hypredrive_tpu/solvers/gmres.py::_gmres_core``, with the
same option surface (ref: src/internal/gmres.c:16-27) and the same
stopping contract: the inner test runs on the rotation-estimated
preconditioned residual against the cycle-start β scaled by the factor the
true residual still needs; the outer check recomputes the true residual
unless ``skip_real_res_check``; a cycle that makes no step ends the solve.

The basis V, the matvecs, the preconditioner and the modified Gram-Schmidt
dots stay on the device.  The Hessenberg column (its j+1 dots and
h_{j+1,j}) comes to the host in one read per inner iteration; the Givens
rotations and the back-substitution run there in the solve's dtype, so a
float32 solve rotates in float32 as the JAX package does.

With a reference solution set (``xref``), every inner iteration also
rebuilds its iterate (the host back-substitution and one combination of
the basis on the device) and records the error norm ‖x_k − xref‖ of each
dof block, the blocks being the dofmap's labels (one block without a
dofmap): the JAX package's tagged histories (ref:
hypredrv_GMRESSetRefSolution, src/internal/gmres.c:80-103).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vectors import dot, norm2
from .base import Solver


def host_dtype(t: torch.Tensor):
    """The numpy scalar type of a tensor's dtype (float32 or float64)."""
    return np.float32 if t.dtype == torch.float32 else np.float64


def residual_threshold(b, r0, rtol, atol, hdt):
    """(‖r0‖, max(rtol·denom, atol)) on the host in the solve's dtype;
    denom is ‖b‖, else ‖r0‖, else 1 (hypre semantics).  One device read."""
    b_norm, r0_norm = (hdt(v) for v in
                       torch.stack([norm2(b), norm2(r0)]).tolist())
    one = hdt(1.0)
    denom = b_norm if b_norm > 0 else (r0_norm if r0_norm > 0 else one)
    return r0_norm, max(hdt(rtol) * denom, hdt(atol))


def mgs_column(V, w, j):
    """Modified Gram-Schmidt of w against V[0..j] on the device, w/‖w‖
    into V[j+1]; returns the host column [h_0j .. h_jj, h_{j+1,j}], read
    from the device at once."""
    hs = []
    for i in range(j + 1):
        h = dot(V[i], w)
        w = torch.addcmul(w, V[i], h, value=-1.0)
        hs.append(h)
    h_next = norm2(w)
    hs.append(h_next)
    col = torch.stack(hs).cpu().numpy()
    # normalise into V[j+1] with the device copy of h_{j+1,j}
    if col[-1] > 0:
        torch.div(w, h_next, out=V[j + 1])
    else:
        V[j + 1].copy_(w)
    return col


def givens_step(H, cs, sn, g, j):
    """Apply the previous rotations to column j of H, make the one that
    zeroes H[j+1, j], rotate g; returns |g[j+1]| (the residual estimate).
    Host arithmetic in H's dtype."""
    for i in range(j):
        t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
        H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
        H[i, j] = t
    d = np.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
    c_new = H[j, j] / d if d > 0 else H.dtype.type(1.0)
    s_new = H[j + 1, j] / d if d > 0 else H.dtype.type(0.0)
    H[j, j] = c_new * H[j, j] + s_new * H[j + 1, j]
    H[j + 1, j] = 0.0
    cs[j], sn[j] = c_new, s_new
    g[j + 1] = -s_new * g[j]
    g[j] = c_new * g[j]
    return abs(g[j + 1])


def back_substitute(H, g, j):
    """y solving the leading j×j upper-triangular system H y = g (zero
    where H[k, k] == 0), in H's dtype."""
    m = H.shape[1]
    y = np.zeros(m, H.dtype)
    for k in range(j - 1, -1, -1):
        if H[k, k] != 0:
            y[k] = (g[k] - np.dot(H[k, :], y)) / H[k, k]
    return y


def combine(y, basis, j):
    """Σ_{k<j} y_k basis_k on the device."""
    if j == 0:
        return torch.zeros_like(basis[0])
    yt = torch.as_tensor(y[:j], dtype=basis.dtype, device=basis.device)
    return torch.matmul(yt, basis[:j])


def block_errors(x, xref, tags, num_tags):
    """‖x − xref‖ per tag on the host: a segment sum of squares on the
    device, read back at once."""
    e = x - xref
    ss = torch.zeros(num_tags, dtype=x.dtype, device=x.device)
    ss.index_add_(0, tags, e * e)
    return torch.sqrt(ss).cpu().numpy()


def gmres_core(matvec, precon, b, x0, rtol: float, atol: float,
               max_iter: int = 300, m: int = 30,
               skip_real_res_check: bool = False, xref=None, tags=None,
               num_tags: int = 0):
    """(x, iters, final norm, converged, history of max_iter+1 norms, NaN
    past the last iteration, per-block error history): the last is the
    (max_iter+1, num_tags) error history against ``xref`` (int64 ``tags``
    per row) with ``num_tags`` > 0, else None."""
    hdt = host_dtype(b)
    n = b.shape[0]
    # hypre convention: the convergence contract is on the TRUE residual;
    # the inner Givens estimate tracks the PRECONDITIONED residual, so each
    # cycle converts the remaining true-residual reduction into
    # preconditioned units via the cycle-start ratio
    r0_norm, threshold = residual_threshold(b, b - matvec(x0), rtol, atol,
                                            hdt)
    history = np.full(max_iter + 1, np.nan)
    history[0] = r0_norm
    ehist = None
    if num_tags > 0:
        ehist = np.full((max_iter + 1, num_tags), np.nan)
        ehist[0] = block_errors(x0, xref, tags, num_tags)
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)

    def cycle(x, total, r_true_norm):
        r = precon(b - matvec(x))
        beta_t = norm2(r)
        beta = hdt(beta_t.item())
        factor = threshold / r_true_norm if r_true_norm > 0 else hdt(1.0)
        inner_threshold = beta * min(factor, hdt(1.0))
        if beta > 0:
            torch.div(r, beta_t, out=V[0])
        else:
            V[0].copy_(r)
        H = np.zeros((m + 1, m), hdt)
        cs, sn = np.zeros(m, hdt), np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j, norm, done = 0, beta, beta <= inner_threshold
        while j < m and not done:
            w = precon(matvec(V[j]))
            H[:j + 2, j] = mgs_column(V, w, j)
            norm = givens_step(H, cs, sn, g, j)
            if total + j + 1 <= max_iter:
                history[total + j + 1] = norm
                if ehist is not None:
                    # the current iterate from the updated Hessenberg
                    y = back_substitute(H, g, j + 1)
                    ehist[total + j + 1] = block_errors(
                        x + combine(y, V, j + 1), xref, tags, num_tags)
            j += 1
            done = norm <= inner_threshold
        y = back_substitute(H, g, j)
        return x + combine(y, V, j), j, norm, done

    x, total, norm = x0, 0, r0_norm
    done = r0_norm <= threshold
    while total < max_iter and not done:
        x, j, norm_est, conv_inner = cycle(x, total, norm)
        total += j
        if skip_real_res_check:
            # trust the inner estimate (ref: hypre skip_real_r_norm_check)
            norm, done = norm_est, conv_inner
        else:
            # real-residual check in TRUE units (ref: hypre GMRES "false
            # convergence" guard)
            norm = hdt(norm2(b - matvec(x)).item())
            done = norm <= threshold
        # no progress this cycle → breakdown, stop
        done = bool(done) or j == 0
    return x, total, float(norm), bool(done), history, ehist


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
        return gmres_core(A.matvec, self.precon_apply, b, x0,
                          float(a.relative_tol), float(a.absolute_tol),
                          int(a.max_iter), int(a.krylov_dim),
                          bool(a.get("skip_real_res_check", False)), **tagged)
