"""Chebyshev polynomial smoother/preconditioner.

Counterpart of ``hypredrive_tpu/precon/chebyshev.py`` (option parity: ref
src/internal/cheby.c:16-21): order, eig_est (power iterations for the λmax
estimate), scale (diagonal scaling), fraction (lower end of the target
interval = fraction·λmax).  ``cheby_coefficients`` is host numpy with the
JAX package's arithmetic; the apply is ``order`` matvec + axpy steps on the
device.  The state is (A, d_inv, θ, δ, ρ_k) with the scalars as Python
floats, as the AMG smoother keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Preconditioner


def estimate_lambda_max(A, d_inv, iters: int = 10, seed: int = 0):
    """Power iteration on D⁻¹A for the largest eigenvalue, from the same
    numpy-seeded start vector as the JAX package; a 0-d tensor."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(n), dtype=A.dtype,
                        device=A.device)
    lam = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        w = d_inv * A.matvec(v)
        lam = torch.sqrt(torch.dot(w, w))
        v = w / torch.clamp(lam, min=1e-30)
    return lam


def cheby_coefficients(lam_max: float, fraction: float, order: int):
    """Three-term recurrence factors for the interval
    [fraction·λmax, λmax]."""
    lam_min = fraction * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta if delta > 0 else 1.0
    rhos = np.zeros(max(order, 1))
    rho = 1.0 / sigma
    rhos[0] = rho
    for k in range(1, order):
        rho = 1.0 / (2.0 * sigma - rho)
        rhos[k] = rho
    return theta, delta, rhos


def cheby_apply(state, r):
    """z ≈ A⁻¹ r by ``order`` Chebyshev steps on D⁻¹A (z₀ = 0)."""
    A, d_inv, theta, delta, rhos = state
    z = d_inv * r / theta
    d = z
    rho_prev = rhos[0]
    for k in range(1, len(rhos)):
        rho = rhos[k]
        resid = d_inv * (r - A.matvec(z))
        d = rho * rho_prev * d + (2.0 * rho / delta) * resid
        z = z + d
        rho_prev = rho
    return z


def make_cheby_state(A, order: int, fraction: float, eig_iters: int = 10,
                     scale: bool = True):
    """Chebyshev state for a device matrix ``A`` (λmax by power iteration
    on the device, padded by 1.1 as hypre pads its estimate)."""
    if scale:
        diag = A.diagonal()
        d_inv = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))
    else:
        d_inv = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    lam_max = float(estimate_lambda_max(A, d_inv, eig_iters)) * 1.1
    theta, delta, rhos = cheby_coefficients(lam_max, fraction, order)
    return (A, d_inv, float(theta), float(delta),
            tuple(float(r) for r in rhos))


class ChebyshevPrecon(Preconditioner):
    method = "chebyshev"

    def setup(self, system):
        self.state = make_cheby_state(
            system.A, int(self.args.get("order", 2)),
            float(self.args.get("fraction", 0.3)),
            int(self.args.get("eig_est", 10)),
            bool(self.args.get("scale", True)))
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return cheby_apply(self.state, r)
