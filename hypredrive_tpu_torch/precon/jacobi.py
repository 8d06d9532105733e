"""(ℓ1-)Jacobi and hybrid Gauss-Seidel preconditioners.

Counterpart of ``hypredrive_tpu/precon/jacobi.py``.  The reference builds
``jacobi``/``gauss-seidel`` as single-level BoomerAMG relaxations (ref:
src/internal/precon.c:256-289); on a device both are diagonal scalings:
``gauss-seidel`` is hybrid ℓ1-GS as ℓ1-Jacobi sweeps, hypre's own device
fallback (relax types 13/14/18).
"""

from __future__ import annotations

import torch

from .base import Preconditioner


def jacobi_apply(state, r):
    """z = D⁻¹ r, then (sweeps − 1) × z += D⁻¹ (r − A z)."""
    d_inv, sweeps, A = state
    z = d_inv * r
    for _ in range(sweeps - 1):
        z = z + d_inv * (r - A.matvec(z))
    return z


def _inverse(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d != 0, 1.0 / d, torch.ones_like(d))


class JacobiPrecon(Preconditioner):
    method = "jacobi"

    def setup(self, system):
        A = system.A
        d = A.row_l1_norms() if self.args.get("l1", True) else A.diagonal()
        sweeps = max(1, int(self.args.get("max_iter", 1)))
        self.state = (_inverse(d), sweeps, A)
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return jacobi_apply(self.state, r)


class GaussSeidelPrecon(JacobiPrecon):
    """Hybrid ℓ1-GS ≈ ℓ1-Jacobi sweeps (device-friendly)."""

    method = "gauss-seidel"

    def setup(self, system):
        A = system.A
        sweeps = max(1, int(self.args.get("sweeps", 1))
                     * int(self.args.get("max_iter", 1)))
        self.state = (_inverse(A.row_l1_norms()), sweeps, A)
        self.is_setup = True
