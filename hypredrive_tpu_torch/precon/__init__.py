"""Preconditioners: AMG (BoomerAMG-equivalent), MGR, ILU, FSAI, Schwarz,
(ℓ1-)Jacobi, hybrid Gauss-Seidel, Chebyshev and none.

Reference equivalent: precon create/setup/apply dispatch
(ref: src/internal/precon.c:461-563).
"""

from .base import Preconditioner, create_precon

__all__ = ["Preconditioner", "create_precon"]
