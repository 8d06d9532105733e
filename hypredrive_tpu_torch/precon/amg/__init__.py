"""BoomerAMG-equivalent algebraic multigrid.

Setup (host, numpy/scipy + native helpers): strength graph → PMIS
coarsening → extended+i interpolation → Galerkin RAP.  Solve (device): V/W
cycles with Chebyshev / (ℓ1-)Jacobi smoothers and a dense coarse solve.
"""

from .precon import AMGPrecon

__all__ = ["AMGPrecon"]
