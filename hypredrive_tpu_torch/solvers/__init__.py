"""Krylov solvers: PCG, GMRES, FGMRES and BiCGSTAB.

Reference equivalent: the solver vtable dispatch (ref: src/internal/
solver.c:104-125).
"""

from .base import Solver, SolveResult, create_solver

__all__ = ["Solver", "SolveResult", "create_solver"]
