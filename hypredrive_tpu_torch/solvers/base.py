"""Solver protocol, result type, and dispatch.

Mirrors the reference solver layer semantics (ref: src/internal/solver.c):
``Solver.apply`` computes *untimed* true residual norms before and after
the timed solve (ref: solver.c:627-699); the stats table's "initial" and
"relative" residual norms come from there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..core.errors import ErrorCode, HypredrvError
from ..ops.vectors import norm2


@dataclass
class SolveResult:
    """Outcome of one Krylov solve."""

    x: Any = None
    iters: int = 0
    initial_res_norm: float = 0.0
    final_res_norm: float = 0.0
    rel_res_norm: float = 0.0
    converged: bool = True
    res_history: Optional[np.ndarray] = None
    solve_time: float = 0.0
    # per-iteration per-dof-block error norms ‖x_k − xref‖ — filled by GMRES
    # when a reference solution is set (ref: hypredrv_GMRESSetRefSolution,
    # src/internal/gmres.c:80-103; tags from the dofmap,
    # src/HYPREDRV.c:693-726)
    error_histories: Optional[np.ndarray] = None
    # ‖x − xref‖₂ after the post-solve tail, when xref is set
    error_norm: Optional[float] = None


def _sync(t: torch.Tensor) -> None:
    """Wait for the device (the timed region ends on finished work)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Solver:
    """Base Krylov solver (one subclass per method)."""

    method = "base"

    def __init__(self, args, input_args=None):
        self.args = args
        self.input_args = input_args
        self._precon = None

    def setup(self, system, precon=None):
        """Bind the preconditioner
        (ref: hypredrv_SolverSetupWithReuse, solver.c:457)."""
        self._system = system
        self._precon = precon

    def precon_apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._precon.apply(r) if self._precon is not None else r

    def apply(self, system, precon=None, stats=None) -> SolveResult:
        """Run the solve with untimed true-residual bookkeeping
        (ref: hypredrv_SolverApply, solver.c:627-699)."""
        A, b, x0 = system.A, system.b, system.x
        initial_res_norm = float(norm2(b - A.matvec(x0)))
        b_norm = float(norm2(b))

        if stats is not None:
            stats.annotate_begin("solve")
        _sync(b)
        t0 = time.perf_counter()
        x, iters, final_norm, converged, history, error_histories = \
            self.solve_core(A, b, x0)
        _sync(x)
        solve_time = time.perf_counter() - t0
        if stats is not None:
            stats.annotate_end("solve")

        # untimed true relative residual
        true_norm = float(norm2(b - A.matvec(x)))
        denom = b_norm if b_norm > 0 else (initial_res_norm or 1.0)
        rel = true_norm / denom if denom > 0 else true_norm

        result = SolveResult(
            x=x,
            iters=int(iters),
            initial_res_norm=initial_res_norm,
            final_res_norm=true_norm,
            rel_res_norm=rel,
            converged=bool(converged),
            res_history=history,
            solve_time=solve_time,
            error_histories=error_histories,
        )
        system.x = x
        if stats is not None:
            stats.record_solve(result.iters, initial_res_norm, rel,
                               result.converged)
        return result

    def solve_core(self, A, b, x0):
        """(x, iters, final norm, converged, residual history, per-block
        error history or None)."""
        raise NotImplementedError


def create_solver(solver_config, input_args=None) -> Solver:
    """ref: solver vtable dispatch (solver.c:104-125, :417)."""
    from .bicgstab import BiCGSTABSolver
    from .fgmres import FGMRESSolver
    from .gmres import GMRESSolver
    from .pcg import PCGSolver

    registry = {
        "pcg": PCGSolver,
        "gmres": GMRESSolver,
        "fgmres": FGMRESSolver,
        "bicgstab": BiCGSTABSolver,
    }
    cls = registry.get(solver_config.method)
    if cls is None:
        raise HypredrvError(f"unknown solver {solver_config.method}",
                            ErrorCode.INVALID_SOLVER)
    return cls(solver_config.args, input_args)
