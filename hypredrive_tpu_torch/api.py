"""Public driver API.

Counterpart of ``hypredrive_tpu/api.py`` for the ported path: a driver
object with the lifecycle verbs of the HYPREDRV C API
(ref: include/HYPREDRV.h)

    create → input_args_parse → linear_system_build → precon_create
    → linear_solver_create → linear_solver_setup → linear_solver_apply
    → get_solution → destroy

plus the one-shot :func:`solve` (the reference Python binding's
``hypredrive.solve``, ref: interfaces/python/src/__init__.py:38-57).
"""

from __future__ import annotations

import bisect
import os
from typing import Optional

import numpy as np

from .config import InputArgs, config_from_dict, parse_input
from .core.errors import ErrorCode, HypredrvError
from .core.logging import log
from .core.stats import Stats


def _not_ported(what: str) -> HypredrvError:
    return HypredrvError(f"{what} is not yet ported to hypredrive_tpu_torch",
                         ErrorCode.NOT_IMPLEMENTED)


class HypreDrive:
    """Driver context (reference equivalent: hypredrv_t,
    ref: src/internal/object.h:11-60)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.args: Optional[InputArgs] = None
        self.stats = Stats(name=name)
        self.system = None          # linsys.system.LinearSystem
        self.precon = None          # precon.base.Preconditioner
        self.solver = None          # solvers.base.Solver
        self.library_mode = False
        self.current_system_index = -1
        self._precon_is_setup = False
        self._reuse_state = None        # precon.reuse.PreconReuseState
        self._timestep_schedule = None  # [(timestep id, first ls id)]
        self._mgr_component_cache = None
        self._mgr_setup_count = 0

    # -- config ----------------------------------------------------------

    def input_args_parse(self, source: str, overrides=None, preset=None):
        """ref: HYPREDRV_InputArgsParse (src/HYPREDRV.c:1204)"""
        self.args = parse_input(source, overrides, preset,
                                object_name=self.name)
        self._after_args()
        return self.args

    def input_args_from_dict(self, options: dict):
        self.args = config_from_dict(options)
        self._after_args()
        return self.args

    def _after_args(self):
        g = self.args.general
        if self.library_mode:
            # config echo is a driver-mode feature (ref: args.c:113)
            g.print_config_params = False
        ls = self.args.linear_system
        if (ls.get("print_system") or {}).get("enable"):
            raise _not_ported("linear_system.print_system")
        if ls.eigspec.enable:
            raise _not_ported("linear_system.eigspec")
        if (self.args.solver.scaling or {}).get("enabled"):
            raise _not_ported("solver scaling")
        self.stats = Stats(use_millisec=g.use_millisec,
                           name=g.name or self.name)
        self._reuse_state = None
        if self.args.precon_variants and self.args.preconditioner.reuse.enabled:
            from .precon.reuse import PreconReuseState

            self._reuse_state = PreconReuseState(self.args.preconditioner.reuse)
        self._load_timestep_schedule()

    def _load_timestep_schedule(self):
        """Load the (timestep, ls_start) schedule from
        ``linear_system.timestep_filename`` (ASCII: count line, then
        "timestep ls_start" lines; ref: hypredrv_LinearSystemLoad-
        TimestepSchedule, src/internal/linsys.c:3195-3292) and feed it to
        the reuse engine (ref: src/HYPREDRV.c:1258-1281).  The lsseq
        container's timestep table is not read: ``sequence_filename``
        raises "not yet ported" when the system is built."""
        self._timestep_schedule = None
        ts_file = self.args.linear_system.get("timestep_filename") or ""
        if not ts_file:
            return
        if not os.path.isfile(ts_file):
            raise HypredrvError(f"timestep file not found: '{ts_file}'",
                                ErrorCode.FILE_NOT_FOUND)
        with open(ts_file) as fh:
            tokens = fh.read().split()
        try:
            total = int(tokens[0]) if tokens else None
        except ValueError:
            total = None
        if total is None:
            raise HypredrvError(
                f"invalid timestep file header in '{ts_file}'",
                ErrorCode.INVALID_ARG)
        if total <= 0 or len(tokens) < 1 + 2 * total:
            raise HypredrvError(f"invalid timestep file '{ts_file}'",
                                ErrorCode.INVALID_ARG)
        schedule = []
        for i in range(total):
            try:
                t = int(tokens[1 + 2 * i])
                start = int(tokens[2 + 2 * i])
            except ValueError:
                start = -1
            if start < 0:
                raise HypredrvError(
                    f"invalid timestep entry in '{ts_file}' at line {i + 2}",
                    ErrorCode.INVALID_ARG)
            schedule.append((t, start))
        self._timestep_schedule = schedule
        if self._reuse_state is not None:
            self._reuse_state.set_timesteps(schedule)

    def _timestep_index(self, ls_id: int):
        """Position of the system's timestep in the schedule (the last
        start ≤ ls_id), or None without a schedule."""
        if not self._timestep_schedule:
            return None
        starts = [s for _, s in self._timestep_schedule]
        idx = bisect.bisect_right(starts, ls_id) - 1
        return idx if idx >= 0 else None

    def set_library_mode(self):
        """ref: HYPREDRV_SetLibraryMode (src/HYPREDRV.c:1309)"""
        self.library_mode = True

    def set_precon_variant(self, index: int):
        """ref: HYPREDRV_InputArgsSetPreconVariant (src/HYPREDRV.c:1409)."""
        self.args.set_precon_variant(index)
        self.precon = None
        self.solver = None
        self._mgr_component_cache = None   # the cache is per variant

    # -- linear system ----------------------------------------------------

    def linear_system_build(self, system_index: Optional[int] = None):
        """Build A, b, x0 from the config
        (ref: HYPREDRV_LinearSystemBuild, src/HYPREDRV.c:1932)."""
        from .linsys.system import LinearSystem

        self.current_system_index += 1
        if system_index is not None:
            self.current_system_index = system_index
        self.system = LinearSystem.build(
            self.args, self.current_system_index, stats=self.stats,
            previous=self.system)
        if self.args.general.statistics:
            log(1, f"Solving linear system #{self.current_system_index} "
                   f"with {self.system.num_rows} rows and "
                   f"{self.system.nnz} nonzeros")
        return self.system

    def set_matrix_from_csr(self, indptr, indices, data):
        """Library-mode CSR ingestion
        (ref: HYPREDRV_LinearSystemSetMatrixFromCSR, include/HYPREDRV.h:882)."""
        from .linsys.system import LinearSystem

        self.current_system_index += 1
        self.system = LinearSystem.from_csr(
            self.args, indptr, indices, data, stats=self.stats)
        return self.system

    def set_rhs(self, values):
        self._require_system().set_rhs_array(np.asarray(values))

    def set_initial_guess(self, values):
        self._require_system().set_x0_array(np.asarray(values))

    def set_dofmap(self, labels):
        """ref: HYPREDRV_LinearSystemSetDofmap (include/HYPREDRV.h:1128)."""
        self._require_system().set_dofmap(np.asarray(labels, dtype=np.int64))

    def set_interleaved_dofmap(self, num_functions: int):
        """Labels cycle 0..ndof-1 per row (ref: HYPREDRV.h:1160 +
        IntArrayBuildInterleaved, containers.h:44)."""
        n = self._require_system().num_rows
        self.set_dofmap(np.arange(n, dtype=np.int64) % int(num_functions))

    def reset_initial_guess(self):
        """x ← x0 (ref: HYPREDRV_LinearSystemResetInitialGuess)."""
        self._require_system().reset_initial_guess()

    def get_solution(self) -> np.ndarray:
        """ref: HYPREDRV_LinearSystemGetSolutionValues (src/HYPREDRV.c:2479)"""
        return self._require_system().get_solution()

    # -- solve lifecycle ----------------------------------------------------

    def precon_create(self):
        """ref: HYPREDRV_PreconCreate (src/HYPREDRV.c:2793); honours the
        reuse engine's rebuild decision."""
        if self.precon is None:
            rebuild = True
            if self._reuse_state is not None:
                self._reuse_state.note_rebuild(self.current_system_index,
                                               self.stats)
        elif self._reuse_state is not None:
            rebuild = self._reuse_state.should_rebuild(
                self.current_system_index, self.stats)
        else:
            rebuild = True
        if rebuild:
            from .precon import create_precon

            self.precon = create_precon(self.args.preconditioner, self.args)
            self._precon_is_setup = False
            if (self._mgr_component_cache is not None
                    and self.precon.method == "mgr"):
                # MGR component-level reuse: cached F/G/coarsest solver
                # components survive whole-precon rebuilds across a
                # sequence (ref: hypredrv_MGRRefreshComponentsForSetup,
                # include/internal/mgr.h:168-177)
                self.precon._component_cache = self._mgr_component_cache
                self.precon._setup_count = self._mgr_setup_count
        return self.precon

    def linear_solver_create(self):
        """ref: HYPREDRV_LinearSolverCreate (src/HYPREDRV.c:2897)"""
        from .solvers import create_solver

        self.solver = create_solver(self.args.solver, self.args)
        return self.solver

    def linear_solver_setup(self):
        """Preconditioner setup (ref: HYPREDRV_LinearSolverSetup,
        src/HYPREDRV.c:3001)."""
        system = self._require_system()
        if self.solver is None:
            raise HypredrvError("solver not created", ErrorCode.INVALID_SOLVER)
        self.stats.annotate_begin("prec")
        try:
            if self.precon is not None and not self._precon_is_setup:
                self.precon.setup(system)
                self._precon_is_setup = True
        finally:
            self.stats.annotate_end("prec")
        self.solver.setup(system, self.precon)

    def linear_solver_apply(self):
        """Krylov solve (ref: HYPREDRV_LinearSolverApply,
        src/HYPREDRV.c:3126)."""
        result = self.solver.apply(self._require_system(), self.precon,
                                   stats=self.stats)
        if self._reuse_state is not None:
            self._reuse_state.record_observation(
                self.current_system_index, self.stats, result)
        return result

    def precon_destroy(self):
        """Destroy unless the reuse engine says keep (ref: main.c:221 +
        reuse); a destroyed MGR leaves its component cache behind."""
        keep = (self._reuse_state is not None
                and self._reuse_state.should_keep(self.current_system_index,
                                                  self.stats))
        if not keep:
            cache = getattr(self.precon, "_component_cache", None)
            if cache:
                self._mgr_component_cache = cache
                self._mgr_setup_count = self.precon._setup_count
            self.precon = None
            self._precon_is_setup = False

    def linear_solver_destroy(self):
        self.solver = None

    # -- stats -------------------------------------------------------------

    def annotate_begin(self, name: str, index: Optional[int] = None):
        self.stats.annotate_begin(name, index)

    def annotate_end(self, name: str, index: Optional[int] = None):
        self.stats.annotate_end(name, index)

    def annotate_level_begin(self, name: str, index: int):
        self.stats.annotate_level_begin(name, index)

    def annotate_level_end(self, name: str, index: int):
        self.stats.annotate_level_end(name, index)

    # level getters (ref: HYPREDRV_StatsLevel*, include/HYPREDRV.h:2223)
    def get_level_time(self, name: str, index=None) -> float:
        return self.stats.level_time(name, index)

    def get_level_records(self, name=None):
        return self.stats.level_records(name)

    def stats_level_get_count(self, name: str) -> int:
        """Completed frames of a level name
        (ref: HYPREDRV_StatsLevelGetCount)."""
        return len(self.stats.level_records(name))

    def stats_level_get_entry_summary(self, name: str, index: int):
        """(num_solves, linear_iters, setup_time, solve_time) of one
        completed level frame (ref: HYPREDRV_StatsLevelGetEntry /
        StatsLevelGetEntrySummary)."""
        recs = self.stats.level_records(name)
        if not 0 <= index < len(recs):
            raise HypredrvError(f"level '{name}' has no entry {index}",
                                ErrorCode.INVALID_ARG)
        e0, e1 = recs[index]["entries"]
        entries = self.stats.entries[e0:e1]
        return (len(entries),
                sum(e.iters for e in entries),
                sum(e.setup_time for e in entries),
                sum(e.solve_time for e in entries))

    def stats_level_print(self):
        text = self.stats.level_table()
        if text:
            print(text, end="")

    def stats_print(self, filename: Optional[str] = None):
        if self.args is not None and self.args.general.statistics_filename:
            filename = filename or self.args.general.statistics_filename
        self.stats.print(filename=filename)

    # getters (ref: HYPREDRV_LinearSolverGet*, src/HYPREDRV.c:3665-3820)
    def get_num_iterations(self) -> int:
        return self.stats.num_iterations()

    def get_final_rel_res_norm(self) -> float:
        return self.stats.final_rel_res_norm()

    def get_setup_time(self) -> float:
        return self.stats.setup_time()

    def get_solve_time(self) -> float:
        return self.stats.solve_time()

    # -- lifecycle ----------------------------------------------------------

    def _require_system(self):
        if self.system is None:
            raise HypredrvError("linear system not built",
                                ErrorCode.UNKNOWN_OBJ)
        return self.system

    def destroy(self):
        """ref: HYPREDRV_Destroy (src/HYPREDRV.c:764)."""
        self.system = None
        self.precon = None
        self.solver = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()
        return False


def solve(A=None, b=None, options: Optional[dict] = None,
          config: Optional[str] = None, x0=None):
    """One-shot solve (ref: interfaces/python/src/__init__.py:38-57).

    ``A`` may be a scipy.sparse matrix, an (indptr, indices, data) triple,
    or None when the config names the matrix.  ``options`` is a config
    dict; its ``general.exec_policy`` picks the device (default: CUDA).
    """
    from .linsys.result import SolveResult

    drv = HypreDrive()
    try:
        drv.set_library_mode()
        if config is not None:
            drv.input_args_parse(config)
        else:
            # with A given the config needs no matrix source
            drv.input_args_from_dict({"linear_system": {}, **(options or {
                "solver": "pcg", "preconditioner": "amg"})})
        if A is not None:
            if hasattr(A, "indptr") or hasattr(A, "tocsr"):
                csr = A.tocsr() if hasattr(A, "tocsr") else A
                drv.set_matrix_from_csr(csr.indptr, csr.indices, csr.data)
            else:
                indptr, indices, data = A
                drv.set_matrix_from_csr(indptr, indices, data)
            if b is not None:
                drv.set_rhs(b)
            if x0 is not None:
                drv.set_initial_guess(x0)
        else:
            drv.linear_system_build()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        result = drv.linear_solver_apply()
        x = drv.get_solution()
        return SolveResult(
            x=x,
            iters=result.iters,
            rel_res_norm=result.rel_res_norm,
            converged=result.converged,
            solution_norm=float(np.linalg.norm(x)),
            res_history=result.res_history,
        )
    finally:
        drv.destroy()
