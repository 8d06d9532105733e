"""Public driver API.

Counterpart of ``hypredrive_tpu/api.py`` for the ported path: a driver
object with the lifecycle verbs of the HYPREDRV C API
(ref: include/HYPREDRV.h)

    create → input_args_parse → linear_system_build → precon_create
    → linear_solver_create → linear_solver_setup → linear_solver_apply
    → get_solution → destroy

plus the one-shot :func:`solve` (the reference Python binding's
``hypredrive.solve``, ref: interfaces/python/src/__init__.py:38-57), the
library-mode setters (near-null space, null space, reference solution,
precon matrix, state vectors), scheduled dumps (``print_system``), the
eigenspectrum and the info reports.  The AMS/ADS inputs
(``set_coordinates``, ``set_discrete_gradient``, ``set_discrete_curl``)
raise a typed "not yet ported" error.
"""

from __future__ import annotations

import bisect
import os
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .config import InputArgs, config_from_dict, parse_input
from .core.errors import ErrorCode, HypredrvError
from .core.logging import log
from .core.stats import Stats


def _not_ported(what: str) -> HypredrvError:
    return HypredrvError(f"{what} is not yet ported to hypredrive_tpu_torch",
                         ErrorCode.NOT_IMPLEMENTED)


def _read_timestep_file(ts_file: str):
    """[(timestep id, first ls id)] from a timestep file, with the JAX
    package's typed errors."""
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
        raise HypredrvError(f"invalid timestep file header in '{ts_file}'",
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
    return schedule


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
        self._print_ctx = None          # linsys.printsys.PrintSystemContext
        self._stats_printed = False
        self._states = []               # library-mode state vectors
        self._state_map = []

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
        self.stats = Stats(use_millisec=g.use_millisec,
                           name=g.name or self.name)
        self._reuse_state = None
        if self.args.precon_variants and self.args.preconditioner.reuse.enabled:
            from .precon.reuse import PreconReuseState

            self._reuse_state = PreconReuseState(self.args.preconditioner.reuse)
        self._print_ctx = None
        ps = self.args.linear_system.get("print_system")
        if ps and ps.get("enable"):
            from .linsys.printsys import PrintSystemContext

            self._print_ctx = PrintSystemContext(ps)
        self._load_timestep_schedule()

    def _load_timestep_schedule(self):
        """Load the (timestep, ls_start) schedule from
        ``linear_system.timestep_filename`` (ASCII: count line, then
        "timestep ls_start" lines; ref: hypredrv_LinearSystemLoad-
        TimestepSchedule, src/internal/linsys.c:3195-3292) or the lsseq
        container's timestep table (ref: hypredrv_LSSeqReadTimesteps-
        WithIds, src/internal/lsseq.c:2029-2107), and feed it to the reuse
        engine and the scheduled dumps (ref: src/HYPREDRV.c:1258-1281)."""
        self._timestep_schedule = None
        ls = self.args.linear_system
        ts_file = ls.get("timestep_filename") or ""
        seq_file = ls.get("sequence_filename") or ""
        if ts_file:
            schedule = _read_timestep_file(ts_file)
        elif seq_file and os.path.isfile(seq_file):
            from .io.lsseq import LSSeqFile

            f = LSSeqFile(seq_file)
            schedule = (f.read_timesteps() if f.summary().has_timesteps
                        else None)
        else:
            return
        if schedule:
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

    def _maybe_dump(self, stage: str):
        """ref: MaybeDumpLinearSystem (src/HYPREDRV.c:611)."""
        if self._print_ctx is not None and self.system is not None:
            self._print_ctx.dump(
                self.system, stage, self.current_system_index, self.stats,
                timestep=self._timestep_index(self.current_system_index))

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
        self._maybe_dump("build")
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

    def set_contiguous_dofmap(self, num_functions: int):
        """Equal contiguous label blocks (ref: HYPREDRV.h:1192 +
        IntArrayBuildContiguous, containers.h:46)."""
        n = self._require_system().num_rows
        ndof = max(1, int(num_functions))
        self.set_dofmap((np.arange(n, dtype=np.int64) * ndof) // max(1, n))

    def read_dofmap(self, path: str):
        """ref: HYPREDRV_LinearSystemReadDofmap (include/HYPREDRV.h:1223)."""
        from .io.ij import read_dofmap_auto

        self.set_dofmap(read_dofmap_auto(path))

    def reset_initial_guess(self):
        """x ← x0 (ref: HYPREDRV_LinearSystemResetInitialGuess)."""
        self._require_system().reset_initial_guess()

    def get_solution(self) -> np.ndarray:
        """ref: HYPREDRV_LinearSystemGetSolutionValues (src/HYPREDRV.c:2479)"""
        return self._require_system().get_solution()

    def set_matrix(self, A):
        """Borrow a scipy/dense matrix as the system operator
        (ref: HYPREDRV_LinearSystemSetMatrix, include/HYPREDRV.h:728)."""
        A = sp.csr_matrix(A)
        return self.set_matrix_from_csr(A.indptr, A.indices, A.data)

    def read_matrix(self, path: str):
        """ref: HYPREDRV_LinearSystemReadMatrix (include/HYPREDRV.h:699)."""
        from .io.ij import read_matrix_auto

        A, _ = read_matrix_auto(path)
        return self.set_matrix(A)

    def set_prec_matrix(self, M=None):
        """Separate preconditioning matrix, or A again when None
        (ref: HYPREDRV_LinearSystemSetPrecMatrix, include/HYPREDRV.h:1092)."""
        self._require_system().M_host = (sp.csr_matrix(M) if M is not None
                                         else None)

    def set_solution(self, values):
        """ref: HYPREDRV_LinearSystemSetSolution (include/HYPREDRV.h:988)."""
        sys_ = self._require_system()
        sys_.x = sys_._vec(np.asarray(values, dtype=np.float64))

    def set_reference_solution(self, values):
        """ref: HYPREDRV_LinearSystemSetReferenceSolution (HYPREDRV.h:1026)."""
        self._require_system().set_xref_array(np.asarray(values))

    def get_rhs_values(self) -> np.ndarray:
        """ref: HYPREDRV_LinearSystemGetRHSValues (HYPREDRV.h:1369-1518)."""
        return self._require_system().b.cpu().numpy()

    def get_solution_length(self) -> int:
        return int(self._require_system().num_rows)

    def get_solution_norm(self) -> float:
        return float(np.linalg.norm(self.get_solution()))

    def linear_system_print(self, prefix: str = "IJ.out"):
        """Dump A/b/x in IJ format (ref: HYPREDRV_LinearSystemPrint,
        include/HYPREDRV.h:1263)."""
        from .io.ij import write_matrix_ascii, write_vector_ascii

        sys_ = self._require_system()
        A = sys_.A_host if sys_.A_host is not None else sys_.A.to_csr()
        write_matrix_ascii(f"{prefix}.A", A)
        write_vector_ascii(f"{prefix}.b", sys_.b.cpu().numpy())
        write_vector_ascii(f"{prefix}.x", sys_.x.cpu().numpy())

    def print_dofmap(self, path: str):
        """ref: HYPREDRV_LinearSystemPrintDofmap (include/HYPREDRV.h)."""
        from .io.ij import write_dofmap_ascii

        sys_ = self._require_system()
        if sys_.dofmap is None:
            raise HypredrvError("no dofmap set", ErrorCode.UNKNOWN_OBJ)
        write_dofmap_ascii(path, sys_.dofmap)

    # -- state vectors (ref: HYPREDRV_StateVector*, src/HYPREDRV.c:1701-1930,
    #    include/HYPREDRV.h:1554-1693): circular time-stepping states, on
    #    the host -----------------------------------------------------------

    def state_vector_set(self, vectors):
        """Register nstates state vectors (borrowed, library mode)."""
        self._states = [np.asarray(v, dtype=np.float64) for v in vectors]
        self._state_map = list(range(len(self._states)))

    def _state(self, index: int) -> np.ndarray:
        if not 0 <= index < len(self._states):
            raise HypredrvError(f"state vector {index} not set",
                                ErrorCode.UNKNOWN_OBJ)
        return self._states[self._state_map[index]]

    def state_vector_get_values(self, index: int) -> np.ndarray:
        """Direct (read/write) access to a state vector's data."""
        return self._state(index)

    def state_vector_copy(self, index_in: int, index_out: int):
        np.copyto(self._state(index_out), self._state(index_in))

    def state_vector_update_all(self):
        """Advance the circular state mapping by one (no data copied)."""
        if self._state_map:
            self._state_map = self._state_map[1:] + self._state_map[:1]

    def state_vector_apply_correction(self, state_idx: int = 0):
        """state[state_idx] += x (Newton update U += ΔU)."""
        x = self.get_solution()
        s = self._state(state_idx)
        s += x[:len(s)]

    # -- null space / auxiliary operators -----------------------------------

    def set_near_nullspace(self, vectors):
        """Near-null-space vectors (RBMs) for AMG interpolation
        (ref: HYPREDRV_LinearSystemSetNearNullSpace, HYPREDRV.h:1286)."""
        self._require_system().near_nullspace = np.asarray(vectors,
                                                           dtype=np.float64)

    def set_nullspace(self, vectors):
        """Exact null space; solutions are projected after each solve
        (ref: HYPREDRV.h:1335 + gauge fix src/HYPREDRV.c:3307)."""
        from .linsys.nullspace import orthonormalize

        self._require_system().nullspace = orthonormalize(
            np.asarray(vectors, dtype=np.float64))

    def set_coordinates(self, coords):
        """Vertex coordinates for AMS/ADS (ref: HYPREDRV.h:793)."""
        raise _not_ported("set_coordinates (AMS/ADS input)")

    def set_discrete_gradient(self, G):
        """Discrete gradient operator for AMS (ref: HYPREDRV.h:749)."""
        raise _not_ported("set_discrete_gradient (AMS input)")

    def set_discrete_curl(self, C):
        """Discrete curl operator for ADS (ref: HYPREDRV.h:770)."""
        raise _not_ported("set_discrete_curl (ADS input)")

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
        system.apply_scaling(self.args.solver.scaling)
        self.stats.annotate_begin("prec")
        try:
            if self.precon is not None and not self._precon_is_setup:
                self.precon.setup(system)
                self._precon_is_setup = True
        finally:
            self.stats.annotate_end("prec")
        self.solver.setup(system, self.precon)
        self._maybe_dump("setup")

    def linear_solver_apply(self):
        """Krylov solve, then the post-solve tail: undo scaling, null-space
        projection, error norms (ref: HYPREDRV_LinearSolverApply,
        src/HYPREDRV.c:3126)."""
        system = self._require_system()
        result = self.solver.apply(system, self.precon, stats=self.stats)
        system.postprocess_solution(result)
        if self._reuse_state is not None:
            self._reuse_state.record_observation(
                self.current_system_index, self.stats, result)
        self._maybe_dump("apply")
        return result

    def precon_setup(self):
        """Set up the preconditioner outside the solver path
        (ref: HYPREDRV_PreconSetup, include/HYPREDRV.h:1771)."""
        if self.precon is None:
            raise HypredrvError("preconditioner not created",
                                ErrorCode.UNKNOWN_OBJ)
        if not self.precon.is_setup:
            self.precon.setup(self._require_system())
            self._precon_is_setup = True

    def precon_apply(self, values) -> np.ndarray:
        """z = M⁻¹ r on the system's device (ref: HYPREDRV_PreconApply,
        include/HYPREDRV.h:1852)."""
        self.precon_setup()
        r = self._require_system()._vec(values)
        return self.precon.apply(r).cpu().numpy()

    def compute_eigenspectrum(self):
        """ref: HYPREDRV_LinearSystemComputeEigenspectrum (HYPREDRV.h:2109)."""
        from .linsys.eigspec import compute_eigenspectrum

        sys_ = self._require_system()
        eig_cfg = self.args.linear_system.eigspec
        precon = self.precon if (eig_cfg.preconditioned and self.precon
                                 and self.precon.is_setup) else None
        return compute_eigenspectrum(sys_, eig_cfg, precon=precon)

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
        self._stats_printed = True

    # getters (ref: HYPREDRV_LinearSolverGet*, src/HYPREDRV.c:3665-3820)
    def get_num_iterations(self) -> int:
        return self.stats.num_iterations()

    def get_final_rel_res_norm(self) -> float:
        return self.stats.final_rel_res_norm()

    def get_setup_time(self) -> float:
        return self.stats.setup_time()

    def get_solve_time(self) -> float:
        return self.stats.solve_time()

    def get_converged(self) -> bool:
        return self.stats.entries[-1].converged if self.stats.entries \
            else False

    # -- remaining C-API-parity verbs (ref: include/HYPREDRV.h) ------------

    def object_set_name(self, name: str):
        """ref: HYPREDRV_ObjectSetName (include/HYPREDRV.h:447)."""
        self.name = str(name)
        self.stats.name = self.name

    def apply_preset_text(self, text: str, kind: str = "precon"):
        """Replace the solver/preconditioner section of the active config
        with a preset's YAML text (ref: HYPREDRV_InputArgsSetPreconPreset /
        SetSolverPreset, include/HYPREDRV.h:570-641)."""
        from .config.parse import parse_tree
        from .config.yamlparse import load_yaml_text

        if self.args is None:
            raise HypredrvError("input args not parsed",
                                ErrorCode.UNKNOWN_OBJ)
        tree = dict(self.args.raw_tree)
        sub = load_yaml_text(text)
        section = "preconditioner" if kind == "precon" else "solver"
        # the preset text may be a bare section body or carry the header
        tree[section] = sub.get(section, sub)
        self.args = parse_tree(tree, object_name=self.name)
        self._after_args()
        self.precon = None
        self.solver = None
        return self.args

    def print_lib_info(self):
        """ref: HYPREDRV_PrintLibInfo (include/HYPREDRV.h:311)."""
        from .core.info import library_banner

        print(f"Date and time: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        print(f"Using {library_banner()}\n")

    def print_system_info(self):
        """ref: HYPREDRV_PrintSystemInfo (include/HYPREDRV.h:333)."""
        from .core.info import system_info

        print(system_info())

    def print_exit_info(self):
        """ref: HYPREDRV_PrintExitInfo (include/HYPREDRV.h:358)."""
        print(f"\nDate and time: {time.strftime('%Y-%m-%d %H:%M:%S')}")
        print(f"{self.name or 'hypredrive-tpu-torch'} done!")

    # -- lifecycle ----------------------------------------------------------

    def _require_system(self):
        if self.system is None:
            raise HypredrvError("linear system not built",
                                ErrorCode.UNKNOWN_OBJ)
        return self.system

    def destroy(self):
        """ref: HYPREDRV_Destroy (src/HYPREDRV.c:764).  Library mode prints
        the stats on destroy unless the application already printed them
        (ref: src/HYPREDRV.c:783-888)."""
        if (self.library_mode and self.args is not None
                and self.args.general.statistics and self.stats.entries
                and not self._stats_printed):
            self.stats_print()
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
