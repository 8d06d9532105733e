"""Enum vocabularies (string ↔ int code maps).

These are the user-facing YAML value vocabularies of the reference; the int
codes are hypre option codes, kept for input compatibility (users may write
either the name or the raw code, e.g. ``down_type: 16``).

Sources: ref src/internal/amg.c:246-465, ilu.c:42-57, fsai.c:40-52,
schwarz.c:44-70, mgr.c:1540-1700, solver.c:351-375, precon.c:75-93,
linsys.c:362-387.
"""

from .fields import Choices

# --- AMG (ref: amg.c AMGintGetValidValues etc.) -------------------------

AMG_PROLONGATION = Choices({
    "mod_classical": 0, "least_squares": 1, "mod_classical_he": 2,
    "direct_sep_weights": 3, "multipass": 4, "multipass_sep_weights": 5,
    "extended+i": 6, "ext+i": 6, "extended+i_c": 7, "standard": 8,
    "standard_sep_weights": 9, "blk_classical": 10, "blk_classical_diag": 11,
    "f_f": 12, "f_f1": 13, "extended": 14, "mm_extended": 16,
    "mm_extended+i": 17, "mm-ext+i": 17, "mm_extended+e": 18, "mm-ext+e": 18,
    "blk_direct": 24, "one_point": 100,
})

AMG_RESTRICTION = Choices({
    "p_transpose": 0, "air_1": 1, "air_2": 2, "neumann_air_0": 3,
    "neumann_air_1": 4, "neumann_air_2": 5, "air_1.5": 15,
})

AMG_COARSENING = Choices({
    "cljp": 0, "rs": 1, "rs3": 3, "falgout": 6, "pmis": 8, "hmis": 10,
})

AMG_AGG_PROLONGATION = Choices({
    "2_stage_extended+i": 1, "2_stage_standard": 2, "2_stage_extended": 3,
    "multipass": 4, "mm_extended": 5, "mm_extended+i": 6, "mm_extended+e": 7,
})

AMG_RELAX = Choices({
    "jacobi_non_mv": 0, "forward-hgs": 3, "backward-hgs": 4,
    "chaotic-hgs": 5, "hsgs": 6, "jacobi": 7, "l1-hsgs": 8,
    "forward-solve": 10, "2gs-it1": 11, "2gs-it2": 12,
    "forward-hl1gs": 13, "backward-hl1gs": 14, "cg": 15, "chebyshev": 16,
    "l1-jacobi": 18, "l1sym-hgs": 89,
})

AMG_COARSE_RELAX = Choices({
    "jacobi_non_mv": 0, "hsgs": 6, "jacobi": 7, "l1-hsgs": 8, "ge": 9,
    "2gs-it1": 11, "2gs-it2": 12, "forward-hl1gs": 13, "backward-hl1gs": 14,
    "cg": 15, "chebyshev": 16, "l1-jacobi": 18, "l1sym-hgs": 89,
    "lu_piv": 99, "lu_inv": 199,
})

AMG_RELAX_POINTS = Choices({"all": 0, "air": 1})

AMG_SMOOTHER = Choices({
    "fsai": 4, "ilu": 5, "schwarz": 6, "pilut": 7, "parasails": 8,
    "euclid": 9,
})

# --- ILU (ref: ilu.c ILUGetValidValues) ---------------------------------

ILU_TYPE = Choices({
    "bj-iluk": 0, "bj-ilu0": 0, "bj-ilut": 1, "gmres-iluk": 10,
    "gmres-ilut": 11, "nsh-iluk": 20, "nsh-ilut": 21, "ras-iluk": 30,
    "ras-ilut": 31, "ddpq-gmres-iluk": 40, "ddpq-gmres-ilut": 41,
    "rap-mod-ilu0": 50,
})

# --- FSAI (ref: fsai.c FSAIGetValidValues) ------------------------------

FSAI_ALGO = Choices({"bj-afsai": 1, "bj-afsai-omp": 2, "bj-sfsai": 3})

# --- Schwarz (ref: schwarz.c SchwarzGetValidValues) ---------------------

SCHWARZ_VARIANT = Choices({
    "mp": 0, "ad": 1, "par-ad": 2, "par-mp": 3, "mp-fw": 4,
    "ras-iluk": 10, "as-iluk": 11, "ras-ilut": 20, "as-ilut": 21,
    "ras-amg": 30, "as-amg": 31, "ras-spdirect": 40, "as-spdirect": 41,
})

SCHWARZ_LOCAL_SOLVER = Choices({
    "iluk": 0, "ilut": 1, "amg": 2, "spdirect": 3, "superlu": 3,
})

# --- MGR (ref: mgr.c:1540-1700) -----------------------------------------

MGR_FRELAX = Choices({
    "none": -1, "single": 7, "jacobi": 7, "l1-jacobi": 18, "v(1,0)": 1,
    "amg": 2, "mgr": 1000, "chebyshev": 16, "ilu": 32, "ge": 9,
    "spdirect": 29, "ge-piv": 99, "ge-inv": 199, "fsai": 33, "schwarz": 1001,
})
MGR_FRLX_NESTED_MGR = 1000
MGR_SOLVER_SCHWARZ = 1001

MGR_GRELAX = Choices({
    "none": -1, "blk-jacobi": 0, "blk-gs": 1, "mixed-gs": 2, "amg": 20,
    "h-fgs": 3, "h-bgs": 4, "ch-gs": 5, "h-ssor": 6, "euclid": 8,
    "2stg-fgs": 11, "2stg-bgs": 12, "l1-hfgs": 13, "l1-hbgs": 14,
    "ilu": 16, "spdirect": 29, "l1-hsgs": 88, "fsai": 33, "schwarz": 1001,
})

MGR_PROLONGATION = Choices({
    "injection": 0, "l1-jacobi": 1, "jacobi": 2, "classical-mod": 3,
    "approx-inv": 4, "blk-jacobi": 12, "blk-rowlump": 13, "blk-rowsum": 13,
    "blk-absrowsum": 14,
})

MGR_RESTRICTION = Choices({
    "injection": 0, "jacobi": 2, "approx-inv": 3, "air_1": 4, "air_1.5": 5,
    "blk-jacobi": 12, "cpr-like": 13, "columped": 14, "columped-partial": 15,
})

MGR_COARSE_LEVEL = Choices({
    "rap": 0, "galerkin": 0, "non-galerkin": 1, "cpr-like-diag": 2,
    "cpr-like-bdiag": 3, "approx-inv": 4, "acc": 5,
})

MGR_COARSEST = Choices({
    "def": -1, "amg": 0, "spdirect": 29, "ilu": 32, "fsai": 33,
    "schwarz": 1001,
})

MGR_CYCLE = Choices({"v": 1, "w": 2})
# (pre,post) relaxation pattern: 1=(1,0), 2=(0,1), 3=(1,1)
# (ref: MGRCycleSet, mgr.c:611-673)
MGR_SMOOTH_POS = Choices({"pre": 1, "post": 2, "pre+post": 3, "1": 1,
                          "2": 2, "3": 3})

# --- Solver / preconditioner type maps ----------------------------------

SOLVER_TYPES = ("pcg", "gmres", "fgmres", "bicgstab")

# jacobi / gauss-seidel are AMG configured as single-level relaxation
# (ref: precon.c:256-289 PreconArgsSetDefaultsForName).
PRECON_TYPES = (
    "amg", "jacobi", "gauss-seidel", "mgr", "ilu", "fsai", "ams", "ads",
    "schwarz", "none",
)

# --- Linear system (ref: linsys.c:362-387) ------------------------------

LS_TYPE = Choices({"online": 0, "ij": 1, "parcsr": 2, "mtx": 3})
RHS_MODE = Choices({"zeros": 0, "ones": 1, "file": 2, "random": 3, "randsol": 4})
INIT_GUESS_MODE = Choices({
    "zeros": 0, "ones": 1, "file": 2, "random": 3, "previous": 4,
})
EXEC_POLICY = Choices({"host": 0, "device": 1})

# --- Scaling (ref: scaling.c:43-66, scaling.h:21-29) --------------------

SCALING_TYPE = Choices({
    "rhs_l2": 0, "dofmap_mag": 1, "dofmap_custom": 2, "dofmap_row_custom": 3,
    "dofmap_col_custom": 4, "dofmap_similarity_custom": 5,
})

# --- Statistics (off/on/2) ----------------------------------------------

STATISTICS_MODE = Choices({"off": 0, "on": 1, "no": 0, "yes": 1, "2": 2,
                           "false": 0, "true": 1})

# --- print_system (ref: include/internal/linsys.h:26-73) ----------------

PRINT_TRIGGERS = (
    "all", "every_n_systems", "every_n_timesteps", "ids", "ranges",
    "iterations_over", "setup_time_over", "solve_time_over", "selectors",
)
PRINT_STAGES = Choices({"build": 1, "setup": 2, "apply": 4})

# --- Precon reuse (ref: include/internal/precon_reuse.h) ----------------

REUSE_POLICY = Choices({"static": 0, "adaptive": 1})
REUSE_METRIC = Choices({
    "iterations": 0, "solve_time": 1, "setup_time": 2, "total_time": 3,
    "solve_overhead_vs_setup": 4,
})
REUSE_TRANSFORM = Choices({
    "raw": 0, "delta": 1, "ratio": 2, "relative_increase": 3,
})
REUSE_MEAN = Choices({"arithmetic": 0, "power": 1, "geometric": 2,
                      "harmonic": 3, "rms": 4, "min": 5, "max": 6})
REUSE_DIRECTION = Choices({"higher_is_worse": 0, "lower_is_worse": 1})
REUSE_HISTORY_SOURCE = Choices({"entries": 0, "levels": 1})
