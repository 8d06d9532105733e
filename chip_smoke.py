#!/usr/bin/env python3
"""Smoke test of hypredrive_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit, CUDA, ``nvcc``; build the
   CUDA kernels from ``hypredrive_tpu_torch/csrc`` (timed).
2. The solve paths, each with both kernels' launch counters zeroed just
   before it and read just after; each must launch the kernels it runs:
   - ex1: examples/ex1.yml through ``hypredrive_tpu_torch.cli`` in float64,
     5 iterations, relative residual ≤ 1e-6, solution checked against
     scipy on the host;
   - lap64: a 64³ Laplacian, PCG + AMG to 1e-8 in float32 through the
     driver API, 10 ± 1 iterations over 6 levels;
   - lap128: a 128³ Laplacian (2,097,152 rows), PCG + AMG to 1e-8 in
     float64, within ±1 iteration of the JAX package's count;
   - mgr_ex3 / mgr_ex5: examples/ex3.yml and ex5.yml (GMRES + MGR on the
     dofmap'd multiphysics system, ex5 through ``include:``) through the
     CLI, 9 iterations each;
   - jacobi_ex1: examples/ex1-jacobi.yml, 21 iterations;
   - mgr_64: the nx = 64 three-field multiphysics system (786,432 rows),
     GMRES(30) + ex3's MGR in float64 through the driver API: the JAX
     package's iteration count and GMRES residual history (rel 1e-6), true
     relative residual ≤ 1e-6;
   - krylov_variants: FGMRES + MGR (9) and BiCGSTAB + MGR (6) on
     data/multiphys2k through the driver API, dofmap from its file;
   - mgr_ex4: examples/ex4.yml (GMRES + MGR with an ILU global relaxation
     and a hybrid-GS coarsest AMG) through the CLI;
   - seq_ex7 / seq_ex7_reuse / seq_ex7_frelax_reuse: the eight-system
     poroseq sequence through the CLI (FGMRES + MGR, ILU G-relaxation,
     nested-AMG F-relaxation), without reuse, with per-timestep reuse and
     with static frequency-2 reuse; every entry within ±1 iteration of the
     JAX package's count, and the reused entries setting up in under 0.2×
     the mean of the rebuilt ones;
   - amg_gs_fsai: examples/ex2.yml (hybrid GS + the FSAI complex smoother)
     and ex8.yml (five AMG variants) through the CLI;
   - ilu_variants: GMRES on data/multiphys2k with the standalone ILU types
     bj-ilu0, bj-ilut, gmres-iluk, nsh-iluk and ras-iluk and with additive
     Schwarz, against the JAX package's counts;
   - seq_64: two timesteps of two Newton systems at nx = 64 (786,432 rows
     each, built in memory), FGMRES + ex7-reuse's MGR with per-timestep
     reuse through the library API: the JAX package's counts ±1, true
     relative residuals ≤ 1.02e-6, setup skipped on the reused systems,
     the host setup of each rebuild split into ILU(0), nested AMG and the
     rest of MGR, first and warm solve, and the device busy share of a
     reused solve.
   - elasticity_rbm: examples/drivers/elasticity.py's flow rebuilt from
     the port's modules at 48×24×24 cells (88,200 rows, 5.47M nnz): its
     preset and config, the six rigid-body modes as the near null space,
     three PCG + AMG solves to 1e-6 through the lifecycle verbs, each
     within ±1 of the JAX package's count; the same with
     ``interp_vec_variant: 0``, and the driver's 12×6×6 default;
   - convdif_air: convection_diffusion_2d(1024, eps=1e-3) (1,048,576
     rows), GMRES(30) + AMG with AIR restriction and the AIR relaxation
     schedule (examples/drivers/convdif-gmres-air.yml) to 1e-8, and
     examples/drivers/convdif.py's transient loop (n = 40, 10 steps);
   - lap128_agg_cf: a 128³ Laplacian, PCG + AMG with one aggressive level
     and C/F ℓ1-Jacobi relaxation, its count and operator complexity;
   - ex6_eigspec / ex9_print_system: examples/ex6.yml (eigenvalues of
     M⁻¹A against the JAX package's, ``data/golden``) and
     examples/ex9-print-system.yml (the dump tree) through the CLI;
   - lsseq_ex7: data/poroseq packed into a zlib lsseq container by the
     port's ``tools/lsseq.py``, then ex7 through ``sequence_filename``;
   - scaling_xref: ex3 with rhs_l2 and dofmap_mag scaling, and GMRES + MGR
     on data/multiphys2k with ``rhs_mode: randsol`` (error norm and
     per-block error history against the JAX package's).
3. Kernels against their plain torch versions on the card, at the shapes
   of the 128³ solve (on lap128's own hierarchy): the fine-grid DIA
   operator, and the CSR remainders of P, R and the first coarse A;
   float32 (rel 1e-5) and float64 (rel 1e-12).  Kernel and plain times
   from CUDA events over back-to-back calls; device times per call from
   CUDA-graph replay (the kernels, the library call) and torch.profiler
   (the plain versions); for each shape the bound (least bytes over 3.35
   TB/s: the stored entries, indices, x and y once) and the device time
   of one library call computing the same product
   (``torch.sparse_csr_tensor @ x``, cuSPARSE; the DIA part converted to
   CSR), timed here and used nowhere in the port.  Every timing cycles
   through copies of the operand and x that fill four times the 50 MB L2,
   so each call reads its operand from device memory; a kernel more than
   5% faster than its bound fails.  The CSR kernel must give bit-identical
   y on a repeat launch, and its tile size is swept at A1.  Then the same
   at the MGR shapes of mgr_64 (level 0 P and R, the level 1 operator, the
   coarsest operator), float64 (rel 1e-12); at seq_64's shapes (the
   level-1 ILU L and U factors, the first coarse operator of the nested
   F-relaxation AMG); and at the elasticity fine operator and convdif_air's
   level-0 AIR restriction.

The JAX package's numbers pinned below come from ``scripts/jax_goldens.py``
run on the CPU.

Prints the kernel table as one JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json``.

``--baseline-csr FILE`` also builds FILE, an earlier ``csr_spmv.cu`` with
the row-group C interface (lanes per row as its argument), into
``build/csr_baseline/`` and times it at every CSR shape beside the current
kernel, in the order earlier, current, current, earlier.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# JAX package on the same 128³ problem (b = ones, x0 = 0, rtol 1e-8,
# float64), run on the CPU (PERF.md): iterations and PCG residual history
JAX_ITERS_128_F64 = 11
JAX_HISTORY_128_F64 = (
    1448.1546878700494, 3293.653967152578, 788.7789979336529,
    125.22490932459208, 17.11869182232035, 1.9396181274406765,
    0.2167578676005322, 0.02780726807465523, 0.004338904608680726,
    0.00060304664419422, 6.900813139053883e-05, 8.635607504721512e-06)

GOLDEN_EX1_ITERS = 5          # tests/test_examples.py GOLDEN["ex1.yml"]
GOLDEN_EX3_ITERS = 9          # tests/test_examples.py GOLDEN["ex3.yml"]
GOLDEN_EX1_JACOBI_ITERS = 21  # tests/test_examples.py GOLDEN["ex1-jacobi.yml"]
JAX_ITERS_64_F32 = 10         # JAX package's 64³ float32 count
JAX_LEVELS_64 = 6

# JAX package on multiphysics_fv_system(64, 3, contrast=0.3, coupling=0.12,
# convection=0.08) (786,432 rows, 6,742,016 nnz), b = ones, x0 = 0, float64,
# GMRES(30) + ex3's MGR, run on the CPU (PERF.md): iterations, the GMRES
# residual history, and the row counts of the coarsest AMG's levels
JAX_ITERS_MGR64 = 44
JAX_HISTORY_MGR64 = (
    886.8100134752651, 72017.77272093638, 20139.493302809155, 2676.51767603565,
    970.1984608324339, 678.3589318716658, 678.3532874887082, 606.619860462599,
    489.69296448996465, 409.013531806931, 345.98504816445745,
    322.3515283671175, 300.580274642792, 235.5700347795105, 116.91107736705754,
    53.935004618468824, 27.981450249770102, 17.174614831500463,
    13.25763863699021, 11.997632520871132, 10.987330242555512,
    9.076583193430604, 7.469657205306917, 6.488912620093237, 4.847001830381881,
    2.4665239239874324, 0.9844203235424079, 0.35482777408556626,
    0.11591599561578839, 0.04376244552488981, 0.029727374396014927,
    0.01521165566578143, 0.010541341924671115, 0.010420342985342113,
    0.00866428525153385, 0.005057877290857739, 0.002926940613721099,
    0.0020308397543692238, 0.00158599923226097, 0.0012916716852398138,
    0.0010491151455256284, 0.0009207545150702499, 0.0008718228678136989,
    0.0008043521942560302, 0.0005782035779433222)
JAX_COARSEST_LEVELS_MGR64 = (262144, 98304, 22528, 3328, 384, 64)

# ex3's MGR (examples/ex3.yml)
EX3_MGR = {"mgr": {
    "level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
              1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                  "restriction_type": "columped"}},
    "coarsest_level": "amg"}}

# ex7-reuse's solver and MGR (examples/ex7-reuse.yml)
EX7_FGMRES = {"fgmres": {"max_iter": 100, "krylov_dim": 30,
                         "relative_tol": 1e-6}}
EX7_MGR = {
    "max_iter": 1,
    "level": {
        0: {"f_dofs": [2],
            "f_relaxation": {"amg": {"coarsening": {"type": "pmis",
                                                    "strong_th": 0.5}}},
            "g_relaxation": "none", "restriction_type": "injection",
            "prolongation_type": "jacobi"},
        1: {"f_dofs": [1], "f_relaxation": "single", "g_relaxation": "ilu",
            "restriction_type": "columped",
            "prolongation_type": "injection"}},
    "coarsest_level": {"amg": {"max_iter": 1, "relaxation": {
        "down_type": "l1-jacobi", "up_type": "l1-jacobi"}}}}

# the JAX package's counts per stats entry through its CLI on the CPU
# (float64); tests/test_torch_slice_seq.py holds the port to them exactly
JAX_ITERS_EX4 = (10,)
JAX_ITERS_EX7 = (12, 21, 8, 12, 21, 8, 12, 21)
JAX_ITERS_EX7_REUSE = (12, 24, 8, 17, 21, 15, 12, 24)
JAX_ITERS_EX7_FRELAX_REUSE = (10, 22, 7, 15, 16, 18, 10, 20)
JAX_ITERS_EX2 = (5,)
JAX_ITERS_EX8 = (7, 6, 7, 6, 6)

# GMRES(30) to 1e-6 on data/multiphys2k (b from its file) with each
# standalone ILU type and Schwarz: the JAX package's counts on the CPU
JAX_ILU_VARIANTS = (
    ({"ilu": {"type": "bj-ilu0"}}, 60), ({"ilu": {"type": "bj-ilut"}}, 115),
    ({"ilu": {"type": "gmres-iluk"}}, 187),
    ({"ilu": {"type": "nsh-iluk"}}, 60), ({"ilu": {"type": "ras-iluk"}}, 104),
    ({"schwarz": {"variant": "as-spdirect"}}, 231))

# the JAX package on drift_sequence(64, 4) with ex7-reuse's FGMRES + MGR
# and per-timestep reuse (two Newton systems per timestep), float64,
# through its library API on the CPU: iterations and true relative
# residuals per system; systems 1 and 3 reuse the preconditioner
JAX_ITERS_SEQ64 = (38, 55, 20, 80)
JAX_RELRES_SEQ64 = (9.859454860586217e-07, 7.770520952997071e-07,
                    9.958417935126493e-07, 8.727718813545901e-07)

# the JAX package on the new paths, from scripts/jax_goldens.py on the CPU
# (float64): elasticity 48×24×24 per solve with rigid-body modes (GM2) and
# without (interp_vec_variant 0), and at the driver's 12×6×6 default
JAX_ITERS_ELASTICITY_48 = 35
JAX_ITERS_ELASTICITY_48_V0 = 20
JAX_ITERS_ELASTICITY_12 = 11
# GMRES + AIR on convection_diffusion_2d(1024, eps=1e-3), b = ones; and
# convdif.py's transient loop (n = 40, 10 steps, dt from 0.01 growing 1.5×)
JAX_ITERS_CONVDIF_1024 = 23
JAX_ITERS_CONVDIF_TRANSIENT = (4, 4, 5, 6, 7, 7, 8, 9, 9, 10)
# 128³ PCG + AMG with one aggressive level and C/F ℓ1-Jacobi
JAX_ITERS_LAP128_AGG_CF = 27
JAX_OC_LAP128_AGG_CF = 1.470297755552142
# ex6's eigenvalues of M⁻¹A (5,184 complex values).  The JAX package's own
# eigenvalues move by 2.64e-8 (relative, nearest neighbour; 2.48e-8 after
# sorting) when LAPACK runs on one thread instead of eight
# (``scripts/jax_goldens.py --eig-spread``): the nonsymmetric eig amplifies
# the last bits of M⁻¹A.  The bound is 1e-7, about four times that spread.
JAX_EX6_EIGENVALUES = os.path.join("data", "golden", "ex6_jax_eigenvalues.npy")
EX6_EIG_TOL = 1e-7
# ex9's dump tree and ‖x‖₂, ‖x‖₁, ‖x‖∞ of its solution dump
JAX_EX9_FILES = tuple(
    f"ls_00000/{stage}/{f}" for stage in ("apply", "build")
    for f in ("IJ.out.A", "IJ.out.b", "IJ.out.x", "IJ.out.x0",
              "metadata.yml"))
JAX_EX9_X_NORMS = (108.75138743773175, 3094.1666104093215, 6.594672387125621)
# ex3 with scaling; GMRES + MGR with rhs_mode randsol: the error norm and
# the per-dof-block error history against xref
JAX_ITERS_SCALING = {"rhs_l2": 9, "dofmap_mag": 10}
JAX_ITERS_RANDSOL = 7
JAX_ERROR_NORM_RANDSOL = 2.6802242318481424e-05
JAX_ERROR_HISTORY_RANDSOL = (
    (24.11078852553775, 23.812833516821716, 23.51069497733468),
    (0.8360729579814181, 1.6465996419098996, 2.172445863106062),
    (0.13000401786834503, 0.1513811464377395, 0.26529869105730275),
    (0.0287604852078096, 0.024455654308124193, 0.03438686288468899),
    (0.005713378579426644, 0.004283336317065077, 0.005111033511589427),
    (0.0007677588131643337, 0.0007220768229345043, 0.0009401667008576941),
    (8.238926549595286e-05, 8.045988566555878e-05, 0.0001586346649172192),
    (6.057544607359008e-06, 1.1529960045408335e-05, 2.342490913493031e-05))

# examples/drivers/elasticity.py's preset and DEFAULT_CONFIG
ELASTICITY_PRESET = (
    "elasticity_sdc_3d",
    "amg:\n  coarsening:\n    num_functions: 3\n    strong_th: 0.8\n"
    "    filter_functions: on",
    "Elasticity 3D AMG with function filtering")
ELASTICITY_CONFIG = """
general:
  name: elasticity
  use_millisec: on

linear_system:
  rhs_mode: ones

solver:
  pcg:
    max_iter: 200
    relative_tol: 1.0e-6
    print_level: 0

preconditioner:
  preset: elasticity_sdc_3d
"""
# the same AMG without interpolation vectors (the preset cannot take an
# override, so it is written out)
ELASTICITY_V0 = ELASTICITY_CONFIG.replace(
    "preset: elasticity_sdc_3d",
    "amg:\n    interp_vec_variant: 0\n    coarsening:\n"
    "      num_functions: 3\n      strong_th: 0.8\n"
    "      filter_functions: on")
CONVDIF_AIR = os.path.join("examples", "drivers", "convdif-gmres-air.yml")

# objects one phase hands to a later one (the mgr_64, seq_64, elasticity
# and convdif_air operators)
KEEP = {}

HBM_TB_S = 3.35   # H100 SXM device-memory rate (NVIDIA data sheet)
L2_BYTES = 50 * 2**20   # H100 SXM L2 cache (NVIDIA data sheet)
BOUND_SHARE_MAX = 1.05  # a kernel faster than its bound fails the check

# the earlier CSR kernel to time beside the current one (--baseline-csr)
BASELINE = {}


def drift_sequence(nx, count, seed=11):
    """A sequence of Newton systems from one time-stepping run: the
    multiphysics generator with its coupling and convection drifting by
    f_k = 1 + 0.1 sin(2.1 k), so every system keeps the sparsity pattern
    and stays well posed.  b_k = cos(0.3 k)·1 + 0.1·N(0, 1), drawn in
    order from one generator.  Returns ([(A_k, b_k)], dofmap)."""
    import numpy as np
    from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system

    rng = np.random.default_rng(seed)
    out, dofmap = [], None
    for k in range(count):
        f = 1.0 + 0.1 * np.sin(2.1 * k)
        A, dofmap = multiphysics_fv_system(nx, 3, seed=seed, contrast=0.3,
                                           coupling=0.12 * f,
                                           convection=0.08 * f)
        b = np.cos(0.3 * k) * np.ones(A.shape[0]) \
            + 0.1 * rng.standard_normal(A.shape[0])
        out.append((A, b))
    return out, dofmap


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _calls(fns, reps):
    """``fns`` (one callable, or copies of one call over copies of its
    operand) as a list, and the number of calls that cycles through it."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    return fns, max(reps, len(fns))


def time_ms(fns, reps=50, warmup=3):
    import torch

    fns, reps = _calls(fns, reps)
    for i in range(warmup):
        fns[i % len(fns)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(prof):
    """{kernel name: [device µs, count]} of a finished torch.profiler run,
    read from its raw device events; the record_function spans mirrored on
    the device are left out.  (``key_averages`` builds the whole event tree
    first and takes seconds on a solve of tens of thousands of kernels.)"""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.name().startswith(("hypredrv::", "amg_L", "mgr_L"))):
            continue
        acc = out.setdefault(e.name(), [0.0, 0])
        acc[0] += e.duration_ns() / 1e3
        acc[1] += 1
    return out


def device_ms(fns, reps=20):
    """Device time of one call: the sum of the kernels' device times under
    torch.profiler, per call.  Unlike back-to-back CUDA events it excludes
    the gaps while the host launches, which bound event times of kernels
    shorter than the host's launch period.  Used for the plain versions,
    which a CUDA graph cannot capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fns, reps = _calls(fns, reps)
    fns[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    us = sum(us for us, _ in device_kernels(prof).values())
    return us / 1e3 / reps


def replay_ms(fns, reps=20, replays=5):
    """Device time of one call: a CUDA graph of ``reps`` calls (cycling
    through ``fns``), replayed ``replays`` times between two CUDA events.
    The calls run back to back on the device with no host gaps, so kernels
    shorter than the host's launch period are timed too.  (After the solve
    phases the profiler was seen to drop kernel records, so it times only
    what a graph cannot capture.)"""
    import torch

    fns, reps = _calls(fns, reps)
    fns[0]()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def phase_env(report):
    import torch
    from hypredrive_tpu_torch.ops import kernels
    from hypredrive_tpu_torch.io import native

    report["nvidia_smi"] = nvidia_smi()
    report["torch"] = torch.__version__
    report["torch_cuda"] = torch.version.cuda
    nvcc = kernels.find_nvcc()
    check(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report["nvcc"] = ver[-1] if ver else ""
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, nvcc: {report['nvcc']}")
    # the host helpers' g++ build runs beside the kernels' nvcc builds
    t0 = time.perf_counter()
    host = {}
    th = threading.Thread(target=lambda: host.update(
        backend=native.backend(), s=time.perf_counter() - t0))
    th.start()
    kernels.lib()
    report["kernel_build_s"] = time.perf_counter() - t0
    print(f"kernel build + load: {report['kernel_build_s']:.3f} s "
          f"({kernels.BUILD_ROOT})")
    th.join()
    report["host_helpers"] = host.get("backend")
    print(f"AMG host setup helpers: {report['host_helpers']} "
          f"({host.get('s', 0.0):.3f} s)")


def spmv_bytes(kind, E, itemsize):
    """Least bytes one matvec of E's DIA or CSR part moves: its stored
    entries (values; the CSR's indices and indptr too), y and x once.  A
    DIA slot that holds no entry of the matrix (a zero inside the band or
    past its ends) is no work of the function and is not counted."""
    import torch

    nr, nc = E.shape
    if kind == "dia_spmv":
        entries = int(torch.count_nonzero(E.dia_data))
        return entries * itemsize + (nr + nc) * itemsize
    return (E.data.numel() * (itemsize + 4)
            + (nr + 1) * E.indptr.element_size() + (nr + nc) * itemsize)


def operand_copies(nbytes):
    """Copies of a kernel's operand (the matrix part and x) that one timing
    cycles through: enough to fill four times the L2, so that every call
    reads its operand from device memory, as the bound assumes, and not
    from what the previous call left in the L2."""
    return max(1, -(-4 * L2_BYTES // nbytes))


def dia_as_csr(dia, offsets, n_cols):
    """(crow, col, values) int32/int32/dtype of a (D, n_rows) DIA part, the
    entries inside the columns, row by row in offset order."""
    import torch

    n_rows = dia.shape[1]
    offs = torch.tensor(offsets, device=dia.device)
    cols = torch.arange(n_rows, device=dia.device)[:, None] + offs[None, :]
    ok = (cols >= 0) & (cols < n_cols)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=dia.device)
    crow[1:] = torch.cumsum(ok.sum(dim=1), 0)
    return crow.int(), cols[ok].int(), dia.t()[ok].contiguous()


def library_spmv(crow, col, values, shape):
    """One PyTorch call computing the same product: a sparse CSR tensor
    times x (cuSPARSE).  The yardstick of library_ms; the port never calls
    it."""
    import torch

    A = torch.sparse_csr_tensor(crow, col, values, size=shape,
                                check_invariants=False)
    return lambda x: torch.mv(A, x)


def load_baseline(src):
    """Build an earlier csr_spmv.cu (row-group C interface) into
    build/csr_baseline/ and load it."""
    from hypredrive_tpu_torch.ops import kernels

    out_dir = os.path.join(REPO, "build", "csr_baseline")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libcsr_baseline.so")
    proc = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                           so, src], capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"baseline build: {proc.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"hdtt_csr_spmv_{suffix}")
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, vp]
    BASELINE["lib"] = lib


def baseline_spmv(nr, nnz, dtype):
    """The earlier row-group kernel on a CSR part op = (indptr, indices,
    data, tiles) of nr rows, with the lanes per row it chose (the power of
    two ≥ the mean row length, in 2..32)."""
    import torch

    lib = BASELINE["lib"]
    g = 2
    while g < 32 and g < nnz / max(1, nr):
        g *= 2
    fn = (lib.hdtt_csr_spmv_f32 if dtype == torch.float32
          else lib.hdtt_csr_spmv_f64)

    def run(op, x):
        indptr, indices, data, _ = op
        y = torch.empty(nr, dtype=x.dtype, device=x.device)
        rc = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                x.data_ptr(), y.data_ptr(), nr, g, 0,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"baseline csr_spmv: CUDA error {rc}")
        return y
    return run


class KernelChecks:
    """Each kernel against its plain version on the same inputs: max
    error; kernel, plain and library times from back-to-back CUDA events;
    device times of the kernel and the library call from CUDA-graph replay
    and of the plain version from the profiler; the bound from the least
    bytes.  Every timing cycles through ``operand_copies`` copies of the
    operand and x, so no call finds its operand in the L2; a kernel that
    still beats its bound by more than 5% fails."""

    TOL = {"float32": 1e-5, "float64": 1e-12}

    def __init__(self):
        import numpy as np

        self.rng = np.random.default_rng(0)
        self.rows = []

    def compare(self, name, shape_name, dt, ops, run, plain, n_x, nbytes,
                library, baseline=None):
        """``ops``: copies of the operand; ``run(op, x)``, ``plain(op, x)``
        and ``baseline(op, x)`` the kernel, its plain version and an earlier
        kernel; ``library(op)`` one library call's closure over op."""
        import numpy as np
        import torch

        dtn = str(dt).replace("torch.", "")
        x = torch.as_tensor(self.rng.standard_normal(n_x), dtype=dt,
                            device="cuda")
        xs = [x] + [x.clone() for _ in ops[1:]]
        op = ops[0]
        y = run(op, x)
        yp = plain(op, x)
        y_again = run(op, x)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        scale = float(yp.abs().max()) or 1.0
        rel = err / scale
        repeat_equal = bool(torch.equal(y, y_again))

        def each(fn):
            return [lambda o=o, v=v: fn(o, v) for o, v in zip(ops, xs)]

        ms = time_ms(each(run))
        plain_ms = time_ms(each(plain))
        plain_dev = device_ms(each(plain))
        bound = nbytes / (HBM_TB_S * 1e12) * 1e3
        row = {"kernel": name, "shape": shape_name, "dtype": dtn,
               "max_abs_err": err, "max_rel_err": rel,
               "tol_rel": self.TOL[dtn], "repeat_bit_identical": repeat_equal,
               "ms": ms, "plain_ms": plain_ms, "plain_device_ms": plain_dev,
               "bytes": nbytes, "operand_copies": len(ops),
               "bound_ms": bound, "bound_by": "bytes"}
        if baseline is not None:
            # earlier, current, current, earlier
            base = [replay_ms(each(baseline))]
            dev = (replay_ms(each(run)) + replay_ms(each(run))) / 2
            base.append(replay_ms(each(baseline)))
            yb = baseline(op, x)
            row["baseline_device_ms"] = sum(base) / 2
            row["baseline_rel_err"] = float((yb - yp).abs().max()) / scale
        else:
            dev = replay_ms(each(run))
        row["device_ms"] = dev
        row["bound_share"] = bound / row["device_ms"]
        row["tb_s"] = nbytes / (row["device_ms"] * 1e-3) / 1e12
        try:
            lib_runs = [library(o) for o in ops]
            yl = lib_runs[0](x)
            torch.cuda.synchronize()
            row["library_rel_err"] = float((yl - yp).abs().max()) / scale
            row["library_ms"] = replay_ms([lambda f=f, v=v: f(v)
                                           for f, v in zip(lib_runs, xs)])
            del lib_runs, yl
        except RuntimeError as exc:   # no such call, or not capturable
            row["library_ms"] = None
            row["library_error"] = str(exc)[:200]
        self.rows.append(row)
        lib_txt = ("n/a" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f}")
        base_txt = (f", PR 3 kernel {row['baseline_device_ms']:.4f}"
                    if "baseline_device_ms" in row else "")
        print(f"  {name:9s} {shape_name:38s} {dtn:8s} rel {rel:.3e}  "
              f"events: kernel {ms:.4f} plain {plain_ms:.4f} ms; device: "
              f"kernel {row['device_ms']:.4f}{base_txt} plain "
              f"{plain_dev:.4f} library {lib_txt} bound {bound:.4f} ms "
              f"({100 * row['bound_share']:.1f}%), {row['tb_s']:.2f} TB/s, "
              f"{len(ops)} operand copies")
        check(np.isfinite(rel) and rel <= self.TOL[dtn],
              f"{name} {shape_name} {dt}: rel err {rel:.3e} > "
              f"{self.TOL[dtn]}")
        check(name != "csr_spmv" or repeat_equal,
              f"{name} {shape_name} {dt}: a repeat launch differs")
        check(row["bound_share"] <= BOUND_SHARE_MAX,
              f"{name} {shape_name} {dt}: {row['device_ms']:.4f} ms beats "
              f"its bound {bound:.4f} ms: the bound or the timing is wrong")
        return row

    def matrix(self, shape_name, E, dt):
        """Every kernel part (DIA, CSR) of device matrix E."""
        from hypredrive_tpu_torch.ops.csr_spmv import (csr_spmv,
                                                       csr_spmv_plain)
        from hypredrive_tpu_torch.ops.dia_spmv import (dia_spmv,
                                                       dia_spmv_plain)

        nr, nc = E.shape
        size = dt.itemsize
        check(E.dense is None, f"{shape_name} is stored dense")
        if E.dia_data is not None:
            offs = E.dia_offsets
            nbytes = spmv_bytes("dia_spmv", E, size)
            dia = E.dia_data.to(dt)
            ops = [dia] + [dia.clone()
                           for _ in range(operand_copies(nbytes) - 1)]
            self.compare("dia_spmv", f"{shape_name} D={len(offs)}", dt, ops,
                         lambda d, x: dia_spmv(d, offs, x, nc),
                         lambda d, x: dia_spmv_plain(d, offs, x, nc), nc,
                         nbytes,
                         lambda d: library_spmv(*dia_as_csr(d, offs, nc),
                                                E.shape))
            del ops, dia
        if E.data is not None:
            nbytes = spmv_bytes("csr_spmv", E, size)
            op = (E.indptr, E.indices, E.data.to(dt), E.tiles)
            ops = [op] + [tuple(t.clone() for t in op)
                          for _ in range(operand_copies(nbytes) - 1)]
            self.compare("csr_spmv", f"{shape_name} nnz={E.data.numel()}",
                         dt, ops,
                         lambda o, x: csr_spmv(o[0], o[1], o[2], x, nr, o[3]),
                         lambda o, x: csr_spmv_plain(o[0], o[1], o[2], x, nr),
                         nc, nbytes,
                         lambda o: library_spmv(o[0].int(), o[1], o[2],
                                                E.shape),
                         baseline_spmv(nr, E.data.numel(), dt)
                         if BASELINE else None)
            del ops, op


def tile_sweep(shape_name, E):
    """Device ms (graph replay) and event ms of the CSR kernel on E's
    remainder (float64) at each tile size, max_rows = min(TILE_ROWS,
    tile_nnz); the default is what the device matrix builds."""
    import torch
    from hypredrive_tpu_torch.ops.csr_spmv import (TILE_NNZ, TILE_ROWS,
                                                   csr_spmv, csr_tiles)

    x = torch.ones(E.shape[1], dtype=torch.float64, device="cuda")
    nr = E.shape[0]
    indptr = E.indptr.cpu().numpy()
    out = []
    for tile_nnz in (128, 256, 512, 1024):
        max_rows = min(TILE_ROWS, tile_nnz)
        tiles = torch.as_tensor(csr_tiles(indptr, tile_nnz, max_rows),
                                device="cuda")
        def run():
            return csr_spmv(E.indptr, E.indices, E.data, x, nr, tiles)
        ms = replay_ms(run)
        event_ms = time_ms(run)
        chosen = (tile_nnz, max_rows) == (TILE_NNZ, TILE_ROWS)
        out.append({"shape": shape_name, "tile_nnz": tile_nnz,
                    "max_rows": max_rows, "tiles": tiles.shape[1] - 1,
                    "device_ms": ms, "event_ms": event_ms, "chosen": chosen,
                    "mean_row_nnz": E.data.numel() / nr})
        print(f"  csr_spmv {shape_name} tile {tile_nnz:4d} entries / "
              f"{max_rows:3d} rows ({tiles.shape[1] - 1} tiles): device "
              f"{ms:.4f} ms, events {event_ms:.4f} ms"
              f"{'  (chosen)' if chosen else ''}")
    return out


def phase_kernels(report):
    """Each kernel against its plain version at the 128³ solve's shapes:
    the fine operator and level 0's P and R and level 1's A of the
    hierarchy the lap128 path set up."""
    import torch

    state = KEEP.pop("lap128_state")
    checks = KernelChecks()
    lv0, lv1 = state.levels[0], state.levels[1]
    A = lv0.A
    for E in (lv0.P, lv0.R, lv1.A):
        check(E.data is not None, f"{E.shape} has no CSR remainder")
    for dt in (torch.float64, torch.float32):
        checks.matrix(f"A0 {A.shape[0]}x{A.shape[1]}", A, dt)
        for shape_name, E in ((f"P0 {lv0.P.shape[0]}x{lv0.P.shape[1]}",
                               lv0.P),
                              (f"R0 {lv0.R.shape[0]}x{lv0.R.shape[1]}",
                               lv0.R),
                              (f"A1 {lv1.A.shape[0]}x{lv1.A.shape[1]}",
                               lv1.A)):
            checks.matrix(shape_name, E, dt)
    report["kernel_checks"] = checks.rows
    report["csr_tile_sweep"] = tile_sweep("A1", lv1.A)
    del state, A
    torch.cuda.empty_cache()


def phase_ex1(report):
    import numpy as np
    import scipy.sparse.linalg as spla
    import hypredrive_tpu_torch
    from hypredrive_tpu_torch import cli
    from hypredrive_tpu_torch.io import ij

    collect = []
    rc = cli.run_one_config(os.path.join("examples", "ex1.yml"),
                            overrides=[("general:print_config_params",
                                        "off")],
                            collect=collect)
    check(rc == 0, f"ex1: cli returned {rc}")
    drv = collect[0]
    (e,) = drv.stats.entries
    report["ex1"] = {"iters": e.iters, "rel_res_norm": e.rel_res_norm,
                     "setup_s": e.setup_time, "solve_s": e.solve_time}
    check(e.iters == GOLDEN_EX1_ITERS,
          f"ex1: {e.iters} iterations, expected {GOLDEN_EX1_ITERS}")
    check(e.converged and e.rel_res_norm <= 1e-6,
          f"ex1: relative residual {e.rel_res_norm:.3e} > 1e-6")
    # the same config through the one-shot API, for the solution vector
    res = hypredrive_tpu_torch.solve(config=os.path.join("examples",
                                                         "ex1.yml"))
    check(res.iters == GOLDEN_EX1_ITERS,
          f"ex1 via solve(): {res.iters} iterations")
    x = res.x
    A_host, _ = ij.read_matrix_auto("data/ps3d10pt7/np1/IJ.out.A")
    b = ij.read_vector_auto("data/ps3d10pt7/np1/IJ.out.b")
    check(x.shape == (A_host.shape[0],) and np.all(np.isfinite(x)),
          "ex1: solution not finite or of the wrong shape")
    host_rel = np.linalg.norm(b - A_host @ x) / np.linalg.norm(b)
    x_ref = spla.spsolve(A_host.tocsc(), b)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    report["ex1"].update(host_rel_res=host_rel, rel_err_vs_scipy=err)
    print(f"ex1: {e.iters} iterations, rel res {e.rel_res_norm:.3e} "
          f"(host {host_rel:.3e}), |x - x_scipy|/|x_scipy| {err:.3e}, "
          f"setup {e.setup_time:.4f} s, solve {e.solve_time:.4f} s")
    check(host_rel <= 1e-6 and err <= 1e-4,
          f"ex1: host check failed (rel res {host_rel:.3e}, err {err:.3e})")


def run_laplacian(nx, dtype, amg=None):
    """PCG + AMG to 1e-8 on an nx³ Laplacian through the driver API
    (``amg``: the AMG section, else the defaults)."""
    import numpy as np
    from hypredrive_tpu_torch import HypreDrive

    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict({
        "general": {"dtype": dtype},
        "linear_system": {"generate": {"kind": "laplacian_7pt", "nx": nx},
                          "rhs_mode": "ones"},
        "solver": {"pcg": {"relative_tol": 1e-8, "max_iter": 100}},
        "preconditioner": {"amg": amg} if amg else "amg",
    })
    sys_ = drv.linear_system_build()
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    e = drv.stats.entries[-1]
    x = drv.get_solution()
    state = drv.precon.state
    levels = len(state.levels)
    out = {"rows": sys_.num_rows, "nnz": sys_.nnz, "levels": levels,
           "level_rows": [lv.A.shape[0] for lv in state.levels],
           "operator_complexity": (sum(lv.A.nnz for lv in state.levels)
                                   / state.levels[0].A.nnz),
           "smoothers": sorted({lv.smoother for lv in state.levels}),
           "iters": res.iters, "rel_res_norm": res.rel_res_norm,
           "converged": res.converged, "build_s": e.build_time,
           "setup_s": e.setup_time, "solve_s": e.solve_time,
           "history": [float(h) for h in res.res_history[:res.iters + 1]]}
    check(x.shape == (sys_.num_rows,) and np.all(np.isfinite(x)),
          f"{nx}^3: solution not finite or of the wrong shape")
    print(f"{nx}^3 {dtype}: {sys_.num_rows} rows, {sys_.nnz} nnz, "
          f"{levels} levels, {res.iters} iterations, rel res "
          f"{res.rel_res_norm:.3e}, build {e.build_time:.3f} s, setup "
          f"{e.setup_time:.3f} s, solve {e.solve_time:.4f} s")
    # a second solve on the same hierarchy: the first one also pays the
    # caching allocator's first allocations at these sizes
    drv.reset_initial_guess()
    n0 = {k: f.launches for k, f in launch_counters().items()}
    out["solve_warm_s"] = drv.linear_solver_apply().solve_time
    out["warm_launches"] = {k: f.launches - n0[k]
                            for k, f in launch_counters().items()}
    print(f"  second solve: {out['solve_warm_s']:.4f} s, kernel launches "
          f"{out['warm_launches']}")
    out["profile"] = profile_solve(drv)
    out["state"] = drv.precon.state
    drv.destroy()
    return out


def profile_solve(drv):
    """One more solve on the set-up hierarchy under torch.profiler: wall
    time, device busy time (sum of kernel times) and the top kernels.
    Informational only: a profiler that records nothing fails no phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    drv.reset_initial_guess()
    torch.cuda.synchronize()
    # device activity only: recording every host op too costs seconds to
    # read back on the long solves and slows the solve it measures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drv.linear_solver_apply()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kern = device_kernels(prof)
    busy = sum(us for us, _ in kern.values()) / 1e6
    n_dev = sum(n for _, n in kern.values())
    top = [{"name": k[:80], "ms": us / 1e3, "count": n}
           for k, (us, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]]
    # the hand-written kernels' device time in this solve
    by_kernel = {name: {"ms": sum(us for k, (us, _) in kern.items()
                                  if name in k) / 1e3,
                        "count": sum(n for k, (_, n) in kern.items()
                                     if name in k)}
                 for name in KERNELS}
    print(f"  profiled solve: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%), {n_dev} device items")
    for t in top:
        print(f"    {t['ms']:9.3f} ms  x{t['count']:5d}  {t['name']}")
    print(f"  hand-written kernels: {by_kernel}")
    return {"wall_s": wall, "device_busy_s": busy, "device_items": n_dev,
            "top": top, "by_kernel": by_kernel}


def phase_64(report):
    r = report["lap64_f32"] = run_laplacian(64, "float32")
    del r["state"]
    # the recurrence reaches 1e-8; the true float32 residual stops near
    # eps32·κ(A) ≈ 6e-8 · 1.7e3 ≈ 1e-4 for this operator
    check(r["converged"] and r["rel_res_norm"] <= 1e-3,
          f"64^3: not converged (true rel {r['rel_res_norm']:.3e})")
    check(abs(r["iters"] - JAX_ITERS_64_F32) <= 1,
          f"64^3: {r['iters']} iterations, expected {JAX_ITERS_64_F32}±1")
    check(r["levels"] == JAX_LEVELS_64,
          f"64^3: {r['levels']} levels, expected {JAX_LEVELS_64}")


def phase_128(report):
    r = report["lap128_f64"] = run_laplacian(128, "float64")
    KEEP["lap128_state"] = r.pop("state")   # for the kernel checks
    check(r["rows"] == 2097152 and r["nnz"] == 14581760,
          f"128^3: {r['rows']} rows / {r['nnz']} nnz")
    check(r["converged"] and r["rel_res_norm"] <= 1e-8,
          f"128^3: not converged (rel {r['rel_res_norm']:.3e})")
    check(abs(r["iters"] - JAX_ITERS_128_F64) <= 1,
          f"128^3: {r['iters']} iterations, JAX package "
          f"{JAX_ITERS_128_F64}±1")
    # same recurrence, other summation orders: float64 rounding, amplified
    # over a dozen iterations, stays far below 1e-6
    k = min(len(r["history"]), len(JAX_HISTORY_128_F64))
    dev = max(abs(a / b - 1) for a, b in zip(r["history"][:k],
                                              JAX_HISTORY_128_F64[:k]))
    r["history_rel_dev_vs_jax"] = dev
    print(f"128^3 residual history vs the JAX package: max rel dev {dev:.3e}")
    check(dev <= 1e-6, f"128^3: history deviates from JAX by {dev:.3e}")


def run_cli(name):
    """An example config through the CLI on the card; its stats entries."""
    from hypredrive_tpu_torch import cli

    collect = []
    rc = cli.run_one_config(os.path.join("examples", name),
                            overrides=[("general:print_config_params",
                                        "off")],
                            collect=collect)
    check(rc == 0, f"{name}: cli returned {rc}")
    return collect[0].stats.entries


def run_example(report, key, name, golden, rtol=1e-6):
    """An example config through the CLI on the card (float64)."""
    (e,) = run_cli(name)
    report[key] = {"iters": e.iters, "rel_res_norm": e.rel_res_norm,
                   "setup_s": e.setup_time, "solve_s": e.solve_time}
    print(f"{name}: {e.iters} iterations, rel res {e.rel_res_norm:.3e}, "
          f"setup {e.setup_time:.4f} s, solve {e.solve_time:.4f} s")
    check(e.iters == golden, f"{name}: {e.iters} iterations, expected "
                             f"{golden}")
    check(e.converged and e.rel_res_norm <= rtol,
          f"{name}: relative residual {e.rel_res_norm:.3e} > {rtol}")


def phase_mgr_ex3(report):
    run_example(report, "mgr_ex3", "ex3.yml", GOLDEN_EX3_ITERS)


def phase_mgr_ex5(report):
    run_example(report, "mgr_ex5", "ex5.yml", GOLDEN_EX3_ITERS)


def phase_jacobi_ex1(report):
    run_example(report, "jacobi_ex1", "ex1-jacobi.yml",
                GOLDEN_EX1_JACOBI_ITERS)


def mgr_driver(A, dofmap, solver, policy="device"):
    """GMRES-family + ex3's MGR on (A, dofmap) through the library API,
    b = ones, x0 = 0, float64; set up, not yet solved."""
    import numpy as np
    from hypredrive_tpu_torch import HypreDrive

    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict({"general": {"exec_policy": policy},
                              "linear_system": {}, "solver": solver,
                              "preconditioner": EX3_MGR})
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    drv.set_dofmap(dofmap)
    drv.set_rhs(np.ones(A.shape[0]))
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    return drv


def phase_mgr64(report):
    """nx = 64 multiphysics, GMRES(30) + MGR, against the JAX package."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv

    t0 = time.perf_counter()
    A, dofmap = multiphysics_fv_system(64, 3, contrast=0.3, coupling=0.12,
                                       convection=0.08)
    gen_s = time.perf_counter() - t0
    check(A.shape[0] == 786432 and A.nnz == 6742016,
          f"mgr_64: {A.shape[0]} rows / {A.nnz} nnz")
    t0 = time.perf_counter()
    drv = mgr_driver(A, dofmap, "gmres")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"mgr_64: host setup (MGR + coarsest AMG) and upload "
          f"{setup_s:.3f} s")
    state = drv.precon.state
    coarsest = tuple(lv.A.shape[0] for lv in state.coarsest_state.levels)
    res = drv.linear_solver_apply()
    x = drv.get_solution()
    host_rel = float(np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]))
    hist = [float(h) for h in res.res_history[:res.iters + 1]]
    k = min(len(hist), len(JAX_HISTORY_MGR64))
    dev = max(abs(a / b - 1) for a, b in zip(hist[:k],
                                              JAX_HISTORY_MGR64[:k]))
    out = report["mgr_64"] = {
        "rows": A.shape[0], "nnz": A.nnz,
        "mgr_level_rows": [lv.A.shape[0] for lv in state.levels],
        "coarsest_amg_level_rows": list(coarsest),
        "iters": res.iters, "rel_res_norm": res.rel_res_norm,
        "host_rel_res": host_rel, "converged": res.converged,
        "generate_s": gen_s, "setup_s": setup_s,
        "solve_s": res.solve_time, "history": hist,
        "history_rel_dev_vs_jax": dev}
    print(f"mgr_64: {A.shape[0]} rows, {A.nnz} nnz, MGR levels "
          f"{out['mgr_level_rows']}, coarsest AMG levels {list(coarsest)}; "
          f"generate {gen_s:.3f} s, setup (host MGR + AMG + upload) "
          f"{setup_s:.3f} s; {res.iters} iterations, rel res "
          f"{res.rel_res_norm:.3e} (host {host_rel:.3e}), first solve "
          f"{res.solve_time:.4f} s; history vs the JAX package: max rel "
          f"dev {dev:.3e}")
    drv.reset_initial_guess()
    n0 = dia_spmv.launches + csr_spmv.launches
    warm = drv.linear_solver_apply()
    out["solve_warm_s"] = warm.solve_time
    out["kernel_launches_per_iter"] = (
        (dia_spmv.launches + csr_spmv.launches - n0) / max(1, warm.iters))
    print(f"  second solve: {warm.solve_time:.4f} s, "
          f"{out['kernel_launches_per_iter']:.1f} DIA+CSR launches per "
          f"GMRES iteration")
    prof = out["profile"] = profile_solve(drv)
    out["device_items_per_iter"] = prof["device_items"] / max(1, warm.iters)
    print(f"  {out['device_items_per_iter']:.1f} device items per GMRES "
          f"iteration")
    KEEP["mgr64_state"] = state
    drv.destroy()
    check(res.iters == JAX_ITERS_MGR64,
          f"mgr_64: {res.iters} iterations, JAX package {JAX_ITERS_MGR64}")
    check(coarsest == JAX_COARSEST_LEVELS_MGR64,
          f"mgr_64: coarsest AMG levels {coarsest}, JAX package "
          f"{JAX_COARSEST_LEVELS_MGR64}")
    # same recurrences, other summation orders (float64)
    check(dev <= 1e-6, f"mgr_64: history deviates from JAX by {dev:.3e}")
    check(res.converged and res.rel_res_norm <= 1e-6 and host_rel <= 1e-6,
          f"mgr_64: true rel res {res.rel_res_norm:.3e} (host "
          f"{host_rel:.3e}) > 1e-6")
    check(np.all(np.isfinite(x)) and x.shape == (A.shape[0],),
          "mgr_64: solution not finite or of the wrong shape")


def phase_krylov_variants(report):
    """FGMRES and BiCGSTAB + MGR on data/multiphys2k, dofmap from file."""
    from hypredrive_tpu_torch.io import ij

    base = os.path.join("data", "multiphys2k", "np1")
    A, _ = ij.read_matrix_auto(os.path.join(base, "IJ.out.A"))
    dofmap = ij.read_dofmap_auto(os.path.join(base, "dofmap.out"))
    out = report["krylov_variants"] = {}
    for solver, golden in (("fgmres", 9), ("bicgstab", 6)):
        drv = mgr_driver(A, dofmap, solver)
        res = drv.linear_solver_apply()
        drv.destroy()
        out[solver] = {"iters": res.iters, "rel_res_norm": res.rel_res_norm,
                       "solve_s": res.solve_time}
        print(f"{solver} + MGR on multiphys2k: {res.iters} iterations, rel "
              f"res {res.rel_res_norm:.3e}, solve {res.solve_time:.4f} s")
        check(res.iters == golden,
              f"{solver} + MGR: {res.iters} iterations, expected {golden}")
        check(res.converged and res.rel_res_norm <= 1e-6,
              f"{solver} + MGR: rel res {res.rel_res_norm:.3e} > 1e-6")


def phase_mgr_kernels(report):
    """Each kernel against its plain version at mgr_64's MGR shapes."""
    import torch

    state = KEEP.pop("mgr64_state")
    lv0, lv1 = state.levels
    A_c = state.coarsest_state.levels[0].A
    checks = KernelChecks()
    for shape_name, E in (
            (f"MGR P0 {lv0.P.shape[0]}x{lv0.P.shape[1]}", lv0.P),
            (f"MGR R0 {lv0.R.shape[0]}x{lv0.R.shape[1]}", lv0.R),
            (f"MGR A1 {lv1.A.shape[0]}x{lv1.A.shape[1]}", lv1.A),
            (f"MGR coarsest A {A_c.shape[0]}x{A_c.shape[1]}", A_c)):
        checks.matrix(shape_name, E, torch.float64)
    report["kernel_checks"].extend(checks.rows)
    del state
    torch.cuda.empty_cache()


def run_sequence(report, key, name, goldens, rtol=1e-6, reused=()):
    """A config with several stats entries through the CLI on the card:
    each entry within ±1 iteration of the JAX package's count and
    converged to ``rtol``; the ``reused`` entries (preconditioner kept)
    set up in under 0.2× the mean setup of the others."""
    entries = run_cli(name)
    out = report[key] = {k: [getattr(e, a) for e in entries] for k, a in (
        ("iters", "iters"), ("rel_res_norm", "rel_res_norm"),
        ("setup_s", "setup_time"), ("solve_s", "solve_time"))}
    print(f"{name}: iterations {out['iters']} (JAX package "
          f"{list(goldens)}), max rel res {max(out['rel_res_norm']):.3e}, "
          f"setup s {[round(t, 4) for t in out['setup_s']]}, solve s "
          f"{[round(t, 4) for t in out['solve_s']]}")
    check(len(entries) == len(goldens),
          f"{name}: {len(entries)} entries, expected {len(goldens)}")
    for i, (e, g) in enumerate(zip(entries, goldens)):
        check(abs(e.iters - g) <= 1,
              f"{name} entry {i}: {e.iters} iterations, JAX package {g}")
        check(e.converged and e.rel_res_norm <= rtol,
              f"{name} entry {i}: rel res {e.rel_res_norm:.3e} > {rtol}")
    if reused:
        rebuilt = [e.setup_time for i, e in enumerate(entries)
                   if i not in reused]
        bound = 0.2 * sum(rebuilt) / len(rebuilt)
        for i in reused:
            check(entries[i].setup_time < bound,
                  f"{name} entry {i}: setup {entries[i].setup_time:.4f} s "
                  f"with the preconditioner reused (bound {bound:.4f} s)")


def phase_mgr_ex4(report):
    run_sequence(report, "mgr_ex4", "ex4.yml", JAX_ITERS_EX4)


def phase_seq_ex7(report):
    run_sequence(report, "seq_ex7", "ex7.yml", JAX_ITERS_EX7)


def phase_seq_ex7_reuse(report):
    run_sequence(report, "seq_ex7_reuse", "ex7-reuse.yml",
                 JAX_ITERS_EX7_REUSE, reused=(1, 3, 5, 7))


def phase_seq_ex7_frelax_reuse(report):
    run_sequence(report, "seq_ex7_frelax_reuse", "ex7-mgr-frelax-reuse.yml",
                 JAX_ITERS_EX7_FRELAX_REUSE, reused=(1, 3, 5, 7))


def phase_amg_gs_fsai(report):
    """ex2 (hybrid GS down/up + the FSAI complex smoother on level 0) and
    ex8's five AMG variants (Chebyshev, hybrid symmetric GS, FSAI)."""
    run_sequence(report, "amg_ex2", "ex2.yml", JAX_ITERS_EX2)
    run_sequence(report, "amg_ex8", "ex8.yml", JAX_ITERS_EX8, rtol=1e-9)


def phase_ilu_variants(report):
    """GMRES with each standalone ILU type and Schwarz on multiphys2k."""
    import numpy as np
    from hypredrive_tpu_torch import HypreDrive

    base = os.path.join("data", "multiphys2k", "np1")
    out = report["ilu_variants"] = []
    for precon, golden in JAX_ILU_VARIANTS:
        drv = HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict({
            "general": {"statistics": False},
            "linear_system": {
                "matrix_filename": os.path.join(base, "IJ.out.A"),
                "rhs_filename": os.path.join(base, "IJ.out.b")},
            "solver": {"gmres": {"max_iter": 300, "krylov_dim": 30,
                                 "relative_tol": 1e-6}},
            "preconditioner": precon})
        drv.linear_system_build()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        e = drv.stats.entries[-1]
        x = drv.get_solution()
        drv.destroy()
        name = json.dumps(precon, sort_keys=True)
        out.append({"precon": precon, "iters": res.iters,
                    "rel_res_norm": res.rel_res_norm,
                    "setup_s": e.setup_time, "solve_s": e.solve_time})
        print(f"GMRES + {name}: {res.iters} iterations (JAX package "
              f"{golden}), rel res {res.rel_res_norm:.3e}, setup "
              f"{e.setup_time:.4f} s, solve {e.solve_time:.4f} s")
        check(abs(res.iters - golden) <= 1,
              f"{name}: {res.iters} iterations, JAX package {golden}")
        check(res.converged and res.rel_res_norm <= 1e-6
              and np.all(np.isfinite(x)),
              f"{name}: rel res {res.rel_res_norm:.3e} > 1e-6")


def _span_seconds(prof, prefix):
    """Host seconds inside the profiler spans whose names start with
    ``prefix``, outermost only (nested spans of the same prefix are not
    counted twice)."""
    evs = sorted((e for e in prof.events() if e.name.startswith(prefix)),
                 key=lambda e: e.time_range.start)
    total, end = 0.0, -1.0
    for e in evs:
        if e.time_range.start >= end:
            total += (e.time_range.end - e.time_range.start) / 1e6
            end = e.time_range.end
    return total


def phase_seq64(report):
    """Two timesteps of two Newton systems at nx = 64 (786,432 rows each),
    FGMRES + ex7-reuse's MGR with per-timestep reuse, through the library
    API once per system, against the JAX package's pinned counts."""
    import contextlib
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hypredrive_tpu_torch import HypreDrive
    from hypredrive_tpu_torch.io import native

    t0 = time.perf_counter()
    seq, dofmap = drift_sequence(64, len(JAX_ITERS_SEQ64))
    gen_s = time.perf_counter() - t0
    A0 = seq[0][0]
    check(A0.shape[0] == 786432 and A0.nnz == 6742016,
          f"seq_64: {A0.shape[0]} rows / {A0.nnz} nnz")
    check(all((A.indices == A0.indices).all() for A, _ in seq),
          "seq_64: the sparsity pattern drifts")
    helper = native.backend()
    print(f"seq_64: generated 4 systems in {gen_s:.3f} s; ILU(0) "
          f"factorization path: {helper}")
    out = report["seq_64"] = {"rows": A0.shape[0], "nnz": A0.nnz,
                              "generate_s": gen_s, "ilu0_path": helper,
                              "systems": []}
    with tempfile.TemporaryDirectory() as tmp:
        ts_file = os.path.join(tmp, "timesteps.txt")
        with open(ts_file, "w") as f:
            f.write("2\n0 0\n1 2\n")
        drv = HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict({
            "general": {"statistics": False},
            "linear_system": {"timestep_filename": ts_file},
            "solver": EX7_FGMRES,
            "preconditioner": {"mgr": EX7_MGR, "reuse": {
                "enabled": True, "per_timestep": True}}})
        for k, (A, b) in enumerate(seq):
            drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
            drv.set_rhs(b)
            drv.set_dofmap(dofmap)
            before = drv.precon
            drv.precon_create()
            rebuilt = drv.precon is not before
            drv.linear_solver_create()
            # the setup split of the first rebuild (reading a profile of a
            # multi-second setup takes seconds itself)
            prof = (profile(activities=[ProfilerActivity.CPU]) if k == 0
                    else contextlib.nullcontext())
            with prof:
                t0 = time.perf_counter()
                drv.linear_solver_setup()
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
            res = drv.linear_solver_apply()
            x = drv.get_solution()
            host_rel = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
            sysk = {"k": k, "rebuilt": rebuilt, "iters": res.iters,
                    "rel_res_norm": res.rel_res_norm, "host_rel_res": host_rel,
                    "setup_s": setup_s, "solve_s": res.solve_time}
            if k == 0:
                sysk["setup_split_s"] = {
                    "ilu0_factor": _span_seconds(prof,
                                                 "hypredrv::ilu0_factor"),
                    "ilu_component": _span_seconds(
                        prof, "hypredrv::component_ilu"),
                    "nested_amg": _span_seconds(prof,
                                                "hypredrv::component_amg")}
                sp_ = sysk["setup_split_s"]
                sp_["mgr_rest"] = (setup_s - sp_["ilu_component"]
                                   - sp_["nested_amg"])
            out["systems"].append(sysk)
            print(f"seq_64 system {k} ({'rebuild' if rebuilt else 'reuse'}):"
                  f" {res.iters} iterations (JAX package "
                  f"{JAX_ITERS_SEQ64[k]}), rel res {res.rel_res_norm!r} "
                  f"(host {host_rel!r}; JAX {JAX_RELRES_SEQ64[k]!r}), setup "
                  f"{setup_s:.3f} s, solve {res.solve_time:.4f} s"
                  + (f", setup split {sysk['setup_split_s']}"
                     if k == 0 else ""))
            if k == len(seq) - 1:
                # a warm solve on the reused preconditioner, profiled (the
                # profiler records device activity only, so its wall time
                # is the warm solve's)
                out["profile_reused"] = profile_solve(drv)
                out["solve_warm_s"] = out["profile_reused"]["wall_s"]
                lv0, lv1 = drv.precon.state.levels
                KEEP["seq64_ilu"] = lv1.g_state
                check(lv0.f_kind == "amg", f"seq_64: level 0 F-relaxation "
                                           f"is {lv0.f_kind}, not amg")
                KEEP["seq64_frelax_A1"] = lv0.f_state.levels[1].A
            drv.precon_destroy()
        out["reuse_decisions"] = [s_["rebuilt"] for s_ in out["systems"]]
        drv.destroy()
    print(f"seq_64 reuse decisions (rebuild?): {out['reuse_decisions']}")
    for sysk, golden, jax_rel in zip(out["systems"], JAX_ITERS_SEQ64,
                                     JAX_RELRES_SEQ64):
        k = sysk["k"]
        check(abs(sysk["iters"] - golden) <= 1,
              f"seq_64 system {k}: {sysk['iters']} iterations, JAX "
              f"package {golden}")
        check(sysk["rel_res_norm"] <= 1.02e-6
              and sysk["host_rel_res"] <= 1.02e-6,
              f"seq_64 system {k}: true rel res {sysk['rel_res_norm']:.4e} "
              f"(host {sysk['host_rel_res']:.4e}) > 1.02e-6")
    check(out["reuse_decisions"] == [True, False, True, False],
          f"seq_64: rebuilds {out['reuse_decisions']}, expected one per "
          "timestep")
    rebuilt_s = [s_["setup_s"] for s_ in out["systems"] if s_["rebuilt"]]
    for s_ in out["systems"]:
        if not s_["rebuilt"]:
            check(s_["setup_s"] < 0.2 * min(rebuilt_s),
                  f"seq_64 system {s_['k']}: setup {s_['setup_s']:.4f} s "
                  "with the preconditioner reused")
    check(helper == "native", "seq_64: the compiled host helpers (ILU(0) "
                              "among them) did not build")


def phase_seq_kernels(report):
    """Each kernel against its plain version at the shapes of seq_64's
    ILU sweeps (the level-1 L and U factors) and of the first coarse
    operator of its nested F-relaxation AMG, float64 (rel 1e-12)."""
    import torch

    st = KEEP.pop("seq64_ilu")
    A1 = KEEP.pop("seq64_frelax_A1")
    checks = KernelChecks()
    for shape_name, E in ((f"ILU L {st.L.shape[0]}x{st.L.shape[1]}", st.L),
                          (f"ILU U {st.U.shape[0]}x{st.U.shape[1]}", st.U),
                          (f"F-AMG A1 {A1.shape[0]}x{A1.shape[1]}", A1)):
        checks.matrix(shape_name, E, torch.float64)
    report["kernel_checks"].extend(checks.rows)
    del st, A1
    torch.cuda.empty_cache()


def run_config(path, overrides=()):
    """A config file through the CLI on the card; its driver."""
    from hypredrive_tpu_torch import cli

    collect = []
    rc = cli.run_one_config(path, overrides=[("general:print_config_params",
                                              "off"), *overrides],
                            collect=collect)
    check(rc == 0, f"{path}: cli returned {rc}")
    return collect[0]


def elasticity_driver(dims, config):
    """elasticity.py's set-up: the matrix, the interleaved xyz dofmap, the
    six rigid-body modes as the near null space, b = ones."""
    import numpy as np
    from hypredrive_tpu_torch import HypreDrive
    from hypredrive_tpu_torch.ops.csr import elasticity_3d, rigid_body_modes

    A, coords = elasticity_3d(*dims)
    rbm = rigid_body_modes(coords, ndim=3)
    n = A.shape[0]
    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(config)
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    drv.system.set_dofmap(np.arange(n) % 3)
    drv.set_near_nullspace([rbm[:, k] for k in range(rbm.shape[1])])
    drv.set_rhs(np.ones(n))
    return drv, A


def elasticity_solves(drv, A, count, keep_last=False):
    """elasticity.py's solve loop: per solve (iters, true rel res, host
    rel res, setup s, solve s); the last preconditioner is kept when
    ``keep_last``."""
    import numpy as np
    import torch

    out = []
    for i in range(count):
        drv.annotate_begin("Run", i)
        drv.reset_initial_guess()
        drv.precon_create()
        drv.linear_solver_create()
        t0 = time.perf_counter()
        drv.linear_solver_setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res = drv.linear_solver_apply()
        x = drv.get_solution()
        host = float(np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]))
        check(np.all(np.isfinite(x)), "elasticity: solution not finite")
        out.append({"iters": res.iters, "rel_res_norm": res.rel_res_norm,
                    "host_rel_res": host, "setup_s": setup_s,
                    "solve_s": res.solve_time})
        if not (keep_last and i == count - 1):
            drv.precon_destroy()
            drv.linear_solver_destroy()
        drv.annotate_end("Run", i)
    return out


def phase_elasticity(report):
    """elasticity.py's flow at 48×24×24 cells, with and without the rigid
    body modes, and at its 12×6×6 default."""
    from hypredrive_tpu_torch.config.presets import register_precon_preset

    register_precon_preset(*ELASTICITY_PRESET)
    out = report["elasticity_rbm"] = {}
    t0 = time.perf_counter()
    drv, A = elasticity_driver((48, 24, 24), ELASTICITY_CONFIG)
    out["generate_s"] = time.perf_counter() - t0
    check(A.shape[0] == 88200, f"elasticity: {A.shape[0]} rows")
    out.update(rows=A.shape[0], nnz=int(A.nnz))
    out["solves"] = elasticity_solves(drv, A, 3, keep_last=True)
    levels = drv.precon.state.levels
    out["level_rows"] = [lv.A.shape[0] for lv in levels]
    drv.reset_initial_guess()
    out["solve_warm_s"] = drv.linear_solver_apply().solve_time
    out["profile"] = profile_solve(drv)
    KEEP["elasticity_A"] = drv.system.A
    drv.stats_print()
    drv.destroy()
    print(f"elasticity 48x24x24: {A.shape[0]} rows, {A.nnz} nnz (generated "
          f"in {out['generate_s']:.3f} s), levels {out['level_rows']}, "
          f"solves {[(s_['iters'], s_['rel_res_norm']) for s_ in out['solves']]}"
          f" (JAX package {JAX_ITERS_ELASTICITY_48} each), setup s "
          f"{[round(s_['setup_s'], 3) for s_ in out['solves']]}, solve s "
          f"{[round(s_['solve_s'], 4) for s_ in out['solves']]}, warm "
          f"{out['solve_warm_s']:.4f} s")
    for name, dims, config, golden in (
            ("variant0", (48, 24, 24), ELASTICITY_V0,
             JAX_ITERS_ELASTICITY_48_V0),
            ("default_12", (12, 6, 6), ELASTICITY_CONFIG,
             JAX_ITERS_ELASTICITY_12)):
        d2, A2 = elasticity_driver(dims, config)
        (r,) = elasticity_solves(d2, A2, 1)
        d2.destroy()
        out[name] = r
        print(f"elasticity {dims} {name}: {r['iters']} iterations (JAX "
              f"package {golden}), rel res {r['rel_res_norm']:.3e}, setup "
              f"{r['setup_s']:.3f} s, solve {r['solve_s']:.4f} s")
        check(abs(r["iters"] - golden) <= 1,
              f"elasticity {name}: {r['iters']} iterations, JAX {golden}")
    check(out["default_12"]["iters"] <= 21,
          "elasticity 12x6x6: outside the reference's golden class (21)")
    for r in [*out["solves"], out["variant0"], out["default_12"]]:
        # the JAX package's 48×24×24 solves end at 9.65e-7
        check(r["rel_res_norm"] <= 1.02e-6 and r["host_rel_res"] <= 1.02e-6,
              f"elasticity: true rel res {r['rel_res_norm']:.3e} (host "
              f"{r['host_rel_res']:.3e}) > 1.02e-6")
    for r in out["solves"]:
        check(abs(r["iters"] - JAX_ITERS_ELASTICITY_48) <= 1,
              f"elasticity: {r['iters']} iterations, JAX package "
              f"{JAX_ITERS_ELASTICITY_48}")


def convdif_driver(A, overrides=()):
    """convdif-gmres-air.yml through the library API, A set."""
    from hypredrive_tpu_torch import HypreDrive

    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(CONVDIF_AIR, [("general:statistics", "off"),
                                       *overrides])
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    return drv


def phase_convdif(report):
    """GMRES + AIR on the 1024² upwind convection-diffusion operator, then
    convdif.py's transient loop at its defaults."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.ops.csr import convection_diffusion_2d

    t0 = time.perf_counter()
    A = convection_diffusion_2d(1024, eps=1e-3)
    gen_s = time.perf_counter() - t0
    check(A.shape[0] == 1048576, f"convdif: {A.shape[0]} rows")
    drv = convdif_driver(A)
    drv.set_rhs(np.ones(A.shape[0]))
    drv.precon_create()
    drv.linear_solver_create()
    t0 = time.perf_counter()
    drv.linear_solver_setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = drv.linear_solver_apply()
    x = drv.get_solution()
    host = float(np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]))
    state = drv.precon.state
    out = report["convdif_air"] = {
        "rows": A.shape[0], "nnz": int(A.nnz), "generate_s": gen_s,
        "setup_s": setup_s, "iters": res.iters,
        "rel_res_norm": res.rel_res_norm, "host_rel_res": host,
        "solve_s": res.solve_time,
        "level_rows": [lv.A.shape[0] for lv in state.levels],
        "smoother": state.levels[0].smoother}
    drv.reset_initial_guess()
    out["solve_warm_s"] = drv.linear_solver_apply().solve_time
    out["profile"] = profile_solve(drv)
    KEEP["convdif_R0"] = state.levels[0].R
    drv.destroy()
    print(f"convdif_air 1024^2: {A.shape[0]} rows, {A.nnz} nnz, levels "
          f"{out['level_rows']} ({out['smoother']}); setup {setup_s:.3f} s; "
          f"{res.iters} iterations (JAX package {JAX_ITERS_CONVDIF_1024}), "
          f"rel res {res.rel_res_norm:.3e} (host {host:.3e}), first solve "
          f"{res.solve_time:.4f} s, warm {out['solve_warm_s']:.4f} s")
    check(abs(res.iters - JAX_ITERS_CONVDIF_1024) <= 1,
          f"convdif_air: {res.iters} iterations, JAX package "
          f"{JAX_ITERS_CONVDIF_1024}")
    check(res.converged and res.rel_res_norm <= 1e-8 and host <= 1e-8
          and np.all(np.isfinite(x)),
          f"convdif_air: rel res {res.rel_res_norm:.3e} (host {host:.3e})")

    # convdif.py's timestep loop (n = 40, 10 steps, velocity (1, 0.5))
    n = 40
    g = (np.arange(n) + 1.0) / (n + 1)
    X, Y = np.meshgrid(g, g, indexing="xy")
    c = np.exp(-80.0 * ((X - 0.2) ** 2 + (Y - 0.2) ** 2)).ravel()
    drv = None
    dt, steps = 0.01, []
    for step, golden in enumerate(JAX_ITERS_CONVDIF_TRANSIENT, start=1):
        At = convection_diffusion_2d(n, eps=1e-3, velocity=(1.0, 0.5), dt=dt)
        if drv is None:
            drv = convdif_driver(At)
        else:
            drv.set_matrix_from_csr(At.indptr, At.indices, At.data)
        drv.annotate_level_begin("timestep", step)
        drv.set_rhs(c / dt)
        drv.set_initial_guess(c)
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        r = drv.linear_solver_apply()
        host = float(np.linalg.norm(c / dt - At @ drv.get_solution())
                     / np.linalg.norm(c / dt))
        c = drv.get_solution()
        drv.precon_destroy()
        drv.linear_solver_destroy()
        drv.annotate_level_end("timestep", step)
        steps.append({"iters": r.iters, "rel_res_norm": r.rel_res_norm,
                      "host_rel_res": host})
        check(abs(r.iters - golden) <= 1,
              f"convdif step {step}: {r.iters} iterations, JAX {golden}")
        check(r.converged and host <= 1e-8,
              f"convdif step {step}: host rel res {host:.3e}")
        dt *= 1.5
    out["transient"] = steps
    out["transient_levels"] = drv.stats_level_get_count("timestep")
    drv.destroy()
    print(f"convdif.py loop (n = 40, 10 steps): iterations "
          f"{[s_['iters'] for s_ in steps]} (JAX package "
          f"{list(JAX_ITERS_CONVDIF_TRANSIENT)}), mass {c.sum() / n**2:.6e}")
    check(out["transient_levels"] == 10, "convdif: timestep frames missing")


def phase_lap128_agg_cf(report):
    """128³ PCG + AMG, one aggressive level, C/F ℓ1-Jacobi relaxation."""
    r = report["lap128_agg_cf"] = run_laplacian(
        128, "float64", amg={"aggressive": {"num_levels": 1},
                             "relaxation": {"type": 18, "order": 1}})
    del r["state"]
    oc = r["operator_complexity"]
    print(f"  operator complexity {oc!r} (JAX package "
          f"{JAX_OC_LAP128_AGG_CF!r}), smoothers {r['smoothers']}")
    check(r["smoothers"] == ["cf-l1-jacobi"],
          f"lap128_agg_cf: smoothers {r['smoothers']}")
    check(abs(r["iters"] - JAX_ITERS_LAP128_AGG_CF) <= 1,
          f"lap128_agg_cf: {r['iters']} iterations, JAX package "
          f"{JAX_ITERS_LAP128_AGG_CF}")
    check(abs(oc / JAX_OC_LAP128_AGG_CF - 1) <= 1e-12,
          f"lap128_agg_cf: operator complexity {oc}, JAX package "
          f"{JAX_OC_LAP128_AGG_CF}")
    check(r["converged"] and r["rel_res_norm"] <= 1e-8,
          f"lap128_agg_cf: rel res {r['rel_res_norm']:.3e}")


def _eig_distance(a, b):
    """max over a of the distance to the nearest of b, relative to |a|."""
    import numpy as np

    worst = 0.0
    for s_ in range(0, len(a), 256):
        blk = a[s_:s_ + 256]
        d = np.abs(blk[:, None] - b[None, :]).min(axis=1)
        worst = max(worst, float((d / np.abs(blk)).max()))
    return worst


def phase_ex6(report):
    """examples/ex6.yml through the CLI: M⁻¹A column by column on the card
    (one MGR apply per column), dense eig on the host."""
    import numpy as np

    prefix = os.path.join("build", "ex6", "eig")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    t0 = time.perf_counter()
    drv = run_config(os.path.join("examples", "ex6.yml"),
                     [("linear_system:eigspec:output_prefix", prefix)])
    wall = time.perf_counter() - t0
    (e,) = drv.stats.entries
    a = np.loadtxt(f"{prefix}_eigenvalues.txt", skiprows=1, ndmin=2)
    w = a[:, 0] + 1j * a[:, 1]
    ref = np.load(JAX_EX6_EIGENVALUES)
    sorted_dev = float(np.abs(np.sort_complex(w) - np.sort_complex(ref)).max()
                       / np.abs(ref).max())
    nearest = max(_eig_distance(w, ref), _eig_distance(ref, w))
    report["ex6_eigspec"] = {"count": len(w), "wall_s": wall,
                             "sorted_rel_dev": sorted_dev,
                             "nearest_rel_dev": nearest, "iters": e.iters,
                             "rel_res_norm": e.rel_res_norm}
    print(f"ex6: {len(w)} eigenvalues of M^-1 A in {wall:.3f} s (with the "
          f"solve), against the JAX package's: sorted rel dev {sorted_dev:.3e},"
          f" nearest rel dev {nearest:.3e}; solve {e.iters} iterations")
    check(len(w) == len(ref) == 5184, f"ex6: {len(w)} eigenvalues")
    check(sorted_dev <= EX6_EIG_TOL and nearest <= EX6_EIG_TOL,
          f"ex6: eigenvalues deviate from the JAX package's by "
          f"{max(sorted_dev, nearest):.3e}")
    check(e.iters == GOLDEN_EX3_ITERS and e.rel_res_norm <= 1e-6,
          f"ex6: the solve took {e.iters} iterations")


def phase_ex9(report):
    """examples/ex9-print-system.yml through the CLI: the dump tree and its
    contents against the input and the JAX package's solution."""
    import shutil

    import numpy as np
    from hypredrive_tpu_torch.io import ij

    d = os.path.join("build", "dump_ex9")
    shutil.rmtree(d, ignore_errors=True)
    drv = run_config(os.path.join("examples", "ex9-print-system.yml"),
                     [("linear_system:print_system:dirname", d)])
    (e,) = drv.stats.entries
    files = sorted(os.path.relpath(os.path.join(r, f), d)
                   for r, _, fs in os.walk(d) for f in fs)
    A_in, _ = ij.read_matrix_auto("data/ps3d10pt7/np1/IJ.out.A")
    b_in = ij.read_vector_auto("data/ps3d10pt7/np1/IJ.out.b")
    x = ij.read_vector_auto(os.path.join(d, "ls_00000/apply/IJ.out.x"))
    norms = (float(np.linalg.norm(x)), float(np.abs(x).sum()),
             float(np.abs(x).max()))
    dev = max(abs(a / b - 1) for a, b in zip(norms, JAX_EX9_X_NORMS))
    report["ex9_print_system"] = {"files": files, "x_norms": norms,
                                  "x_norms_rel_dev": dev, "iters": e.iters}
    print(f"ex9: {len(files)} files dumped, solution norms {norms} (JAX "
          f"package {JAX_EX9_X_NORMS}, max rel dev {dev:.3e})")
    check(tuple(files) == JAX_EX9_FILES, f"ex9: dump tree {files}")
    for stage in ("build", "apply"):
        A_d, _ = ij.read_matrix_auto(os.path.join(d, f"ls_00000/{stage}/"
                                                  "IJ.out.A"))
        check((A_d != A_in).nnz == 0, f"ex9: {stage} matrix dump differs")
        check(np.array_equal(ij.read_vector_auto(os.path.join(
            d, f"ls_00000/{stage}/IJ.out.b")), b_in),
              f"ex9: {stage} rhs dump differs")
        check(not ij.read_vector_auto(os.path.join(
            d, f"ls_00000/{stage}/IJ.out.x0")).any(),
              f"ex9: {stage} x0 dump not zero")
    check(dev <= 1e-8, f"ex9: solution dump deviates by {dev:.3e}")
    check(e.iters == GOLDEN_EX1_ITERS, f"ex9: {e.iters} iterations")


def phase_lsseq_ex7(report):
    """data/poroseq packed by the port's tools/lsseq.py into a zlib
    container, then ex7 through sequence_filename."""
    import re

    from hypredrive_tpu_torch.tools import lsseq as lsseq_cli

    os.makedirs("build", exist_ok=True)
    container = os.path.join("build", "poroseq.lsseq")
    pat = os.path.join("data", "poroseq", "np1", "ls_%05d", "{}")
    t0 = time.perf_counter()
    rc = lsseq_cli.main(["pack", container, "-m", pat.format("IJ.out.A"),
                         "-r", pat.format("IJ.out.b"),
                         "-d", pat.format("dofmap.out"), "--codec", "zlib"])
    pack_s = time.perf_counter() - t0
    check(rc == 0, f"lsseq pack returned {rc}")
    with open(os.path.join("examples", "ex7.yml")) as f:
        text = re.sub(r"linear_system:\n(  .*\n)+",
                      f"linear_system:\n  sequence_filename: {container}\n",
                      f.read())
    cfg = os.path.join("build", "ex7-lsseq.yml")
    with open(cfg, "w") as f:
        f.write(text)
    entries = run_config(cfg).stats.entries
    out = report["lsseq_ex7"] = {
        "pack_s": pack_s, "bytes": os.path.getsize(container),
        "iters": [e.iters for e in entries],
        "rel_res_norm": [e.rel_res_norm for e in entries]}
    print(f"lsseq_ex7: packed in {pack_s:.3f} s ({out['bytes']} bytes); "
          f"iterations {out['iters']} (JAX package {list(JAX_ITERS_EX7)})")
    check(len(entries) == len(JAX_ITERS_EX7),
          f"lsseq_ex7: {len(entries)} systems")
    for i, (e, g) in enumerate(zip(entries, JAX_ITERS_EX7)):
        check(abs(e.iters - g) <= 1 and e.converged
              and e.rel_res_norm <= 1e-6,
              f"lsseq_ex7 system {i}: {e.iters} iterations (JAX {g}), rel "
              f"res {e.rel_res_norm:.3e}")


def ex3_config(scaling=None, rhs_mode=None):
    """ex3's system and GMRES + MGR, with a scaling type or an rhs mode."""
    base = os.path.join("data", "multiphys2k", "np1")
    ls = {"matrix_filename": os.path.join(base, "IJ.out.A"),
          "dofmap_filename": os.path.join(base, "dofmap.out")}
    if rhs_mode:
        ls["rhs_mode"] = rhs_mode
    else:
        ls["rhs_filename"] = os.path.join(base, "IJ.out.b")
    solver = {"gmres": {}}
    if scaling:
        solver["scaling"] = {"enabled": True, "type": scaling}
    return {"general": {"statistics": False}, "linear_system": ls,
            "solver": solver, "preconditioner": EX3_MGR}


def phase_scaling_xref(report):
    """ex3 with rhs_l2 and dofmap_mag scaling; randsol's error norm and
    per-block error history against the JAX package's."""
    import numpy as np
    from hypredrive_tpu_torch import HypreDrive

    out = report["scaling_xref"] = {}
    for key in ("rhs_l2", "dofmap_mag", "randsol"):
        drv = HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict(
            ex3_config(rhs_mode="randsol") if key == "randsol"
            else ex3_config(scaling=key))
        sys_ = drv.linear_system_build()
        b = sys_.b.cpu().numpy()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        x = drv.get_solution()
        host = float(np.linalg.norm(b - sys_.A_host @ x) / np.linalg.norm(b))
        r = out[key] = {"iters": res.iters, "rel_res_norm": res.rel_res_norm,
                        "host_rel_res": host}
        if key == "randsol":
            hist = res.error_histories[:res.iters + 1]
            ref = np.asarray(JAX_ERROR_HISTORY_RANDSOL)
            r["error_norm"] = res.error_norm
            r["error_history"] = hist.tolist()
            k = min(len(hist), len(ref))
            r["history_rel_dev"] = float(np.abs(hist[:k] / ref[:k] - 1).max())
            r["error_norm_rel_dev"] = abs(res.error_norm
                                          / JAX_ERROR_NORM_RANDSOL - 1)
            golden = JAX_ITERS_RANDSOL
        else:
            golden = JAX_ITERS_SCALING[key]
        drv.destroy()
        print(f"ex3 {key}: {res.iters} iterations (JAX package {golden}), "
              f"rel res {res.rel_res_norm:.3e} (host {host:.3e})"
              + (f", error norm {r['error_norm']!r} (rel dev "
                 f"{r['error_norm_rel_dev']:.3e}), error history rel dev "
                 f"{r['history_rel_dev']:.3e}" if key == "randsol" else ""))
        check(res.iters == golden, f"{key}: {res.iters} iterations, JAX "
                                   f"package {golden}")
        check(res.converged and host <= 1e-6 and np.all(np.isfinite(x)),
              f"{key}: host rel res {host:.3e}")
    r = out["randsol"]
    check(r["error_norm_rel_dev"] <= 1e-6 and r["history_rel_dev"] <= 1e-6
          and len(r["error_history"]) == len(JAX_ERROR_HISTORY_RANDSOL),
          f"randsol: error norm / history deviate by "
          f"{r['error_norm_rel_dev']:.3e} / {r['history_rel_dev']:.3e}")


def phase_slice_kernels(report):
    """Each kernel against its plain version at the elasticity fine
    operator (DIA part and CSR remainder) and at convdif_air's level-0 AIR
    restriction (about 8 entries a row), float64 (rel 1e-12)."""
    import torch

    A = KEEP.pop("elasticity_A")
    R0 = KEEP.pop("convdif_R0")
    checks = KernelChecks()
    for shape_name, E in (
            (f"elasticity A0 {A.shape[0]}x{A.shape[1]}", A),
            (f"AIR R0 {R0.shape[0]}x{R0.shape[1]}", R0)):
        checks.matrix(shape_name, E, torch.float64)
    report["kernel_checks"].extend(checks.rows)
    del A, R0
    torch.cuda.empty_cache()


KERNELS = {
    "dia_spmv": ("hypredrive_tpu_torch/csrc/dia_spmv.cu",
                 "hypredrive_tpu/ops/pallas_dia.py:99 (K1); "
                 "hypredrive_tpu/ops/pallas_dia.py:171 (K2)"),
    "csr_spmv": ("hypredrive_tpu_torch/csrc/csr_spmv.cu",
                 "hypredrive_tpu/ops/pallas_spmv.py:85 (K3); "
                 "hypredrive_tpu/ops/pallas_spmv.py:216 (K4)"),
}


def launch_counters():
    """The wrappers whose ``launches`` count kernel launches."""
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv

    return {"dia_spmv": dia_spmv, "csr_spmv": csr_spmv}


# the solve paths: (name, phase, kernels each must launch); ex1-jacobi is
# a 7-point Laplacian without AMG, all on diagonals
BOTH = ("dia_spmv", "csr_spmv")
PATHS = (("ex1", phase_ex1, BOTH), ("lap64", phase_64, BOTH),
         ("lap128", phase_128, BOTH), ("mgr_ex3", phase_mgr_ex3, BOTH),
         ("mgr_ex5", phase_mgr_ex5, BOTH),
         ("jacobi_ex1", phase_jacobi_ex1, ("dia_spmv",)),
         ("mgr_64", phase_mgr64, BOTH),
         ("krylov_variants", phase_krylov_variants, BOTH),
         ("mgr_ex4", phase_mgr_ex4, BOTH), ("seq_ex7", phase_seq_ex7, BOTH),
         ("seq_ex7_reuse", phase_seq_ex7_reuse, BOTH),
         ("seq_ex7_frelax_reuse", phase_seq_ex7_frelax_reuse, BOTH),
         ("amg_gs_fsai", phase_amg_gs_fsai, BOTH),
         ("ilu_variants", phase_ilu_variants, BOTH),
         ("seq_64", phase_seq64, BOTH),
         ("elasticity_rbm", phase_elasticity, BOTH),
         ("convdif_air", phase_convdif, BOTH),
         ("lap128_agg_cf", phase_lap128_agg_cf, BOTH),
         ("ex6_eigspec", phase_ex6, BOTH),
         ("ex9_print_system", phase_ex9, BOTH),
         ("lsseq_ex7", phase_lsseq_ex7, BOTH),
         ("scaling_xref", phase_scaling_xref, BOTH))


def main() -> int:
    args = sys.argv[1:]
    baseline_src = None
    if args[:1] == ["--baseline-csr"] and len(args) == 2:
        baseline_src = os.path.abspath(args[1])
    elif args:
        print("usage: chip_smoke.py [--baseline-csr FILE]", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    counters = launch_counters()

    report = {}
    failures = []
    t_start = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn(report)
        except Exception as exc:  # record every phase's failure, go on
            failures.append(f"{name}: {type(exc).__name__}: {exc}")
            print(f"PHASE {name} FAILED: {exc}", file=sys.stderr)
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        print(f"phase {name}: {report['phase_s'][name]:.3f} s")

    run("env", phase_env)
    if baseline_src and not failures:
        run("baseline", lambda _: load_baseline(baseline_src))
    if not failures:
        launches = {k: 0 for k in counters}
        for name, fn, kernels_run in PATHS:
            # each path's own count: zeroed just before, read just after
            for f in counters.values():
                f.launches = 0
            run(name, fn)
            counts = {k: f.launches for k, f in counters.items()}
            report.setdefault("launches_by_path", {})[name] = counts
            print(f"{name} kernel launches: {counts}")
            for k in kernels_run:
                launches[k] += counts[k]
                if counts[k] <= 0:
                    failures.append(f"launches: {name} never launched {k}")
        report["launches"] = launches
        print(f"main-path kernel launches: {launches}")
        for name, key, fn in (("kernels", "lap128_state", phase_kernels),
                              ("mgr_kernels", "mgr64_state",
                               phase_mgr_kernels),
                              ("seq_kernels", "seq64_ilu", phase_seq_kernels),
                              ("slice_kernels", "convdif_R0",
                               phase_slice_kernels)):
            if key in KEEP:
                run(name, fn)
            else:
                failures.append(f"{name}: no operators to check")
    report["total_s"] = time.perf_counter() - t_start
    print(f"total: {report['total_s']:.3f} s")
    report["failures"] = failures
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1

    table = []
    warm = report["lap128_f64"]["warm_launches"]
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in report["kernel_checks"] if r["kernel"] == name]
        # the float64 shape that moves the most bytes
        main_row = max((r for r in rows if r["dtype"] == "float64"),
                       key=lambda r: r["bytes"])
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": report["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": main_row["device_ms"], "plain_ms": main_row["plain_device_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
            "library_ms": main_row["library_ms"],
            "shape": f"{main_row['shape']} {main_row['dtype']}",
            "launches_warm_lap128_solve": warm[name],
            "shapes": [{k: r.get(k) for k in (
                "shape", "dtype", "device_ms", "ms", "plain_device_ms",
                "plain_ms", "bound_ms", "bound_share", "library_ms",
                "baseline_device_ms", "max_rel_err", "tb_s")}
                for r in rows],
        })
    print(json.dumps({"kernels": table}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
