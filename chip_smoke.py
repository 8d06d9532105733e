#!/usr/bin/env python3
"""Smoke test of hypredrive_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit, CUDA, ``nvcc``; build the
   CUDA kernels from ``hypredrive_tpu_torch/csrc`` (timed).
2. The solve paths, each with every kernel's launch counter zeroed just
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
   - elasticity_rbm: the elasticity driver
     (``hypredrive_tpu_torch.drivers.elasticity``, the port of
     examples/drivers/elasticity.py) at 48×24×24 cells (88,200 rows, 5.47M
     nnz): its preset and config, the six rigid-body modes as the near null
     space, three PCG + AMG solves to 1e-6 through its solve loop, each
     within ±1 of the JAX package's count; the same with
     ``interp_vec_variant: 0``, and the driver's 12×6×6 default;
   - convdif_air: convection_diffusion_2d(1024, eps=1e-3) (1,048,576
     rows), GMRES(30) + AMG with AIR restriction and the AIR relaxation
     schedule (the convdif driver's default config,
     examples/drivers/convdif-gmres-air.yml) to 1e-8, and the convdif
     driver's timestep loop (``drivers.convdif``, n = 40, 10 steps);
   - lap128_agg_cf: a 128³ Laplacian, PCG + AMG with one aggressive level
     and C/F ℓ1-Jacobi relaxation, its count and operator complexity;
   - ex6_eigspec / ex9_print_system: examples/ex6.yml (eigenvalues of
     M⁻¹A against the JAX package's, ``data/golden``) and
     examples/ex9-print-system.yml (the dump tree) through the CLI;
   - lsseq_ex7: data/poroseq packed into a zlib lsseq container by the
     port's ``tools/lsseq.py``, then ex7 through ``sequence_filename``;
   - scaling_xref: ex3 with rhs_l2 and dofmap_mag scaling, and GMRES + MGR
     on data/multiphys2k with ``rhs_mode: randsol`` (error norm and
     per-block error history against the JAX package's);
   - ams_maxwell64 / ads_graddiv48: maxwell_edge_system(64, eps=0.05,
     dim=3) (774,144 edges) with PCG + AMS and graddiv_face_system(48,
     eps=0.1) (318,096 faces) with PCG + ADS, float64 to 1e-8 through the
     library verbs: the JAX package's count and residual history (rel
     1e-6), setup, first, warm and profiled solve;
   - ams_cycles: maxwell_edge_system(16, dim=3) with every AMS cycle type
     and Chebyshev relaxation, each count the JAX package's;
   - laplacian_driver: the Laplacian driver's main
     (``drivers.laplacian``: 30³, the poisson preset, five solves on one
     driver);
   - capi: the C API shim built with g++, interfaces/c/example_laplacian.c
     compiled with gcc and run (PASSED and the bad-config line), then the
     example's config on a 32³ Laplacian through the C verbs by ctypes;
   - the distributed layer, each path on one mesh of 8 row shards on
     cuda:0 (every shard's matvec launching the DIA and CSR kernels, the
     halo exchange on the device), each count and residual history the
     JAX package's 8-device mesh run's (``data/golden/jax_counts.json``):
     dist_dryrun8 (``__graft_entry__.dryrun_multichip(8)``'s three stacks:
     PCG + AMG 6, GMRES + MGR 5, BiCGSTAB + bj-ILU(0) 12), dist_lap128 (a
     128³ Laplacian, the distributed AMG setup from per-shard parts, PCG,
     also ±1 of the one-device count), dist_mgr64 (the nx = 64
     multiphysics system, GMRES(30) + the mesh MGR with masked AMG and
     Jacobi F-relaxations, then BiCGSTAB + block-Jacobi ILU(0) to 1e-2) and
     dist_ams32 (maxwell_edge_system(32), PCG + AMS on the mesh); then
     dist_multicard: one rank per card (world = the largest of 1, 2, 4
     and 8 at most the card count), started by this script with
     torchrun's environment and joined over NCCL, each rank running
     dist_lap128 and dist_mgr64 on its shards of 8 with the halos and
     dot products as collectives inside the captured graphs (counts and
     histories against the same JAX numbers; per rank the launches, halo
     bytes per iteration, warm wall and device time, peak RSS; at world
     1, which exercises no cross-card exchange, two gloo ranks on cuda:0
     also run the dryrun stacks eagerly);
   - the entry points around the package, each pinned to the JAX
     package's numbers in ``data/golden/jax_counts.json``: bench
     (``hypredrive_tpu_torch.bench`` at 64³ float32, its JSON line printed;
     ex1_iters, amg_levels and the V-cycle's entries equal, the 1e-8 count
     ±1), profile_setup (64³), node_scaling (weak, 32,768 rows a shard on
     1, 2, 4 and 8 row shards of the card; rows and counts equal),
     parity_report --fast (every example and two drivers; each entry ±1,
     elasticity skipped) and bindings (the MATLAB MEX and a C++ program
     on ``interfaces/cpp``'s header linked against the port's shim and run
     on the card, the Julia and Fortran symbols exported, the C surface by
     ctypes in this process); flagship (``flagship.entry()``, the port of
     ``__graft_entry__.entry()``: the JAX entry's count) and profile_solve
     (``tools/profile_solve.py`` on examples/ex3.yml, a Chrome trace).
   - the ports of the repo's JAX-bound scripts: example_output
     (``tools/generate_example_output.py`` over every example, held against
     the JAX package's outputs in ``data/golden/example_output_jax``: equal
     text outside the stats tables, equal counts, residuals within rel
     2e-2), bench_kernels (``tools/bench_kernels.py`` at 64³ float32: the
     build and launch probe, the triad, the DIA and CSR rows, each within
     rel 1e-5 of scipy, and the V-cycle) and plot_convergence
     (``tools/plot_convergence.run_config`` on ex1 and ex3: the JAX
     package's counts and final residuals to rel 1e-6, then its plot, or
     its typed error without matplotlib).
   Every Krylov solve runs through the device loop: captured CUDA graphs,
   one replay per iteration (GMRES: per inner step, and one for each
   cycle's start and end).  On bench64, lap64, lap128_f64, mgr_64,
   elasticity_rbm, ams_maxwell64 and dist_mgr64 the first solve (with its
   capture), a warm solve and a profiled one are timed, and the same solve
   runs as the eager body on the card (launches uncounted), which must
   give the same count, history (rel 1e-12 in float64, 1e-5 in float32)
   and kernel launches.
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
   F-relaxation AMG); at the elasticity fine operator and convdif_air's
   level-0 AIR restriction; at ams_maxwell64's G, Gᵀ, Π, Πᵀ and edge
   matrix; and at shard 1 of dist_lap128's A0 (its DIA part and the CSR
   remainder holding its halo columns).
4. device_loop: the figures of step 2's device-loop paths, and the Givens
   update and the Hessenberg back-substitution (``csrc/krylov_small.cu``,
   the device form of XLA code, not TPU kernels) at GMRES(m), m = 30 (the
   main path's), 50 and 300, against their plain versions, bit for bit in
   float32 and float64, with their device times, bounds, the floor (an
   empty one-block kernel node), the chain estimate (dependent operations
   times the latencies measured on the card) and (back-substitution) the
   time of ``torch.linalg.solve_triangular``.

The JAX package's numbers pinned below, and those in
``data/golden/jax_counts.json``, come from ``scripts/jax_goldens.py`` run on
the CPU.

Prints the kernel table as one JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json``.

``--only PATH...`` runs the environment phase and the named paths of
step 2 alone (no kernel table), e.g. ``--only dist_multicard`` on four
cards.  ``--baseline-csr FILE`` also builds FILE, an earlier
``csr_spmv.cu`` with the row-group C interface (lanes per row as its
argument), into ``build/csr_baseline/`` and times it at every CSR shape
beside the current kernel, in the order current, earlier, earlier,
current.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading
import time

from hypredrive_tpu_torch.core.entry import replay_ms
from hypredrive_tpu_torch.solvers.device_loop import uncounted
from hypredrive_tpu_torch.tools.bench_kernels import (
    BOUND_SHARE_MAX, HBM_TB_S, bound_ms, dia_as_csr, library_spmv,
    operand_copies, spmv_bytes, spmv_row)

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

# the elasticity driver's AMG without interpolation vectors (the preset
# cannot take an override, so it is written out in place of the preset)
ELASTICITY_V0_PRECON = (
    "amg:\n    interp_vec_variant: 0\n    coarsening:\n"
    "      num_functions: 3\n      strong_th: 0.8\n"
    "      filter_functions: on")

# objects one phase hands to a later one (the mgr_64, seq_64, elasticity
# and convdif_air operators)
KEEP = {}


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
                or e.name().startswith("hypredrv::")):
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


def loop_begin():
    """Before a path's first solve: zero the device loop's stats and the
    peak of allocated memory; (start time, memory allocated now)."""
    import torch
    from hypredrive_tpu_torch.solvers import device_loop

    torch.cuda.synchronize()
    device_loop.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter(), torch.cuda.memory_allocated()


def api_run(drv):
    """One solve from the initial guess through the driver API: (iters,
    history)."""
    def run():
        drv.reset_initial_guess()
        res = drv.linear_solver_apply()
        return res.iters, res.res_history
    return run


def device_loop_check(report, key, run, begin, dtype="float64",
                      pinned=None):
    """The device loop on one path, after its first solve (``loop_begin()``
    before it gave ``begin``): the first solve's wall, capture, graphs
    and nodes; a warm solve (graph replays: wall, replays, masked replays,
    host reads); the same under torch.profiler (device time, busy share,
    kernel records); then the same solve as the eager body on the card,
    uncounted, which must give the same count (``pinned`` too, if given)
    and history (rel 1e-12 in float64, 1e-5 in float32) and the same
    kernel launches.  ``run()`` solves from the path's initial guess and
    returns (iters, history)."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.solvers import device_loop as dl

    torch.cuda.synchronize()
    first_s = time.perf_counter() - begin[0]
    first = dict(dl.stats)
    # what the first solve (its buffers, capture and graph pool) added
    peak = torch.cuda.max_memory_allocated() - begin[1]
    counters = launch_counters()
    n0 = {k: f.launches for k, f in counters.items()}
    dl.reset_stats()
    (g_iters, g_hist), warm_s = timed(run)
    warm = dict(dl.stats)
    graph_launches = {k: f.launches - n0[k] for k, f in counters.items()}
    dl.reset_stats()
    prof = profile_run(run)
    # every replayed node is one device record: fewer records means the
    # profiler dropped some, and its busy share is low
    replayed = dl.stats["replayed_nodes"]
    with uncounted():
        n1 = {k: f.launches for k, f in counters.items()}
        with dl.eager():
            (e_iters, e_hist), eager_s = timed(run)
        eager_launches = {k: f.launches - n1[k] for k, f in counters.items()}
    k = g_iters + 1
    g_hist = np.asarray(g_hist[:k], dtype=np.float64)
    e_hist = np.asarray(e_hist[:k], dtype=np.float64)
    dev = float(np.max(np.abs(g_hist / e_hist - 1))) if k else 0.0
    tol = 1e-12 if dtype == "float64" else 1e-5
    out = {
        "first_solve_s": first_s, "warm_solve_s": warm_s,
        "eager_solve_s": eager_s, "iters": g_iters,
        "capture_s": first["capture_s"], "captures": first["captures"],
        "graphs": first["graphs"], "graph_nodes": first["nodes"],
        "largest_graph_nodes": first["max_nodes"],
        "replays_per_solve": warm["replays"],
        "masked_replays_per_solve": warm["masked"],
        "host_reads_per_solve": warm["host_reads"],
        "graph_solves": warm["graph_solves"],
        "device_s": prof["device_busy_s"], "profiled_wall_s": prof["wall_s"],
        "busy": prof["device_busy_s"] / prof["wall_s"],
        "device_items": prof["device_items"],
        "replayed_nodes": replayed,
        "profiler_records_complete": prof["device_items"] >= replayed,
        "peak_allocated_bytes": peak,
        "history_rel_dev_vs_eager": dev,
        "history_bit_identical": bool(np.array_equal(g_hist, e_hist)),
        "launches_graph": graph_launches, "launches_eager": eager_launches}
    report.setdefault("device_loop", {})[key] = out
    print(f"device loop {key}: first solve {first_s:.4f} s (capture "
          f"{first['capture_s']:.4f} s, {first['graphs']} graphs, "
          f"{first['nodes']} nodes, largest {first['max_nodes']}), warm "
          f"{warm_s:.4f} s, {warm['replays']} replays ({warm['masked']} "
          f"masked), {warm['host_reads']} host reads; profiled "
          f"{prof['wall_s']:.4f} s, device {prof['device_busy_s']:.4f} s "
          f"({100 * out['busy']:.1f}% busy, {prof['device_items']} device "
          f"records for {replayed} replayed graph nodes); "
          f"eager body {eager_s:.4f} s, {e_iters} iterations, history dev "
          f"{dev:.3e}; first solve's peak allocation {peak / 2**20:.1f} "
          f"MiB")
    check(warm["graph_solves"] >= 1 and warm["captures"] == 0,
          f"{key}: the warm solve did not replay cached graphs ({warm})")
    check(g_iters == e_iters and (pinned is None or g_iters == pinned),
          f"{key}: graphs {g_iters} iterations, eager body {e_iters}"
          + ("" if pinned is None else f", pinned {pinned}"))
    check(dev <= tol, f"{key}: graph history deviates from the eager "
                      f"body's by {dev:.3e} > {tol}")
    check(graph_launches == eager_launches,
          f"{key}: kernel launches {graph_launches} by graphs, "
          f"{eager_launches} eager")
    return out


def phase_env(report):
    import torch
    from hypredrive_tpu_torch.core.entry import card
    from hypredrive_tpu_torch.ops import kernels
    from hypredrive_tpu_torch.io import native

    report["nvidia_smi"] = card()["nvidia_smi"]
    check(report["nvidia_smi"], "nvidia-smi gave no name and power limit")
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
    """Each kernel against its plain version on the same inputs: the
    measurement of ``bench_kernels.spmv_row`` (max error; device times of
    the kernel and the library call from CUDA-graph replay over operand
    copies that fill four times the L2; the bound from the least bytes; a
    kernel that beats its bound by more than 5% fails), and on top the
    kernel and plain times from back-to-back CUDA events, the plain
    version's device time from the profiler, a repeat launch and, with
    ``--baseline-csr``, the earlier kernel."""

    TOL = {"float32": 1e-5, "float64": 1e-12}

    def __init__(self):
        import numpy as np

        self.rng = np.random.default_rng(0)
        self.rows = []

    def compare(self, name, shape_name, dt, op, run, plain, n_x, nbytes,
                library, baseline=None):
        """``op``: the operand, a tuple of tensors; ``run(op, x)``,
        ``plain(op, x)`` and ``baseline(op, x)`` the kernel, its plain
        version and an earlier kernel; ``library(op)`` one library call's
        closure over op."""
        import numpy as np
        import torch

        dtn = str(dt).replace("torch.", "")
        x = torch.as_tensor(self.rng.standard_normal(n_x), dtype=dt,
                            device="cuda")
        yp = plain(op, x)

        def each(fn):
            return [lambda o=o, v=v: fn(o, v) for o, v in zip(ops, xs)]

        row, ops, xs = spmv_row(op, x, run, library, nbytes, yp)
        rel = row["max_rel_err"]
        repeat_equal = bool(torch.equal(run(op, x), run(op, x)))
        row.update(kernel=name, shape=shape_name, dtype=dtn,
                   tol_rel=self.TOL[dtn], repeat_bit_identical=repeat_equal,
                   ms=time_ms(each(run)), plain_ms=time_ms(each(plain)),
                   plain_device_ms=device_ms(each(plain)))
        if baseline is not None:
            # current, earlier, earlier, current
            base = [replay_ms(each(baseline)), replay_ms(each(baseline))]
            row["device_ms"] = (row["device_ms"] + replay_ms(each(run))) / 2
            yb = baseline(op, x)
            row["baseline_device_ms"] = sum(base) / 2
            row["baseline_rel_err"] = (float((yb - yp).abs().max())
                                       / (float(yp.abs().max()) or 1.0))
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["tb_s"] = nbytes / (row["device_ms"] * 1e-3) / 1e12
        self.rows.append(row)
        lib_txt = ("n/a" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f}")
        base_txt = (f", PR 3 kernel {row['baseline_device_ms']:.4f}"
                    if "baseline_device_ms" in row else "")
        print(f"  {name:9s} {shape_name:38s} {dtn:8s} rel {rel:.3e}  "
              f"events: kernel {row['ms']:.4f} plain {row['plain_ms']:.4f} "
              f"ms; device: kernel {row['device_ms']:.4f}{base_txt} plain "
              f"{row['plain_device_ms']:.4f} library {lib_txt} bound "
              f"{row['bound_ms']:.4f} ms ({100 * row['bound_share']:.1f}%), "
              f"{row['tb_s']:.2f} TB/s, {len(ops)} operand copies")
        check(np.isfinite(rel) and rel <= self.TOL[dtn],
              f"{name} {shape_name} {dt}: rel err {rel:.3e} > "
              f"{self.TOL[dtn]}")
        check(name != "csr_spmv" or repeat_equal,
              f"{name} {shape_name} {dt}: a repeat launch differs")
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
            self.compare("dia_spmv", f"{shape_name} D={len(offs)}", dt,
                         (E.dia_data.to(dt),),
                         lambda o, x: dia_spmv(o[0], offs, x, nc),
                         lambda o, x: dia_spmv_plain(o[0], offs, x, nc), nc,
                         spmv_bytes("dia_spmv", E, size),
                         lambda o: library_spmv(*dia_as_csr(o[0], offs, nc),
                                                E.shape))
        if E.data is not None:
            self.compare("csr_spmv", f"{shape_name} nnz={E.data.numel()}",
                         dt, (E.indptr, E.indices, E.data.to(dt), E.tiles),
                         lambda o, x: csr_spmv(o[0], o[1], o[2], x, nr, o[3]),
                         lambda o, x: csr_spmv_plain(o[0], o[1], o[2], x, nr),
                         nc, spmv_bytes("csr_spmv", E, size),
                         lambda o: library_spmv(o[0].int(), o[1], o[2],
                                                E.shape),
                         baseline_spmv(nr, E.data.numel(), dt)
                         if BASELINE else None)

    def epilogues(self, shape_name, A, P=None):
        """Each of the cycles' fused steps (``ops/epilogue.py``) on level
        operator A, and the correction x + P·e on its prolongation P,
        called through the operator's method as the cycles call it,
        against its torch chain (``*_plain``) on the same vectors: bit for
        bit (``torch.equal``), or the check fails.  Each row is the
        instance that carries the epilogue (the DIA kernel on a DIA-only
        operator, else the CSR kernel), with the device time of the whole
        step and of the chain by graph replay over copies of the operator
        and vectors that fill four times the L2, and its bound: the
        matvec's bytes, plus each vector the epilogue reads or writes
        beside the store of y."""
        import copy

        import torch
        from hypredrive_tpu_torch.ops import epilogue as ep

        theta, c1, c2 = 1.7, 0.61, 0.93
        # name, vectors beside y's store, fused, plain; v = (b, x, u, z,
        # d, e): five of A's rows, e of P's columns
        steps = (
            ("residual", A, 1, lambda M, v: M.residual(v[0], v[1]),
             lambda M, v: ep.residual_plain(M, v[0], v[1])),
            ("residual_z0", A, 3,
             lambda M, v: M.residual(v[0], v[1], v[2], theta),
             lambda M, v: ep.residual_plain(M, v[0], v[1], v[2], theta)),
            ("cheby_middle", A, 4,
             lambda M, v: M.cheby_step(v[0], v[3], v[4], v[2], c1, c2),
             lambda M, v: ep.cheby_step_plain(M, v[0], v[3], v[4], v[2],
                                              c1, c2)),
            ("cheby_last", A, 4,
             lambda M, v: M.cheby_step(v[0], v[3], v[4], v[2], c1, c2,
                                       v[1], True),
             lambda M, v: ep.cheby_step_plain(M, v[0], v[3], v[4], v[2],
                                              c1, c2, v[1], True)),
            ("jacobi", A, 2, lambda M, v: M.jacobi_step(v[1], v[0], v[2]),
             lambda M, v: ep.jacobi_step_plain(M, v[1], v[0], v[2])))
        if P is not None:
            steps += (("add", P, 1, lambda M, v: M.matvec_add(v[1], v[5]),
                       lambda M, v: ep.matvec_add_plain(M, v[1], v[5])),)
        for name, M, n_extra, fused, plain in steps:
            check(M.dense is None, f"{shape_name} {name}: stored dense")
            dt = M.dtype
            nr, nc = M.shape
            size = dt.itemsize
            kernel = ("dia_spmv_epilogue" if M.data is None
                      else "csr_spmv_epilogue")
            nbytes = n_extra * nr * size + sum(
                spmv_bytes(part, M, size) for part, t in (
                    ("dia_spmv", M.dia_data), ("csr_spmv", M.data))
                if t is not None)

            def vectors():
                v = [torch.as_tensor(self.rng.standard_normal(nr), dtype=dt,
                                     device="cuda") for _ in range(5)]
                v[2] = v[2].abs()
                return v + [torch.as_tensor(self.rng.standard_normal(nc),
                                            dtype=dt, device="cuda")]

            per_copy = nbytes + 5 * nr * size
            mats = [M] + [copy.deepcopy(M) for _ in
                          range(operand_copies(per_copy) - 1)]
            vecs = [vectors() for _ in mats]
            with uncounted():
                got, want = fused(M, vecs[0]), plain(M, vecs[0])
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                equal = len(got) == len(want) and all(
                    g.dtype == w.dtype and torch.equal(g, w)
                    for g, w in zip(got, want))
                err = max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got, want))
                scale = max(float(w.abs().max()) for w in want) or 1.0
                ms = replay_ms([lambda M=M, v=v: fused(M, v)
                                for M, v in zip(mats, vecs)])
                plain_ms = replay_ms([lambda M=M, v=v: plain(M, v)
                                      for M, v in zip(mats, vecs)])
            dtn = str(dt).replace("torch.", "")
            row = {"kernel": kernel, "step": name,
                   "shape": f"{shape_name} {name} {nr}x{nc}", "dtype": dtn,
                   "bit_identical": equal, "max_abs_err": err,
                   "max_rel_err": err / scale, "device_ms": ms,
                   "plain_device_ms": plain_ms, "bytes": nbytes,
                   "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                   "library_ms": None, "operand_copies": len(mats)}
            row["bound_share"] = row["bound_ms"] / ms
            row["tb_s"] = nbytes / (ms * 1e-3) / 1e12
            self.rows.append(row)
            print(f"  {kernel:17s} {row['shape']:38s} {dtn:8s} "
                  f"bit-identical {equal} (max abs {err:.3e}); device: "
                  f"fused {ms:.4f} plain chain {plain_ms:.4f} bound "
                  f"{row['bound_ms']:.4f} ms ({100 * row['bound_share']:.1f}"
                  f"%), {row['tb_s']:.2f} TB/s, {len(mats)} operand copies")
            check(equal, f"{kernel} {row['shape']} {dtn}: differs from the "
                         f"torch chain by {err:.3e}")
            check(row["bound_share"] <= BOUND_SHARE_MAX,
                  f"{kernel} {row['shape']}: {ms:.4f} ms beats the bound "
                  f"{row['bound_ms']:.4f} ms")


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
    hierarchy the lap128 path set up; then the cycles' fused steps on A0
    (with the correction on P0) and A1 in float64, each bit for bit
    against its torch chain."""
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
    check(A.dtype == torch.float64, f"lap128's A0 is {A.dtype}")
    checks.epilogues(f"A0 {A.shape[0]}x{A.shape[1]}", A, lv0.P)
    checks.epilogues(f"A1 {lv1.A.shape[0]}x{lv1.A.shape[1]}", lv1.A)
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


def run_laplacian(nx, dtype, amg=None, report=None, loop_key=None,
                  pinned=None):
    """PCG + AMG to 1e-8 on an nx³ Laplacian through the driver API
    (``amg``: the AMG section, else the defaults); ``loop_key`` names its
    device-loop check (``device_loop_check``) in ``report``."""
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
    begin = loop_begin()
    res = drv.linear_solver_apply()
    e = drv.stats.entries[-1]
    x = drv.get_solution()
    if loop_key:
        device_loop_check(report, loop_key, api_run(drv), begin, dtype,
                          pinned)
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
    drv.reset_initial_guess()
    return profile_run(drv.linear_solver_apply)


def profile_run(run):
    """``run()`` under torch.profiler: see profile_solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: recording every host op too costs seconds to
    # read back on the long solves and slows the solve it measures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    r = report["lap64_f32"] = run_laplacian(64, "float32", report=report,
                                            loop_key="lap64")
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
    r = report["lap128_f64"] = run_laplacian(
        128, "float64", report=report, loop_key="lap128_f64")
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
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv, csr_spmv_epilogue
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_epilogue

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
    begin = loop_begin()
    res = drv.linear_solver_apply()
    x = drv.get_solution()
    device_loop_check(report, "mgr_64", api_run(drv), begin,
                      pinned=JAX_ITERS_MGR64)
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
    spmv = (dia_spmv, csr_spmv, dia_spmv_epilogue, csr_spmv_epilogue)
    n0 = sum(f.launches for f in spmv)
    warm = drv.linear_solver_apply()
    out["solve_warm_s"] = warm.solve_time
    out["kernel_launches_per_iter"] = (
        (sum(f.launches for f in spmv) - n0) / max(1, warm.iters))
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
    from hypredrive_tpu_torch.solvers import device_loop

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
            device_loop.reset_stats()
            res = drv.linear_solver_apply()
            x = drv.get_solution()
            host_rel = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
            sysk = {"k": k, "rebuilt": rebuilt, "iters": res.iters,
                    "rel_res_norm": res.rel_res_norm, "host_rel_res": host_rel,
                    "setup_s": setup_s, "solve_s": res.solve_time,
                    # a new A (and, on a rebuild, a new preconditioner)
                    # is captured anew with the solve
                    "capture_s": device_loop.stats["capture_s"],
                    "captures": device_loop.stats["captures"],
                    "graph_nodes": device_loop.stats["nodes"]}
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
                  f"{setup_s:.3f} s, solve {res.solve_time:.4f} s (capture "
                  f"{sysk['capture_s']:.4f} s, {sysk['graph_nodes']} nodes)"
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


def elasticity_solves(drv, A, count, keep_last=False):
    """The elasticity driver's solve loop (``drivers.solve_loop``) on
    ``drv``: per solve (iters, true rel res, host rel res, setup s, solve
    s); the last preconditioner is kept when ``keep_last``."""
    import numpy as np
    from hypredrive_tpu_torch.drivers import solve_loop

    out = []

    def after(i, res):
        x = drv.get_solution()
        check(np.all(np.isfinite(x)), "elasticity: solution not finite")
        out.append({"iters": res.iters, "rel_res_norm": res.rel_res_norm,
                    "host_rel_res": float(np.linalg.norm(1.0 - A @ x)
                                          / np.sqrt(A.shape[0])),
                    "setup_s": drv.stats.entries[-1].setup_time,
                    "solve_s": res.solve_time})

    solve_loop(drv, count, after=after, keep_last=keep_last)
    return out


def phase_elasticity(report):
    """The elasticity driver (``hypredrive_tpu_torch.drivers.elasticity``)
    at 48×24×24 cells, with and without the rigid-body modes, and at its
    12×6×6 default."""
    from hypredrive_tpu_torch.drivers import elasticity

    out = report["elasticity_rbm"] = {}
    t0 = time.perf_counter()
    drv, A = elasticity.build(elasticity.parse_args(
        ["--nx", "48", "--ny", "24", "--nz", "24"]))
    out["generate_s"] = time.perf_counter() - t0
    check(A.shape[0] == 88200, f"elasticity: {A.shape[0]} rows")
    out.update(rows=A.shape[0], nnz=int(A.nnz))
    out["solves"] = elasticity_solves(drv, A, 3, keep_last=True)
    levels = drv.precon.state.levels
    out["level_rows"] = [lv.A.shape[0] for lv in levels]
    # the device loop on the kept preconditioner, from a fresh capture
    from hypredrive_tpu_torch.solvers import device_loop
    device_loop.release(drv.precon)
    begin = loop_begin()
    api_run(drv)()
    device_loop_check(report, "elasticity_rbm", api_run(drv), begin,
                      pinned=out["solves"][-1]["iters"])
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
    v0 = elasticity.DEFAULT_CONFIG.replace("preset: elasticity_sdc_3d",
                                           ELASTICITY_V0_PRECON)
    for name, argv, golden in (
            ("variant0", ["--nx", "48", "--ny", "24", "--nz", "24",
                          "--solves", "1", "-i", v0],
             JAX_ITERS_ELASTICITY_48_V0),
            ("default_12", [], JAX_ITERS_ELASTICITY_12)):
        args = elasticity.parse_args(argv)
        d2, A2 = elasticity.build(args)
        rs = elasticity_solves(d2, A2, args.solves)
        d2.destroy()
        out[name] = rs
        print(f"elasticity {(args.nx, args.ny, args.nz)} {name}: "
              f"{[r['iters'] for r in rs]} iterations (JAX package "
              f"{golden}), rel res {[r['rel_res_norm'] for r in rs]}")
        for r in rs:
            check(abs(r["iters"] - golden) <= 1,
                  f"elasticity {name}: {r['iters']} iterations, JAX {golden}")
    check(all(r["iters"] <= 21 for r in out["default_12"]),
          "elasticity 12x6x6: outside the reference's golden class (21)")
    for r in [*out["solves"], *out["variant0"], *out["default_12"]]:
        # the JAX package's 48×24×24 solves end at 9.65e-7
        check(r["rel_res_norm"] <= 1.02e-6 and r["host_rel_res"] <= 1.02e-6,
              f"elasticity: true rel res {r['rel_res_norm']:.3e} (host "
              f"{r['host_rel_res']:.3e}) > 1.02e-6")
    for r in out["solves"]:
        check(abs(r["iters"] - JAX_ITERS_ELASTICITY_48) <= 1,
              f"elasticity: {r['iters']} iterations, JAX package "
              f"{JAX_ITERS_ELASTICITY_48}")


def phase_convdif(report):
    """GMRES + AIR (the convdif driver's default config) on the 1024²
    upwind convection-diffusion operator, then the driver's timestep loop
    (``hypredrive_tpu_torch.drivers.convdif``) at its defaults."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.drivers import convdif
    from hypredrive_tpu_torch.ops.csr import convection_diffusion_2d

    no_stats = [("general:statistics", "off")]
    t0 = time.perf_counter()
    A = convection_diffusion_2d(1024, eps=1e-3)
    gen_s = time.perf_counter() - t0
    check(A.shape[0] == 1048576, f"convdif: {A.shape[0]} rows")
    drv = convdif.build(convdif.parse_args([]), no_stats)
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
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

    # the driver's timestep loop at its defaults (n = 40, 10 steps)
    args = convdif.parse_args([])
    drv = convdif.build(args, no_stats)
    steps = []

    def after(step, At, rhs, r):
        host = float(np.linalg.norm(rhs - At @ drv.get_solution())
                     / np.linalg.norm(rhs))
        steps.append({"iters": r.iters, "rel_res_norm": r.rel_res_norm,
                      "host_rel_res": host})
        golden = JAX_ITERS_CONVDIF_TRANSIENT[step - 1]
        check(abs(r.iters - golden) <= 1,
              f"convdif step {step}: {r.iters} iterations, JAX {golden}")
        check(r.converged and host <= 1e-8,
              f"convdif step {step}: host rel res {host:.3e}")

    _, c = convdif.time_steps(drv, args, after)
    out["transient"] = steps
    out["transient_levels"] = drv.stats_level_get_count("timestep")
    drv.destroy()
    print(f"convdif driver loop (n = {args.n}, {args.steps} steps): "
          f"iterations {[s_['iters'] for s_ in steps]} (JAX package "
          f"{list(JAX_ITERS_CONVDIF_TRANSIENT)}), mass "
          f"{c.sum() / args.n**2:.6e}")
    check(len(steps) == len(JAX_ITERS_CONVDIF_TRANSIENT)
          and out["transient_levels"] == 10, "convdif: timestep frames missing")


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


# the JAX package's numbers for the AMS/ADS, Laplacian-driver and C API
# paths (scripts/jax_goldens.py --json, float64, on the CPU).  Beside each
# AMS/ADS history, ``history_spread``: how far the JAX package's own history
# moves when b is perturbed by 1e-15 (AMS's gauge term GᵀAG + 1e-12·I
# amplifies rounding); at these sizes it is far below the 1e-6 bound.
JAX_COUNTS = os.path.join("data", "golden", "jax_counts.json")
AUX_HISTORY_TOL = 1e-6


def jax_counts(name):
    with open(JAX_COUNTS) as f:
        return json.load(f)[name]


def aux_driver(A, precon, setters, b):
    """PCG to 1e-8 (float64) with ``precon`` through the library verbs:
    A from CSR, the auxiliary operators by their setters, b; set up."""
    import torch
    from hypredrive_tpu_torch import HypreDrive

    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict({
        "general": {"statistics": False}, "linear_system": {},
        "solver": {"pcg": {"relative_tol": 1e-8, "max_iter": 400}},
        "preconditioner": precon})
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    for name, val in setters.items():
        getattr(drv, name)(val)
    drv.set_rhs(b)
    drv.precon_create()
    drv.linear_solver_create()
    t0 = time.perf_counter()
    drv.linear_solver_setup()
    torch.cuda.synchronize()
    return drv, time.perf_counter() - t0


def run_aux_path(report, key, A, precon, setters, gen_s):
    """An AMS/ADS path at full width: b = A·u(−1, 1) from seed 11; setup,
    first, warm and profiled solve; the count, history and true residual
    against the JAX package's."""
    import numpy as np

    ref = jax_counts(key)
    check(A.shape[0] == ref["rows"] and A.nnz == ref["nnz"],
          f"{key}: {A.shape[0]} rows / {A.nnz} nnz, JAX package "
          f"{ref['rows']} / {ref['nnz']}")
    b = A @ np.random.default_rng(11).uniform(-1, 1, A.shape[0])
    drv, setup_s = aux_driver(A, precon, setters, b)
    begin = loop_begin()
    res = drv.linear_solver_apply()
    x = drv.get_solution()
    if key == "ams_maxwell64":
        device_loop_check(report, key, api_run(drv), begin,
                          pinned=ref["iters"])
    host = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    hist = [float(h) for h in res.res_history[:res.iters + 1]]
    k = min(len(hist), len(ref["history"]))
    dev = max(abs(a / c - 1) for a, c in zip(hist[:k], ref["history"][:k]))
    state = drv.precon.state
    out = report[key] = {
        "rows": A.shape[0], "nnz": int(A.nnz), "generate_s": gen_s,
        "setup_s": setup_s, "iters": res.iters,
        "rel_res_norm": res.rel_res_norm, "host_rel_res": host,
        "solve_s": res.solve_time, "history": hist,
        "history_rel_dev_vs_jax": dev,
        "jax_history_spread": ref["history_spread"],
        "aux_level_rows": {
            name: [lv.A.shape[0] for lv in st.levels]
            for name, st in (("B_G", state.bg_state),
                             ("B_Pi", state.bpi_state))
            if st is not None and hasattr(st, "levels")}}
    drv.reset_initial_guess()
    out["solve_warm_s"] = drv.linear_solver_apply().solve_time
    out["profile"] = profile_solve(drv)
    print(f"{key}: {A.shape[0]} rows, {A.nnz} nnz (generated in "
          f"{gen_s:.3f} s), auxiliary levels {out['aux_level_rows']}; setup "
          f"{setup_s:.3f} s; {res.iters} iterations (JAX package "
          f"{ref['iters']}), rel res {res.rel_res_norm!r} (host {host!r}), "
          f"first solve {res.solve_time:.4f} s, warm {out['solve_warm_s']:.4f}"
          f" s; history vs the JAX package: max rel dev {dev:.3e} (the JAX "
          f"package's own spread {ref['history_spread']:.3e})")
    drv.destroy()
    check(res.iters == ref["iters"],
          f"{key}: {res.iters} iterations, JAX package {ref['iters']}")
    check(ref["history_spread"] < AUX_HISTORY_TOL and dev <= AUX_HISTORY_TOL,
          f"{key}: history deviates from JAX by {dev:.3e} (the JAX "
          f"package's own spread {ref['history_spread']:.3e})")
    check(res.converged and res.rel_res_norm <= 1e-8 and host <= 1e-8
          and np.all(np.isfinite(x)) and x.shape == (A.shape[0],),
          f"{key}: true rel res {res.rel_res_norm:.3e} (host {host:.3e})")
    return state


def phase_ams64(report):
    """maxwell_edge_system(64, eps=0.05, dim=3): 774,144 edges, PCG + AMS
    (cycle type 1) through the library verbs."""
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    t0 = time.perf_counter()
    A, G, coords = maxwell_edge_system(64, eps=0.05, dim=3)
    gen_s = time.perf_counter() - t0
    check(A.shape[0] == 774144 and G.shape == (774144, 262144),
          f"ams_maxwell64: A {A.shape}, G {G.shape}")
    KEEP["ams64_state"] = run_aux_path(
        report, "ams_maxwell64", A, {"ams": {"cycle_type": 1}},
        {"set_discrete_gradient": G, "set_coordinates": coords}, gen_s)


def phase_ads48(report):
    """graddiv_face_system(48, eps=0.1): 318,096 faces, PCG + ADS."""
    from hypredrive_tpu_torch.ops.csr import graddiv_face_system

    t0 = time.perf_counter()
    A, C, G, coords = graddiv_face_system(48, eps=0.1)
    gen_s = time.perf_counter() - t0
    run_aux_path(report, "ads_graddiv48", A, "ads",
                 {"set_discrete_curl": C, "set_discrete_gradient": G,
                  "set_coordinates": coords}, gen_s)


def phase_ams_cycles(report):
    """maxwell_edge_system(16, dim=3) with every AMS cycle type (1-8,
    11-14) and with Chebyshev relaxation: each count the JAX package's."""
    import numpy as np
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    ref = jax_counts("ams_cycles16")
    A, G, coords = maxwell_edge_system(16, dim=3)
    check(A.shape[0] == ref["rows"], f"ams_cycles: {A.shape[0]} rows")
    b = A @ np.random.default_rng(11).uniform(-1, 1, A.shape[0])
    setters = {"set_discrete_gradient": G, "set_coordinates": coords}
    out = report["ams_cycles"] = []
    for case in ref["cases"]:
        drv, setup_s = aux_driver(A, {"ams": case["ams"]}, setters, b)
        res = drv.linear_solver_apply()
        drv.reset_initial_guess()
        warm = drv.linear_solver_apply().solve_time
        drv.destroy()
        out.append({"ams": case["ams"], "iters": res.iters,
                    "jax_iters": case["iters"],
                    "rel_res_norm": res.rel_res_norm, "setup_s": setup_s,
                    "solve_s": res.solve_time, "solve_warm_s": warm})
    print(f"ams_cycles ({A.shape[0]} edges): iterations "
          f"{[(c['ams'], c['iters']) for c in out]} (JAX package "
          f"{[c['iters'] for c in ref['cases']]}), setup s "
          f"{[round(c['setup_s'], 3) for c in out]}, first / warm solve s "
          f"{[(round(c['solve_s'], 4), round(c['solve_warm_s'], 4))
              for c in out]}")
    for c in out:
        check(c["iters"] == c["jax_iters"] and c["rel_res_norm"] <= 1e-8,
              f"ams_cycles {c['ams']}: {c['iters']} iterations (JAX "
              f"{c['jax_iters']}), rel res {c['rel_res_norm']:.3e}")


def phase_laplacian_driver(report):
    """The Laplacian driver's main (``hypredrive_tpu_torch.drivers.
    laplacian``) at its defaults: a 30³ Laplacian, the poisson preset, five
    solves on one driver."""
    from hypredrive_tpu_torch.drivers import laplacian

    ref = jax_counts("laplacian_driver")
    collect = []
    check(laplacian.main([], collect=collect) == 0,
          "laplacian_driver: main failed")
    solves = [{"iters": e.iters, "rel_res_norm": e.rel_res_norm,
               "setup_s": e.setup_time, "solve_s": e.solve_time}
              for e in collect[0].stats.entries]
    report["laplacian_driver"] = {"rows": ref["rows"], "solves": solves}
    print(f"laplacian_driver ({ref['rows']} rows): iterations "
          f"{[s_['iters'] for s_ in solves]} (JAX package "
          f"{[it for it, _ in ref['solves']]}), setup s "
          f"{[round(s_['setup_s'], 4) for s_ in solves]}, solve s (first, "
          f"then warm) {[round(s_['solve_s'], 4) for s_ in solves]}")
    check(len(solves) == len(ref["solves"]),
          f"laplacian_driver: {len(solves)} solves")
    for s_, (it, _) in zip(solves, ref["solves"]):
        check(s_["iters"] == it and s_["rel_res_norm"] <= 1e-6,
              f"laplacian_driver: {s_['iters']} iterations (JAX {it}), rel "
              f"res {s_['rel_res_norm']:.3e}")


def phase_capi(report):
    """The port's C API shim: built with g++, interfaces/c/example_laplacian.c
    compiled against it with gcc and run (on the card: its config has no
    exec_policy), then the example's config on a 32³ Laplacian through
    the C verbs in this process, by ctypes."""
    import re

    import numpy as np
    import torch
    from hypredrive_tpu_torch.io import capi
    from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt

    out = report["capi"] = {}
    t0 = time.perf_counter()
    lib_dir = capi.build()
    out["build_s"] = time.perf_counter() - t0
    exe = os.path.join("build", "example_laplacian")
    proc = subprocess.run(
        ["gcc", os.path.join("interfaces", "c", "example_laplacian.c"),
         f"-I{capi.INCLUDE_DIR}", f"-L{lib_dir}", f"-l{capi.LIB_NAME}",
         "-o", exe], capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"capi: gcc failed: {proc.stderr[-2000:]}")
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = lib_dir + os.pathsep + \
        env.get("LD_LIBRARY_PATH", "")
    env["PYTHONPATH"] = os.pathsep.join([REPO, *(p for p in sys.path if p)])
    t0 = time.perf_counter()
    proc = subprocess.run([os.path.abspath(exe)], capture_output=True,
                          text=True, timeout=300, env=env)
    out["example_s"] = time.perf_counter() - t0
    out["example_stdout"] = proc.stdout[-2000:]
    print(f"capi: shim built in {out['build_s']:.3f} s; example_laplacian "
          f"(rc {proc.returncode}, {out['example_s']:.3f} s):\n  "
          + proc.stdout.strip().replace("\n", "\n  "))
    check(proc.returncode == 0 and "PASSED" in proc.stdout
          and "bad-config rc=" in proc.stdout,
          f"capi: example_laplacian failed (rc {proc.returncode}): "
          f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")

    ref = jax_counts("capi_lap32")
    A = laplacian_3d_7pt(32)
    lib = ctypes.CDLL(os.path.join(lib_dir, f"lib{capi.LIB_NAME}.so"))
    lib.HYPREDRV_ErrorMessage.restype = ctypes.c_char_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def ok(rc, what):
        check(rc == 0, f"capi: {what} returned {rc}: "
                       f"{lib.HYPREDRV_ErrorMessage()}")

    arrays = [np.ascontiguousarray(A.indptr, np.int64),
              np.ascontiguousarray(A.indices, np.int64),
              np.ascontiguousarray(A.data, np.float64),
              np.ones(A.shape[0])]
    ptrs = [a.ctypes.data_as(i64p if a.dtype == np.int64 else f64p)
            for a in arrays]
    n = ctypes.c_int64(A.shape[0])
    # the example's own config (a C string literal), statistics off
    with open(os.path.join("interfaces", "c", "example_laplacian.c")) as f:
        body = f.read().split("static const char *CONFIG =", 1)[1]
    literal = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"',
                                 body.split(";", 1)[0]))
    yaml = "general:\n  statistics: off\n" + literal.replace("\\n", "\n")
    check("preconditioner: amg" in yaml, f"capi: example config {yaml!r}")
    ok(lib.HYPREDRV_Initialize(), "Initialize")
    h = ctypes.c_int64()
    ok(lib.HYPREDRV_Create(ctypes.byref(h)), "Create")
    ok(lib.HYPREDRV_SetLibraryMode(h), "SetLibraryMode")
    ok(lib.HYPREDRV_InputArgsParse(h, yaml.encode()), "InputArgsParse")
    ok(lib.HYPREDRV_LinearSystemSetMatrixFromCSR(h, n, *ptrs[:3]),
       "SetMatrixFromCSR")
    ok(lib.HYPREDRV_LinearSystemSetRHSFromArray(h, n, ptrs[3]),
       "SetRHSFromArray")
    for verb in ("PreconCreate", "LinearSolverCreate", "LinearSolverSetup",
                 "LinearSolverApply"):
        ok(getattr(lib, f"HYPREDRV_{verb}")(h), verb)
    torch.cuda.synchronize()
    iters = ctypes.c_int32()
    setup, solve, rel = ctypes.c_double(), ctypes.c_double(), ctypes.c_double()
    ok(lib.HYPREDRV_LinearSolverGetNumIterations(h, ctypes.byref(iters)),
       "GetNumIterations")
    ok(lib.HYPREDRV_LinearSolverGetFinalRelativeResidualNorm(
        h, ctypes.byref(rel)), "GetFinalRelativeResidualNorm")
    ok(lib.HYPREDRV_LinearSolverGetSetupTime(h, ctypes.byref(setup)),
       "GetSetupTime")
    ok(lib.HYPREDRV_LinearSolverGetSolveTime(h, ctypes.byref(solve)),
       "GetSolveTime")
    x = np.zeros(A.shape[0])
    ok(lib.HYPREDRV_LinearSystemGetSolutionValues(
        h, n, x.ctypes.data_as(f64p)), "GetSolutionValues")
    first = (iters.value, rel.value, setup.value, solve.value)
    ok(lib.HYPREDRV_LinearSystemResetInitialGuess(h), "ResetInitialGuess")
    ok(lib.HYPREDRV_LinearSolverApply(h), "LinearSolverApply (warm)")
    ok(lib.HYPREDRV_LinearSolverGetSolveTime(h, ctypes.byref(solve)),
       "GetSolveTime")
    ok(lib.HYPREDRV_Destroy(ctypes.byref(h)), "Destroy")
    ok(lib.HYPREDRV_Finalize(), "Finalize")
    host = float(np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]))
    out.update(rows=A.shape[0], iters=first[0], rel_res_norm=first[1],
               host_rel_res=host, setup_s=first[2], solve_s=first[3],
               solve_warm_s=solve.value)
    print(f"capi in process ({A.shape[0]} rows, the example's config): "
          f"{first[0]} iterations (JAX package {ref['iters']}), rel res "
          f"{first[1]:.3e} (host {host:.3e}), setup {first[2]:.4f} s, solve "
          f"{first[3]:.4f} s, warm {solve.value:.4f} s")
    check(first[0] == ref["iters"] and host <= 1e-8,
          f"capi: {first[0]} iterations (JAX {ref['iters']}), host rel res "
          f"{host:.3e}")


def phase_aux_kernels(report):
    """Each kernel against its plain version at ams_maxwell64's shapes:
    G (2 entries a row), Gᵀ (up to 6), Π (6), Πᵀ and the edge matrix
    (about 13 a row), float64 (rel 1e-12)."""
    import torch

    st = KEEP.pop("ams64_state")
    checks = KernelChecks()
    for name, E in (("AMS G", st.G), ("AMS GT", st.GT), ("AMS Pi", st.Pi),
                    ("AMS PiT", st.PiT), ("AMS edge A0", st.A)):
        checks.matrix(f"{name} {E.shape[0]}x{E.shape[1]}", E, torch.float64)
    report["kernel_checks"].extend(checks.rows)
    del st
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the distributed layer: 8 row shards on cuda:0 (hypredrive_tpu_torch.parallel)
# ---------------------------------------------------------------------------

N_SHARDS = 8
DIST_HISTORY_TOL = 1e-6
# the mesh MGR of dist_mgr64 (scripts/jax_goldens.py DIST_MGR64): inside the
# distributed subset, with AMG and Jacobi F-relaxations and a coarsest AMG
DIST_MGR64 = {
    "level": {0: {"f_dofs": [2], "f_relaxation": {"amg": {"max_iter": 1}}},
              1: {"f_dofs": [1], "f_relaxation": "jacobi"}},
    "coarsest_level": "amg"}


def history_dev(hist, ref):
    k = min(len(hist), len(ref))
    return max(abs(a / c - 1) for a, c in zip(hist[:k], ref[:k]))


def timed(fn):
    """(fn(), seconds) on the host clock, ending in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_solve(core, D, pc, b, rtol, max_iter):
    """A Krylov core of the port on the mesh from x0 = 0 (GMRES(30); PCG
    on the two-norm)."""
    import torch
    from hypredrive_tpu_torch.solvers.gmres import gmres_core
    from hypredrive_tpu_torch.solvers.pcg import pcg_core

    extra = {gmres_core: (30, False), pcg_core: (True, 0)}.get(core, ())
    return core(D.matvec, pc, b, torch.zeros_like(b), rtol, 0.0, max_iter,
                *extra, group=D.mesh.reduce_group)


def check_mesh_solve(key, A, b_host, out, ref, bound, mesh=None):
    """Count equal to the JAX package's mesh count, history within
    DIST_HISTORY_TOL of its, finite x and host relative residual ≤
    bound; the numbers for the report.  On a mesh across ranks x is
    gathered from every rank first."""
    import numpy as np

    x = out[0] if mesh is None else mesh.gather(out[0])
    x = x[:A.shape[0]].cpu().numpy()
    iters = int(out[1])
    hist = [float(h) for h in out[4][:iters + 1]]
    rel = float(np.linalg.norm(b_host - A @ x) / np.linalg.norm(b_host))
    dev = history_dev(hist, ref["history"])
    check(iters == ref["iters"], f"{key}: {iters} iterations, JAX package "
                                 f"{ref['iters']}")
    check(dev <= DIST_HISTORY_TOL, f"{key}: history deviates from the JAX "
                                   f"package's by {dev:.3e}")
    check(bool(out[3]) and rel <= bound and np.all(np.isfinite(x)),
          f"{key}: host rel res {rel:.3e} > {bound}")
    return {"iters": iters, "host_rel_res": rel, "history": hist,
            "history_rel_dev_vs_jax": dev}


def phase_dist_dryrun8(report):
    """__graft_entry__.dryrun_multichip(8)'s three stacks on 8 shards of
    cuda:0: PCG + AMG (distributed setup, 8³), GMRES + the mesh MGR and
    BiCGSTAB + block-Jacobi ILU(0); the JAX package's 6, 5 and 12."""
    from hypredrive_tpu_torch.parallel import make_mesh
    from hypredrive_tpu_torch.parallel.dryrun import dryrun_multichip

    ref = {s["stack"]: s for s in jax_counts("dist_dryrun8")["stacks"]}
    mesh = make_mesh(N_SHARDS)
    stacks, wall = timed(lambda: dryrun_multichip(mesh))
    report["dist_dryrun8"] = {"stacks": stacks, "wall_s": wall}
    print(f"dist_dryrun8 ({N_SHARDS} shards on {mesh.device}, {wall:.3f} s):"
          + "".join(f" {s['stack']} {s['iters']} iterations (JAX package "
                    f"{ref[s['stack']]['iters']}), rel {s['rel']:.3e};"
                    for s in stacks))
    bound = {"pcg_amg": 1e-6, "gmres_mgr": 1e-5, "bicgstab_bj_ilu": 1e-5}
    for s in stacks:
        r = ref[s["stack"]]
        dev = history_dev(s["history"], r["history"])
        check(s["iters"] == r["iters"] and s["converged"]
              and s["rel"] < bound[s["stack"]] and dev <= DIST_HISTORY_TOL,
              f"dist_dryrun8 {s['stack']}: {s['iters']} iterations (JAX "
              f"{r['iters']}), rel {s['rel']:.3e}, history dev {dev:.3e}")


def phase_dist_lap128(report):
    """A 128³ Laplacian (2,097,152 rows, 262,144 a shard) on 8 shards of
    cuda:0, f64: the distributed AMG setup from split_rows parts, PCG to
    1e-8 (b = ones): the JAX package's mesh count and history, ±1 of the
    one-device count; setup, first, warm and profiled solve."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu_torch.parallel import make_mesh, pad_vector
    from hypredrive_tpu_torch.parallel.dist_setup import split_rows
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu_torch.solvers.pcg import pcg_core

    ref = jax_counts("dist_lap128")
    mesh = make_mesh(N_SHARDS)
    A = laplacian_3d_7pt(128)
    parts = split_rows(A, N_SHARDS)
    state, setup_s = timed(lambda: setup_hierarchy(
        parts, AMG_SCHEMA.defaults(), dtype=torch.float64, mesh=mesh))
    D = state.levels[0].A
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)

    def solve():
        return mesh_solve(pcg_core, D, lambda r: amg_apply(state, r), b,
                          1e-8, 100)

    out, first_s = timed(solve)
    _, warm_s = timed(solve)
    rows = [lv.A.shape[0] for lv in state.levels]
    r = report["dist_lap128"] = {
        "rows": A.shape[0], "nnz": int(A.nnz), "level_rows": rows,
        "dia_offsets": list(D.dia_offsets), "halo_offsets": list(D.offsets),
        "ext_size": D.ext_size, "setup_s": setup_s, "solve_s": first_s,
        "solve_warm_s": warm_s}
    r.update(check_mesh_solve("dist_lap128", A, np.ones(A.shape[0]), out,
                              ref, 1e-8))
    r["profile"] = profile_run(solve)
    print(f"dist_lap128: {A.shape[0]} rows on {N_SHARDS} shards, levels "
          f"{rows}, DIA offsets {D.dia_offsets}, halo distances {D.offsets}; "
          f"setup {setup_s:.3f} s; {r['iters']} iterations (JAX package "
          f"{ref['iters']}, one device {JAX_ITERS_128_F64}), host rel res "
          f"{r['host_rel_res']:.3e}, first solve {first_s:.4f} s, warm "
          f"{warm_s:.4f} s; history vs the JAX package: max rel dev "
          f"{r['history_rel_dev_vs_jax']:.3e}")
    check(rows == ref["level_rows"], f"dist_lap128: levels {rows}, JAX "
                                     f"package {ref['level_rows']}")
    check(list(D.dia_offsets) == ref["dia_offsets"]
          and list(D.offsets) == ref["halo_offsets"],
          f"dist_lap128: DIA offsets {D.dia_offsets} / halo {D.offsets}, "
          f"JAX package {ref['dia_offsets']} / {ref['halo_offsets']}")
    check(abs(r["iters"] - JAX_ITERS_128_F64) <= 1,
          f"dist_lap128: {r['iters']} iterations, one device "
          f"{JAX_ITERS_128_F64}±1")
    KEEP["dist_lap128_A0"] = D


def phase_dist_mgr64(report):
    """The nx = 64 multiphysics system (786,432 rows) on 8 shards of
    cuda:0: GMRES(30) + the mesh MGR (masked AMG and Jacobi F-relaxations,
    coarsest distributed AMG) to 1e-6, then BiCGSTAB + block-Jacobi ILU(0)
    to 1e-2 (it stalls near 3e-3 in both packages), b = ones: both the JAX
    package's mesh counts and histories."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.config.sections import MGR_SCHEMA
    from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system
    from hypredrive_tpu_torch.parallel import make_mesh, pad_vector
    from hypredrive_tpu_torch.parallel.dist_precon import (build_bj_ilu_dist,
                                                           setup_mgr_dist)
    from hypredrive_tpu_torch.parallel.dist_setup import split_rows
    from hypredrive_tpu_torch.precon.ilu import tri_jacobi_apply
    from hypredrive_tpu_torch.precon.mgr import mgr_apply
    from hypredrive_tpu_torch.solvers.bicgstab import bicgstab_core
    from hypredrive_tpu_torch.solvers.gmres import gmres_core

    ref = jax_counts("dist_mgr64")
    mesh = make_mesh(N_SHARDS)
    A, dofmap = multiphysics_fv_system(64, 3, contrast=0.3, coupling=0.12,
                                       convection=0.08)
    check(A.shape[0] == ref["rows"] and A.nnz == ref["nnz"],
          f"dist_mgr64: {A.shape[0]} rows / {A.nnz} nnz")
    parts = split_rows(A, N_SHARDS)
    args = MGR_SCHEMA.parse(DIST_MGR64, "mgr", [])
    sm, mgr_setup_s = timed(lambda: setup_mgr_dist(
        parts, args, dofmap, mesh, dtype=torch.float64))
    D = sm.levels[0].A
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    ones = np.ones(A.shape[0])

    def solve_mgr():
        return mesh_solve(gmres_core, D, lambda r: mgr_apply(sm, r), b,
                          1e-6, 100)

    begin = loop_begin()
    out, first_s = timed(solve_mgr)

    def run_mgr():
        o = solve_mgr()
        return o[1], o[4]

    device_loop_check(report, "dist_mgr64", run_mgr, begin,
                      pinned=ref["mgr"]["iters"])
    _, warm_s = timed(solve_mgr)
    mgr = {"setup_s": mgr_setup_s, "solve_s": first_s,
           "solve_warm_s": warm_s,
           "level_rows": [lv.A.shape[0] for lv in sm.levels],
           "f_kinds": [lv.f_kind for lv in sm.levels],
           "coarsest_level_rows": [lv.A.shape[0]
                                   for lv in sm.coarsest_state.levels]}
    mgr.update(check_mesh_solve("dist_mgr64 GMRES + MGR", A, ones, out,
                                ref["mgr"], 1e-6))
    mgr["profile"] = profile_run(solve_mgr)
    si, ilu_setup_s = timed(lambda: build_bj_ilu_dist(
        parts, mesh, dtype=torch.float64))
    out, ilu_s = timed(lambda: mesh_solve(
        bicgstab_core, D, lambda r: tri_jacobi_apply(si, r), b, 1e-2, 200))
    ilu = {"setup_s": ilu_setup_s, "solve_s": ilu_s}
    ilu.update(check_mesh_solve("dist_mgr64 BiCGSTAB + bj-ILU", A, ones,
                                out, ref["bj_ilu"], 1e-2))
    report["dist_mgr64"] = {"rows": A.shape[0], "nnz": int(A.nnz),
                            "mgr": mgr, "bj_ilu": ilu}
    print(f"dist_mgr64: {A.shape[0]} rows on {N_SHARDS} shards; MGR levels "
          f"{mgr['level_rows']} ({mgr['f_kinds']}), coarsest AMG levels "
          f"{mgr['coarsest_level_rows']}, setup {mgr_setup_s:.3f} s; "
          f"GMRES {mgr['iters']} iterations (JAX package "
          f"{ref['mgr']['iters']}), rel {mgr['host_rel_res']:.3e}, first "
          f"{first_s:.4f} s, warm {warm_s:.4f} s, history dev "
          f"{mgr['history_rel_dev_vs_jax']:.3e}; bj-ILU(0) setup "
          f"{ilu_setup_s:.3f} s, BiCGSTAB {ilu['iters']} iterations (JAX "
          f"package {ref['bj_ilu']['iters']}), {ilu_s:.4f} s, history dev "
          f"{ilu['history_rel_dev_vs_jax']:.3e}")
    check(mgr["f_kinds"] == ref["mgr"]["f_kinds"]
          and mgr["coarsest_level_rows"] == ref["mgr"]["coarsest_level_rows"],
          f"dist_mgr64: F-relaxations {mgr['f_kinds']}, coarsest levels "
          f"{mgr['coarsest_level_rows']}")


def phase_dist_ams32(report):
    """maxwell_edge_system(32, eps=0.05, dim=3) on 8 shards of cuda:0: PCG +
    AMS (cycle type 1) with every operator row-sharded and both auxiliary
    hierarchies from the distributed setup, to 1e-8, b = A·u(−1, 1) from
    seed 11: the JAX package's mesh count and history."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.config.sections import AMS_SCHEMA
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system
    from hypredrive_tpu_torch.parallel import make_mesh, pad_vector
    from hypredrive_tpu_torch.precon.ams import _ams_apply, build_ams_state
    from hypredrive_tpu_torch.solvers.pcg import pcg_core

    ref = jax_counts("dist_ams32")
    mesh = make_mesh(N_SHARDS)
    A, G, coords = maxwell_edge_system(32, eps=0.05, dim=3)
    check(A.shape[0] == ref["rows"] and A.nnz == ref["nnz"],
          f"dist_ams32: {A.shape[0]} rows / {A.nnz} nnz")
    args = AMS_SCHEMA.parse({"cycle_type": 1}, "ams", [])
    st, setup_s = timed(lambda: build_ams_state(
        A, G, coords, args, torch.float64, mesh=mesh))
    bh = A @ np.random.default_rng(11).uniform(-1, 1, A.shape[0])
    b = pad_vector(bh, st.A.shape[0], mesh)

    def solve():
        return mesh_solve(pcg_core, st.A, lambda r: _ams_apply(st, r), b,
                          1e-8, 400)

    out, first_s = timed(solve)
    _, warm_s = timed(solve)
    r = report["dist_ams32"] = {"rows": A.shape[0], "nnz": int(A.nnz),
                                "setup_s": setup_s, "solve_s": first_s,
                                "solve_warm_s": warm_s,
                                "jax_history_spread": ref["history_spread"]}
    check(ref["history_spread"] < DIST_HISTORY_TOL,
          f"dist_ams32: the JAX package's own spread "
          f"{ref['history_spread']:.3e}")
    r.update(check_mesh_solve("dist_ams32", A, bh, out, ref, 1e-8))
    r["profile"] = profile_run(solve)
    print(f"dist_ams32: {A.shape[0]} edges on {N_SHARDS} shards; setup "
          f"{setup_s:.3f} s; {r['iters']} iterations (JAX package "
          f"{ref['iters']}), host rel res {r['host_rel_res']:.3e}, first "
          f"{first_s:.4f} s, warm {warm_s:.4f} s; history dev "
          f"{r['history_rel_dev_vs_jax']:.3e} (the JAX package's own spread "
          f"{ref['history_spread']:.3e})")


def phase_dist_kernels(report):
    """Each kernel against its plain version at a shard of dist_lap128's A0
    (float64): the DIA part, and the CSR remainder that holds the shard's
    halo columns.  Shard 1: shard 0 (and the last shard) receive one halo
    plane only, which lands on a diagonal of x_ext, so their remainder is
    empty."""
    import torch

    D = KEEP.pop("dist_lap128_A0")
    s = 1
    E = D.shards[s]
    check(E.dia_data is not None and E.data is not None,
          f"dist_lap128 shard {s}: DIA part or CSR remainder missing")
    checks = KernelChecks()
    checks.matrix(f"dist A0 shard {s} {E.shape[0]}x{E.shape[1]}", E,
                  torch.float64)
    report["kernel_checks"].extend(checks.rows)
    del D, E
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the mesh across cards: one rank per card
# ---------------------------------------------------------------------------

MULTICARD_WORLDS = (1, 2, 4, 8)
MULTICARD_TIMEOUT_S = 480


def multicard_world():
    """The largest of 1, 2, 4 and 8 that is at most the cards there are."""
    import torch

    n = torch.cuda.device_count()
    return max(w for w in MULTICARD_WORLDS if w <= n)


def rank_solves(key, A, b_host, mesh, solve, ref, bound):
    """One rank's first (capturing) and warm solve of a mesh path, held
    to the JAX package's mesh count and history; then, uncounted, the
    same solve as the eager body (its count, and the halo bytes this rank
    sends) and under the profiler (the warm solve's device time)."""
    from hypredrive_tpu_torch.solvers import device_loop as dl

    out, first_s = timed(solve)
    out, warm_s = timed(solve)
    r = check_mesh_solve(key, A, b_host, out, ref, bound, mesh)
    with uncounted(), dl.eager():
        sent = dl.stats["halo_bytes"]
        eager = solve()
        halo = dl.stats["halo_bytes"] - sent
    check(int(eager[1]) == r["iters"],
          f"{key}: the eager body took {int(eager[1])} iterations, the "
          f"graphs {r['iters']}")
    with uncounted():
        prof = profile_run(solve)
    r.update(first_s=first_s, warm_s=warm_s,
             warm_device_s=prof["device_busy_s"],
             profiled_wall_s=prof["wall_s"], halo_bytes_solve=halo,
             halo_bytes_per_iter=halo / max(1, r["iters"]))
    return r


def rank_lap128(mesh):
    """dist_lap128 on this rank's shards: the 128³ Laplacian, the
    distributed AMG setup from per-shard parts, PCG to 1e-8."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu_torch.parallel import pad_vector
    from hypredrive_tpu_torch.parallel.dist_setup import split_rows
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu_torch.solvers.pcg import pcg_core

    ref = jax_counts("dist_lap128")
    A = laplacian_3d_7pt(128)
    state, setup_s = timed(lambda: setup_hierarchy(
        split_rows(A, N_SHARDS), AMG_SCHEMA.defaults(), dtype=torch.float64,
        mesh=mesh))
    rows = [lv.A.shape[0] for lv in state.levels]
    check(rows == ref["level_rows"], f"lap128: levels {rows}")
    D = state.levels[0].A
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    r = rank_solves("dist_multicard lap128", A, np.ones(A.shape[0]), mesh,
                    lambda: mesh_solve(pcg_core, D,
                                       lambda r: amg_apply(state, r), b,
                                       1e-8, 100), ref, 1e-8)
    r["setup_s"] = setup_s
    return r


def rank_mgr64(mesh):
    """dist_mgr64 on this rank's shards: GMRES(30) + the mesh MGR to 1e-6,
    then BiCGSTAB + block-Jacobi ILU(0) to 1e-2."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.config.sections import MGR_SCHEMA
    from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system
    from hypredrive_tpu_torch.parallel import pad_vector
    from hypredrive_tpu_torch.parallel.dist_precon import (build_bj_ilu_dist,
                                                           setup_mgr_dist)
    from hypredrive_tpu_torch.parallel.dist_setup import split_rows
    from hypredrive_tpu_torch.precon.ilu import tri_jacobi_apply
    from hypredrive_tpu_torch.precon.mgr import mgr_apply
    from hypredrive_tpu_torch.solvers.bicgstab import bicgstab_core
    from hypredrive_tpu_torch.solvers.gmres import gmres_core

    ref = jax_counts("dist_mgr64")
    A, dofmap = multiphysics_fv_system(64, 3, contrast=0.3, coupling=0.12,
                                       convection=0.08)
    parts = split_rows(A, N_SHARDS)
    sm, setup_s = timed(lambda: setup_mgr_dist(
        parts, MGR_SCHEMA.parse(DIST_MGR64, "mgr", []), dofmap, mesh,
        dtype=torch.float64))
    D = sm.levels[0].A
    ones = np.ones(A.shape[0])
    b = pad_vector(ones, D.shape[0], mesh)
    mgr = rank_solves("dist_multicard mgr64 GMRES + MGR", A, ones, mesh,
                      lambda: mesh_solve(gmres_core, D,
                                         lambda r: mgr_apply(sm, r), b,
                                         1e-6, 100), ref["mgr"], 1e-6)
    mgr["setup_s"] = setup_s
    si, ilu_setup_s = timed(lambda: build_bj_ilu_dist(
        parts, mesh, dtype=torch.float64))
    out, ilu_s = timed(lambda: mesh_solve(
        bicgstab_core, D, lambda r: tri_jacobi_apply(si, r), b, 1e-2, 200))
    ilu = check_mesh_solve("dist_multicard mgr64 BiCGSTAB + bj-ILU", A, ones,
                           out, ref["bj_ilu"], 1e-2, mesh)
    ilu.update(setup_s=ilu_setup_s, solve_s=ilu_s)
    return {"mgr": mgr, "bj_ilu": ilu}


def rank_dryrun(mesh):
    """The three dryrun stacks on this rank's shards (eager over gloo),
    against the JAX package's 8-device mesh."""
    from hypredrive_tpu_torch.parallel.dryrun import dryrun_multichip

    ref = {s["stack"]: s for s in jax_counts("dist_dryrun8")["stacks"]}
    stacks = dryrun_multichip(mesh)
    for s in stacks:
        r = ref[s["stack"]]
        dev = history_dev(s["history"], r["history"])
        check(s["iters"] == r["iters"] and s["converged"]
              and dev <= DIST_HISTORY_TOL,
              f"dryrun {s['stack']}: {s['iters']} iterations (JAX "
              f"{r['iters']}), history dev {dev:.3e}")
        s["history_rel_dev_vs_jax"] = dev
    return stacks


def multicard_worker(mode, out_path):
    """One rank, started by phase_dist_multicard with torchrun's
    environment: ``nccl`` runs dist_lap128 and dist_mgr64 on 8 shards over
    the ranks, one card each; ``gloo`` the dryrun stacks with every rank
    on cuda:0.  Writes its results (or its error) to ``out_path``."""
    import resource

    import torch
    from hypredrive_tpu_torch.core import runtime
    from hypredrive_tpu_torch.parallel import make_mesh

    res = {"mode": mode, "rank": int(os.environ["RANK"])}
    try:
        runtime.initialize(distributed=True, backend=mode)
        mesh = make_mesh(N_SHARDS)
        res.update(world=mesh.world, device=str(mesh.device),
                   shards=list(mesh.shard_range))
        counters = launch_counters()
        for f in counters.values():
            f.launches = 0
        if mode == "gloo":
            res["dryrun"] = rank_dryrun(mesh)
        else:
            res["lap128"] = rank_lap128(mesh)
            res["mgr64"] = rank_mgr64(mesh)
        res["launches"] = {k: f.launches for k, f in counters.items()}
        torch.cuda.synchronize()
    except Exception as exc:  # the parent reports every rank's failure
        res["error"] = f"{type(exc).__name__}: {exc}"
    res["peak_rss_mib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024
    with open(out_path, "w") as f:
        json.dump(res, f)
    if "error" not in res:
        runtime.finalize()
    return 1 if "error" in res else 0


def run_ranks(world, mode):
    """Start ``world`` ranks of this script as torchrun would (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); every rank's
    results.  Each rank's output goes to build/multicard_<mode>_<r>.log;
    ranks still running at the time limit are killed."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.makedirs("build", exist_ok=True)
    procs, paths, logs = [], [], []
    for r in range(world):
        paths.append(os.path.join("build", f"multicard_{mode}_{r}.json"))
        logs.append(os.path.join("build", f"multicard_{mode}_{r}.log"))
        if os.path.exists(paths[-1]):
            os.remove(paths[-1])
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r if mode == "nccl" else 0),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 mode, paths[-1]], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MULTICARD_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    outs, errors = [], []
    for r, (p, path, log) in enumerate(zip(procs, paths, logs)):
        res = None
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        if res is None or "error" in res or p.returncode != 0:
            with open(log) as f:
                tail = f.read()[-1500:]
            what = ("no result" if res is None else res.get(
                "error", "its result written, then no exit in time"))
            errors.append(f"rank {r} ({mode}, exit {p.returncode}): "
                          f"{what}\n{tail}")
        outs.append(res)
    check(not errors, "dist_multicard: " + "\n".join(errors))
    return outs


def phase_dist_multicard(report):
    """The mesh across cards: as many ranks as there are cards (the
    largest of 1, 2, 4 and 8 at most the card count), one card each,
    joined over NCCL; each rank runs dist_lap128 and dist_mgr64 on its
    shards of 8 in all, the halos and dot products collectives inside the
    captured Krylov graphs: the JAX package's 8-device counts 11 and
    81 + 24, histories within DIST_HISTORY_TOL.  On one card there is no
    cross-card exchange; the cross-rank exchange is then checked by two
    gloo ranks on cuda:0 (eager: gloo's collectives cannot be captured)
    running the three dryrun stacks."""
    world = multicard_world()
    runs = run_ranks(world, "nccl")
    rep = report["dist_multicard"] = {"world": world, "ranks": runs}
    total = {k: sum(r["launches"][k] for r in runs)
             for k in launch_counters()}
    print(f"dist_multicard: world {world} ({world} rank(s), one card each, "
          f"NCCL), 8 shards in all")
    if world == 1:
        print("dist_multicard: world 1 (one card): no cross-card exchange "
              "was exercised; the cross-rank exchange is checked below by "
              "2 gloo ranks on cuda:0, eager")
    for r in runs:
        lap, mgr, ilu = r["lap128"], r["mgr64"]["mgr"], r["mgr64"]["bj_ilu"]
        print(f"  rank {r['rank']} on {r['device']} (shards {r['shards']}): "
              f"lap128 {lap['iters']} iterations, warm {lap['warm_s']:.4f} "
              f"s wall / {lap['warm_device_s']:.4f} s device, halo "
              f"{lap['halo_bytes_per_iter']:.0f} B/iteration; mgr64 GMRES "
              f"{mgr['iters']} iterations, warm {mgr['warm_s']:.4f} s wall "
              f"/ {mgr['warm_device_s']:.4f} s device, halo "
              f"{mgr['halo_bytes_per_iter']:.0f} B/iteration; bj-ILU "
              f"BiCGSTAB {ilu['iters']}; setup {lap['setup_s']:.1f} / "
              f"{mgr['setup_s']:.1f} s; peak RSS "
              f"{r['peak_rss_mib']:.0f} MiB; launches {r['launches']}")
    print(f"  launches summed over the ranks: {total}")
    rep["launches_sum"] = dict(total)
    if world == 1:
        gl = run_ranks(2, "gloo")
        rep["gloo_ranks"] = gl
        for r in gl:
            print(f"  gloo rank {r['rank']} on {r['device']} (shards "
                  f"{r['shards']}): dryrun "
                  + ", ".join(f"{s['stack']} {s['iters']} (history dev "
                              f"{s['history_rel_dev_vs_jax']:.3e})"
                              for s in r["dryrun"])
                  + f"; launches {r['launches']}")
            for k in total:
                total[k] += r["launches"][k]
        check(all(r["dryrun"] == gl[0]["dryrun"] for r in gl),
              "dist_multicard: the gloo ranks' records differ")
    # the ranks' launches are this path's
    for k, f in launch_counters().items():
        f.launches += total[k]


def phase_bench(report):
    """``hypredrive_tpu_torch.bench`` at its default 64³ float32: its JSON
    line printed; ex1_iters, amg_levels and the V-cycle's entries the JAX
    package's, the 1e-8 count within ±1 of its float32 count."""
    import math

    from hypredrive_tpu_torch import bench

    ref = jax_counts("bench64")
    line, state = bench.run(64)
    print(json.dumps(line))
    ex = line["extra"]
    report["bench"] = line
    print(f"bench: first solve {ex['pcg_amg_first_solve_s']:.4f} s (capture "
          f"{ex['capture_s']:.4f} s, graph nodes {ex['graph_nodes']}), warm "
          f"{ex['pcg_amg_solve_s']:.5f} s, device "
          f"{ex['pcg_amg_solve_device_s']:.5f} s "
          f"({100 * ex['pcg_amg_solve_busy']:.1f}% busy), "
          f"{ex['replays_per_solve']} replays, {ex['host_reads_per_solve']} "
          f"host reads a solve")
    bench64_loop(report, state, ex["pcg_amg_iters_to_1e-8"])
    cyc = bench.cycle_nnz(state)
    print(f"bench: ex1 {ex['ex1_iters']} iterations (JAX package "
          f"{ref['ex1_iters']}), {ex['amg_levels']} levels "
          f"({ref['amg_levels']}), {ex['pcg_amg_iters_to_1e-8']} iterations "
          f"to 1e-8 ({ref['pcg_amg_iters_to_1e-8']}), V-cycle entries {cyc} "
          f"({ref['cyc_nnz']})")
    check(ex["backend"] == "cuda" and ex["device"] and ex["power_limit"],
          f"bench: backend {ex['backend']}, device {ex['device']}, power "
          f"limit {ex['power_limit']}")
    check(ex["ex1_iters"] == ref["ex1_iters"]
          and ex["amg_levels"] == ref["amg_levels"] and cyc == ref["cyc_nnz"],
          "bench: ex1 count, levels or V-cycle entries differ from the JAX "
          "package's")
    check(abs(ex["pcg_amg_iters_to_1e-8"] - ref["pcg_amg_iters_to_1e-8"])
          <= 1, "bench: the 1e-8 count is not within 1 of the JAX package's")
    check(all(math.isfinite(v) and v > 0 for v in (
        line["value"], ex["amg_vcycle_nnz_per_s"], ex["stream_triad_gbs"],
        ex["pcg_amg_solve_s"], ex["pcg_amg_solve_device_s"])),
        "bench: a rate or time is not a finite positive number")


def bench64_loop(report, state, iters):
    """The bench's solve (PCG + AMG to 1e-8, 64³ float32) on its AMG
    state: the device loop's check (``device_loop_check``)."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu_torch.ops.device_matrix import EllMatrix
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.solvers.pcg import pcg_core

    A = EllMatrix.from_csr(laplacian_3d_7pt(64, dtype=np.float32),
                           dtype=torch.float32, device="cuda")
    b = torch.ones(A.shape[0], dtype=torch.float32, device="cuda")
    x0 = torch.zeros_like(b)

    def run():
        out = pcg_core(A.matvec, lambda r: amg_apply(state, r), b, x0, 1e-8,
                       0.0, 100, True, 0)
        return out[1], out[4]

    begin = loop_begin()
    run()
    device_loop_check(report, "bench64", run, begin, "float32", iters)


# __graft_entry__.entry() on the CPU (the JAX package): its count and norm
JAX_ITERS_ENTRY = 6
JAX_NORM_ENTRY = 7.090098733897321e-06


def phase_flagship(report):
    """``flagship.entry()``, the port of ``__graft_entry__.entry()``: 16³
    float32 PCG + the default AMG to 1e-6 through the device loop, twice
    (capture, then replays); the JAX entry's count, its norm to rel 1e-3
    (float32, other summation orders)."""
    import torch
    from hypredrive_tpu_torch import flagship

    fn, args = flagship.entry()
    (x, iters, norm), first_s = timed(lambda: fn(*args))
    (x2, iters2, norm2), warm_s = timed(lambda: fn(*args))
    report["flagship"] = {"iters": iters, "norm": norm, "first_s": first_s,
                          "warm_s": warm_s}
    print(f"flagship entry: {iters} iterations (JAX entry "
          f"{JAX_ITERS_ENTRY}), norm {norm!r} (JAX {JAX_NORM_ENTRY!r}), "
          f"first {first_s:.4f} s, warm {warm_s:.5f} s")
    check(iters == iters2 == JAX_ITERS_ENTRY and norm == norm2
          and bool(torch.isfinite(x).all()) and torch.equal(x, x2),
          f"flagship: {iters}/{iters2} iterations, norms {norm}/{norm2}")
    check(abs(norm - JAX_NORM_ENTRY) <= 1e-3 * JAX_NORM_ENTRY,
          f"flagship: norm {norm} against the JAX entry's {JAX_NORM_ENTRY}")


def phase_profile_solve(report):
    """``tools/profile_solve.py`` on examples/ex3.yml (GMRES + MGR): the
    stats table, each phase's wall, device time and busy share, the
    device loop's replays, and a Chrome trace under build/."""
    import contextlib
    import io

    from hypredrive_tpu_torch.tools import profile_solve

    buf = io.StringIO()
    trace = os.path.join("build", "profile_solve_ex3.json")
    with contextlib.redirect_stdout(buf):
        rc = profile_solve.main([os.path.join("examples", "ex3.yml"),
                                 "--trace", trace])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(("converged=", "solve", "precon_setup",
                               "linear_system_build"))]
    report["profile_solve"] = lines
    print("\n".join(lines))
    check(rc == 0 and any(f"converged=True iters={GOLDEN_EX3_ITERS}" in ln
                          for ln in lines) and os.path.getsize(trace) > 0,
          f"profile_solve: rc {rc}, {lines[:1]}")


def phase_profile_setup(report):
    """``hypredrive_tpu_torch.tools.profile_setup`` at 64³: the hierarchy
    the bench's (the JAX package's level count), the phases adding up to
    the total."""
    from hypredrive_tpu_torch.tools import profile_setup

    r = report["profile_setup"] = profile_setup.run(64)
    ref = jax_counts("bench64")
    check(r["levels"] == ref["amg_levels"],
          f"profile_setup: {r['levels']} levels, JAX {ref['amg_levels']}")
    check(abs(sum(r["phases"].values()) - r["total_s"]) <= 1e-6
          and r["cycle_s"] > 0 and r["upload_bytes"] > 0,
          "profile_setup: phases do not add up or a phase is empty")


def phase_node_scaling(report):
    """``hypredrive_tpu_torch.tools.node_scaling`` weak mode, 32,768 rows a
    shard on 1/2/4/8 row shards of the card: rows and PCG + AMG counts the
    JAX script's on its 8-device CPU mesh."""
    from hypredrive_tpu_torch.tools import node_scaling

    ref = jax_counts("node_scaling32k")
    runs = report["node_scaling"] = node_scaling.run(
        "weak", ref["rows_per_chip"], reps=3)
    got = [(r["shards"], r["rows"], r["iters"]) for r in runs]
    want = [(r["chips"], r["rows"], r["iters"]) for r in ref["runs"]]
    print(f"node_scaling (shards, rows, iterations): {got} (JAX package "
          f"{want})")
    check(got == want, "node_scaling: counts differ from the JAX script's")


def phase_parity_report(report):
    """``hypredrive_tpu_torch.tools.parity_report --fast``: every example
    and the Laplacian and convdif drivers against the reference goldens and
    the JAX package's counts (build/PARITY_torch.md); each entry within ±1
    of the JAX package's count, elasticity marked skipped."""
    from hypredrive_tpu_torch.tools import parity_report

    results, gaps = parity_report.run(fast=True)
    report["parity_report"] = {"results": results, "gaps_vs_jax": gaps}
    print(f"parity_report: largest count gap to the JAX package per case "
          f"{gaps}")
    check(results["elasticity"] == parity_report.SKIPPED,
          "parity_report: elasticity not marked skipped")
    check(all(g is None or g <= 1 for g in gaps.values()),
          f"parity_report: counts off the JAX package's by more than 1: "
          f"{gaps}")


def phase_bindings(report):
    """``hypredrive_tpu_torch.tools.bindings`` on the card: the MATLAB MEX
    and the C++ program linked against the port's shim and run, the Julia
    and Fortran symbols, and the C surface by ctypes in this process."""
    from hypredrive_tpu_torch.tools import bindings

    report["bindings"] = bindings.run()


JAX_EXAMPLE_OUTPUT = os.path.join("data", "golden", "example_output_jax")
BENCH_KERNELS_TOL = 1e-5   # float32 SpMV rows against scipy
PLOT_RTOL = 1e-6


def phase_example_output(report):
    """``tools/generate_example_output.py`` over every example on the card,
    held against the JAX package's outputs: equal text outside the stats
    tables, equal counts, residuals within rel 2e-2."""
    from hypredrive_tpu_torch.tools import generate_example_output as geo

    results = geo.run(compare_dir=JAX_EXAMPLE_OUTPUT)
    report["example_output"] = {cfg: {"rc": r["rc"],
                                      "problems": r["problems"]}
                                for cfg, r in results.items()}
    check(sorted(results) == sorted(geo.EXAMPLES),
          f"example_output: ran {sorted(results)}")
    bad = {cfg: r["problems"] or f"rc {r['rc']}"
           for cfg, r in results.items() if r["rc"] or r["problems"]}
    check(not bad, f"example_output: {bad}")


def phase_bench_kernels(report):
    """``tools/bench_kernels.py`` at 64³ float32: the probe, the triad,
    the DIA and CSR rows (each within rel 1e-5 of scipy), the epilogue rows
    (each bit for bit against its torch chain) and the V-cycle."""
    from hypredrive_tpu_torch.tools import bench_kernels

    out = report["bench_kernels"] = bench_kernels.run(64, "float32")
    check(out["probe"]["launch_ok"],
          "bench_kernels: a probe launch disagrees with its plain version")
    spmv = [r for r in out["rows"] if r["name"] in ("dia_spmv", "csr_spmv")]
    check({r["name"] for r in spmv} == {"dia_spmv", "csr_spmv"},
          f"bench_kernels: SpMV rows {[r['name'] for r in spmv]}")
    for r in spmv:
        check(r["rel_err"] <= BENCH_KERNELS_TOL,
              f"bench_kernels {r['name']} {r['shape']}: rel err "
              f"{r['rel_err']:.3e} > {BENCH_KERNELS_TOL}")
    fused = [r for r in out["rows"] if r["name"] == "epilogue"]
    check(fused, "bench_kernels: no epilogue rows")
    for r in fused:
        check(r["bit_equal"], f"bench_kernels epilogue {r['shape']}: "
                              "differs from the torch chain")


def phase_plot_convergence(report):
    """``tools/plot_convergence.run_config`` on ex1 and ex3 on the card:
    the JAX package's count (one history entry more) and final relative
    residual (``jax_counts.json``'s parity_report, rel 1e-6); then its main,
    which plots, or raises a typed error without matplotlib."""
    from hypredrive_tpu_torch.core.errors import HypredrvError
    from hypredrive_tpu_torch.tools import plot_convergence

    golden = jax_counts("parity_report")["cases"]
    out = report["plot_convergence"] = {}
    for name in ("ex1.yml", "ex3.yml"):
        hist, res = plot_convergence.run_config(os.path.join("examples",
                                                             name))
        ((iters, rel),) = golden[name]
        out[name] = {"iters": res.iters, "history_len": len(hist),
                     "rel_res_norm": res.rel_res_norm, "jax": [iters, rel]}
        print(f"plot_convergence {name}: {res.iters} iterations, history of "
              f"{len(hist)}, rel res {res.rel_res_norm:.10e} (JAX package "
              f"{iters}, {rel:.10e})")
        check(res.iters == iters and len(hist) == iters + 1,
              f"plot_convergence {name}: {res.iters} iterations, history of "
              f"{len(hist)}; JAX package {iters}")
        check(abs(res.rel_res_norm - rel) <= PLOT_RTOL * rel,
              f"plot_convergence {name}: rel res {res.rel_res_norm:.6e}, "
              f"JAX package {rel:.6e}")
    png = os.path.join("build", "convergence_ex1.png")
    try:
        plot_convergence.main([os.path.join("examples", "ex1.yml"), "-o",
                               png])
        out["plot"] = png
        check(os.path.getsize(png) > 0, "plot_convergence: empty plot")
    except HypredrvError as exc:
        out["plot"] = f"typed error: {exc}"
        print(f"plot_convergence: no plot ({exc})")
        check("matplotlib" in str(exc), f"plot_convergence: {exc}")


# the paths whose device-loop figures PERF.md keeps (device_loop_check)
LOOP_KEYS = ("bench64", "lap64", "lap128_f64", "mgr_64", "elasticity_rbm",
             "ams_maxwell64", "dist_mgr64")
# H100 SXM peaks outside the tensor cores (NVIDIA data sheet): FP32 67,
# FP64 34 TFLOP/s
PEAK_FLOP_S = {"float32": 67e12, "float64": 34e12}


# GMRES(30) is the main path's shape; 50 is past one warp, and at 300 the
# float64 triangle is past shared memory and streams
KRYLOV_MS = (30, 50, 300)


def krylov_chain_ms(name, size, lat):
    """The recurrence's own chain: its dependent operations times their
    latencies (``latency_probe``), in ms.  Givens at step j: j multiply-
    adds, then the root's square, sum, sqrt and divide and the new
    diagonal's multiply-add; back-substitution of n rows: n (n - 1) / 2
    adds, n - 1 products of the fresh y[k+1], n subtractions and n
    divides."""
    if name == "givens_update":
        ops = {"add": size + 2, "mul": size + 2, "sqrt": 1, "div": 1}
    else:
        ops = {"add": size * (size - 1) // 2 + size, "mul": size - 1,
               "div": size}
    return sum(k * lat[op]["ns"] for op, k in ops.items()) * 1e-6, ops


def krylov_small_rows(ms=KRYLOV_MS):
    """givens_update at GMRES(m)'s last step j = m − 1 and
    hessenberg_backsolve of the whole m × m system, float32 and float64,
    for each m of ``ms``: the kernel against its plain version on the same
    inputs (a cycle's state built by the plain version from seeded
    columns, then copied), bit for bit; device ms by graph replay, plain
    ms on the card, the bound (bytes over 3.35 TB/s, operations over the
    FP32/FP64 peak), ``torch.linalg.solve_triangular`` as the back-
    substitution's library call, the floor (an empty one-block kernel of
    the same width, by graph replay) and the chain estimate
    (``krylov_chain_ms``).  Rows at m ≠ 30 carry ``path_shape`` False."""
    import torch
    from hypredrive_tpu_torch.ops.krylov_small import (empty_node,
                                                       latency_probe)

    # each kernel's block width: 128 threads (Givens), 256 (back-subst.)
    floor = {name: replay_ms(lambda t=t: empty_node(t))
             for name, t in (("givens_update", 128),
                             ("hessenberg_backsolve", 256))}
    lat = {dtn: latency_probe(dt) for dtn, dt in
           (("float32", torch.float32), ("float64", torch.float64))}
    print("  floor (empty one-block node of the kernel's width, graph "
          "replay): " + ", ".join(f"{k} {v:.5f} ms" for k, v in floor.items()))
    for dtn, d in lat.items():
        print(f"  latency {dtn}: " + ", ".join(
            f"{op} {v['cycles']:.1f} cycles / {v['ns']:.2f} ns"
            for op, v in d.items()))
    return [r for m in ms for r in _krylov_small_rows_at(m, floor, lat)]


def _krylov_small_rows_at(m, floor, lat):
    """krylov_small_rows at one m."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.ops.krylov_small import (
        givens_update, givens_update_plain, hessenberg_backsolve,
        hessenberg_backsolve_plain)

    rows = []
    rng = np.random.default_rng(30)
    # the plain back-substitution walks m³/6 scalar steps of launches
    plain_reps = (20, 10, 3) if m <= 50 else (1, 1, 1)
    for dt in (torch.float32, torch.float64):
        dtn = str(dt).replace("torch.", "")
        size = dt.itemsize
        st = dict(H=torch.zeros((m + 1, m), dtype=dt),
                  cs=torch.zeros(m, dtype=dt), sn=torch.zeros(m, dtype=dt),
                  g=torch.zeros(m + 1, dtype=dt),
                  norm=torch.zeros((), dtype=dt),
                  thr=torch.tensor(1e-30, dtype=dt),
                  done=torch.zeros((), dtype=torch.bool),
                  hist=torch.zeros(m + 1, dtype=dt),
                  base=torch.zeros((), dtype=torch.int64),
                  on=torch.ones((), dtype=torch.bool),
                  y=torch.zeros(m, dtype=dt),
                  count=torch.full((), m, dtype=torch.int64))
        st["g"][0] = 1.0
        cols = [torch.tensor(rng.standard_normal(j + 2), dtype=dt)
                for j in range(m)]
        for j in range(m - 1):
            givens_update_plain(st["H"], st["cs"], st["sn"], st["g"],
                                cols[j], j, st["on"], st["norm"], st["thr"],
                                st["done"], st["hist"], st["base"])
        col = cols[m - 1].cuda()
        j = m - 1

        def copy():
            return {k: v.cuda().clone() for k, v in st.items()}

        def g_args(c):
            return (c["H"], c["cs"], c["sn"], c["g"], col, j, c["on"],
                    c["norm"], c["thr"], c["done"], c["hist"], c["base"])

        ck, cp = copy(), copy()
        givens_update(*g_args(ck))
        givens_update_plain(*g_args(cp))
        hessenberg_backsolve(ck["H"], ck["g"], ck["y"], ck["count"],
                             ck["on"])
        hessenberg_backsolve_plain(cp["H"], cp["g"], cp["y"], cp["count"],
                                   cp["on"])
        torch.cuda.synchronize()
        keys = {"givens_update": ("H", "cs", "sn", "g", "norm", "done",
                                  "hist"),
                "hessenberg_backsolve": ("y",)}
        for name, kk in keys.items():
            err = max(float((ck[k].double() - cp[k].double()).abs().max())
                      for k in kk)
            same = all(torch.equal(ck[k], cp[k]) for k in kk)
            c1, c2 = copy(), copy()
            if name == "givens_update":
                run = lambda c=c1: givens_update(*g_args(c))          # noqa
                plain = lambda c=c2: givens_update_plain(*g_args(c))  # noqa
                nbytes = (4 * j + 12) * size
                flops = 6 * j + 11
                library = None
                shape = f"GMRES({m}) j={j}"
                chain, chain_ops = krylov_chain_ms(name, j, lat[dtn])
            else:
                run = lambda c=c1: hessenberg_backsolve(           # noqa
                    c["H"], c["g"], c["y"], c["count"], c["on"])
                plain = lambda c=c2: hessenberg_backsolve_plain(   # noqa
                    c["H"], c["g"], c["y"], c["count"], c["on"])
                nbytes = (m * (m + 1) // 2 + 2 * m) * size + 8
                flops = m * (m - 1) + 2 * m
                U = torch.triu(c1["H"][:m, :m]).contiguous()
                rhs = c1["g"][:m, None].contiguous()
                library = lambda: torch.linalg.solve_triangular(   # noqa
                    U, rhs, upper=True)
                shape = f"GMRES({m}) {m}x{m}"
                chain, chain_ops = krylov_chain_ms(name, m, lat[dtn])
            t_bytes = nbytes / (HBM_TB_S * 1e12) * 1e3
            t_ops = flops / PEAK_FLOP_S[dtn] * 1e3
            row = {"kernel": name, "shape": shape, "dtype": dtn, "m": m,
                   "path_shape": m == 30,
                   "max_abs_err": err, "max_rel_err": err,
                   "bit_identical": same, "bytes": nbytes, "flops": flops,
                   "ms": time_ms(run), "device_ms": replay_ms(run),
                   "plain_ms": time_ms(plain, reps=plain_reps[0],
                                       warmup=plain_reps[2]),
                   "plain_device_ms": device_ms(plain, reps=plain_reps[1]),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": (replay_ms(library) if library else None),
                   "floor_ms": floor[name], "chain_ms": chain,
                   "chain_ops": chain_ops}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            row["tb_s"] = nbytes / (row["device_ms"] * 1e-3) / 1e12
            rows.append(row)
            lib_txt = ("n/a" if row["library_ms"] is None
                       else f"{row['library_ms']:.5f}")
            print(f"  {name:20s} {shape:18s} {dtn:8s} bit-identical {same} "
                  f"(max abs {err:.3e}); device {row['device_ms']:.5f} ms, "
                  f"events {row['ms']:.5f} ms, plain {row['plain_ms']:.4f} "
                  f"ms (device {row['plain_device_ms']:.4f}), library "
                  f"{lib_txt} ms, floor {row['floor_ms']:.5f} ms, chain "
                  f"{chain:.5f} ms, bound {row['bound_ms']:.2e} ms "
                  f"({row['bound_by']})")
            check(same, f"{name} {shape} {dtn}: differs from its plain "
                        f"version by {err:.3e}")
    return rows


def phase_device_loop(report):
    """The device loop's figures on the paths of LOOP_KEYS (each checked
    against the eager body where it ran), and the Givens and back-
    substitution kernels against their plain versions."""
    loops = report.get("device_loop", {})
    missing = [k for k in LOOP_KEYS if k not in loops]
    check(not missing, f"device loop: no figures for {missing}")
    for k in LOOP_KEYS:
        d = loops[k]
        print(f"  {k:15s} first {d['first_solve_s']:.4f} s (capture "
              f"{d['capture_s']:.4f} s), warm {d['warm_solve_s']:.5f} s, "
              f"device {d['device_s']:.5f} s, busy {100 * d['busy']:.1f}%, "
              f"eager body {d['eager_solve_s']:.4f} s; {d['iters']} "
              f"iterations, {d['replays_per_solve']} replays "
              f"({d['masked_replays_per_solve']} masked), "
              f"{d['host_reads_per_solve']} host reads, {d['graphs']} "
              f"graphs, {d['graph_nodes']} nodes (largest "
              f"{d['largest_graph_nodes']}), first solve's peak "
              f"{d['peak_allocated_bytes'] / 2**20:.1f} MiB")
    report["kernel_checks"].extend(krylov_small_rows())


KERNELS = {
    "dia_spmv": ("hypredrive_tpu_torch/csrc/dia_spmv.cu",
                 "hypredrive_tpu/ops/pallas_dia.py:99 (K1); "
                 "hypredrive_tpu/ops/pallas_dia.py:171 (K2)"),
    "csr_spmv": ("hypredrive_tpu_torch/csrc/csr_spmv.cu",
                 "hypredrive_tpu/ops/pallas_spmv.py:85 (K3); "
                 "hypredrive_tpu/ops/pallas_spmv.py:216 (K4)"),
    # the same kernels with the cycles' vector chain in their epilogue
    # (csrc/spmv_epilogue.cuh): the device form of the JAX package's
    # smoother and correction arithmetic around its SpMV
    "dia_spmv_epilogue": ("hypredrive_tpu_torch/csrc/dia_spmv.cu",
                          "none (XLA code around K1/K2): hypredrive_tpu/"
                          "precon/amg/cycle.py smoother and correction"),
    "csr_spmv_epilogue": ("hypredrive_tpu_torch/csrc/csr_spmv.cu",
                          "none (XLA code around K3/K4): hypredrive_tpu/"
                          "precon/amg/cycle.py smoother and correction"),
    # not TPU kernels: the device form of XLA code in the jitted loop
    "givens_update": ("hypredrive_tpu_torch/csrc/krylov_small.cu",
                      "none (XLA code): hypredrive_tpu/solvers/gmres.py:107 "
                      "rot_step fori_loop and the rotation after it"),
    "hessenberg_backsolve": ("hypredrive_tpu_torch/csrc/krylov_small.cu",
                             "none (XLA code): hypredrive_tpu/solvers/"
                             "gmres.py:133 back_sub fori_loop"),
}


def launch_counters():
    """The wrappers whose ``launches`` count kernel launches."""
    from hypredrive_tpu_torch.solvers.device_loop import counted

    return {f.__name__: f for f in counted()}


# the solve paths: (name, phase, kernels each must launch); ex1-jacobi is
# a 7-point Laplacian without AMG, all on diagonals; the GMRES and FGMRES
# paths also launch the Givens and back-substitution kernels
BOTH = ("dia_spmv", "csr_spmv")
EPILOGUES = ("dia_spmv_epilogue", "csr_spmv_epilogue")
ARNOLDI = BOTH + ("givens_update", "hessenberg_backsolve")
PATHS = (("ex1", phase_ex1, BOTH), ("lap64", phase_64, BOTH),
         ("lap128", phase_128, BOTH + EPILOGUES), ("mgr_ex3", phase_mgr_ex3, ARNOLDI),
         ("mgr_ex5", phase_mgr_ex5, ARNOLDI),
         ("jacobi_ex1", phase_jacobi_ex1, ("dia_spmv",)),
         ("mgr_64", phase_mgr64, ARNOLDI),
         ("krylov_variants", phase_krylov_variants, ARNOLDI),
         ("mgr_ex4", phase_mgr_ex4, ARNOLDI),
         ("seq_ex7", phase_seq_ex7, ARNOLDI),
         ("seq_ex7_reuse", phase_seq_ex7_reuse, ARNOLDI),
         ("seq_ex7_frelax_reuse", phase_seq_ex7_frelax_reuse, ARNOLDI),
         ("amg_gs_fsai", phase_amg_gs_fsai, BOTH),
         ("ilu_variants", phase_ilu_variants, ARNOLDI),
         ("seq_64", phase_seq64, ARNOLDI),
         ("elasticity_rbm", phase_elasticity, BOTH),
         ("convdif_air", phase_convdif, ARNOLDI),
         ("lap128_agg_cf", phase_lap128_agg_cf, BOTH),
         ("ex6_eigspec", phase_ex6, BOTH),
         ("ex9_print_system", phase_ex9, BOTH),
         ("lsseq_ex7", phase_lsseq_ex7, ARNOLDI),
         ("scaling_xref", phase_scaling_xref, ARNOLDI),
         ("ams_maxwell64", phase_ams64, BOTH),
         ("ads_graddiv48", phase_ads48, BOTH),
         ("ams_cycles", phase_ams_cycles, BOTH),
         ("laplacian_driver", phase_laplacian_driver, BOTH),
         ("capi", phase_capi, BOTH),
         ("dist_dryrun8", phase_dist_dryrun8, ARNOLDI),
         ("dist_lap128", phase_dist_lap128, BOTH),
         ("dist_mgr64", phase_dist_mgr64, ARNOLDI),
         ("dist_ams32", phase_dist_ams32, BOTH),
         ("dist_multicard", phase_dist_multicard, ARNOLDI),
         ("bench", phase_bench, BOTH),
         ("flagship", phase_flagship, BOTH),
         ("profile_solve", phase_profile_solve, ARNOLDI),
         ("profile_setup", phase_profile_setup, BOTH),
         ("node_scaling", phase_node_scaling, BOTH),
         ("parity_report", phase_parity_report, ARNOLDI),
         ("bindings", phase_bindings, BOTH),
         ("example_output", phase_example_output, ARNOLDI),
         ("bench_kernels", phase_bench_kernels, BOTH),
         ("plot_convergence", phase_plot_convergence, ARNOLDI))


def main() -> int:
    args = sys.argv[1:]
    baseline_src = None
    only = None
    if args[:1] == ["--baseline-csr"] and len(args) == 2:
        baseline_src = os.path.abspath(args[1])
    elif args[:1] == ["--only"] and len(args) > 1:
        only = args[1:]
    elif args[:1] == ["--rank-worker"] and len(args) == 3:
        pass
    elif args:
        print("usage: chip_smoke.py [--baseline-csr FILE | --only PATH...]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if args[:1] == ["--rank-worker"]:
        return multicard_worker(args[1], args[2])
    paths = PATHS
    if only is not None:
        paths = tuple(p for p in PATHS if p[0] in only)
        if len(paths) != len(set(only)):
            print(f"chip_smoke: unknown paths in {only}", file=sys.stderr)
            return 2
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
        for name, fn, kernels_run in paths:
            # each path's own count: zeroed just before, read just after
            for f in counters.values():
                f.launches = 0
            run(name, fn)
            counts = {k: f.launches for k, f in counters.items()}
            report.setdefault("launches_by_path", {})[name] = counts
            print(f"{name} kernel launches: {counts}")
            for k in counts:
                launches[k] += counts[k]
            for k in kernels_run:
                if counts[k] <= 0:
                    failures.append(f"launches: {name} never launched {k}")
        report["launches"] = launches
        print(f"main-path kernel launches: {launches}")
    if only is not None:
        # the named paths alone: their checks and launches, no kernel table
        print(report.get("nvidia_smi", ""))
        if failures:
            print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
                  file=sys.stderr)
        print(json.dumps({"ok": not failures, "only": only}))
        return 1 if failures else 0
    if not failures:
        for name, key, fn in (("kernels", "lap128_state", phase_kernels),
                              ("mgr_kernels", "mgr64_state",
                               phase_mgr_kernels),
                              ("seq_kernels", "seq64_ilu", phase_seq_kernels),
                              ("slice_kernels", "convdif_R0",
                               phase_slice_kernels),
                              ("aux_kernels", "ams64_state",
                               phase_aux_kernels),
                              ("dist_kernels", "dist_lap128_A0",
                               phase_dist_kernels)):
            if key in KEEP:
                run(name, fn)
            else:
                failures.append(f"{name}: no operators to check")
        if "kernel_checks" in report:
            run("device_loop", phase_device_loop)
        else:
            failures.append("device_loop: no kernel table to add to")
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
        # the float64 shape of the main path that moves the most bytes
        main_row = max((r for r in rows if r["dtype"] == "float64"
                        and r.get("path_shape", True)),
                       key=lambda r: r["bytes"])
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": report["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": main_row["device_ms"], "plain_ms": main_row["plain_device_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row.get("bound_by", "bytes"),
            "library_ms": main_row["library_ms"],
            "shape": f"{main_row['shape']} {main_row['dtype']}",
            "launches_warm_lap128_solve": warm[name],
            "shapes": [{k: r.get(k) for k in (
                "shape", "dtype", "device_ms", "ms", "plain_device_ms",
                "plain_ms", "bound_ms", "bound_share", "library_ms",
                "baseline_device_ms", "max_rel_err", "tb_s", "floor_ms",
                "chain_ms")}
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
