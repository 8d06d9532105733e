#!/usr/bin/env python3
"""The JAX package's reference numbers for the port's chip smoke test.

Runs ``hypredrive_tpu`` on the CPU on the inputs of ``chip_smoke.py``'s
elasticity, convection-diffusion, aggressive/C-F Laplacian, eigenspectrum
and dump paths, and prints what the smoke test pins: iteration counts,
relative residuals, operator complexities and dump statistics as JSON, and
(``--eigenvalues FILE``) writes the ex6 eigenvalues as a ``.npy`` file.
``--eig-spread`` computes the ex6 eigenvalues twice, with LAPACK on one
thread and on eight (two child processes), and prints how far the two sets
lie apart: the spread that bounds how closely any other run can match them.

    python3 scripts/jax_goldens.py [--only NAME ...] [--eigenvalues FILE]
                                   [--eig-spread]

The elasticity matrices come from ``hypredrive_tpu_torch.ops.csr``, whose
generator stores what the JAX package's stores but builds 48×24×24 in
linear memory; they reach the JAX package through ``set_matrix_from_csr``.
Everything else is the JAX package's own.  Needs JAX; run it where the
JAX package runs (not on the card's machine).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import hypredrive_tpu as hd  # noqa: E402
from hypredrive_tpu.config.presets import register_precon_preset  # noqa
from hypredrive_tpu.ops.csr import (convection_diffusion_2d,  # noqa: E402
                                    rigid_body_modes)

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
  statistics: off
linear_system:
  rhs_mode: ones
solver:
  pcg:
    max_iter: 200
    relative_tol: 1.0e-6
    print_level: 0
preconditioner:
  {precon}
"""
ELASTICITY_PRECON = {
    None: "preset: elasticity_sdc_3d",
    0: ("amg:\n    interp_vec_variant: 0\n    coarsening:\n"
        "      num_functions: 3\n      strong_th: 0.8\n"
        "      filter_functions: on")}
CONVDIF_AIR = os.path.join(REPO, "examples", "drivers", "convdif-gmres-air.yml")
NO_STATS = [("general:statistics", "off")]


def elasticity_config(variant=None):
    return ELASTICITY_CONFIG.format(precon=ELASTICITY_PRECON[variant])


def elasticity(dims, variant=None, solves=3):
    """examples/drivers/elasticity.py's flow: (iters, rel res) per solve."""
    from hypredrive_tpu_torch.ops.csr import elasticity_3d

    A, coords = elasticity_3d(*dims)
    rbm = rigid_body_modes(coords, ndim=3)
    n = A.shape[0]
    drv = hd.HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(elasticity_config(variant))
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    drv.system.set_dofmap(np.arange(n) % 3)
    drv.set_near_nullspace([rbm[:, k] for k in range(rbm.shape[1])])
    drv.set_rhs(np.ones(n))
    out = []
    for _ in range(solves):
        drv.reset_initial_guess()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        out.append((res.iters, res.rel_res_norm))
        drv.precon_destroy()
        drv.linear_solver_destroy()
    drv.destroy()
    return {"rows": n, "nnz": int(A.nnz), "solves": out}


def convdif_steady(n):
    """convection_diffusion_2d(n, eps=1e-3), b = ones, GMRES + AIR."""
    A = convection_diffusion_2d(n, eps=1e-3)
    drv = hd.HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(CONVDIF_AIR, NO_STATS)
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    drv.set_rhs(np.ones(A.shape[0]))
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    levels = [lv.A.shape[0] for lv in drv.precon.state.levels]
    drv.destroy()
    return {"rows": A.shape[0], "nnz": int(A.nnz), "iters": res.iters,
            "rel_res_norm": res.rel_res_norm, "level_rows": levels}


def convdif_transient(n=40, steps=10, eps=1e-3, velocity=(1.0, 0.5),
                      dt0=0.01, growth=1.5):
    """examples/drivers/convdif.py's timestep loop at its defaults."""
    x = (np.arange(n) + 1.0) / (n + 1)
    X, Y = np.meshgrid(x, x, indexing="xy")
    c = np.exp(-80.0 * ((X - 0.2) ** 2 + (Y - 0.2) ** 2)).ravel()
    drv = hd.HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(CONVDIF_AIR, NO_STATS)
    dt, out = dt0, []
    for step in range(1, steps + 1):
        drv.annotate_level_begin("timestep", step)
        A = convection_diffusion_2d(n, eps=eps, velocity=velocity, dt=dt)
        drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
        drv.set_rhs(c / dt)
        drv.set_initial_guess(c)
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        c = drv.get_solution()
        drv.precon_destroy()
        drv.linear_solver_destroy()
        out.append((res.iters, res.rel_res_norm))
        dt *= growth
        drv.annotate_level_end("timestep", step)
    drv.destroy()
    return {"steps": out, "final_sum": float(np.sum(c))}


def lap_agg_cf(nx=128):
    """nx³ Laplacian, PCG + AMG with one aggressive level and C/F
    ℓ1-Jacobi, to 1e-8 in float64."""
    drv = hd.HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict({
        "general": {"statistics": False},
        "linear_system": {"generate": {"kind": "laplacian_7pt", "nx": nx},
                          "rhs_mode": "ones"},
        "solver": {"pcg": {"relative_tol": 1e-8, "max_iter": 100}},
        "preconditioner": {"amg": {
            "aggressive": {"num_levels": 1},
            "relaxation": {"type": 18, "order": 1}}}})
    drv.linear_system_build()
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    levels = drv.precon.state.levels
    nnz0 = levels[0].A.nnz
    out = {"iters": res.iters, "rel_res_norm": res.rel_res_norm,
           "level_rows": [lv.A.shape[0] for lv in levels],
           "level_nnz": [int(lv.A.nnz) for lv in levels],
           "operator_complexity": sum(lv.A.nnz for lv in levels) / nnz0,
           "smoother": levels[0].smoother}
    drv.destroy()
    return out


def ex6_eigenvalues():
    """examples/ex6.yml through the CLI: the eigenvalues of M⁻¹A."""
    from hypredrive_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "eig")
        rc = cli.main(["-a", "linear_system:eigspec:output_prefix", prefix,
                       "-a", "general:print_config_params", "off",
                       os.path.join(REPO, "examples", "ex6.yml")])
        assert rc == 0
        a = np.loadtxt(f"{prefix}_eigenvalues.txt", skiprows=1, ndmin=2)
    return a[:, 0] + 1j * a[:, 1] if a.shape[1] == 2 else a[:, 0]


def ex9_dumps():
    """examples/ex9-print-system.yml through the CLI: the dump tree and
    the norms of each dumped vector."""
    from hypredrive_tpu import cli
    from hypredrive_tpu.io import ij

    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "dump")
        rc = cli.main(["-a", "linear_system:print_system:dirname", d,
                       "-a", "general:print_config_params", "off",
                       os.path.join(REPO, "examples", "ex9-print-system.yml")])
        assert rc == 0
        files = sorted(os.path.relpath(os.path.join(r, f), d)
                       for r, _, fs in os.walk(d) for f in fs)
        norms = {}
        for f in files:
            if os.path.basename(f) in ("IJ.out.b", "IJ.out.x0", "IJ.out.x"):
                v = ij.read_vector_auto(os.path.join(d, f))
                norms[f] = [float(np.linalg.norm(v)),
                            float(np.abs(v).sum()), float(np.abs(v).max())]
    return {"files": files, "vector_norms": norms}


def eig_distance(a, b):
    """max over a of the distance to the nearest of b, relative to |a|."""
    worst = 0.0
    for s_ in range(0, len(a), 256):
        blk = a[s_:s_ + 256]
        d = np.abs(blk[:, None] - b[None, :]).min(axis=1)
        worst = max(worst, float((d / np.abs(blk)).max()))
    return worst


def ex6_thread_spread(threads=(1, 8)):
    """ex6's eigenvalues with LAPACK on each thread count (child processes,
    since the BLAS reads its thread count when it loads): the nearest
    neighbour and sorted relative deviations between the first and the
    others, and of each against data/golden/ex6_jax_eigenvalues.npy."""
    golden = np.load(os.path.join(REPO, "data", "golden",
                                  "ex6_jax_eigenvalues.npy"))
    out, sets = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for t in threads:
            path = os.path.join(tmp, f"eig_{t}.npy")
            env = dict(os.environ, **{k: str(t) for k in (
                "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--only", "--eigenvalues", path], env=env,
                           check=True, stdout=subprocess.DEVNULL)
            sets[t] = np.load(path)
    for t, w in sets.items():
        out[f"threads_{t}_vs_golden"] = max(eig_distance(w, golden),
                                            eig_distance(golden, w))
    w0 = sets[threads[0]]
    for t in threads[1:]:
        w = sets[t]
        out[f"threads_{threads[0]}_vs_{t}"] = {
            "nearest_rel_dev": max(eig_distance(w0, w), eig_distance(w, w0)),
            "sorted_rel_dev": float(np.abs(np.sort_complex(w0)
                                           - np.sort_complex(w)).max()
                                    / np.abs(w0).max())}
    return out


MP2K = os.path.join(REPO, "data", "multiphys2k", "np1")
EX3_MGR = {"mgr": {
    "level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
              1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                  "restriction_type": "columped"}},
    "coarsest_level": "amg"}}


def ex3_config(scaling=None, rhs_mode=None):
    """ex3's system and GMRES + MGR, with a scaling type or an rhs mode."""
    ls = {"matrix_filename": os.path.join(MP2K, "IJ.out.A"),
          "dofmap_filename": os.path.join(MP2K, "dofmap.out")}
    if rhs_mode:
        ls["rhs_mode"] = rhs_mode
    else:
        ls["rhs_filename"] = os.path.join(MP2K, "IJ.out.b")
    solver = {"gmres": {}}
    if scaling:
        solver["scaling"] = {"enabled": True, "type": scaling}
    return {"general": {"statistics": False}, "linear_system": ls,
            "solver": solver, "preconditioner": EX3_MGR}


def scaling_xref():
    """ex3 with rhs_l2 and dofmap_mag scaling; GMRES + MGR on multiphys2k
    with rhs_mode randsol: the error norm and the per-dof-block error
    history against xref."""
    out = {}
    for key, cfg in (("rhs_l2", ex3_config("rhs_l2")),
                     ("dofmap_mag", ex3_config("dofmap_mag")),
                     ("randsol", ex3_config(rhs_mode="randsol"))):
        drv = hd.HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict(cfg)
        drv.linear_system_build()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        out[key] = {"iters": res.iters, "rel_res_norm": res.rel_res_norm}
        if key == "randsol":
            out[key]["error_norm"] = res.error_norm
            out[key]["error_history"] = np.asarray(
                res.error_histories)[:res.iters + 1].tolist()
        drv.destroy()
    return out


TASKS = {
    "scaling_xref": scaling_xref,
    "elasticity_12": lambda: elasticity((12, 6, 6)),
    "elasticity_48": lambda: elasticity((48, 24, 24)),
    "elasticity_48_variant0": lambda: elasticity((48, 24, 24), variant=0),
    "convdif_1024": lambda: convdif_steady(1024),
    "convdif_transient": convdif_transient,
    "lap128_agg_cf": lap_agg_cf,
    "ex9": ex9_dumps,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, choices=sorted(TASKS))
    ap.add_argument("--eigenvalues", default=None,
                    help="write the ex6 eigenvalues to this .npy file")
    ap.add_argument("--eig-spread", action="store_true",
                    help="ex6's eigenvalues with LAPACK on 1 and 8 threads, "
                         "and how far they lie apart")
    args = ap.parse_args()
    register_precon_preset(*ELASTICITY_PRESET)
    for name in (args.only if args.only is not None else sorted(TASKS)):
        print(json.dumps({name: TASKS[name]()}), flush=True)
    if args.eigenvalues:
        w = ex6_eigenvalues()
        np.save(args.eigenvalues, w)
        print(json.dumps({"ex6": {"count": len(w),
                                  "abs_min": float(np.abs(w).min()),
                                  "abs_max": float(np.abs(w).max())}}))
    if args.eig_spread:
        print(json.dumps({"ex6_thread_spread": ex6_thread_spread()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
