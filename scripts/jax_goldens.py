#!/usr/bin/env python3
"""The JAX package's reference numbers for the port's chip smoke test.

Runs ``hypredrive_tpu`` on the CPU on the inputs of ``chip_smoke.py``'s
elasticity, convection-diffusion, aggressive/C-F Laplacian, eigenspectrum,
dump, AMS/ADS, Laplacian-driver and C API paths, and prints what the smoke
test pins: iteration counts, relative residuals, residual histories,
operator complexities and dump statistics as JSON; ``--json FILE`` also
writes them to FILE (``data/golden/jax_counts.json`` holds the AMS/ADS,
Laplacian-driver and C API ones, which ``chip_smoke.py`` reads), and
``--eigenvalues FILE`` writes the ex6 eigenvalues as a ``.npy`` file.
``--eig-spread`` computes the ex6 eigenvalues twice, with LAPACK on one
thread and on eight (two child processes), and prints how far the two sets
lie apart: the spread that bounds how closely any other run can match them.
The AMS/ADS paths also solve twice more with b perturbed by 1e-15
(relative, seeded): ``history_spread`` is how far the JAX package's own
residual history moves, the bound on how closely any other summation
order can follow it; ``ams_spread5`` measures the same for every AMS
cycle type at n = 5, where the gauge term's amplified rounding shows.
The ``dist_*`` tasks run the JAX package's distributed layer on an
8-device CPU mesh (``--xla_force_host_platform_device_count=8``, set here
before JAX starts): the three ``dryrun_multichip(8)`` stacks, a 128³
Laplacian with PCG + AMG from per-shard parts, the nx = 64 multiphysics
system with GMRES + the mesh MGR and BiCGSTAB + block-Jacobi ILU(0), and
maxwell_edge_system(32) with PCG + AMS on the mesh; each records its
host seconds here.  ``--json FILE`` merges into FILE when it exists.

    python3 scripts/jax_goldens.py [--only NAME ...] [--json FILE]
                                   [--eigenvalues FILE] [--eig-spread]

The elasticity matrices and the AMS/ADS incidence operators come from
``hypredrive_tpu_torch.ops.csr``, whose generators store what the JAX
package's store (``tests/test_torch_ams_ads.py``,
``tests/test_torch_amg_extras.py``) but build 48×24×24 elasticity in linear
memory and the n = 64 de Rham complex without Python loops; they reach the
JAX package through its library verbs.  Everything else is the JAX
package's own.  Needs JAX; run it where the JAX package runs (not on the
card's machine).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the distributed tasks' 8-device CPU mesh (no effect on one-device runs)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                           "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import hypredrive_tpu as hd  # noqa: E402
from hypredrive_tpu.config.presets import register_precon_preset  # noqa
from hypredrive_tpu.ops.csr import (convection_diffusion_2d,  # noqa: E402
                                    laplacian_3d_7pt, rigid_body_modes)

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


def aux_solve(A, precon, setters, perturb_seed=None):
    """PCG to 1e-8 with ``precon`` on A, b = A·u(−1, 1) from seed 11
    (times 1 + 1e-15·N(0, 1) from ``perturb_seed``), float64: (iters, rel
    res, residual history)."""
    b = A @ np.random.default_rng(11).uniform(-1, 1, A.shape[0])
    if perturb_seed is not None:
        b = b * (1.0 + 1e-15 * np.random.default_rng(
            perturb_seed).standard_normal(len(b)))
    drv = hd.HypreDrive()
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
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    drv.destroy()
    hist = np.asarray(res.res_history)[:res.iters + 1]
    return res.iters, float(res.rel_res_norm), hist


def aux_path(A, precon, setters, spread_seeds=(1, 2)):
    """An AMS/ADS chip path: its count, residual history and the largest
    relative move of the history under 1e-15 perturbations of b."""
    iters, rel, hist = aux_solve(A, precon, setters)
    spread = 0.0
    for seed in spread_seeds:
        it_p, _, h_p = aux_solve(A, precon, setters, seed)
        k = min(len(hist), len(h_p))
        spread = max(spread, float(np.abs(h_p[:k] / hist[:k] - 1).max()))
        assert it_p == iters, (it_p, iters)
    return {"rows": A.shape[0], "nnz": int(A.nnz), "iters": iters,
            "rel_res_norm": rel, "history": hist.tolist(),
            "history_spread": spread}


def ams_maxwell(n=64):
    """maxwell_edge_system(n, eps=0.05, dim=3), PCG + AMS (cycle type 1)."""
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    A, G, coords = maxwell_edge_system(n, eps=0.05, dim=3)
    return aux_path(A, {"ams": {"cycle_type": 1}},
                    {"set_discrete_gradient": G, "set_coordinates": coords})


def ads_graddiv(n=48):
    """graddiv_face_system(n, eps=0.1), PCG + ADS."""
    from hypredrive_tpu_torch.ops.csr import graddiv_face_system

    A, C, G, coords = graddiv_face_system(n, eps=0.1)
    return aux_path(A, "ads", {"set_discrete_curl": C,
                               "set_discrete_gradient": G,
                               "set_coordinates": coords})


AMS_CYCLE_CASES = tuple({"cycle_type": ct} for ct in (
    1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 13, 14)) + (
        {"cycle_type": 1, "relax_type": 16},)


def ams_cycles(n=16):
    """maxwell_edge_system(n, dim=3) with every AMS cycle type and with
    Chebyshev relaxation: the count of each."""
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    A, G, coords = maxwell_edge_system(n, dim=3)
    setters = {"set_discrete_gradient": G, "set_coordinates": coords}
    return {"rows": A.shape[0], "cases": [
        {"ams": case, "iters": aux_solve(A, {"ams": case}, setters)[0]}
        for case in AMS_CYCLE_CASES]}


def ams_spread(n=5):
    """maxwell_edge_system(n), every AMS cycle type: how far the JAX
    package's own relative residual history (h / h_0) moves when b is
    perturbed by 1e-15, as a fraction of ‖r0‖; with the counts."""
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    A, G, coords = maxwell_edge_system(n)
    setters = {"set_discrete_gradient": G, "set_coordinates": coords}
    out = []
    for case in AMS_CYCLE_CASES:
        iters, _, h = aux_solve(A, {"ams": case}, setters)
        it_p, _, h_p = aux_solve(A, {"ams": case}, setters, 1)
        k = min(len(h), len(h_p))
        out.append({"ams": case, "iters": (iters, it_p),
                    "spread_over_r0": float(
                        np.abs(h_p[:k] / h_p[0] - h[:k] / h[0]).max())})
    return {"rows": A.shape[0], "cases": out}


# examples/drivers/laplacian.py's DEFAULT_CONFIG
LAPLACIAN_CONFIG = """
general:
  name: laplacian
  use_millisec: on
  statistics: off
linear_system:
  rhs_mode: ones
solver:
  pcg:
    max_iter: 100
    relative_tol: 1.0e-6
    print_level: 0
preconditioner:
  preset: poisson
"""


def laplacian_driver(n=30, solves=5):
    """examples/drivers/laplacian.py's flow at its defaults: the count and
    relative residual of each solve."""
    A = laplacian_3d_7pt(n)
    drv = hd.HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(LAPLACIAN_CONFIG)
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    drv.set_rhs(np.ones(A.shape[0]))
    out = []
    for _ in range(solves):
        drv.reset_initial_guess()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        out.append((res.iters, float(res.rel_res_norm)))
        drv.precon_destroy()
        drv.linear_solver_destroy()
    drv.destroy()
    return {"rows": A.shape[0], "solves": out}


# interfaces/c/example_laplacian.c's config
CAPI_CONFIG = ("linear_system:\n  rhs_mode: ones\nsolver:\n  pcg:\n"
               "    relative_tol: 1.0e-8\n    max_iter: 200\n"
               "preconditioner: amg\n")


def capi_lap(n=32):
    """The C example's config on an n³ Laplacian set from CSR, b = ones."""
    A = laplacian_3d_7pt(n)
    drv = hd.HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(CAPI_CONFIG, NO_STATS)
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    drv.set_rhs(np.ones(A.shape[0]))
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    drv.destroy()
    return {"rows": A.shape[0], "iters": res.iters,
            "rel_res_norm": float(res.rel_res_norm)}


# ---------------------------------------------------------------------------
# the distributed layer on the 8-device CPU mesh
# ---------------------------------------------------------------------------

N_SHARDS = 8
DIST_MGR64 = {
    "level": {0: {"f_dofs": [2], "f_relaxation": {"amg": {"max_iter": 1}}},
              1: {"f_dofs": [1], "f_relaxation": "jacobi"}},
    "coarsest_level": "amg"}


def _mesh():
    from hypredrive_tpu.parallel import make_mesh

    assert len(jax.devices()) >= N_SHARDS, "needs the 8-device CPU mesh"
    return make_mesh(N_SHARDS)


def _mesh_solve(kind, D, apply_fn, state, b, rtol, max_iter):
    """A Krylov core preconditioned by ``apply_fn(state, r)`` on the mesh
    from x0 = 0: (x, iters, history).  The operator and the state are
    arguments of the jitted solve, not constants folded into it."""
    import jax.numpy as jnp
    from hypredrive_tpu.solvers.bicgstab import _bicgstab_core
    from hypredrive_tpu.solvers.gmres import _gmres_core
    from hypredrive_tpu.solvers.pcg import _pcg_core

    def run(D, state, b):
        mv = D.matvec

        def pc(r):
            return apply_fn(state, r)
        x0 = jnp.zeros_like(b)
        if kind == "pcg":
            return _pcg_core(mv, pc, b, x0, rtol, 0.0, max_iter, True, 0)
        if kind == "gmres":
            return _gmres_core(mv, pc, b, x0, jnp.asarray(rtol),
                               jnp.asarray(0.0), max_iter, 30, False)
        return _bicgstab_core(mv, pc, b, x0, jnp.asarray(rtol),
                              jnp.asarray(0.0), max_iter)

    out = jax.jit(run)(D, state, b)
    iters = int(out[1])
    return (np.asarray(out[0]), iters,
            np.asarray(out[4])[:iters + 1])


def _two_field(A_host):
    """__graft_entry__.dryrun_multichip's two-field CPR system."""
    import scipy.sparse as sp

    nc = A_host.shape[0]
    coo = A_host.tocoo()
    rows = list(2 * coo.row); cols = list(2 * coo.col)
    vals = list(coo.data)
    rows += list(2 * np.arange(nc) + 1)
    cols += list(2 * np.arange(nc) + 1); vals += [2.0] * nc
    rows += list(2 * np.arange(nc) + 1)
    cols += list(2 * np.arange(nc)); vals += [0.3] * nc
    rows += list(2 * np.arange(nc))
    cols += list(2 * np.arange(nc) + 1); vals += [0.1] * nc
    A2 = sp.csr_matrix((vals, (rows, cols)), shape=(2 * nc, 2 * nc))
    return A2, np.tile([0, 1], nc)


def _stack(name, A, x, iters, hist, t0):
    n = A.shape[0]
    return {"stack": name, "rows": n, "iters": iters,
            "rel": float(np.linalg.norm(np.ones(n) - A @ x[:n])
                         / np.sqrt(n)),
            "history": hist.tolist(), "seconds": time.perf_counter() - t0}


def dist_dryrun8():
    """The three stacks of __graft_entry__.dryrun_multichip(8): PCG + AMG
    (distributed setup from parts, 8³), GMRES + the mesh MGR (AMG
    F-relaxation) and BiCGSTAB + block-Jacobi ILU(0) on the two-field
    system; b = ones."""
    from hypredrive_tpu.config.sections import AMG_SCHEMA, MGR_SCHEMA
    from hypredrive_tpu.parallel import DistEllMatrix
    from hypredrive_tpu.parallel import dist_precon as dp
    from hypredrive_tpu.parallel import dist_setup as ds
    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu.precon.ilu import _tri_jacobi_apply
    from hypredrive_tpu.precon.mgr import mgr_apply

    mesh = _mesh()
    A = laplacian_3d_7pt(8)
    out = []
    t0 = time.perf_counter()
    D = DistEllMatrix.from_csr(A, mesh)
    st = setup_hierarchy(ds.split_rows(A, N_SHARDS), AMG_SCHEMA.defaults(),
                         mesh=mesh)
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    x, it, h = _mesh_solve("pcg", D, amg_apply, st, b, 1e-8, 50)
    out.append(_stack("pcg_amg", A, x, it, h, t0))
    A2, dofmap = _two_field(A)
    parts2 = ds.split_rows(A2, N_SHARDS)
    args = MGR_SCHEMA.parse(
        {"level": {0: {"f_dofs": [1],
                       "f_relaxation": {"amg": {"max_iter": 1}}}},
         "coarsest_level": "amg"}, "mgr", [])
    t0 = time.perf_counter()
    D2 = DistEllMatrix.from_csr(A2, mesh)
    b2 = pad_vector(np.ones(A2.shape[0]), D2.shape[0], mesh)
    sm = dp.setup_mgr_dist(parts2, args, dofmap, mesh)
    x, it, h = _mesh_solve("gmres", D2, mgr_apply, sm, b2, 1e-6, 100)
    out.append(_stack("gmres_mgr", A2, x, it, h, t0))
    t0 = time.perf_counter()
    si = dp.build_bj_ilu_dist(parts2, mesh)
    x, it, h = _mesh_solve("bicgstab", D2, _tri_jacobi_apply, si, b2,
                           1e-8, 200)
    out.append(_stack("bicgstab_bj_ilu", A2, x, it, h, t0))
    return {"stacks": out}


def dist_lap128(nx=128):
    """nx³ Laplacian, PCG + AMG (defaults) to 1e-8 on the mesh, the
    hierarchy from per-shard parts (the distributed setup), b = ones."""
    from hypredrive_tpu.config.sections import AMG_SCHEMA
    from hypredrive_tpu.parallel import dist_setup as ds
    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.amg.cycle import amg_apply
    from hypredrive_tpu.precon.amg.hierarchy import setup_hierarchy

    mesh = _mesh()
    A = laplacian_3d_7pt(nx)
    t0 = time.perf_counter()
    st = setup_hierarchy(ds.split_rows(A, N_SHARDS), AMG_SCHEMA.defaults(),
                         mesh=mesh)
    setup_s = time.perf_counter() - t0
    D = st.levels[0].A
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    t0 = time.perf_counter()
    x, it, h = _mesh_solve("pcg", D, amg_apply, st, b, 1e-8, 100)
    out = _stack("pcg_amg", A, x, it, h, t0)
    out.update(nnz=int(A.nnz), setup_s=setup_s,
               level_rows=[lv.A.shape[0] for lv in st.levels],
               dia_offsets=list(D.dia_offsets), halo_offsets=list(D.offsets),
               ext_size=int(D.ext_size))
    return out


def dist_mgr64(nx=64):
    """multiphysics_fv_system(nx, 3) (chip_smoke's mgr_64 system): GMRES(30)
    + the mesh MGR (level 0 F = dof 2 with an AMG F-relaxation, level 1
    F = dof 1 with Jacobi, coarsest AMG) to 1e-6, then BiCGSTAB + the
    mesh's block-Jacobi ILU(0) to 1e-2 (it stalls near 3e-3: at 1e-6 it
    runs all 200 iterations); b = ones."""
    from hypredrive_tpu.config.sections import MGR_SCHEMA
    from hypredrive_tpu.parallel import dist_precon as dp
    from hypredrive_tpu.parallel import dist_setup as ds
    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.ilu import _tri_jacobi_apply
    from hypredrive_tpu.precon.mgr import mgr_apply
    from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system

    mesh = _mesh()
    A, dofmap = multiphysics_fv_system(nx, 3, contrast=0.3, coupling=0.12,
                                       convection=0.08)
    parts = ds.split_rows(A, N_SHARDS)
    args = MGR_SCHEMA.parse(DIST_MGR64, "mgr", [])
    t0 = time.perf_counter()
    sm = dp.setup_mgr_dist(parts, args, dofmap, mesh)
    mgr_setup_s = time.perf_counter() - t0
    D = sm.levels[0].A
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    t0 = time.perf_counter()
    x, it, h = _mesh_solve("gmres", D, mgr_apply, sm, b, 1e-6, 100)
    mgr = _stack("gmres_mgr", A, x, it, h, t0)
    mgr.update(setup_s=mgr_setup_s,
               level_rows=[lv.A.shape[0] for lv in sm.levels],
               f_kinds=[lv.f_kind for lv in sm.levels],
               coarsest_level_rows=[lv.A.shape[0]
                                    for lv in sm.coarsest_state.levels])
    t0 = time.perf_counter()
    si = dp.build_bj_ilu_dist(parts, mesh)
    ilu_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, it, h = _mesh_solve("bicgstab", D, _tri_jacobi_apply, si, b, 1e-2,
                           200)
    ilu = _stack("bicgstab_bj_ilu", A, x, it, h, t0)
    ilu.update(setup_s=ilu_setup_s)
    return {"rows": A.shape[0], "nnz": int(A.nnz), "mgr": mgr,
            "bj_ilu": ilu}


def dist_ams(n=32, spread_seeds=(1, 2)):
    """maxwell_edge_system(n, eps=0.05, dim=3), PCG + AMS (cycle type 1) to
    1e-8 with every operator on the mesh (build_ams_state(mesh=)), b =
    A·u(−1, 1) from seed 11; ``history_spread`` as aux_path's."""
    import jax.numpy as jnp
    from hypredrive_tpu.config.sections import AMS_SCHEMA
    from hypredrive_tpu.parallel.dist_matrix import pad_vector
    from hypredrive_tpu.precon.ams import _ams_apply, build_ams_state
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    mesh = _mesh()
    A, G, coords = maxwell_edge_system(n, eps=0.05, dim=3)
    args = AMS_SCHEMA.parse({"cycle_type": 1}, "ams", [])
    t0 = time.perf_counter()
    st = build_ams_state(A, G, coords, args, jnp.float64, mesh=mesh)
    setup_s = time.perf_counter() - t0
    b0 = A @ np.random.default_rng(11).uniform(-1, 1, A.shape[0])

    def solve(b):
        bd = pad_vector(b, st.A.shape[0], mesh)
        x, it, h = _mesh_solve("pcg", st.A, _ams_apply, st, bd, 1e-8, 400)
        return x[:len(b)], it, h

    t0 = time.perf_counter()
    x, iters, hist = solve(b0)
    solve_s = time.perf_counter() - t0
    spread = 0.0
    for seed in spread_seeds:
        b = b0 * (1.0 + 1e-15 * np.random.default_rng(
            seed).standard_normal(len(b0)))
        _, it_p, h_p = solve(b)
        k = min(len(hist), len(h_p))
        spread = max(spread, float(np.abs(h_p[:k] / hist[:k] - 1).max()))
        assert it_p == iters, (it_p, iters)
    return {"rows": A.shape[0], "nnz": int(A.nnz), "iters": iters,
            "rel_res_norm": float(np.linalg.norm(b0 - A @ x)
                                  / np.linalg.norm(b0)),
            "history": hist.tolist(), "history_spread": spread,
            "setup_s": setup_s, "solve_s": solve_s}


TASKS = {
    "scaling_xref": scaling_xref,
    "elasticity_12": lambda: elasticity((12, 6, 6)),
    "elasticity_48": lambda: elasticity((48, 24, 24)),
    "elasticity_48_variant0": lambda: elasticity((48, 24, 24), variant=0),
    "convdif_1024": lambda: convdif_steady(1024),
    "convdif_transient": convdif_transient,
    "lap128_agg_cf": lap_agg_cf,
    "ex9": ex9_dumps,
    "ams_maxwell64": ams_maxwell,
    "ads_graddiv48": ads_graddiv,
    "ams_cycles16": ams_cycles,
    "ams_spread5": ams_spread,
    "laplacian_driver": laplacian_driver,
    "capi_lap32": capi_lap,
    "dist_dryrun8": dist_dryrun8,
    "dist_lap128": dist_lap128,
    "dist_mgr64": dist_mgr64,
    "dist_ams32": dist_ams,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, choices=sorted(TASKS))
    ap.add_argument("--json", default=None,
                    help="also write the tasks' results to this JSON file")
    ap.add_argument("--eigenvalues", default=None,
                    help="write the ex6 eigenvalues to this .npy file")
    ap.add_argument("--eig-spread", action="store_true",
                    help="ex6's eigenvalues with LAPACK on 1 and 8 threads, "
                         "and how far they lie apart")
    args = ap.parse_args()
    register_precon_preset(*ELASTICITY_PRESET)
    results = {}
    for name in (args.only if args.only is not None else sorted(TASKS)):
        t0 = time.perf_counter()
        results[name] = TASKS[name]()
        print(json.dumps({name: results[name]}), flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    if args.json:
        merged = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                merged = json.load(f)
        merged.update(results)
        with open(args.json, "w") as f:
            json.dump(merged, f, indent=1)
            f.write("\n")
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
