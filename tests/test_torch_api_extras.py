"""The port's library-mode verbs and CLI extras against the JAX package's,
on the CPU: the drivers' flows (examples/drivers/elasticity.py with rigid
body modes, convdif.py's AIR timestep loop), preconditioner setup/apply
outside a solve, state vectors, dofmap and matrix setters, dumps, info
reports, ``-i`` and ``--profile``.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hypredrive_tpu as jax_hd
import hypredrive_tpu_torch as hd
from hypredrive_tpu.config.presets import \
    register_precon_preset as jax_register
from hypredrive_tpu_torch import cli
from hypredrive_tpu_torch.config.presets import register_precon_preset
from hypredrive_tpu_torch.core.errors import ErrorCode, HypredrvError
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.ops.csr import (convection_diffusion_2d,
                                          elasticity_3d, rigid_body_modes)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS3D = os.path.join(REPO, "data", "ps3d10pt7", "np1")
HOST = [("general:exec_policy", "host")]

# examples/drivers/elasticity.py's preset and DEFAULT_CONFIG
PRESET = ("elasticity_sdc_3d",
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
  preset: elasticity_sdc_3d
"""
CONVDIF_AIR = os.path.join(REPO, "examples", "drivers",
                           "convdif-gmres-air.yml")


def _elasticity_flow(module, overrides, dims, solves=2):
    """elasticity.py's flow: set_matrix_from_csr, the interleaved dofmap,
    the six rigid-body modes, repeated solves with the lifecycle verbs."""
    A, coords = elasticity_3d(*dims)
    rbm = rigid_body_modes(coords, ndim=3)
    n = A.shape[0]
    drv = module.HypreDrive()
    out = []
    try:
        drv.set_library_mode()
        drv.input_args_parse(ELASTICITY_CONFIG, overrides)
        drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
        drv.system.set_dofmap(np.arange(n) % 3)
        drv.set_near_nullspace([rbm[:, k] for k in range(rbm.shape[1])])
        drv.set_rhs(np.ones(n))
        for i in range(solves):
            drv.annotate_begin("Run", i)
            drv.reset_initial_guess()
            drv.precon_create()
            drv.linear_solver_create()
            drv.linear_solver_setup()
            res = drv.linear_solver_apply()
            drv.precon_destroy()
            drv.linear_solver_destroy()
            drv.annotate_end("Run", i)
            out.append((res.iters, res.rel_res_norm))
    finally:
        drv.destroy()
    return out


def test_elasticity_driver_flow_matches_jax():
    """12×6×6 cells (the driver's default): the JAX package's count, in the
    reference's golden class (≤ 21)."""
    register_precon_preset(*PRESET)
    jax_register(*PRESET)
    ours = _elasticity_flow(hd, HOST, (12, 6, 6))
    theirs = _elasticity_flow(jax_hd, None, (12, 6, 6))
    assert [i for i, _ in ours] == [i for i, _ in theirs]
    assert all(i <= 21 for i, _ in ours)
    for (_, r_t), (_, r_j) in zip(ours, theirs):
        assert r_t == pytest.approx(r_j, rel=1e-6) and r_t <= 1e-6


def _convdif_flow(module, overrides, n=40, steps=10):
    """convdif.py's timestep loop: new values, same pattern every step,
    warm start from the previous state, level annotations."""
    x = (np.arange(n) + 1.0) / (n + 1)
    X, Y = np.meshgrid(x, x, indexing="xy")
    c = np.exp(-80.0 * ((X - 0.2) ** 2 + (Y - 0.2) ** 2)).ravel()
    drv = module.HypreDrive()
    out = []
    try:
        drv.set_library_mode()
        drv.input_args_parse(CONVDIF_AIR, overrides)
        dt = 0.01
        for step in range(1, steps + 1):
            drv.annotate_level_begin("timestep", step)
            A = convection_diffusion_2d(n, eps=1e-3, velocity=(1.0, 0.5),
                                        dt=dt)
            drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
            drv.set_rhs(c / dt)
            drv.set_initial_guess(c)
            drv.precon_create()
            drv.linear_solver_create()
            drv.linear_solver_setup()
            res = drv.linear_solver_apply()
            c = np.asarray(drv.get_solution())
            drv.precon_destroy()
            drv.linear_solver_destroy()
            dt *= 1.5
            drv.annotate_level_end("timestep", step)
            out.append(res.iters)
        levels = drv.stats_level_get_count("timestep")
    finally:
        drv.destroy()
    return out, levels, c


def test_convdif_air_driver_flow_matches_jax():
    """convdif.py's loop at its defaults (n = 40, 10 steps) with
    convdif-gmres-air.yml (GMRES + AIR): the same count each step and the
    same state."""
    off = [("general:statistics", "off")]
    ours, lv_t, c_t = _convdif_flow(hd, HOST + off)
    theirs, lv_j, c_j = _convdif_flow(jax_hd, off)
    assert ours == theirs == [4, 4, 5, 6, 7, 7, 8, 9, 9, 10]
    assert lv_t == lv_j == 10
    assert np.abs(c_t - c_j).max() <= 1e-8 * np.abs(c_j).max()


def _ex3_driver(module, overrides):
    drv = module.HypreDrive()
    drv.set_library_mode()
    drv.input_args_parse(os.path.join(REPO, "examples", "ex3.yml"),
                         overrides)
    drv.linear_system_build()
    drv.precon_create()
    return drv


def test_precon_setup_and_apply_match_jax():
    """precon_setup / precon_apply outside a solve (ex3's MGR)."""
    d_t = _ex3_driver(hd, HOST)
    d_j = _ex3_driver(jax_hd, None)
    r = np.random.default_rng(4).standard_normal(d_t.get_solution_length())
    z_t, z_j = d_t.precon_apply(r), d_j.precon_apply(r)
    assert d_t.precon.is_setup
    assert np.abs(z_t - z_j).max() <= 1e-12 * np.abs(z_j).max()
    d_t.destroy()
    d_j.destroy()


def test_library_verbs_match_jax(tmp_path, capsys):
    """Setters, getters, state vectors, dumps and info reports of both
    drivers on ex1's system."""
    out = {}
    A, _ = ij.read_matrix_auto(os.path.join(PS3D, "IJ.out.A"))
    for name, module, ov in (("t", hd, {"exec_policy": "host"}),
                             ("j", jax_hd, {})):
        drv = module.HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict({"general": dict(ov, statistics=True),
                                  "linear_system": {}, "solver": "pcg",
                                  "preconditioner": "amg"})
        drv.object_set_name(f"drv_{name}")
        drv.read_matrix(os.path.join(PS3D, "IJ.out.A"))
        drv.set_rhs(ij.read_vector_auto(os.path.join(PS3D, "IJ.out.b")))
        drv.set_contiguous_dofmap(4)
        d1 = np.asarray(drv.system.dofmap).copy()
        drv.print_dofmap(str(tmp_path / f"dof_{name}"))
        drv.set_interleaved_dofmap(2)
        drv.read_dofmap(str(tmp_path / f"dof_{name}"))
        np.testing.assert_array_equal(drv.system.dofmap, d1)
        drv.set_solution(np.ones(A.shape[0]))
        drv.set_reference_solution(np.zeros(A.shape[0]))
        drv.set_prec_matrix(A)
        drv.state_vector_set([np.zeros(A.shape[0]), np.ones(A.shape[0])])
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        drv.state_vector_apply_correction(0)
        drv.state_vector_update_all()
        drv.state_vector_copy(0, 1)
        drv.linear_system_print(str(tmp_path / f"sys_{name}"))
        converged = drv.get_converged()
        drv.apply_preset_text("pcg:\n  max_iter: 7", kind="solver")
        out[name] = {
            "dofmap": d1,
            "iters": res.iters, "converged": converged,
            "norm": drv.get_solution_norm(),
            "rhs": np.asarray(drv.get_rhs_values()),
            "error_norm": res.error_norm,
            "states": [drv.state_vector_get_values(k).copy()
                       for k in range(2)],
            "max_iter": int(drv.args.solver.args.max_iter),
            "stats_name": drv.stats.name}
        drv.print_lib_info()
        drv.print_exit_info()
        drv.destroy()
    t, j = out["t"], out["j"]
    np.testing.assert_array_equal(t["dofmap"], j["dofmap"])
    assert t["iters"] == j["iters"] and t["converged"] and j["converged"]
    assert t["norm"] == pytest.approx(j["norm"], rel=1e-10)
    assert t["error_norm"] == pytest.approx(j["error_norm"], rel=1e-10)
    np.testing.assert_array_equal(t["rhs"], j["rhs"])
    for s_t, s_j in zip(t["states"], j["states"]):
        np.testing.assert_allclose(s_t, s_j, rtol=1e-10)
    assert t["max_iter"] == j["max_iter"] == 7
    assert (t["stats_name"], j["stats_name"]) == ("drv_t", "drv_j")
    for suffix in ("A", "b"):
        a = open(tmp_path / f"sys_t.{suffix}").read()
        assert a == open(tmp_path / f"sys_j.{suffix}").read()
    assert open(tmp_path / "dof_t").read() == open(tmp_path / "dof_j").read()
    printed = capsys.readouterr().out
    assert "hypredrive-tpu-torch" in printed and "drv_t done!" in printed


@pytest.mark.parametrize("verb", ["set_coordinates", "set_discrete_gradient",
                                  "set_discrete_curl"])
def test_ams_ads_inputs_raise_typed(verb):
    drv = hd.HypreDrive()
    with pytest.raises(HypredrvError, match="not yet ported") as exc:
        getattr(drv, verb)(sp.identity(3))
    assert exc.value.code == ErrorCode.NOT_IMPLEMENTED


def test_cli_info_and_profile(tmp_path, capsys):
    """``-i`` names torch and the CUDA devices, never jax; ``--profile``
    writes a torch.profiler trace of the run."""
    assert cli.main(["-i"]) == 0
    info = capsys.readouterr().out
    assert "torch" in info and "CUDA devices" in info and "nvcc" in info
    assert "jax" not in info.lower()
    prof = str(tmp_path / "prof")
    assert cli.main(["--profile", prof, "-a", "general:exec_policy", "host",
                     "-a", "general:print_config_params", "off",
                     os.path.join(REPO, "examples", "ex1.yml")]) == 0
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(prof))
    assert cli.main(["--profile"]) == 2
