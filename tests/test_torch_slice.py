"""The port's main path end to end against the JAX package, on the CPU.

YAML → IJ read or generator → device matrix → host AMG setup → PCG → stats,
through the port's CLI and API with ``exec_policy: host`` (its CPU rule).
The JAX package runs the same configs on its CPU backend.  Both take the
same host setup, so iteration counts match exactly; the residual
histories differ only by float64 summation order (ELL + COO gathers and
XLA fusion against dense/CSR torch ops), bounded at rel 1e-9.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from hypredrive_tpu import api as jax_api
from hypredrive_tpu.config import parse_input as jax_parse_input
from hypredrive_tpu.io import ij as jax_ij
from hypredrive_tpu.ops.csr import laplacian_3d_7pt as jax_laplacian
import hypredrive_tpu_torch
from hypredrive_tpu_torch import api, cli
from hypredrive_tpu_torch.config import parse_input
from hypredrive_tpu_torch.core.errors import ErrorCode, HypredrvError
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX1 = os.path.join(REPO, "examples", "ex1.yml")
HOST = [("general:exec_policy", "host")]


@pytest.fixture(autouse=True)
def _cwd_repo(monkeypatch):
    monkeypatch.chdir(REPO)    # ex1.yml names its data relative to the repo


def test_import_pulls_in_no_jax_and_no_yaml():
    code = textwrap.dedent("""
        import sys
        import hypredrive_tpu_torch, hypredrive_tpu_torch.cli
        import hypredrive_tpu_torch.convert
        hypredrive_tpu_torch.config_from_dict(
            {"linear_system": {}, "solver": "pcg", "preconditioner": "amg"})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hypredrive_tpu",
                                            "yaml"))
        print(",".join(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _solve_history(drive_cls, config, overrides=None):
    drv = drive_cls()
    drv.set_library_mode()
    drv.input_args_parse(config, overrides)
    drv.linear_system_build()
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    drv.destroy()
    return res


def test_ex1_cli_matches_golden():
    collect = []
    assert cli.run_one_config(EX1, overrides=list(HOST),
                              collect=collect) == 0
    (e,) = collect[0].stats.entries
    assert e.iters == 5 and e.converged
    assert e.rel_res_norm <= 1e-6
    assert abs(e.initial_res_norm - np.sqrt(1000.0)) < 1e-9


def test_ex1_history_matches_jax():
    res_t = _solve_history(api.HypreDrive, EX1, list(HOST))
    res_j = _solve_history(jax_api.HypreDrive, EX1, list(HOST))
    assert res_t.iters == res_j.iters == 5
    h_t = res_t.res_history[:6]
    h_j = np.asarray(res_j.res_history)[:6]
    np.testing.assert_allclose(h_t, h_j, rtol=1e-9)
    assert np.isnan(res_t.res_history[6:]).all()
    assert len(res_t.res_history) == len(res_j.res_history) == 101
    assert res_t.rel_res_norm == pytest.approx(res_j.rel_res_norm, rel=1e-9)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generated_laplacian_iterations_match_jax(dtype):
    """The __graft_entry__ problem class: 16³ 7-pt Laplacian, b = ones."""
    opts = {"general": {"exec_policy": "host", "dtype": dtype},
            "linear_system": {"generate": {"kind": "laplacian_7pt",
                                           "nx": 16},
                              "rhs_mode": "ones"},
            "solver": {"pcg": {"relative_tol": 1e-8, "max_iter": 50}},
            "preconditioner": "amg"}
    r_t = hypredrive_tpu_torch.solve(options=opts)
    r_j = jax_api.solve(options=opts)
    assert r_t.iters == r_j.iters and r_t.converged
    assert r_t.x.dtype == np.dtype(dtype) and r_t.x.shape == (4096,)
    np.testing.assert_allclose(r_t.x, np.asarray(r_j.x),
                               rtol=1e-6 if dtype == "float64" else 1e-3)


def test_solve_api_with_matrix():
    A = laplacian_3d_7pt(10)
    b = np.random.default_rng(11).standard_normal(A.shape[0])
    res = hypredrive_tpu_torch.solve(
        A, b, options={"general": {"exec_policy": "host"},
                       "solver": "pcg", "preconditioner": "amg"})
    assert res.iters > 0
    assert res.converged
    assert np.linalg.norm(b - A @ res.x) <= 1e-6 * np.linalg.norm(b)


def test_default_policy_needs_cuda():
    """exec_policy device (the default) never falls back to the CPU."""
    opts = {"linear_system": {"generate": {"kind": "laplacian_7pt",
                                           "nx": 4}},
            "solver": "pcg", "preconditioner": "amg"}
    if torch.cuda.is_available():
        res = hypredrive_tpu_torch.solve(options=opts)
        assert res.converged
        return
    with pytest.raises(HypredrvError, match="needs CUDA"):
        hypredrive_tpu_torch.solve(options=opts)


@pytest.mark.parametrize("section,value", [("preconditioner", "ams"),
                                           ("preconditioner", "ads")])
def test_unported_methods_raise(section, value):
    opts = {"general": {"exec_policy": "host"},
            "linear_system": {"generate": {"kind": "laplacian_7pt",
                                           "nx": 4}},
            "solver": "pcg", "preconditioner": "amg"}
    opts[section] = value
    with pytest.raises(HypredrvError, match="not yet ported") as exc:
        hypredrive_tpu_torch.solve(options=opts)
    assert exc.value.code == ErrorCode.NOT_IMPLEMENTED


def test_copied_host_modules_agree():
    """Config parse, IJ read and generator give what the JAX package's
    give."""
    args_t = parse_input(EX1, list(HOST))
    args_j = jax_parse_input(EX1, list(HOST))
    assert args_t.raw_tree == args_j.raw_tree
    assert dict(args_t.preconditioner.args) == \
        dict(args_j.preconditioner.args)
    A_t, _ = ij.read_matrix_auto("data/ps3d10pt7/np1/IJ.out.A")
    A_j, _ = jax_ij.read_matrix_auto("data/ps3d10pt7/np1/IJ.out.A")
    assert (A_t != A_j).nnz == 0
    np.testing.assert_array_equal(
        ij.read_vector_auto("data/ps3d10pt7/np1/IJ.out.b"),
        jax_ij.read_vector_auto("data/ps3d10pt7/np1/IJ.out.b"))
    assert (laplacian_3d_7pt(9) != jax_laplacian(9)).nnz == 0


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal path needs a machine without CUDA")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
