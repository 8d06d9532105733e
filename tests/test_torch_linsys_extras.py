"""The port's linear-system extras against the JAX package's, on the CPU:
pre-solve scaling (all six types), the reference solution (xref file,
``rhs_mode: randsol``) with its error norms and GMRES's per-block error
histories, null-space projection, MatrixMarket and precmat input,
per-block residual norms, the eigenspectrum (ex6's flow) and the
scheduled dumps (ex9).

Both packages run the same host setups, so the counts are equal; vectors
differ only by float64 summation order.
"""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from hypredrive_tpu import api as jax_api
from hypredrive_tpu import cli as jax_cli
from hypredrive_tpu.linsys.scaling import ScalingContext as JaxScaling
from hypredrive_tpu_torch import api, cli, convert
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.linsys.scaling import ScalingContext

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP2K = os.path.join(REPO, "data", "multiphys2k", "np1")
PS3D = os.path.join(REPO, "data", "ps3d10pt7", "np1")
MGR = {"mgr": {"level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
                         1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                             "restriction_type": "columped"}},
               "coarsest_level": "amg"}}
CUSTOM = [1.0, 3.0, 10.0]
SCALINGS = {
    "rhs_l2": {"type": "rhs_l2"},
    "dofmap_mag": {"type": "dofmap_mag"},
    "dofmap_custom": {"type": "dofmap_custom", "custom_values": CUSTOM},
    "dofmap_row_custom": {"type": "dofmap_row_custom",
                          "custom_values": CUSTOM},
    "dofmap_col_custom": {"type": "dofmap_col_custom",
                          "custom_values": CUSTOM},
    "dofmap_similarity_custom": {"type": "dofmap_similarity_custom",
                                 "custom_values": CUSTOM},
}


def _general(port):
    return {"exec_policy": "host", "statistics": False} if port \
        else {"statistics": False}


def _ex3(port, scaling=None, rhs_mode=None):
    """ex3's system and GMRES + MGR as a config dict."""
    ls = {"matrix_filename": os.path.join(MP2K, "IJ.out.A"),
          "dofmap_filename": os.path.join(MP2K, "dofmap.out")}
    if rhs_mode:
        ls["rhs_mode"] = rhs_mode
    else:
        ls["rhs_filename"] = os.path.join(MP2K, "IJ.out.b")
    solver = {"gmres": {}}
    if scaling:
        solver["scaling"] = dict(scaling, enabled=True)
    return {"general": _general(port), "linear_system": ls,
            "solver": solver, "preconditioner": MGR}


def _ex1(port, **ls):
    return {"general": _general(port),
            "linear_system": dict({
                "matrix_filename": os.path.join(PS3D, "IJ.out.A"),
                "rhs_filename": os.path.join(PS3D, "IJ.out.b")}, **ls),
            "solver": "pcg", "preconditioner": "amg"}


def _run(module, config, before_setup=None):
    drv = module.HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict(config)
    drv.linear_system_build()
    if before_setup is not None:
        before_setup(drv)
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    return drv, res


def _x(drv):
    return np.asarray(drv.get_solution())


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_scaling_matches_jax(name):
    """ex3 with each scaling type: the same Sl/Sr, the same count, the
    unscaled solution back (rel 1e-10), the original A restored."""
    d_t, r_t = _run(api, _ex3(True, SCALINGS[name]))
    d_j, r_j = _run(jax_api, _ex3(False, SCALINGS[name]))
    assert r_t.iters == r_j.iters and r_t.converged
    # a residual near 1e-7·‖b‖ is a difference of much larger terms once
    # the columns are scaled by up to 10: its rounding reaches 1e-5
    assert r_t.rel_res_norm == pytest.approx(r_j.rel_res_norm, rel=1e-4)
    x_t, x_j = _x(d_t), _x(d_j)
    assert np.abs(x_t - x_j).max() <= 1e-10 * np.abs(x_j).max()
    assert d_t.system.scaling is None
    A, _ = ij.read_matrix_auto(os.path.join(MP2K, "IJ.out.A"))
    assert (d_t.system.A_host != A).nnz == 0      # the original is back
    np.testing.assert_array_equal(
        d_t.system.b.numpy(), ij.read_vector_auto(os.path.join(MP2K,
                                                               "IJ.out.b")))
    # the scaling vectors themselves, and the carried-across context
    ctx_t = ScalingContext.compute(d_t.system, d_t.args.solver.scaling)
    ctx_j = JaxScaling.compute(d_j.system, d_j.args.solver.scaling)
    for got, want in ((ctx_t, ctx_j), (convert.scaling_state(ctx_j), ctx_j)):
        for a, b_ in ((got.sl, want.sl), (got.sr, want.sr)):
            assert (a is None) == (b_ is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                           rtol=1e-14)


def test_randsol_error_norms_and_tagged_histories():
    """rhs_mode randsol on ex3: xref drawn as the JAX package draws it,
    b = A·xref, the final error norm and GMRES's per-dof-block error
    history within rel 1e-6; block residual norms within rel 1e-6."""
    d_t, r_t = _run(api, _ex3(True, rhs_mode="randsol"))
    d_j, r_j = _run(jax_api, _ex3(False, rhs_mode="randsol"))
    np.testing.assert_array_equal(d_t.system.xref.numpy(),
                                  np.asarray(d_j.system.xref))
    assert r_t.iters == r_j.iters
    assert r_t.error_norm == pytest.approx(r_j.error_norm, rel=1e-6)
    k = r_t.iters + 1
    e_t, e_j = r_t.error_histories[:k], np.asarray(r_j.error_histories)[:k]
    assert e_t.shape == e_j.shape == (k, 3)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-6)
    assert np.isnan(r_t.error_histories[k:]).all()
    bt, bj = d_t.system.block_residual_norms(), \
        d_j.system.block_residual_norms()
    assert sorted(bt) == sorted(bj) == [0, 1, 2]
    for label in bt:
        assert bt[label] == pytest.approx(bj[label], rel=1e-6)


def test_xref_file_one_tag_and_nullspace(tmp_path):
    """An xref file on ex1 (PCG + AMG: no tagged histories), GMRES without
    a dofmap (one tag), and a null space projected out of the solution."""
    xref = np.random.default_rng(2).uniform(-1, 1, 1000)
    path = str(tmp_path / "xref")
    ij.write_vector_ascii(path, xref)
    d_t, r_t = _run(api, _ex1(True, xref_filename=path))
    d_j, r_j = _run(jax_api, _ex1(False, xref_filename=path))
    assert r_t.iters == r_j.iters == 5
    assert r_t.error_norm == pytest.approx(r_j.error_norm, rel=1e-8)
    assert r_t.error_histories is None
    cfg_t, cfg_j = _ex1(True, xref_filename=path), _ex1(False,
                                                          xref_filename=path)
    cfg_t["solver"] = cfg_j["solver"] = "gmres"
    _, g_t = _run(api, cfg_t)
    _, g_j = _run(jax_api, cfg_j)
    assert g_t.error_histories.shape[1] == 1
    np.testing.assert_allclose(g_t.error_histories[:g_t.iters + 1],
                               np.asarray(g_j.error_histories)
                               [:g_j.iters + 1], rtol=1e-6)
    modes = np.stack([np.ones(1000), np.arange(1000.0)], axis=1)

    def with_nullspace(drv):
        drv.set_nullspace(modes)

    n_t, _ = _run(api, _ex1(True), with_nullspace)
    n_j, _ = _run(jax_api, _ex1(False), with_nullspace)
    np.testing.assert_allclose(n_t.system.nullspace, n_j.system.nullspace,
                               rtol=0, atol=1e-15)
    x_t, x_j = _x(n_t), _x(n_j)
    assert np.abs(modes.T @ x_t).max() <= 1e-8 * np.abs(x_t).max()
    assert np.abs(x_t - x_j).max() <= 1e-10 * np.abs(x_j).max()


def test_matrix_market_and_precmat(tmp_path):
    """ex1's matrix as a .mtx file; then A with a separate preconditioning
    matrix (precmat_filename), against the JAX package."""
    A, _ = ij.read_matrix_auto(os.path.join(PS3D, "IJ.out.A"))
    mtx = str(tmp_path / "A.mtx")
    scipy.io.mmwrite(mtx, A)
    d_m, r_m = _run(api, _ex1(True, matrix_filename=mtx))
    d_i, r_i = _run(api, _ex1(True))
    assert (d_m.system.A_host != A).nnz == 0
    assert r_m.iters == r_i.iters == 5
    np.testing.assert_array_equal(_x(d_m), _x(d_i))
    M = sp.csr_matrix(A + sp.diags(0.5 * A.diagonal()))
    pm = str(tmp_path / "M")
    ij.write_matrix_ascii(pm, M)
    d_t, r_t = _run(api, _ex1(True, precmat_filename=pm))
    d_j, r_j = _run(jax_api, _ex1(False, precmat_filename=pm))
    assert (d_t.system.M_host != M).nnz == 0
    assert r_t.iters == r_j.iters != r_i.iters
    assert r_t.rel_res_norm == pytest.approx(r_j.rel_res_norm, rel=1e-6)


def _eig_config(port, prefix, hermitian, preconditioned):
    cfg = _ex1(port)
    cfg["linear_system"]["eigspec"] = {
        "enable": True, "vectors": hermitian, "hermitian": hermitian,
        "preconditioned": preconditioned, "output_prefix": prefix}
    return cfg


def _eigenvalues(prefix):
    a = np.loadtxt(f"{prefix}_eigenvalues.txt", skiprows=1, ndmin=2)
    return a[:, 0] + 1j * a[:, 1] if a.shape[1] == 2 else a[:, 0]


@pytest.mark.parametrize("hermitian,preconditioned",
                         [(False, True), (True, False)])
def test_eigenspectrum_matches_jax(hermitian, preconditioned, tmp_path):
    """ex6's flow (a set-up preconditioner, M⁻¹A column by column, dense
    eig on the host) on ex1's 1,000-row system with AMG: the eigenvalues
    within rel 1e-8 after sorting; the symmetric path with vectors."""
    out = {}
    for name, module in (("t", api), ("j", jax_api)):
        prefix = str(tmp_path / f"eig_{name}")
        drv = module.HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict(_eig_config(name == "t", prefix, hermitian,
                                              preconditioned))
        drv.linear_system_build()
        drv.precon_create()
        drv.precon_setup()
        drv.compute_eigenspectrum()
        out[name] = np.sort_complex(_eigenvalues(prefix))
        if hermitian:
            v = np.fromfile(f"{prefix}_eigenvectors.bin")
            assert v.shape == (1000 * 1000,)
    scale = np.abs(out["j"]).max()
    assert np.abs(out["t"] - out["j"]).max() <= 1e-8 * scale


def test_ex6_and_ex9_through_the_cli(tmp_path):
    """ex9's dump tree and contents equal the JAX package's (solution rel
    1e-10); ex6's CLI branch writes the eigenvalue file (the full ex6 runs
    in chip_smoke.py)."""
    dirs = {}
    for name, main in (("t", cli.main), ("j", jax_cli.main)):
        d = str(tmp_path / f"dump_{name}")
        argv = ["-a", "linear_system:print_system:dirname", d,
                "-a", "general:print_config_params", "off"]
        if name == "t":
            argv += ["-a", "general:exec_policy", "host"]
        assert main(argv + [os.path.join(REPO, "examples",
                                         "ex9-print-system.yml")]) == 0
        dirs[name] = d

    def tree(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert tree(dirs["t"]) == tree(dirs["j"])
    assert len(tree(dirs["t"])) == 10
    for rel in tree(dirs["t"]):
        base = os.path.basename(rel)
        t, j = (os.path.join(dirs[k], rel) for k in "tj")
        if base == "IJ.out.A":
            At, _ = ij.read_matrix_auto(t)
            Aj, _ = ij.read_matrix_auto(j)
            assert (At != Aj).nnz == 0
        elif base == "IJ.out.x":
            vt, vj = ij.read_vector_auto(t), ij.read_vector_auto(j)
            assert np.abs(vt - vj).max() <= 1e-10 * max(1.0,
                                                        np.abs(vj).max())
        elif base.startswith("IJ.out."):
            np.testing.assert_array_equal(ij.read_vector_auto(t),
                                          ij.read_vector_auto(j))
    prefix = str(tmp_path / "ex6")
    yml = tmp_path / "ex6-small.yml"
    yml.write_text(
        "general: {exec_policy: host, print_config_params: off}\n"
        "linear_system:\n"
        f"  matrix_filename: {os.path.join(PS3D, 'IJ.out.A')}\n"
        f"  rhs_filename: {os.path.join(PS3D, 'IJ.out.b')}\n"
        "  eigspec: {enable: yes, preconditioned: yes, "
        f"output_prefix: {prefix}}}\n"
        "solver: pcg\npreconditioner: amg\n")
    assert cli.main([str(yml)]) == 0
    assert len(_eigenvalues(prefix)) == 1000
