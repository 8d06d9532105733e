"""ILU, Schwarz and FSAI against the JAX package, on the CPU.

* The compiled ILU(0) (``csrc/ilu0.cpp``) gives the JAX package's
  ``ilu0_factor`` factors bit for bit, and so does the port's Python loop.
* Each ILU state family (tri-Jacobi, GMRES-Schur, NSH, RAS), the Schwarz
  and the FSAI applies: the JAX package's state carried across with
  ``convert`` gives the JAX apply to rel 1e-12 (float64 summation order
  only), and the state the port builds itself gives it too.
* GMRES with the standalone preconditioners through both packages' API
  takes the same number of iterations.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypredrive_tpu import api as jax_api
from hypredrive_tpu.config import sections as jax_sections
from hypredrive_tpu.precon import fsai as jax_fsai
from hypredrive_tpu.precon import ilu as jax_ilu
from hypredrive_tpu.precon import schwarz as jax_schwarz
from hypredrive_tpu_torch import api, convert
from hypredrive_tpu_torch.config import sections
from hypredrive_tpu_torch.core.errors import ErrorCode, HypredrvError
from hypredrive_tpu_torch.io import ij, native
from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system
from hypredrive_tpu_torch.precon import fsai, ilu, schwarz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP2K = os.path.join(REPO, "data", "multiphys2k", "np1")
RTOL = 1e-12


def _multiphys2k():
    A, _ = ij.read_matrix_auto(os.path.join(MP2K, "IJ.out.A"))
    return A, ij.read_dofmap_auto(os.path.join(MP2K, "dofmap.out"))


def _random_dd(n=400, seed=5):
    """Nonsymmetric, diagonally dominant, random pattern."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    A.data = rng.standard_normal(A.nnz)
    d = np.asarray(abs(A).sum(axis=1)).ravel() + 1.0
    A = sp.csr_matrix(A + sp.diags(d))
    A.sort_indices()
    return A


def _blocks():
    A, dofmap = _multiphys2k()
    f = np.flatnonzero(dofmap == 2)
    c = np.flatnonzero(dofmap != 2)
    return {"multiphys2k_Aff": sp.csr_matrix(A[f][:, f]),
            "multiphys2k_Acc": sp.csr_matrix(A[c][:, c]),
            "random_dd": _random_dd()}


@pytest.mark.parametrize("name", ["multiphys2k_Aff", "multiphys2k_Acc",
                                  "random_dd"])
def test_ilu0_factors_bit_identical_to_jax(name):
    A = _blocks()[name]
    assert native.backend() == "native"
    Lj, Uj = jax_ilu.ilu0_factor(A)
    for plain in (False, True):
        Lt, Ut = ilu.ilu0_factor(A, plain=plain)
        for X, Y in ((Lt, Lj), (Ut, Uj)):
            np.testing.assert_array_equal(X.indptr, Y.indptr)
            np.testing.assert_array_equal(X.indices, Y.indices)
            np.testing.assert_array_equal(X.data, Y.data)   # bit for bit


@pytest.mark.parametrize("plain", [False, True], ids=["native", "python"])
def test_ilu0_missing_diagonal_raises_matrix_error(plain):
    A = sp.csr_matrix(np.array([[2.0, 1.0], [1.0, 0.0]]))
    A.eliminate_zeros()
    with pytest.raises(HypredrvError) as exc:
        ilu.ilu0_factor(A, plain=plain)
    assert exc.value.code == ErrorCode.MATRIX


ILU_CASES = {
    "bj-ilu0": {"type": "bj-ilu0"},
    "bj-ilu0-rcm-sweeps": {"type": "bj-ilu0", "reordering": 1,
                           "tri_solve": False, "lower_jac_iters": 3,
                           "upper_jac_iters": 4},
    "bj-ilut": {"type": "bj-ilut", "droptol": 1e-3},
    "bj-iluk-fill1": {"type": "bj-iluk", "fill_level": 1},
    "gmres-iluk": {"type": "gmres-iluk"},
    "nsh-iluk": {"type": "nsh-iluk"},
    "ras-iluk": {"type": "ras-iluk"},
}


@pytest.fixture(scope="module")
def small_system():
    A, _ = multiphysics_fv_system(8, 3, contrast=0.3, coupling=0.12,
                                  convection=0.08)
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    return A, r


def _close(z, ref):
    z = z.numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
    ref = np.asarray(ref)
    assert np.abs(z - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("case", sorted(ILU_CASES))
def test_ilu_apply_matches_jax(case, small_system):
    A, r = small_system
    opts = ILU_CASES[case]
    st_j = jax_ilu.build_ilu_state(
        A, jax_sections.ILU_SCHEMA.parse(opts, "ilu", []), jnp.float64)
    ref = jax_ilu._ilu_apply(st_j, jnp.asarray(r))
    rt = torch.tensor(r)
    _close(ilu.ilu_apply(convert.ilu_state(st_j), rt), ref)
    st_t = ilu.build_ilu_state(
        A, sections.ILU_SCHEMA.parse(opts, "ilu", []), torch.float64)
    expected = {"gmres-iluk": ilu.SchurILUState, "nsh-iluk": ilu.NSHState,
                "ras-iluk": schwarz.SchwarzState}.get(case,
                                                      ilu.TriJacobiState)
    assert isinstance(st_t, expected)
    _close(ilu.ilu_apply(st_t, rt), ref)


@pytest.mark.parametrize("variant,overlap", [("ras-spdirect", 1),
                                             ("as-iluk", 2),
                                             ("ras-ilut", 1)])
def test_schwarz_apply_matches_jax(variant, overlap, small_system):
    A, r = small_system
    opts = {"variant": variant, "overlap": overlap}
    pj = jax_schwarz.SchwarzPrecon(
        jax_sections.SCHWARZ_SCHEMA.parse(opts, "schwarz", []))
    pj.setup(SimpleNamespace(A_host=A, M_host=None, dtype=jnp.float64))
    ref = jax_schwarz._schwarz_apply(pj.state, jnp.asarray(r))
    rt = torch.tensor(r)
    _close(schwarz.schwarz_apply(convert.schwarz_state(pj.state), rt), ref)
    pt = schwarz.SchwarzPrecon(
        sections.SCHWARZ_SCHEMA.parse(opts, "schwarz", []))
    pt.setup(SimpleNamespace(A_host=A, dtype=torch.float64,
                             device=torch.device("cpu")))
    _close(pt.apply(rt), ref)


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["afsai", "sfsai"])
def test_fsai_apply_matches_jax(adaptive, small_system):
    A, r = small_system
    A = sp.csr_matrix(A + A.T)      # FSAI's setting: a symmetric operator
    A.sort_indices()
    if adaptive:
        st_j = jax_fsai.build_fsai_adaptive(A, max_steps=4, max_step_size=2,
                                            kap_tolerance=1e-3)
        st_t = fsai.build_fsai_adaptive(A, max_steps=4, max_step_size=2,
                                        kap_tolerance=1e-3)
    else:
        st_j = jax_fsai.build_fsai(A, max_nnz_row=6, threshold=1e-3)
        st_t = fsai.build_fsai(A, max_nnz_row=6, threshold=1e-3)
    ref = jax_fsai._fsai_apply(st_j, jnp.asarray(r))
    rt = torch.tensor(r)
    _close(fsai.fsai_apply(convert.fsai_state(st_j), rt), ref)
    _close(fsai.fsai_apply(st_t, rt), ref)
    Gj, Gt = st_j[0].to_csr(), st_t.G.to_csr()
    assert (Gj != 0).nnz == (Gt != 0).nnz
    assert abs(Gj - Gt).max() <= RTOL * abs(Gj).max()


# GMRES(30) to 1e-6 on multiphys2k: the JAX package's counts
STANDALONE = [({"ilu": {"type": "bj-ilu0"}}, 60),
              ({"ilu": {"type": "nsh-iluk"}}, 60),
              ({"ilu": {"type": "ras-iluk"}}, 104),
              ({"schwarz": {"variant": "as-spdirect"}}, 231),
              ("fsai", 38)]


@pytest.mark.parametrize("precon,iters", STANDALONE,
                         ids=["bj-ilu0", "nsh-iluk", "ras-iluk",
                              "schwarz-as-spdirect", "fsai"])
def test_standalone_precon_gmres_matches_jax(precon, iters):
    out = []
    for cls in (api.HypreDrive, jax_api.HypreDrive):
        drv = cls()
        drv.set_library_mode()
        drv.input_args_from_dict({
            "general": {"exec_policy": "host", "statistics": False},
            "linear_system": {
                "matrix_filename": os.path.join(MP2K, "IJ.out.A"),
                "rhs_filename": os.path.join(MP2K, "IJ.out.b")},
            "solver": {"gmres": {"max_iter": 300, "krylov_dim": 30,
                                 "relative_tol": 1e-6}},
            "preconditioner": precon})
        drv.linear_system_build()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        out.append(drv.linear_solver_apply())
    res_t, res_j = out
    assert res_t.iters == res_j.iters == iters
    assert res_t.converged and res_t.rel_res_norm <= 1e-6
    assert res_t.rel_res_norm == pytest.approx(res_j.rel_res_norm, rel=1e-6)
