"""The port's MGR against the JAX package's, on the same matrices.

Setup: the port's MGR setup is a copy of the JAX package's host code, so
the F/C splits, P, R and the coarse operators agree to float64 rounding of
a round trip through the device matrix (bound 1e-14 relative to the
largest entry; they are in fact equal).  Cases: ``data/multiphys2k`` (ex3's
system, 5,184 rows, its dofmap from its file) and
``multiphysics_fv_system(6, 3)`` (648 rows), for every prolongation and
restriction family, both coarse-level types and symbolic ``f_dofs``.

Apply: the port's ``mgr_apply`` on the JAX package's state carried across
(``convert.mgr_state``), and on its own state, matches the JAX
``mgr_apply`` on the same random vector to rel 1e-12 in float64 (only
summation order differs), for V and W cycles and ``cycle_smooth_pos``
1/2/3.  Each component kind is held against the JAX ``apply_component``
the same way.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypredrive_tpu.config.sections import MGR_SCHEMA as JAX_MGR_SCHEMA
from hypredrive_tpu.precon.components import \
    apply_component as jax_apply_component
from hypredrive_tpu.precon.components import \
    build_component as jax_build_component
from hypredrive_tpu.precon.mgr import mgr_apply as jax_mgr_apply
from hypredrive_tpu.precon.mgr import setup_mgr as jax_setup_mgr
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.config.sections import MGR_SCHEMA
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system
from hypredrive_tpu_torch.precon.components import (apply_component,
                                                    build_component)
from hypredrive_tpu_torch.precon.mgr import mgr_apply, setup_mgr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP2K = os.path.join(REPO, "data", "multiphys2k", "np1")
SETUP_TOL = 1e-14
APPLY_TOL = 1e-12


def _multiphys2k():
    A, _ = ij.read_matrix_auto(os.path.join(MP2K, "IJ.out.A"))
    return A, ij.read_dofmap_auto(os.path.join(MP2K, "dofmap.out"))


MATRICES = {"multiphys2k": _multiphys2k,
            "fv6": lambda: multiphysics_fv_system(6, 3)}

EX3 = {"level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
                 1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                     "restriction_type": "columped"}},
       "coarsest_level": "amg"}


def _one_level(**level):
    return {"level": {0: {"f_dofs": [2], **level}}, "coarsest_level": "amg"}


SETUPS = {
    "ex3": EX3,
    "p_injection": _one_level(prolongation_type="injection"),
    "p_l1_jacobi": _one_level(prolongation_type="l1-jacobi"),
    "p_rowsum": _one_level(prolongation_type="blk-rowsum"),
    "p_blk_jacobi_r_blk_jacobi": {
        "level": {0: {"f_dofs": [1, 2], "prolongation_type": "blk-jacobi",
                      "restriction_type": "blk-jacobi"}},
        "coarsest_level": "spdirect"},
    "r_jacobi_nongalerkin": _one_level(prolongation_type="jacobi",
                                       restriction_type="jacobi",
                                       coarse_level_type="non-galerkin"),
    "r_injection": _one_level(restriction_type="injection"),
    "r_air_1": _one_level(restriction_type="air_1"),
    "symbolic_f_dofs": {
        "level": {0: {"f_dofs": ["saturation"],
                      "prolongation_type": "jacobi"},
                  1: {"f_dofs": ["density"],
                      "restriction_type": "columped"}},
        "coarsest_level": "amg"},
}
LABELS = {"pressure": 0, "density": 1, "saturation": 2}


def _setups(matrix, cfg):
    A, dofmap = MATRICES[matrix]()
    errs = []
    args_t = MGR_SCHEMA.parse(cfg, "mgr", errs)
    args_j = JAX_MGR_SCHEMA.parse(cfg, "mgr", errs)
    assert not errs
    st = setup_mgr(A, args_t, dofmap, torch.float64, dof_labels=LABELS)
    sj = jax_setup_mgr(A, args_j, dofmap, jnp.float64, dof_labels=LABELS)
    return A, st, sj


def _assert_same(Bt, Bj):
    """Equal to SETUP_TOL relative to the largest entry (scipy or dense)."""
    assert Bt.shape == Bj.shape
    diff = abs(sp.csr_matrix(Bt) - sp.csr_matrix(Bj))
    scale = abs(sp.csr_matrix(Bj)).max()
    assert (diff.max() if diff.nnz else 0.0) <= SETUP_TOL * scale


def _coarsest_operator(state):
    """The coarsest AMG's finest operator, or the dense direct inverse."""
    s = state.coarsest_state
    if state.coarsest_kind == "amg":
        return s.levels[0].A.to_csr()
    return np.asarray(s)


@pytest.mark.parametrize("setup", sorted(SETUPS))
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_setup_matches_jax(matrix, setup):
    A, st, sj = _setups(matrix, SETUPS[setup])
    assert len(st.levels) == len(sj.levels)
    assert st.coarsest_kind == sj.coarsest_kind
    for lt, lj in zip(st.levels, sj.levels):
        np.testing.assert_array_equal(lt.f_idx.numpy(), np.asarray(lj.f_idx))
        np.testing.assert_array_equal(lt.c_idx.numpy(), np.asarray(lj.c_idx))
        assert (lt.f_kind, lt.g_kind, lt.pre, lt.post) == \
            (lj.f_kind, lj.g_kind, lj.pre, lj.post)
        for name in ("A", "P", "R"):
            _assert_same(getattr(lt, name).to_csr(),
                         getattr(lj, name).to_csr())
    _assert_same(_coarsest_operator(st), _coarsest_operator(sj))


def _apply_both(st, sj, n):
    r = np.random.default_rng(3).standard_normal(n)
    zj = np.asarray(jax.jit(jax_mgr_apply)(sj, jnp.asarray(r)))
    z_own = mgr_apply(st, torch.tensor(r)).numpy()
    z_conv = mgr_apply(convert.mgr_state(sj), torch.tensor(r)).numpy()
    return zj, z_own, z_conv


def _close(z, ref):
    assert np.abs(z - ref).max() <= APPLY_TOL * np.abs(ref).max()


@pytest.mark.parametrize("pos", [1, 2, 3])
@pytest.mark.parametrize("cycle", ["v", "w"])
def test_apply_matches_jax(cycle, pos):
    cfg = dict(EX3, cycle=cycle, cycle_smooth_pos=pos)
    A, st, sj = _setups("multiphys2k", cfg)
    assert st.cycle_type == sj.cycle_type == (1 if cycle == "v" else 2)
    zj, z_own, z_conv = _apply_both(st, sj, A.shape[0])
    _close(z_conv, zj)
    _close(z_own, zj)


@pytest.mark.parametrize("setup", ["p_blk_jacobi_r_blk_jacobi", "r_air_1",
                                   "r_jacobi_nongalerkin"])
def test_apply_matches_jax_transfers(setup):
    A, st, sj = _setups("fv6", SETUPS[setup])
    zj, z_own, z_conv = _apply_both(st, sj, A.shape[0])
    _close(z_conv, zj)
    _close(z_own, zj)


COMPONENTS = {
    "none": "none",
    "jacobi": "jacobi",
    "l1-jacobi": "l1-hsgs",
    "chebyshev": {"chebyshev": {"order": 3}},
    "amg": {"amg": {"coarsening": {"strong_th": 0.5}}},
    "dense": "spdirect",
    # GMRES: on this operator (κ ≈ 7e7) FGMRES and BiCGSTAB amplify
    # rounding past 1e-12 within a few steps; test_torch_krylov.py holds
    # every nested method against the JAX package on a benign operator
    "krylov": {"krylov": {"type": "gmres", "max_iter": 4, "krylov_dim": 4,
                          "preconditioner": "l1-jacobi"}},
    "mgr": {"mgr": {"level": {0: {"f_dofs": [2]}},
                    "coarsest_level": "spdirect"}},
    "ilu": {"ilu": {"type": "bj-ilu0"}},
    "fsai": "fsai",
    "schwarz": {"schwarz": {"overlap": 2}},
}


@pytest.mark.parametrize("name", sorted(COMPONENTS))
def test_component_matches_jax(name):
    A, dofmap = multiphysics_fv_system(4, 3)
    cfg = COMPONENTS[name]
    kj, sj = jax_build_component(cfg, A, jnp.float64, dofmap=dofmap)
    kt, st = build_component(cfg, A, torch.float64, dofmap=dofmap)
    assert kt == kj
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    zj = np.asarray(jax.jit(lambda s, v: jax_apply_component(kj, s, v))(
        sj, jnp.asarray(r)))
    _close(apply_component(kt, st, torch.tensor(r)).numpy(), zj)
    _close(apply_component(kj, convert.component_state(kj, sj),
                           torch.tensor(r)).numpy(), zj)

