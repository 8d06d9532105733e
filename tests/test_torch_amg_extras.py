"""The rest of the port's AMG against the JAX package's: aggressive
coarsening, AIR restriction and the AIR F/C relaxation schedule, C/F
relaxation, rigid-body-mode (RBM) interpolation vectors, and the repaired
elasticity generator.

Setup: the host arithmetic is the JAX package's, so the C/F splits, P, R
(the non-Galerkin AIR R included), the level operators and the smoother
operands (the F-point masks included) are bit-identical.  Cycle: one apply
on the port's own hierarchy and on the JAX package's carried across
(``convert.amg_state``) matches the JAX ``amg_apply`` to rel 1e-12 in
float64.  Iteration counts through the two drivers' APIs are equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import hypredrive_tpu as jax_hd
import hypredrive_tpu_torch as hd
from hypredrive_tpu.config.sections import AMG_SCHEMA as JAX_AMG_SCHEMA
from hypredrive_tpu.ops.csr import elasticity_3d as jax_elasticity_3d
from hypredrive_tpu.precon.amg import hierarchy as jax_hierarchy
from hypredrive_tpu.precon.amg.cycle import amg_apply as jax_amg_apply
from hypredrive_tpu.precon.amg.rbm import \
    augment_interpolation as jax_augment
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
from hypredrive_tpu_torch.ops.csr import (convection_diffusion_2d,
                                          elasticity_3d, laplacian_3d_7pt,
                                          rigid_body_modes)
from hypredrive_tpu_torch.precon.amg import hierarchy
from hypredrive_tpu_torch.precon.amg.coarsen import coarsen
from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
from hypredrive_tpu_torch.precon.amg.interp import build_interpolation
from hypredrive_tpu_torch.precon.amg.rbm import augment_interpolation
from hypredrive_tpu_torch.precon.amg.strength import strength_graph

torch.set_num_threads(1)

HOST = {"exec_policy": "host", "statistics": False}

# convdif-gmres-air.yml's AMG with each restriction type
AIR_RELAX = {"points": "air", "down_type": "jacobi", "down_sweeps": 0,
             "up_type": "jacobi", "up_sweeps": 3}


def _air(restriction_type):
    return {"interpolation": {"prolongation_type": "extended+i",
                              "restriction_type": restriction_type,
                              "restrict_strong_th": 0.25},
            "coarsening": {"type": "pmis", "strong_th": 0.25,
                           "max_coarse_size": 64},
            "relaxation": AIR_RELAX}


ELASTICITY_AMG = {"coarsening": {"num_functions": 3, "strong_th": 0.8}}


def _args(schema, overrides):
    return schema.parse(overrides, "amg", []) if overrides \
        else schema.defaults()


def _csr_equal(A, B):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    assert A.shape == B.shape
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_array_equal(A.data, B.data)


def _elasticity_rbm(dims):
    A, coords = elasticity_3d(*dims)
    return A, np.arange(A.shape[0]) % 3, rigid_body_modes(coords, 3)


def _hierarchies(A, overrides, **kw):
    js = jax_hierarchy.setup_hierarchy(
        A, _args(JAX_AMG_SCHEMA, overrides), dtype=jnp.float64, **kw)
    ts = hierarchy.setup_hierarchy(A, _args(AMG_SCHEMA, overrides),
                                   dtype=torch.float64, **kw)
    return js, ts


def _assert_same_hierarchy(js, ts):
    """Level sizes, smoother kinds, A/P/R and smoother operands bit for
    bit."""
    assert [lv.A.shape for lv in ts.levels] == \
        [lv.A.shape for lv in js.levels]
    for lj, lt in zip(js.levels, ts.levels):
        assert (lt.smoother, lt.up_smoother, lt.pre_sweeps,
                lt.post_sweeps) == (lj.smoother, lj.up_smoother,
                                    lj.pre_sweeps, lj.post_sweeps)
        for name in ("A", "P", "R"):
            Mj, Mt = getattr(lj, name), getattr(lt, name)
            assert (Mj is None) == (Mt is None)
            if Mj is not None:
                _csr_equal(Mt.to_csr(), Mj.to_csr())
        for arrs_j, arrs_t in ((lj.smooth_arrays, lt.smooth_arrays),
                               (lj.up_arrays, lt.up_arrays)):
            if arrs_j is None:
                assert arrs_t is None
                continue
            for a_j, a_t in zip(arrs_j, arrs_t):
                if isinstance(a_t, torch.Tensor):
                    np.testing.assert_array_equal(a_t.numpy(),
                                                  np.asarray(a_j))
    np.testing.assert_array_equal(ts.coarse_inv.numpy(),
                                  np.asarray(js.coarse_inv))


@pytest.mark.parametrize("dims", [(8, 4, 4), (12, 6, 6)])
def test_elasticity_generator_matches_jax(dims):
    """The repaired generator (row-then-column slicing, explicit zeros
    dropped) stores what the JAX package's stores."""
    A_t, c_t = elasticity_3d(*dims)
    A_j, c_j = jax_elasticity_3d(*dims)
    _csr_equal(A_t, A_j)
    np.testing.assert_array_equal(c_t, c_j)


def test_aggressive_coarsening_bit_identical():
    """Two-stage coarsening of a 16³ Laplacian: the fused level's C/F marks
    and P₁·P₂, then the whole hierarchy."""
    A = laplacian_3d_7pt(16)
    args = _args(AMG_SCHEMA, {"aggressive": {"num_levels": 1}})
    jargs = _args(JAX_AMG_SCHEMA, {"aggressive": {"num_levels": 1}})
    S = strength_graph(A, theta=0.25)
    cf1 = coarsen(S, ctype=8, seed=0)
    P_t, cf_t = hierarchy._aggressive_interpolation(
        A, S, cf1, args.interpolation, 0, 8, 0.25, False, None, 0.0, 4)
    P_j, cf_j = jax_hierarchy._aggressive_interpolation(
        A, S, cf1, jargs.interpolation, 0, 8, 0.25, False, None, 0.0, 4)
    np.testing.assert_array_equal(cf_t, cf_j)
    _csr_equal(P_t, P_j)
    assert (cf_t > 0).sum() < (cf1 > 0).sum()
    js, ts = _hierarchies(A, {"aggressive": {"num_levels": 1}})
    _assert_same_hierarchy(js, ts)
    # the distance-2 C set: fewer, smaller coarse operators
    _, plain = _hierarchies(A, {})
    assert ts.levels[1].A.shape[0] < plain.levels[1].A.shape[0]


@pytest.mark.parametrize("restriction_type", [
    "air_1", "air_2", "air_1.5", "neumann_air_0", "neumann_air_1",
    "neumann_air_2"])
def test_air_hierarchy_bit_identical(restriction_type):
    """AIR R, the Petrov-Galerkin coarse operators and the F-point masks
    of the AIR schedule on convection_diffusion_2d(24)."""
    A = convection_diffusion_2d(24, eps=1e-3)
    js, ts = _hierarchies(A, _air(restriction_type))
    _assert_same_hierarchy(js, ts)
    lv0 = ts.levels[0]
    assert lv0.smoother == "air-jacobi"
    R, P = lv0.R.to_csr(), lv0.P.to_csr()
    assert (R != sp.csr_matrix(P.T)).nnz > 0      # non-Galerkin
    fmask = lv0.smooth_arrays[1].numpy()
    assert set(np.unique(fmask)) == {0.0, 1.0}
    # a row of R per C point, padded to the level's bucket
    assert R.shape[0] == hierarchy._bucket_rows(int((fmask == 0).sum()))


def test_rbm_gm2_bit_identical():
    """GM2 pattern growth and min-norm re-weighting on elasticity_3d(6, 3,
    3), alone and inside the hierarchy (num_functions 3, qmax pinned to 4
    by interp_vec_variant 2)."""
    A, dof, V = _elasticity_rbm((6, 3, 3))
    S = strength_graph(A, theta=0.8, dof_func=dof)
    cf = coarsen(S, ctype=8, seed=0)
    P = build_interpolation(A, S, cf)
    P_t, Vc_t = augment_interpolation(P, cf, V, A=A, qmax=4)
    P_j, Vc_j = jax_augment(P, cf, V, A=A, qmax=4)
    _csr_equal(P_t, P_j)
    np.testing.assert_array_equal(Vc_t, Vc_j)
    assert P_t.nnz > P.nnz                          # the pattern grew
    vectors = [V[:, k] for k in range(6)]          # (k, n), as the API
    js, ts = _hierarchies(A, ELASTICITY_AMG, dof_func=dof,
                          interp_vectors=vectors)
    _assert_same_hierarchy(js, ts)
    _, plain = _hierarchies(A, ELASTICITY_AMG, dof_func=dof)
    assert ts.levels[0].P.nnz > plain.levels[0].P.nnz


# (AMG overrides, matrix): every F/C-masked smoother kind
MASKED = {
    "cf-l1-jacobi": ({"relaxation": {"type": 18, "order": 1}}, "lap"),
    "cf-jacobi-2sweeps": ({"relaxation": {"down_type": 0, "up_type": 18,
                                          "order": 1, "num_sweeps": 2}},
                          "lap"),
    "air-jacobi": (_air("air_2"), "convdif"),
    "air-l1-jacobi": ({"relaxation": {"points": "air", "type": 18,
                                      "num_sweeps": 3},
                       "interpolation": {"restriction_type": "air_1"}},
                      "convdif"),
}


@pytest.mark.parametrize("name", sorted(MASKED))
def test_masked_smoothers_and_cycle(name):
    overrides, which = MASKED[name]
    A = laplacian_3d_7pt(12) if which == "lap" \
        else convection_diffusion_2d(24, eps=1e-3)
    js, ts = _hierarchies(A, overrides)
    _assert_same_hierarchy(js, ts)
    assert ts.levels[0].smoother.startswith(name[:3])
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    z_j = np.asarray(jax_amg_apply(js, jnp.asarray(r)))
    scale = np.abs(z_j).max()
    for state in (ts, convert.amg_state(js)):
        z_t = amg_apply(state, torch.from_numpy(r)).numpy()
        assert np.abs(z_t - z_j).max() <= 1e-12 * scale


def _air_config(api_host):
    return {"general": dict(HOST) if api_host else {},
            "linear_system": {"rhs_mode": "ones"},
            "solver": {"gmres": {"relative_tol": 1e-8, "max_iter": 60,
                                 "krylov_dim": 30}},
            "preconditioner": {"amg": _air("air_2")}}


def _solve(mod, config, A, b, dofmap=None, near_nullspace=None):
    drv = mod.HypreDrive()
    try:
        drv.input_args_from_dict(config)
        drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
        if dofmap is not None:
            drv.system.set_dofmap(dofmap)
        if near_nullspace is not None:
            drv.set_near_nullspace(near_nullspace)
        drv.set_rhs(b)
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        return drv.linear_solver_apply()
    finally:
        drv.destroy()


def _pcg_config(host, amg):
    return {"general": dict(HOST) if host else {},
            "linear_system": {},
            "solver": {"pcg": {"relative_tol": 1e-8, "max_iter": 100}},
            "preconditioner": {"amg": amg}}


@pytest.mark.parametrize("case", ["air_via_config", "rbm_via_api",
                                  "aggressive"])
def test_counts_match_jax(case):
    """The setups of tests/test_amg.py's test_air_via_config,
    test_rbm_via_api_converges and test_aggressive_coarsening_cuts_
    complexity through both drivers: the same iteration count."""
    kw = {}
    if case == "air_via_config":
        A = convection_diffusion_2d(24, eps=1e-3)
        configs = [_air_config(host) for host in (False, True)]
    elif case == "rbm_via_api":
        A, dof, V = _elasticity_rbm((8, 4, 4))
        configs = [_pcg_config(host, ELASTICITY_AMG)
                   for host in (False, True)]
        kw = dict(dofmap=dof, near_nullspace=[V[:, k] for k in range(6)])
    else:
        A = laplacian_3d_7pt(16)
        configs = [_pcg_config(host, {"aggressive": {"num_levels": 1}})
                   for host in (False, True)]
    b = np.ones(A.shape[0])
    res_j = _solve(jax_hd, configs[0], A, b, **kw)
    res_t = _solve(hd, configs[1], A, b, **kw)
    assert res_t.iters == res_j.iters
    assert res_t.converged and res_j.converged
    assert res_t.rel_res_norm == pytest.approx(res_j.rel_res_norm, rel=1e-6)
    if case == "air_via_config":
        assert res_t.iters <= 15
    elif case == "rbm_via_api":
        assert res_t.iters <= 21
