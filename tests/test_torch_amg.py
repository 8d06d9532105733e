"""The port's AMG against the JAX package's, on the same matrices.

Setup: the port's host modules are copies of the JAX package's, so the
C/F splits, interpolation and Galerkin operators are bit-identical, and so
are the level sizes, nnz and smoother coefficients.

Cycle: the port's ``amg_apply`` on a hierarchy carried across from the JAX
package (``convert.amg_state``), and on its own hierarchy, matches the JAX
``amg_apply`` to rel 1e-12 in float64.  The JAX package applies the dense
coarse levels and the remainders as ELL + COO on the CPU, the port as dense
matvecs and CSR: the sums run in other orders, so the bound is rounding.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hypredrive_tpu.config.sections import AMG_SCHEMA as JAX_AMG_SCHEMA
from hypredrive_tpu.ops.csr import laplacian_2d_5pt, laplacian_3d_7pt
from hypredrive_tpu.precon.amg import coarsen as jax_coarsen
from hypredrive_tpu.precon.amg import interp as jax_interp
from hypredrive_tpu.precon.amg import strength as jax_strength
from hypredrive_tpu.precon.amg.cycle import amg_apply as jax_amg_apply
from hypredrive_tpu.precon.amg.hierarchy import \
    setup_hierarchy as jax_setup
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
from hypredrive_tpu_torch.io import native
from hypredrive_tpu_torch.precon.amg import coarsen, interp, strength
from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy

torch.set_num_threads(1)


def _aniso_2d(n=40, eps=0.01):
    """Anisotropic 2-D diffusion: a second operator class for PMIS."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sp.identity(n)
    return sp.csr_matrix(sp.kron(I, T) + eps * sp.kron(T, I))


MATRICES = {"lap7_12": lambda: laplacian_3d_7pt(12),
            "lap5_48": lambda: laplacian_2d_5pt(48),
            "aniso_40": _aniso_2d}

# (AMG overrides) — defaults: Chebyshev(2), V-cycle, one cycle
VARIANTS = {
    "default": {},
    "jacobi_w": {"relaxation": {"down_type": 7, "up_type": 7,
                                "weight": 0.7},
                 "cycle_type": 2},
    "l1_2sweeps_2cycles": {"relaxation": {"type": 18, "num_sweeps": 2},
                           "max_iter": 2},
    "cheby3_up_jacobi": {"relaxation": {"up_type": 0,
                                        "chebyshev": {"order": 3}}},
}


def _args(schema, overrides):
    return schema.parse(overrides, "amg", []) if overrides \
        else schema.defaults()


@pytest.fixture(scope="module", params=sorted(MATRICES))
def matrix(request):
    return sp.csr_matrix(MATRICES[request.param]())


def test_native_helpers_on_both_sides():
    """Both packages take the same host path, so hierarchies can match
    bit for bit."""
    from hypredrive_tpu.io import native as jax_native

    assert native.backend() == "native"
    assert jax_native.get_lib() is not None


def test_setup_passes_bit_identical(matrix):
    """strength → PMIS → ext+i on every level: same C/F splits, same P."""
    A = matrix
    for lvl in range(3):
        S_j = jax_strength.strength_graph(A, theta=0.25)
        S_t = strength.strength_graph(A, theta=0.25)
        assert (S_j != S_t).nnz == 0
        cf_j = jax_coarsen.coarsen(S_j, ctype=8, seed=lvl)
        cf_t = coarsen.coarsen(S_t, ctype=8, seed=lvl)
        np.testing.assert_array_equal(cf_j, cf_t)
        P_j = jax_interp.build_interpolation(A, S_j, cf_j, 6, 0.0, 4)
        P_t = interp.build_interpolation(A, S_t, cf_t, 6, 0.0, 4)
        np.testing.assert_array_equal(P_j.indptr, P_t.indptr)
        np.testing.assert_array_equal(P_j.indices, P_t.indices)
        np.testing.assert_array_equal(P_j.data, P_t.data)
        if P_t.shape[1] < 40:
            break
        A = sp.csr_matrix(P_t.T @ A @ P_t)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hierarchy_matches(matrix, variant):
    js = jax_setup(matrix, _args(JAX_AMG_SCHEMA, VARIANTS[variant]),
                   dtype=jnp.float64)
    ts = setup_hierarchy(matrix, _args(AMG_SCHEMA, VARIANTS[variant]),
                         dtype=torch.float64)
    assert len(ts.levels) == len(js.levels) >= 3
    assert (ts.cycle_type, ts.max_iter) == (js.cycle_type, js.max_iter)
    for lj, lt in zip(js.levels, ts.levels):
        assert lt.A.shape == lj.A.shape and lt.A.nnz == lj.A.nnz
        assert (lt.smoother, lt.pre_sweeps, lt.post_sweeps,
                lt.up_smoother) == (lj.smoother, lj.pre_sweeps,
                                    lj.post_sweeps, lj.up_smoother)
        np.testing.assert_array_equal(lt.smooth_arrays[0].numpy(),
                                      np.asarray(lj.smooth_arrays[0]))
        if lt.smoother == "chebyshev":
            theta, delta, rhos = lt.smooth_arrays[1:]
            assert theta == float(lj.smooth_arrays[1])
            assert delta == float(lj.smooth_arrays[2])
            assert rhos == tuple(np.asarray(lj.smooth_arrays[3]).tolist())
        for name in ("P", "R"):
            Mj, Mt = getattr(lj, name), getattr(lt, name)
            if Mj is None:
                assert Mt is None
                continue
            Bj, Bt = Mj.to_csr(), Mt.to_csr()
            assert Bt.shape == Bj.shape
            np.testing.assert_array_equal(Bt.indptr, Bj.indptr)
            np.testing.assert_array_equal(Bt.indices, Bj.indices)
            np.testing.assert_array_equal(Bt.data, Bj.data)
    np.testing.assert_array_equal(ts.coarse_inv.numpy(),
                                  np.asarray(js.coarse_inv))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cycle_matches(matrix, variant):
    js = jax_setup(matrix, _args(JAX_AMG_SCHEMA, VARIANTS[variant]),
                   dtype=jnp.float64)
    r = np.random.default_rng(7).standard_normal(matrix.shape[0])
    z_j = np.asarray(jax_amg_apply(js, jnp.asarray(r)))
    scale = np.abs(z_j).max()
    z_conv = amg_apply(convert.amg_state(js), torch.from_numpy(r)).numpy()
    assert np.abs(z_conv - z_j).max() <= 1e-12 * scale
    ts = setup_hierarchy(matrix, _args(AMG_SCHEMA, VARIANTS[variant]),
                         dtype=torch.float64)
    z_t = amg_apply(ts, torch.from_numpy(r)).numpy()
    assert np.abs(z_t - z_j).max() <= 1e-12 * scale
