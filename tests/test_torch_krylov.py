"""The port's GMRES, FGMRES and BiCGSTAB against the JAX package's cores.

Problem: the nonsymmetric upwind ``convection_diffusion_2d(16)`` (256
rows), b from a seeded numpy generator, x0 = 0, float64, with no
preconditioner and with Jacobi.  The JAX side runs ``_gmres_core``,
``_fgmres_core`` and ``_bicgstab_core`` under ``jax.jit`` on the CPU; the
port runs its cores on CPU tensors (the kernels' plain versions).

Iteration counts must be equal.  Residual histories must agree to rel
1e-10, with an absolute floor of 1e-11·‖r0‖: both run the same
recurrences in float64 and only summation order differs (XLA's fused dots
and ELL gathers against torch's dot and dense/CSR matvecs).  That rounding
is relative to the vectors' scale, ‖r0‖, not to the residual an entry has
shrunk to: a restarted GMRES or a BiCGSTAB entry 1e-9 below ‖r0‖ differs
by about 1e-16·‖r0‖ (GMRES) to 3e-13·‖r0‖ (BiCGSTAB), so near the end of
a solve the relative difference reaches 1e-7 while the floor holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypredrive_tpu.ops.csr import convection_diffusion_2d as jax_cd2d
from hypredrive_tpu.ops.device_matrix import EllMatrix as JaxEll
from hypredrive_tpu.precon.components import \
    apply_component as jax_apply_component
from hypredrive_tpu.precon.components import \
    build_component as jax_build_component
from hypredrive_tpu.solvers.bicgstab import _bicgstab_core
from hypredrive_tpu.solvers.fgmres import _fgmres_core
from hypredrive_tpu.solvers.gmres import _gmres_core
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.ops.csr import convection_diffusion_2d
from hypredrive_tpu_torch.ops.device_matrix import EllMatrix
from hypredrive_tpu_torch.precon.components import (apply_component,
                                                    build_component)
from hypredrive_tpu_torch.solvers.bicgstab import bicgstab_core
from hypredrive_tpu_torch.solvers.fgmres import fgmres_core
from hypredrive_tpu_torch.solvers.gmres import gmres_core

torch.set_num_threads(1)

RTOL_HIST = 1e-10
ATOL_HIST = 1e-11      # times ‖r0‖
N = 16
SOLVE_RTOL = 1e-9


@pytest.fixture(scope="module")
def problem():
    A = convection_diffusion_2d(N)
    assert (A != jax_cd2d(N)).nnz == 0
    assert abs(A - A.T).max() > 0           # nonsymmetric
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    d = A.diagonal()
    return A, b, 1.0 / d


def _jax_run(core, A, b, d_inv, precon, statics):
    E = JaxEll.from_csr(A)
    dj = jnp.asarray(d_inv)
    pc = (lambda r: dj * r) if precon == "jacobi" else (lambda r: r)

    @jax.jit
    def run(bj, x0):
        return core(lambda v: E.matvec(v), pc, bj, x0,
                    jnp.asarray(SOLVE_RTOL), jnp.asarray(0.0), *statics)

    x, iters, _, done, hist = run(jnp.asarray(b), jnp.zeros_like(b))
    return np.asarray(x), int(iters), bool(done), np.asarray(hist)


def _torch_run(core, A, b, d_inv, precon, statics):
    E = EllMatrix.from_csr(A)
    dt = torch.tensor(d_inv)
    pc = (lambda r: dt * r) if precon == "jacobi" else (lambda r: r)
    bt = torch.tensor(b)
    x, iters, _, done, hist = core(E.matvec, pc, bt, torch.zeros_like(bt),
                                   SOLVE_RTOL, 0.0, *statics)[:5]
    return x.numpy(), iters, done, hist


CASES = {
    # name: (JAX core, port core, statics after atol)
    "gmres30": (_gmres_core, gmres_core, (200, 30, False)),
    "gmres5_restart": (_gmres_core, gmres_core, (200, 5, False)),
    "gmres5_skip_real_res": (_gmres_core, gmres_core, (200, 5, True)),
    "fgmres30": (_fgmres_core, fgmres_core, (200, 30)),
    "fgmres5_restart": (_fgmres_core, fgmres_core, (200, 5)),
    "bicgstab": (_bicgstab_core, bicgstab_core, (200,)),
}


@pytest.mark.parametrize("precon", ["none", "jacobi"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_core_matches_jax(problem, case, precon):
    A, b, d_inv = problem
    jcore, tcore, statics = CASES[case]
    xj, it_j, done_j, hj = _jax_run(jcore, A, b, d_inv, precon, statics)
    xt, it_t, done_t, ht = _torch_run(tcore, A, b, d_inv, precon, statics)
    assert it_t == it_j and done_t == done_j
    assert done_t and it_t > 5
    if "restart" in case or "skip" in case:
        assert it_t > statics[1]            # the solve crossed a restart
    np.testing.assert_allclose(ht[:it_t + 1], hj[:it_j + 1], rtol=RTOL_HIST,
                               atol=ATOL_HIST * hj[0])
    assert np.isnan(ht[it_t + 1:]).all()
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-12)
    if not (case.startswith("gmres") and statics[2]):
        # every contract but skip_real_res_check ends on the true residual
        assert np.linalg.norm(b - A @ xt) <= SOLVE_RTOL * np.linalg.norm(b)


@pytest.mark.parametrize("method", ["gmres", "fgmres", "pcg", "bicgstab"])
def test_nested_krylov_component_matches_jax(problem, method):
    """A ``krylov`` component (fixed budget, inner Jacobi) on the same
    operator: the port's build + apply against the JAX package's, and on
    the JAX package's state carried across (``convert``)."""
    A, _, _ = problem
    if method == "pcg":
        A = A + A.T      # PCG needs a symmetric operator
    cfg = {"krylov": {"type": method, "max_iter": 7, "krylov_dim": 4,
                      "preconditioner": "jacobi"}}
    r = np.random.default_rng(9).standard_normal(A.shape[0])
    jk, js = jax_build_component(cfg, A, jnp.float64)
    zj = np.asarray(jax.jit(lambda s, v: jax_apply_component(jk, s, v))(
        js, jnp.asarray(r)))
    tk, ts = build_component(cfg, A, torch.float64)
    assert tk == jk == "krylov" and ts.method == method
    zt = apply_component(tk, ts, torch.tensor(r)).numpy()
    zc = apply_component(jk, convert.component_state(jk, js),
                         torch.tensor(r)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=1e-10,
                               atol=1e-10 * np.abs(zj).max())
    np.testing.assert_allclose(zc, zj, rtol=1e-10,
                               atol=1e-10 * np.abs(zj).max())
