"""The port's distributed layer against the JAX package's 8-shard mesh:
halo plans, row-sharded operators, the distributed AMG setup and cycle.

The JAX side runs on the 8-device CPU mesh that ``tests/conftest.py``
forces; the port runs ``make_mesh(8, device="cpu")``, so every halo
exchange and every per-shard matvec runs here through the kernels' plain
versions.  The host setup is copied, so halo plans, C/F splits and the
distributed P, R and A_c are equal exactly; matvecs and one AMG apply
agree to rel 1e-12 (float64 rounding, other summation orders), Krylov
histories to rel 1e-10 with a floor of 1e-12·‖r0‖.  Inputs come from ``np.random.default_rng(seed)``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from hypredrive_tpu.config.sections import AMG_SCHEMA as JAX_AMG_SCHEMA
from hypredrive_tpu.parallel import dist_setup as jax_ds
from hypredrive_tpu.parallel import make_mesh as jax_make_mesh
from hypredrive_tpu.parallel.dist_matrix import DistEllMatrix as JaxDist
from hypredrive_tpu.parallel.dist_matrix import pad_vector as jax_pad
from hypredrive_tpu.parallel.halo import build_halo_plan as jax_halo_plan
from hypredrive_tpu.precon.amg.cycle import amg_apply as jax_amg_apply
from hypredrive_tpu.precon.amg.hierarchy import \
    setup_hierarchy as jax_setup
from hypredrive_tpu.precon.amg.strength import \
    strength_graph as jax_strength
from hypredrive_tpu.solvers.gmres import _gmres_core as jax_gmres
from hypredrive_tpu.solvers.pcg import _pcg_core as jax_pcg
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
from hypredrive_tpu_torch.ops.csr import (convection_diffusion_2d,
                                          laplacian_3d_7pt,
                                          multiphysics_block_system,
                                          row_partition)
from hypredrive_tpu_torch.parallel import (DistEllMatrix, make_mesh,
                                           pad_vector)
from hypredrive_tpu_torch.parallel import dist_setup as ds
from hypredrive_tpu_torch.parallel.halo import build_halo_plan
from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy
from hypredrive_tpu_torch.precon.amg.strength import strength_graph
from hypredrive_tpu_torch.solvers.gmres import gmres_core
from hypredrive_tpu_torch.solvers.pcg import pcg_core

torch.set_num_threads(1)

N_SH = 8


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= N_SH, "tests need the 8-device CPU mesh"
    return jax_make_mesh(N_SH)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_SH, device="cpu")


def _tridiag(n=64):
    return sp.diags([np.ones(n - 1), 2 * np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


def _random_rect():
    return sp.random(96, 24, density=0.2, random_state=0, format="csr")


def _convdif():
    """Advection-dominated, so asymmetric: a halo shift in the wrong
    direction gives a wrong matvec here (it would not on a Laplacian)."""
    return sp.csr_matrix(convection_diffusion_2d(16, eps=1e-2,
                                                 velocity=(4.0, 2.0)))


OPERATORS = {"square_lap10": lambda: laplacian_3d_7pt(10),
             "padded_lap7": lambda: laplacian_3d_7pt(7),   # 343 → 344 rows
             "rectangular": _random_rect,
             "asymmetric_convdif": _convdif}


@pytest.mark.parametrize("case", ["tridiag", "lap10"])
def test_halo_plan_matches_jax(case):
    A = _tridiag() if case == "tridiag" else laplacian_3d_7pt(10)
    off = row_partition(A.shape[0], N_SH)
    needed = [np.unique(A[off[s]:off[s + 1]].indices) for s in range(N_SH)]
    plan, recv = build_halo_plan(N_SH, off, needed)
    jplan, jrecv = jax_halo_plan(N_SH, off, needed)
    assert plan.offsets == jplan.offsets
    assert (plan.ext_size, plan.local_max) == (jplan.ext_size,
                                               jplan.local_max)
    assert len(plan.send_idx) == len(jplan.send_idx)
    for a, b in zip(plan.send_idx, jplan.send_idx):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert recv == jrecv
    if case == "tridiag":
        assert set(plan.offsets) == {1, N_SH - 1}
        assert all(idx.shape == (N_SH, 1) for idx in plan.send_idx)


@pytest.mark.parametrize("case", sorted(OPERATORS))
def test_dist_matrix_structure_matches_jax(case, mesh, jax_mesh):
    """Shapes, halo schedule, local_max, ext_size and the union of DIA
    offsets are the JAX package's; the shards hold the padded matrix."""
    A = sp.csr_matrix(OPERATORS[case]())
    D = DistEllMatrix.from_csr(A, mesh)
    J = JaxDist.from_csr(A, jax_mesh)
    assert (D.shape, D.orig_shape, D.nnz) == (J.shape, J.orig_shape, J.nnz)
    assert (D.local_max, D.ext_size) == (J.local_max, J.ext_size)
    assert D.offsets == J.offsets and D.dia_offsets == J.dia_offsets
    for a, b in zip(D.send_idx, J.send_idx):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert all(E.dense is None for E in D.shards)
    padded = sp.csr_matrix(A, copy=True)
    padded.resize(D.shape)
    if A.shape[0] == A.shape[1]:
        extra = np.arange(A.shape[0], D.shape[0])
        padded = padded + sp.csr_matrix(
            (np.ones(len(extra)), (extra, extra)), shape=D.shape)
    assert abs(D.to_csr() - padded).max() == 0
    assert abs(convert.dist_matrix(J, mesh).to_csr() - padded).max() == 0


@pytest.mark.parametrize("case", sorted(OPERATORS))
def test_dist_matvec_matches_jax(case, mesh, jax_mesh):
    """matvec, diagonal and row ℓ1 norms against the JAX package's and
    the host product; identity pad rows keep y exactly 0."""
    A = sp.csr_matrix(OPERATORS[case]())
    D = DistEllMatrix.from_csr(A, mesh)
    J = JaxDist.from_csr(A, jax_mesh)
    x = np.random.default_rng(7).standard_normal(A.shape[1])
    y = D.matvec(pad_vector(x, D.shape[1], mesh)).numpy()
    yj = np.asarray(J.matvec(jax_pad(x, J.shape[1], jax_mesh)))
    scale = np.abs(yj).max()
    assert np.abs(y - yj).max() <= 1e-12 * scale
    assert np.abs(y[:A.shape[0]] - A @ x).max() <= 1e-12 * scale
    assert np.all(y[A.shape[0]:] == 0.0)
    l1 = D.row_l1_norms().numpy()
    assert np.abs(l1 - np.asarray(J.row_l1_norms())).max() \
        <= 1e-12 * np.abs(l1).max()
    if A.shape[0] == A.shape[1]:
        d = D.diagonal().numpy()
        assert np.abs(d - np.asarray(J.diagonal())).max() \
            <= 1e-12 * np.abs(d).max()
        assert np.array_equal(d[:A.shape[0]], A.diagonal())


def test_from_parts_leaves_caller_blocks_intact(mesh):
    rng = np.random.default_rng(0)
    A = sp.csr_matrix(sp.random(64, 64, 0.2, random_state=rng)
                      + 4 * sp.identity(64))
    parts = ds.split_rows(A, N_SH)
    before = [(p.indices.copy(), p.data.copy()) for p in parts]
    D = DistEllMatrix.from_parts(parts, mesh, 64)
    for p, (idx, dat) in zip(parts, before):
        assert np.array_equal(p.indices, idx)
        assert np.array_equal(p.data, dat)
    assert abs(D.to_csr() - A).max() == 0


def test_dist_setup_primitives_match_jax():
    """Strength, PMIS/HMIS, ext+i P, RAP, AIR R and the Petrov RAP per
    shard: the JAX package's results exactly."""
    A = laplacian_3d_7pt(12)
    parts = ds.split_rows(A, N_SH)
    off = ds.offsets_of(parts)
    S = [strength_graph(parts[s], theta=0.25, row_offset=int(off[s]))
         for s in range(N_SH)]
    Sj = [jax_strength(parts[s], theta=0.25, row_offset=int(off[s]))
          for s in range(N_SH)]
    assert all((a != b).nnz == 0 for a, b in zip(S, Sj))
    for seed in (0, 3):
        cf = ds.pmis_dist(S, off, seed=seed)
        assert all(np.array_equal(a, b) for a, b in
                   zip(cf, jax_ds.pmis_dist(Sj, off, seed=seed)))
    cf_h = ds.hmis_dist(S, off, seed=1)
    assert all(np.array_equal(a, b) for a, b in
               zip(cf_h, jax_ds.hmis_dist(Sj, off, seed=1)))

    def same(xs, ys):
        return all(a.shape == b.shape and (abs(a - b).max() if a.nnz else 0)
                   == 0 for a, b in zip(xs, ys))

    P, c_off = ds.build_P_dist(parts, S, off, cf, 6, 0.0, 4)
    Pj, c_offj = jax_ds.build_P_dist(parts, Sj, off, cf, 6, 0.0, 4)
    assert np.array_equal(c_off, c_offj) and same(P, Pj)
    assert same(ds.rap_dist(parts, P, off, c_off),
                jax_ds.rap_dist(parts, Pj, off, c_offj))

    C = _convdif()
    cparts = ds.split_rows(C, N_SH)
    coff = ds.offsets_of(cparts)
    CS = [strength_graph(cparts[s], theta=0.25, row_offset=int(coff[s]))
          for s in range(N_SH)]
    ccf = ds.pmis_dist(CS, coff, seed=0)
    CP, cc_off = ds.build_P_dist(cparts, CS, coff, ccf, 100, 0.0, 4)
    R = ds.build_R_dist(cparts, coff, ccf, cc_off, 1, 0.25, 0.0)
    Rj = jax_ds.build_R_dist(cparts, coff, ccf, cc_off, 1, 0.25, 0.0)
    assert same(R, Rj)
    assert same(ds.rap_petrov_dist(cparts, CP, R, coff, cc_off),
                jax_ds.rap_petrov_dist(cparts, CP, Rj, coff, cc_off))


def _variant_args(schema, name):
    a = schema.defaults()
    if name == "air":
        a["interpolation"]["prolongation_type"] = 100
        a["interpolation"]["restriction_type"] = 1
        a["relaxation"]["points"] = 1
    elif name == "aggressive":
        a["aggressive"]["num_levels"] = 1
    elif name == "num_functions":
        a["coarsening"]["num_functions"] = 2
    return a


def _variant_system(name):
    """(A, dof_func, solver): tests/test_parallel.py's dist-setup cases."""
    if name == "air":
        return _convdif(), None, "gmres"
    if name == "num_functions":
        A, dofmap = multiphysics_block_system(6, ndof=2)
        return sp.csr_matrix(A), np.asarray(dofmap), "gmres"
    return laplacian_3d_7pt(12), None, "pcg"


VARIANTS = ("default", "air", "aggressive", "num_functions")


@pytest.fixture(scope="module", params=VARIANTS)
def hierarchies(request, mesh, jax_mesh):
    """Both packages' hierarchies from the same per-shard parts."""
    name = request.param
    A, dof_func, solver = _variant_system(name)
    parts = ds.split_rows(A, N_SH)
    assert ds.supports_dist_setup(_variant_args(AMG_SCHEMA, name))
    st = setup_hierarchy(parts, _variant_args(AMG_SCHEMA, name),
                         mesh=mesh, dof_func=dof_func)
    sj = jax_setup(parts, _variant_args(JAX_AMG_SCHEMA, name),
                   dtype=jnp.float64, mesh=jax_mesh, dof_func=dof_func)
    return name, A, solver, st, sj


def test_setup_hierarchy_parts_matches_jax(hierarchies, mesh):
    """Level sizes, every level's A, P and R and the smoother operands
    equal to the JAX package's mesh hierarchy."""
    name, _, _, st, sj = hierarchies
    assert st.mesh is mesh
    assert [lv.A.shape for lv in st.levels] == [lv.A.shape
                                                for lv in sj.levels]
    if name == "aggressive":
        std = setup_hierarchy(ds.split_rows(laplacian_3d_7pt(12), N_SH),
                              AMG_SCHEMA.defaults(), mesh=mesh)
        assert st.levels[1].A.shape[0] < std.levels[1].A.shape[0]
    for lt, lj in zip(st.levels, sj.levels):
        for nm in ("A", "P", "R"):
            Et, Ej = getattr(lt, nm), getattr(lj, nm)
            if Ej is None:
                assert Et is None
                continue
            assert (Et.offsets, Et.dia_offsets, Et.ext_size) == \
                (Ej.offsets, Ej.dia_offsets, Ej.ext_size)
            diff = Et.to_csr() - convert.dist_matrix(Ej, mesh).to_csr()
            assert diff.nnz == 0 or abs(diff).max() == 0
        assert lt.smoother == lj.smoother
        for a, b in zip(lt.smooth_arrays, lj.smooth_arrays):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert np.allclose(a, np.asarray(b), rtol=1e-14, atol=0)
    np.testing.assert_array_equal(st.coarse_inv.numpy(),
                                  np.asarray(sj.coarse_inv))


def test_amg_apply_matches_jax(hierarchies, mesh, jax_mesh):
    """One V-cycle on the port's own mesh hierarchy and on the JAX
    package's carried across, against the JAX package's apply."""
    _, A, _, st, sj = hierarchies
    n_pad = st.levels[0].A.shape[0]
    r = np.random.default_rng(3).standard_normal(A.shape[0])
    zj = np.asarray(jax.jit(jax_amg_apply)(sj, jax_pad(r, n_pad, jax_mesh)))
    rt = pad_vector(r, n_pad, mesh)
    scale = np.abs(zj).max()
    for state in (st, convert.amg_state(sj, mesh=mesh)):
        z = amg_apply(state, rt).numpy()
        assert np.abs(z - zj).max() <= 1e-12 * scale
        assert np.all(z[A.shape[0]:] == 0.0)


def test_krylov_amg_counts_match_jax(hierarchies, mesh, jax_mesh):
    """PCG (GMRES(30) for the AIR and multi-function cases) + the mesh
    AMG to 1e-8, b = ones: the JAX package's count and residual history
    (rel 1e-10, floor 1e-12·‖r0‖)."""
    _, A, solver, st, sj = hierarchies
    n = A.shape[0]
    D, J = st.levels[0].A, sj.levels[0].A
    b = pad_vector(np.ones(n), D.shape[0], mesh)
    bj = jax_pad(np.ones(n), J.shape[0], jax_mesh)
    if solver == "pcg":
        x, it, _, done, hist = pcg_core(
            D.matvec, lambda r: amg_apply(st, r), b, torch.zeros_like(b),
            1e-8, 0.0, 100, True, 0)
        out = jax.jit(lambda J, s, b: jax_pcg(
            J.matvec, lambda r: jax_amg_apply(s, r), b, jnp.zeros_like(b),
            1e-8, 0.0, 100, True, 0))(J, sj, bj)
    else:
        x, it, _, done, hist, _ = gmres_core(
            D.matvec, lambda r: amg_apply(st, r), b, torch.zeros_like(b),
            1e-8, 0.0, 100, 30, False)
        out = jax.jit(lambda J, s, b: jax_gmres(
            J.matvec, lambda r: jax_amg_apply(s, r), b, jnp.zeros_like(b),
            jnp.asarray(1e-8), jnp.asarray(0.0), 100, 30, False))(J, sj, bj)
    it_j = int(out[1])
    assert done and it == it_j
    hj = np.asarray(out[4])[:it + 1]
    # GMRES's last entry is the true residual ‖b − Ax‖, whose cancellation
    # rounding is relative to ‖r0‖: hence the floor
    assert np.all(np.abs(hist[:it + 1] - hj) <= 1e-10 * hj + 1e-12 * hj[0])
    xh = x.numpy()[:n]
    assert np.linalg.norm(np.ones(n) - A @ xh) <= 1e-7 * np.sqrt(n)


def test_host_matrix_with_mesh_runs_dist_setup(mesh, jax_mesh):
    """A host matrix with a mesh: the distributed setup from its row
    blocks; a config outside the subset: the host-global hierarchy
    uploaded level by level (hybrid GS triangles row-sharded too), equal
    to the JAX package's and applying as its does."""
    A = laplacian_3d_7pt(10)
    st = setup_hierarchy(A, AMG_SCHEMA.defaults(), mesh=mesh)
    sp_ = setup_hierarchy(ds.split_rows(A, N_SH), AMG_SCHEMA.defaults(),
                          mesh=mesh)
    assert [lv.A.shape for lv in st.levels] == [lv.A.shape
                                                for lv in sp_.levels]
    gs = AMG_SCHEMA.defaults()
    gs["relaxation"]["type"] = 6                  # hybrid symmetric GS
    assert not ds.supports_dist_setup(gs)
    jgs = JAX_AMG_SCHEMA.defaults()
    jgs["relaxation"]["type"] = 6
    st = setup_hierarchy(A, gs, mesh=mesh)
    sj = jax_setup(A, jgs, dtype=jnp.float64, mesh=jax_mesh)
    assert st.levels[0].smoother == "gs-sym"
    assert isinstance(st.levels[0].smooth_arrays[1], DistEllMatrix)
    n_pad = st.levels[0].A.shape[0]
    r = np.random.default_rng(5).standard_normal(A.shape[0])
    zj = np.asarray(jax.jit(jax_amg_apply)(sj, jax_pad(r, n_pad, jax_mesh)))
    for state in (st, convert.amg_state(sj, mesh=mesh)):
        z = amg_apply(state, pad_vector(r, n_pad, mesh)).numpy()
        assert np.abs(z - zj).max() <= 1e-12 * np.abs(zj).max()


def test_parts_outside_the_subset_warn_and_assemble(mesh, monkeypatch):
    """Parts need a mesh; with a config outside the distributed subset
    they are assembled for the host-global setup, with the JAX package's
    warning."""
    import io

    from hypredrive_tpu_torch.core.logging import logger

    A = laplacian_3d_7pt(8)
    gs = AMG_SCHEMA.defaults()
    gs["relaxation"]["type"] = 3
    with pytest.raises(ValueError):
        setup_hierarchy(ds.split_rows(A, N_SH), gs)
    stream = io.StringIO()
    monkeypatch.setattr(logger, "stream", stream)
    st = setup_hierarchy(ds.split_rows(A, N_SH), gs, mesh=mesh)
    assert "outside the distributed-setup subset" in stream.getvalue()
    assert isinstance(st.levels[0].A, DistEllMatrix)
    assert st.levels[0].smoother == "gs-fwd"
    z = amg_apply(st, pad_vector(np.ones(A.shape[0]), A.shape[0], mesh))
    assert torch.isfinite(z).all()
