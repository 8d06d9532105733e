"""The port's mesh MGR, block-Jacobi ILU, AMS and ADS, and the three
``dryrun_multichip`` stacks, against the JAX package's 8-shard mesh.

The JAX side runs on the 8-device CPU mesh that ``tests/conftest.py``
forces, the port on ``make_mesh(8, device="cpu")``.  Both set up from the
same per-shard parts with the same host code, so the counts are equal; a
JAX state carried across (``convert.mgr_state``) applies as the JAX
package's does, to rel 1e-12.  AMS histories agree to 1e-4·‖r0‖ only:
its gradient space GᵀAG + 1e-12·I amplifies rounding (``ROADMAP.md``
Queue 3); ADS skips that space and agrees to rel 1e-8 (floor
1e-12·‖r0‖).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hypredrive_tpu.config.sections import ADS_SCHEMA as JAX_ADS_SCHEMA
from hypredrive_tpu.config.sections import AMS_SCHEMA as JAX_AMS_SCHEMA
from hypredrive_tpu.config.sections import MGR_SCHEMA as JAX_MGR_SCHEMA
from hypredrive_tpu.parallel import dist_precon as jax_dp
from hypredrive_tpu.parallel import make_mesh as jax_make_mesh
from hypredrive_tpu.parallel.dist_matrix import DistEllMatrix as JaxDist
from hypredrive_tpu.parallel.dist_matrix import pad_vector as jax_pad
from hypredrive_tpu.precon.ads import build_ads_state as jax_ads_state
from hypredrive_tpu.precon.ams import _ams_apply as jax_ams_apply
from hypredrive_tpu.precon.ams import build_ams_state as jax_ams_state
from hypredrive_tpu.precon.ilu import _tri_jacobi_apply as jax_tri_apply
from hypredrive_tpu.precon.mgr import mgr_apply as jax_mgr_apply
from hypredrive_tpu.solvers.bicgstab import _bicgstab_core as jax_bicgstab
from hypredrive_tpu.solvers.gmres import _gmres_core as jax_gmres
from hypredrive_tpu.solvers.pcg import _pcg_core as jax_pcg
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.config.sections import (ADS_SCHEMA, AMS_SCHEMA,
                                                  MGR_SCHEMA)
from hypredrive_tpu_torch.core.errors import ErrorCode, HypredrvError
from hypredrive_tpu_torch.ops.csr import (graddiv_face_system,
                                          laplacian_3d_7pt,
                                          maxwell_edge_system)
from hypredrive_tpu_torch.parallel import (DistEllMatrix, make_mesh,
                                           pad_vector)
from hypredrive_tpu_torch.parallel import dist_precon as dp
from hypredrive_tpu_torch.parallel import dist_setup as ds
from hypredrive_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                  two_field_system)
from hypredrive_tpu_torch.precon.ads import build_ads_state
from hypredrive_tpu_torch.precon.ams import _ams_apply, build_ams_state
from hypredrive_tpu_torch.precon.ilu import tri_jacobi_apply
from hypredrive_tpu_torch.precon.mgr import mgr_apply
from hypredrive_tpu_torch.solvers.bicgstab import bicgstab_core
from hypredrive_tpu_torch.solvers.gmres import gmres_core
from hypredrive_tpu_torch.solvers.pcg import pcg_core

torch.set_num_threads(1)

N_SH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= N_SH, "tests need the 8-device CPU mesh"
    return jax_make_mesh(N_SH)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_SH, device="cpu")


@pytest.fixture(scope="module")
def two_field():
    """tests/test_parallel.py's two-field system (1,024 rows)."""
    A, dofmap = two_field_system(laplacian_3d_7pt(8))
    return A, dofmap, ds.split_rows(A, N_SH)


def _solve(core, A, mv, pc, b, rtol, max_iter):
    """The port's core from x0 = 0: (iters, history, host rel residual)."""
    out = core(mv, pc, b, torch.zeros_like(b), rtol, 0.0, max_iter,
               *((30, False) if core is gmres_core else ()))
    it, hist = out[1], out[4][:out[1] + 1]
    x = out[0].numpy()[:A.shape[0]]
    return it, hist, np.linalg.norm(np.ones(A.shape[0]) - A @ x)


def _jax_solve(core, J, apply_fn, state, bj, rtol, max_iter):
    def run(J, state, b):
        pc = lambda r: apply_fn(state, r)            # noqa: E731
        x0 = jnp.zeros_like(b)
        if core == "gmres":
            return jax_gmres(J.matvec, pc, b, x0, jnp.asarray(rtol),
                             jnp.asarray(0.0), max_iter, 30, False)
        if core == "bicgstab":
            return jax_bicgstab(J.matvec, pc, b, x0, jnp.asarray(rtol),
                                jnp.asarray(0.0), max_iter)
        return jax_pcg(J.matvec, pc, b, x0, rtol, 0.0, max_iter, True, 0)

    out = jax.jit(run)(J, state, bj)
    it = int(out[1])
    return it, np.asarray(out[4])[:it + 1]


def _close(h, hj, rel, floor):
    return np.all(np.abs(h - hj) <= rel * np.abs(hj) + floor * hj[0])


F_RELAX = {"masked-jacobi": "jacobi",
           "masked-amg": {"amg": {"max_iter": 1}},
           "masked-ilu": {"ilu": {}}}


@pytest.mark.parametrize("kind", sorted(F_RELAX))
def test_dist_mgr_matches_jax(kind, two_field, mesh, jax_mesh):
    """GMRES(30) + the mesh MGR (F = dof 1 with each masked F-relaxation,
    coarsest AMG) to 1e-6: the JAX package's count and history (rel
    1e-10, floor 1e-12·‖r0‖); its state carried across applies as its
    own does."""
    A, dofmap, parts = two_field
    cfg = {"level": {0: {"f_dofs": [1], "f_relaxation": F_RELAX[kind]}},
           "coarsest_level": "amg"}
    st = dp.setup_mgr_dist(parts, MGR_SCHEMA.parse(cfg, "mgr", []), dofmap,
                           mesh)
    sj = jax_dp.setup_mgr_dist(parts, JAX_MGR_SCHEMA.parse(cfg, "mgr", []),
                               dofmap, jax_mesh, dtype=jnp.float64)
    assert st.levels[0].f_kind == sj.levels[0].f_kind == kind
    D, J = st.levels[0].A, sj.levels[0].A
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    bj = jax_pad(np.ones(A.shape[0]), J.shape[0], jax_mesh)
    it, hist, res = _solve(gmres_core, A, D.matvec,
                           lambda r: mgr_apply(st, r), b, 1e-6, 100)
    it_j, hist_j = _jax_solve("gmres", J, jax_mgr_apply, sj, bj, 1e-6, 100)
    assert it == it_j and _close(hist, hist_j, 1e-10, 1e-12)
    assert res <= 1e-5 * np.sqrt(A.shape[0])
    r = np.random.default_rng(2).standard_normal(A.shape[0])
    zj = np.asarray(jax.jit(jax_mgr_apply)(sj, jax_pad(r, J.shape[0],
                                                       jax_mesh)))
    z = mgr_apply(convert.mgr_state(sj, mesh=mesh),
                  pad_vector(r, D.shape[0], mesh)).numpy()
    assert np.abs(z - zj).max() <= 1e-12 * np.abs(zj).max()


def test_dist_bj_ilu_matches_jax(two_field, mesh, jax_mesh):
    """Block-Jacobi ILU(0): the JAX package's per-shard factors exactly,
    and BiCGSTAB's count and history (rel 1e-10, floor 1e-12·‖r0‖)."""
    A, _, parts = two_field
    st = dp.build_bj_ilu_dist(parts, mesh)
    sj = jax_dp.build_bj_ilu_dist(parts, jax_mesh, dtype=jnp.float64)
    conv = convert.ilu_state(sj, mesh=mesh)
    for ours, theirs in ((st.L, conv.L), (st.U, conv.U)):
        diff = ours.to_csr() - theirs.to_csr()
        assert diff.nnz == 0 or abs(diff).max() == 0
    np.testing.assert_array_equal(st.u_dinv.numpy(), np.asarray(sj[3]))
    D = DistEllMatrix.from_csr(A, mesh)
    J = JaxDist.from_csr(A, jax_mesh)
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
    bj = jax_pad(np.ones(A.shape[0]), J.shape[0], jax_mesh)
    it, hist, res = _solve(bicgstab_core, A, D.matvec,
                           lambda r: tri_jacobi_apply(st, r), b, 1e-8, 200)
    it_j, hist_j = _jax_solve("bicgstab", J, jax_tri_apply, sj, bj, 1e-8,
                              200)
    assert it == it_j and _close(hist, hist_j, 1e-10, 1e-12)
    assert res <= 1e-5 * np.sqrt(A.shape[0])


def test_dist_mgr_coarsest_jacobi(two_field, mesh, jax_mesh):
    """A coarsest level other than amg/def becomes Jacobi on the mesh, as
    in the JAX package; its Jacobi state there is a 1-tuple its own apply
    cannot unpack, while the port's (D⁻¹, 1 sweep) applies."""
    A, dofmap, parts = two_field
    cfg = {"level": {0: {"f_dofs": [1]}}, "coarsest_level": "ilu"}
    st = dp.setup_mgr_dist(parts, MGR_SCHEMA.parse(cfg, "mgr", []), dofmap,
                           mesh)
    sj = jax_dp.setup_mgr_dist(parts, JAX_MGR_SCHEMA.parse(cfg, "mgr", []),
                               dofmap, jax_mesh, dtype=jnp.float64)
    assert st.coarsest_kind == sj.coarsest_kind == "jacobi"
    n_pad = st.levels[0].A.shape[0]
    with pytest.raises(ValueError):
        jax_mgr_apply(sj, jax_pad(np.ones(A.shape[0]), n_pad, jax_mesh))
    D = st.levels[0].A
    it, _, res = _solve(gmres_core, A, D.matvec, lambda r: mgr_apply(st, r),
                        pad_vector(np.ones(A.shape[0]), n_pad, mesh), 1e-6,
                        200)
    assert it < 200 and res <= 1e-5 * np.sqrt(A.shape[0])


def _aux(kind, mesh, jax_mesh):
    if kind == "ams":
        A, G, coords = maxwell_edge_system(8, eps=0.1, dim=2)
        st = build_ams_state(A, G, coords, AMS_SCHEMA.defaults(),
                             torch.float64, mesh=mesh)
        sj = jax_ams_state(A, G, coords, JAX_AMS_SCHEMA.defaults(),
                           jnp.float64, mesh=jax_mesh)
    else:
        A, C, G, coords = graddiv_face_system(4, eps=0.1)
        st = build_ads_state(A, C, G, coords, ADS_SCHEMA.defaults(),
                             torch.float64, mesh=mesh)
        sj = jax_ads_state(A, C, G, coords, JAX_ADS_SCHEMA.defaults(),
                           jnp.float64, mesh=jax_mesh)
    return A, st, sj


@pytest.mark.parametrize("kind", ["ams", "ads"])
def test_dist_aux_space_matches_jax(kind, mesh, jax_mesh):
    """PCG + AMS (2-D Maxwell, n = 8) and PCG + ADS (grad-div, n = 4) with
    every operator on the mesh and every auxiliary hierarchy from the
    distributed setup, b = A·linspace(0.2, 1): the JAX package's mesh
    count; histories to 1e-4·‖r0‖ (AMS) and rel 1e-8 with a floor of
    1e-12·‖r0‖ (ADS)."""
    A, st, sj = _aux(kind, mesh, jax_mesh)
    n = A.shape[0]
    assert st.A.shape == sj.A.shape and st.A.offsets == sj.A.offsets
    assert [lv.A.shape for lv in st.bpi_state.levels] == \
        [lv.A.shape for lv in sj.bpi_state.levels]
    bh = A @ np.linspace(0.2, 1.0, n)
    b = pad_vector(bh, st.A.shape[0], mesh)
    out = pcg_core(st.A.matvec, lambda r: _ams_apply(st, r), b,
                   torch.zeros_like(b), 1e-8, 0.0, 300, True, 0)
    it, hist = out[1], out[4][:out[1] + 1]
    it_j, hist_j = _jax_solve("pcg", sj.A, jax_ams_apply, sj,
                              jax_pad(bh, sj.A.shape[0], jax_mesh), 1e-8,
                              300)
    assert it == it_j
    if kind == "ams":
        assert np.abs(hist / hist[0] - hist_j / hist_j[0]).max() <= 1e-4
    else:
        assert _close(hist, hist_j, 1e-8, 1e-12)
    x = out[0].numpy()[:n]
    assert np.linalg.norm(bh - A @ x) <= 1e-6 * np.linalg.norm(bh)


# MULTICHIP_r05.json: dryrun_multichip(8) on 8 virtual devices
DRYRUN_ITERS = {"pcg_amg": 6, "gmres_mgr": 5, "bicgstab_bj_ilu": 12}
DRYRUN_BOUND = {"pcg_amg": 1e-6, "gmres_mgr": 1e-5, "bicgstab_bj_ilu": 1e-5}


@pytest.fixture(scope="module")
def dryrun(mesh):
    return {s["stack"]: s for s in dryrun_multichip(mesh)}


@pytest.mark.parametrize("stack", sorted(DRYRUN_ITERS))
def test_dryrun_stacks(stack, dryrun):
    """The three stacks of __graft_entry__.dryrun_multichip(8) on the
    port's mesh: the JAX package's 6, 5 and 12 iterations, each within
    the dryrun's residual bound."""
    s = dryrun[stack]
    assert s["converged"] and s["iters"] == DRYRUN_ITERS[stack]
    assert s["rel"] < DRYRUN_BOUND[stack]


def test_make_mesh_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HypredrvError) as exc:
        make_mesh(8)
    assert exc.value.code == ErrorCode.EXTERNAL
    m = make_mesh(device="cpu")
    assert (m.n_shards, m.device) == (1, torch.device("cpu"))
    with pytest.raises(HypredrvError):
        make_mesh(0, device="cpu")


def test_parallel_imports_no_jax():
    """With jax and the JAX package made unimportable, the distributed
    layer imports and runs a halo-exchanging matvec."""
    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "hypredrive_tpu"):
                    raise ImportError(f"blocked: {name}")
        sys.meta_path.insert(0, Block())
        import numpy as np
        import hypredrive_tpu_torch.parallel as par
        import hypredrive_tpu_torch.parallel.dist_setup
        import hypredrive_tpu_torch.parallel.dist_precon
        import hypredrive_tpu_torch.parallel.dryrun
        from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
        mesh = par.make_mesh(8, device="cpu")
        A = laplacian_3d_7pt(6)
        D = par.DistEllMatrix.from_csr(A, mesh)
        y = D.matvec(par.pad_vector(np.ones(216), D.shape[1], mesh))
        assert np.allclose(y.numpy(), A @ np.ones(216))
        assert not any(m.split(".")[0] in ("jax", "hypredrive_tpu")
                       for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
