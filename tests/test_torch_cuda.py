"""The CUDA kernels and the device path on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one (a CUDA kernel has no CPU mode; its plain version is what the
CPU tests check against the JAX package).  This file imports neither JAX
nor the JAX package, so on a machine with a card it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the kernels and their plain versions sum in different orders
(lane-parallel shuffles against torch's reductions), so they agree to
float32 rounding (rel 1e-5) or float64 rounding (rel 1e-12).  The CSR
kernel sums in a fixed order, so a repeat launch is bit-identical.
"""

import contextlib
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hypredrive_tpu_torch
from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
from hypredrive_tpu_torch.ops.csr_spmv import (TILE_NNZ, csr_spmv,
                                               csr_spmv_plain, csr_tiles)
from hypredrive_tpu_torch.ops.device_matrix import EllMatrix
from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
from hypredrive_tpu_torch.solvers.bicgstab import bicgstab_core
from hypredrive_tpu_torch.solvers.fgmres import fgmres_core
from hypredrive_tpu_torch.solvers.gmres import gmres_core
from hypredrive_tpu_torch.solvers.pcg import pcg_core

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = sorted(TOL, key=str)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(y, ref, dtype):
    return float((y - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())


DIA_CASES = {
    "mixed": (3000, 3000, (-1200, -129, -1, 0, 1, 137, 255)),
    "all_positive": (3000, 3000, (3, 130, 300)),
    "rectangular": (1500, 900, (-400, -7, 0, 5, 300)),
    "max_diags": (5000, 5000, tuple(range(-24, 24))),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_kernel_matches_plain(dev, dtype, case):
    n_rows, n_cols, offsets = DIA_CASES[case]
    rng = np.random.default_rng(1)
    dia = torch.tensor(rng.standard_normal((len(offsets), n_rows)),
                       dtype=dtype, device=dev)
    x = torch.tensor(rng.standard_normal(n_cols), dtype=dtype, device=dev)
    before = dia_spmv.launches
    y = dia_spmv(dia, offsets, x, n_cols)
    assert dia_spmv.launches == before + 1
    assert _close(y, dia_spmv_plain(dia, offsets, x, n_cols), dtype)


def _lengths_csr(lengths, n_cols, rng):
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = rng.integers(0, n_cols, indptr[-1])
    A = sp.csr_matrix((rng.standard_normal(indptr[-1]), indices, indptr),
                      shape=(len(lengths), n_cols))
    A.sum_duplicates()
    A.sort_indices()
    return A


def _csr_case(case, rng):
    if case in CSR_CASES:
        m, n, density = CSR_CASES[case]
        A = sp.random(m, n, density=density, random_state=rng, format="csr")
        A.data = rng.standard_normal(A.nnz)
        A.sort_indices()
        return A
    # a row longer than a tile, empty rows, 1-entry rows (MGR R0)
    lengths = {"long_row": [5, 3 * TILE_NNZ + 11, 0, 7, 2 * TILE_NNZ, 1],
               "empty_rows": np.where(rng.random(5000) < 0.5, 0,
                                      rng.integers(1, 40, 5000)),
               "one_entry_rows": np.ones(20000, np.int64)}[case]
    return _lengths_csr(lengths, 9000, rng)


CSR_CASES = {"square": (6000, 6000, 0.002), "tall": (6000, 2000, 0.003),
             "wide": (2000, 6000, 0.01), "long_rows": (300, 4000, 0.05)}
CSR_ALL = sorted(CSR_CASES) + ["long_row", "empty_rows", "one_entry_rows"]


@pytest.mark.parametrize("tile_nnz", [64, 256, TILE_NNZ])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CSR_ALL)
def test_csr_kernel_matches_plain(dev, dtype, case, tile_nnz):
    """The tiled kernel at several tile sizes against the plain version,
    writing y and adding into it, and bit-identical on a repeat launch."""
    rng = np.random.default_rng(3)
    A = _csr_case(case, rng)
    m, n = A.shape
    ip = torch.tensor(A.indptr, dtype=torch.int64, device=dev)
    ix = torch.tensor(A.indices, dtype=torch.int32, device=dev)
    dd = torch.tensor(A.data, dtype=dtype, device=dev)
    tl = torch.tensor(csr_tiles(A.indptr, tile_nnz), device=dev)
    x = torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev)
    before = csr_spmv.launches
    y = csr_spmv(ip, ix, dd, x, m, tl)
    ref = csr_spmv_plain(ip, ix, dd, x, m)
    assert _close(y, ref, dtype)
    assert torch.equal(csr_spmv(ip, ix, dd, x, m, tl), y)
    y2 = csr_spmv(ip, ix, dd, x, m, tl, out=torch.ones_like(y))
    assert _close(y2 - 1, ref, dtype)
    assert csr_spmv.launches == before + 3


def test_csr_kernel_unaligned_views(dev):
    """Spans that start off 16-byte words: the operands are views at odd
    element offsets into larger allocations."""
    rng = np.random.default_rng(5)
    A = _csr_case("empty_rows", rng)
    m, n = A.shape
    ip = torch.tensor(A.indptr, dtype=torch.int64, device=dev)
    ix = torch.zeros(A.nnz + 3, dtype=torch.int32, device=dev)[3:]
    ix.copy_(torch.tensor(A.indices, dtype=torch.int32))
    dd = torch.zeros(A.nnz + 1, dtype=torch.float64, device=dev)[1:]
    dd.copy_(torch.tensor(A.data))
    tl = torch.tensor(csr_tiles(A.indptr, 300), device=dev)
    x = torch.tensor(rng.standard_normal(n), device=dev)
    assert _close(csr_spmv(ip, ix, dd, x, m, tl),
                  csr_spmv_plain(ip, ix, dd, x, m), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_hybrid_matvec_on_card_matches_cpu(dev, dtype):
    """DIA launch then CSR launch into the same y, against the CPU path."""
    rng = np.random.default_rng(4)
    A = sp.csr_matrix(laplacian_3d_7pt(24)
                      + sp.random(13824, 13824, density=2e-4,
                                  random_state=rng, format="csr"))
    E_gpu = EllMatrix.from_csr(A, dtype=dtype, device=dev)
    E_cpu = EllMatrix.from_csr(A, dtype=dtype)
    assert E_gpu.dia_data is not None and E_gpu.data is not None
    x = rng.standard_normal(A.shape[1])
    n_dia, n_csr = dia_spmv.launches, csr_spmv.launches
    y = E_gpu.matvec(torch.tensor(x, dtype=dtype, device=dev)).cpu()
    assert (dia_spmv.launches, csr_spmv.launches) == (n_dia + 1, n_csr + 1)
    assert _close(y, E_cpu.matvec(torch.tensor(x, dtype=dtype)), dtype)


def test_ex1_on_card_matches_cpu(dev, monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = os.path.join("examples", "ex1.yml")
    gpu = hypredrive_tpu_torch.solve(config=cfg)
    cpu = hypredrive_tpu_torch.solve(
        options={**_ex1_options(), "general": {"exec_policy": "host"}})
    assert gpu.iters == cpu.iters == 5
    np.testing.assert_allclose(gpu.x, cpu.x, rtol=1e-10, atol=1e-12)


def _ex1_options():
    return {"linear_system": {
        "matrix_filename": "data/ps3d10pt7/np1/IJ.out.A",
        "rhs_filename": "data/ps3d10pt7/np1/IJ.out.b"},
        "solver": "pcg", "preconditioner": "amg"}


def _multiphys2k():
    from hypredrive_tpu_torch.io import ij

    base = os.path.join(REPO, "data", "multiphys2k", "np1")
    A, _ = ij.read_matrix_auto(os.path.join(base, "IJ.out.A"))
    return A, ij.read_dofmap_auto(os.path.join(base, "dofmap.out"))


EX3_MGR = {"level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
                     1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                         "restriction_type": "columped"}},
           "coarsest_level": "amg"}


@pytest.mark.parametrize("cycle", ["v", "w(1,1)"])
def test_mgr_apply_on_card_matches_cpu(dev, cycle):
    """ex3's MGR set up for the card and for the CPU: one cycle on the
    same vector agrees to float64 rounding (rel 1e-12)."""
    from hypredrive_tpu_torch.config.sections import MGR_SCHEMA
    from hypredrive_tpu_torch.precon.mgr import mgr_apply, setup_mgr

    A, dofmap = _multiphys2k()
    args = MGR_SCHEMA.parse(dict(EX3_MGR, cycle=cycle), "mgr", [])
    st_gpu = setup_mgr(A, args, dofmap, torch.float64, device=dev)
    st_cpu = setup_mgr(A, args, dofmap, torch.float64)
    r = np.random.default_rng(6).standard_normal(A.shape[0])
    n_dia, n_csr = dia_spmv.launches, csr_spmv.launches
    z = mgr_apply(st_gpu, torch.tensor(r, device=dev)).cpu()
    assert dia_spmv.launches > n_dia and csr_spmv.launches > n_csr
    assert _close(z, mgr_apply(st_cpu, torch.tensor(r)), torch.float64)


@pytest.mark.parametrize("solver,iters", [("gmres", 9), ("fgmres", 9),
                                          ("bicgstab", 6)])
def test_krylov_mgr_on_card_matches_cpu(dev, solver, iters):
    """ex3's system and MGR under each Krylov method, on the card and on
    the CPU: equal counts, GMRES-family histories to rel 1e-8."""
    A, dofmap = _multiphys2k()
    out = []
    for policy in ("device", "host"):
        drv = hypredrive_tpu_torch.HypreDrive()
        drv.set_library_mode()
        drv.input_args_from_dict({"general": {"exec_policy": policy},
                                  "linear_system": {}, "solver": solver,
                                  "preconditioner": {"mgr": EX3_MGR}})
        drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
        drv.set_dofmap(dofmap)
        drv.set_rhs(np.ones(A.shape[0]))
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        out.append(drv.linear_solver_apply())
    gpu, cpu = out
    assert gpu.iters == cpu.iters == iters
    assert gpu.rel_res_norm <= 1e-6
    if solver != "bicgstab":   # BiCGSTAB's history is chaotic here
        np.testing.assert_allclose(gpu.res_history[:iters + 1],
                                   cpu.res_history[:iters + 1], rtol=1e-8)


@pytest.mark.parametrize("itype", ["bj-ilu0", "bj-ilut", "gmres-iluk",
                                   "nsh-iluk", "ras-iluk"])
def test_ilu_apply_on_card_matches_cpu(dev, itype):
    """Each ILU family set up for the card and for the CPU on multiphys2k:
    one apply on the same vector agrees to float64 rounding (rel 1e-12)."""
    from hypredrive_tpu_torch.config.sections import ILU_SCHEMA
    from hypredrive_tpu_torch.precon.ilu import build_ilu_state, ilu_apply

    A, _ = _multiphys2k()
    args = ILU_SCHEMA.parse({"type": itype}, "ilu", [])
    st_gpu = build_ilu_state(A, args, torch.float64, dev)
    st_cpu = build_ilu_state(A, args, torch.float64)
    r = np.random.default_rng(8).standard_normal(A.shape[0])
    n_dia = dia_spmv.launches
    z = ilu_apply(st_gpu, torch.tensor(r, device=dev)).cpu()
    if itype != "ras-iluk":          # RAS is gathers and one batched solve
        assert dia_spmv.launches > n_dia
    assert _close(z, ilu_apply(st_cpu, torch.tensor(r)), torch.float64)


# examples/ex2.yml's AMG (forward/backward hybrid GS, FSAI on level 0) and
# ex8's symmetric hybrid GS
AMG_SMOOTHERS = {
    "ex2": {"coarsening": {"type": "pmis", "rand_seed": 7919},
            "interpolation": {"max_nnz_row": 4},
            "relaxation": {"down_type": "forward-hl1gs",
                           "up_type": "backward-hl1gs"},
            "smoother": {"type": "fsai", "num_levels": 1, "fsai": {
                "max_step_size": 1, "eig_max_iters": 4,
                "kap_tolerance": 1e-2}}},
    "gs_sym": {"relaxation": {"type": 8, "num_sweeps": 2}},
}


@pytest.mark.parametrize("name", sorted(AMG_SMOOTHERS))
def test_amg_gs_fsai_cycle_on_card_matches_cpu(dev, name):
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy

    A = laplacian_3d_7pt(24)
    args = AMG_SCHEMA.parse(AMG_SMOOTHERS[name], "amg", [])
    st_gpu = setup_hierarchy(A, args, torch.float64, dev)
    st_cpu = setup_hierarchy(A, args, torch.float64)
    assert {lv.smoother for lv in st_gpu.levels} & {"fsai", "gs-fwd",
                                                   "gs-sym"}
    r = np.random.default_rng(9).standard_normal(A.shape[0])
    n_dia, n_csr = dia_spmv.launches, csr_spmv.launches
    z = amg_apply(st_gpu, torch.tensor(r, device=dev)).cpu()
    assert dia_spmv.launches > n_dia and csr_spmv.launches > n_csr
    assert _close(z, amg_apply(st_cpu, torch.tensor(r)), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dist_matvec_8_shards_on_card_matches_plain(dev, dtype):
    """One 8-shard matvec on the card (the halo exchange on the device,
    every shard's DIA and CSR kernels) against the same shards applied by
    the kernels' plain versions on the CPU, on an asymmetric operator."""
    from hypredrive_tpu_torch.ops.csr import convection_diffusion_2d
    from hypredrive_tpu_torch.parallel import (DistEllMatrix, make_mesh,
                                               pad_vector)

    A = sp.csr_matrix(convection_diffusion_2d(256, velocity=(4.0, 2.0)))
    D_gpu = DistEllMatrix.from_csr(A, make_mesh(8, dev), dtype=dtype)
    D_cpu = DistEllMatrix.from_csr(A, make_mesh(8, "cpu"), dtype=dtype)
    x = np.random.default_rng(4).standard_normal(A.shape[0])
    n_dia, n_csr = dia_spmv.launches, csr_spmv.launches
    y = D_gpu.matvec(pad_vector(x, A.shape[0], D_gpu.mesh, dtype)).cpu()
    assert dia_spmv.launches - n_dia == 8
    assert csr_spmv.launches - n_csr == sum(E.data is not None
                                            for E in D_gpu.shards) > 0
    ref = D_cpu.matvec(pad_vector(x, A.shape[0], D_cpu.mesh, dtype))
    assert _close(y, ref, dtype)


# ---------------------------------------------------------------------------
# the device loop: Krylov solves as replayed CUDA graphs
# ---------------------------------------------------------------------------

def _graph_problem(dev, kind):
    """(matvec, precon) on the card: a 24³ Laplacian with the default AMG,
    or multiphys2k with ex3's MGR."""
    if kind == "lap24_amg":
        from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
        from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
        from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy

        A = laplacian_3d_7pt(24)
        st = setup_hierarchy(A, AMG_SCHEMA.defaults(), torch.float64, dev)
        pc = lambda r: amg_apply(st, r)   # noqa: E731
    else:
        from hypredrive_tpu_torch.config.sections import MGR_SCHEMA
        from hypredrive_tpu_torch.precon.mgr import mgr_apply, setup_mgr

        A, dofmap = _multiphys2k()
        st = setup_mgr(A, MGR_SCHEMA.parse(EX3_MGR, "mgr", []), dofmap,
                       torch.float64, device=dev)
        pc = lambda r: mgr_apply(st, r)   # noqa: E731
    E = EllMatrix.from_csr(A, dtype=torch.float64, device=dev)
    b = torch.tensor(np.random.default_rng(8).standard_normal(A.shape[0]),
                     device=dev)
    return E.matvec, pc, b


GRAPH_SOLVES = {
    "pcg": ("lap24_amg", lambda mv, pc, b: pcg_core(
        mv, pc, b, torch.zeros_like(b), 1e-9, 0.0, 100, True, 3)),
    "bicgstab": ("mp2k_mgr", lambda mv, pc, b: bicgstab_core(
        mv, pc, b, torch.zeros_like(b), 1e-8, 0.0, 100)),
    "gmres": ("mp2k_mgr", lambda mv, pc, b: gmres_core(
        mv, pc, b, torch.zeros_like(b), 1e-9, 0.0, 100, 5, False)),
    "fgmres": ("mp2k_mgr", lambda mv, pc, b: fgmres_core(
        mv, pc, b, torch.zeros_like(b), 1e-9, 0.0, 100, 30)),
}


@pytest.mark.parametrize("method", sorted(GRAPH_SOLVES))
def test_device_loop_graphs_match_eager_body(dev, method):
    """The graph replays against the same bodies run eagerly on the card:
    equal counts and kernel launches, histories and x to float64 rounding
    (rel 1e-12; MGR's index_add sums in no fixed order), and a second
    solve (replays of the cached graphs) bit-identical to the first up to
    that order."""
    from hypredrive_tpu_torch.solvers import device_loop as dl

    kind, solve = GRAPH_SOLVES[method]
    mv, pc, b = _graph_problem(dev, kind)
    counters = dl.counted()
    runs = []
    for eager in (True, False, False):
        for f in counters:
            f.launches = 0
        dl.reset_stats()
        with (dl.eager() if eager else contextlib.nullcontext()):
            out = solve(mv, pc, b)
        torch.cuda.synchronize()
        runs.append((out, [f.launches for f in counters], dict(dl.stats)))
    (e, ne, se), (g1, n1, s1), (g2, n2, s2) = runs
    assert se["graph_solves"] == 0 and s1["graph_solves"] == 1
    assert s1["captures"] == 1 and s2["captures"] == 0
    assert s1["max_nodes"] > 0 and s2["replays"] == s1["replays"]
    assert e[1] == g1[1] == g2[1] and e[3] and g1[3]
    assert ne == n1 == n2
    k = e[1] + 1
    for g in (g1, g2):
        np.testing.assert_allclose(g[4][:k], e[4][:k], rtol=1e-12)
        assert _close(g[0], e[0], torch.float64)
    if method == "pcg":      # no atomics on the AMG path: bit-identical
        assert torch.equal(g1[0], g2[0]) and torch.equal(g1[0], e[0])


def test_device_loop_spans_on_the_graph_path(dev):
    """The device loop's spans (``core/trace.py``) on the card: the first
    solve captures (one ``capture`` entry, its seconds ``capture_s``),
    every solve looks its graphs up once, each replay is one ``launch``,
    each flag read but ``read_out`` one ``flag_wait``."""
    from hypredrive_tpu_torch.solvers import device_loop as dl

    mv, pc, b = _graph_problem(dev, "lap24_amg")
    _, solve = GRAPH_SOLVES["pcg"]
    dl.clear()
    dl.reset_stats()
    solve(mv, pc, b)
    first = dict(dl.stats)
    assert first["captures"] == 1 and "capture_n" not in first
    assert first["capture_s"] > 0
    for _ in range(2):
        dl.reset_stats()
        solve(mv, pc, b)
        s = dict(dl.stats)
        assert s["captures"] == 0
        assert s["graph_lookup_n"] == s["read_out_n"] == 1
        assert s["launch_n"] == s["replays"] > 0
        assert s["flag_wait_n"] == s["host_reads"] - 1 > 0
        assert s["launch_s"] > 0 and s["flag_wait_s"] > 0


def _halo_loop(dev):
    """A solve of the device loop whose step body counts what one halo
    send to another rank counts (32 bytes, one message) and stops on a
    device flag after three active steps."""
    from hypredrive_tpu_torch.core.trace import count
    from hypredrive_tpu_torch.solvers import device_loop as dl

    b = torch.zeros(4, device=dev)

    def make():
        L = dl.Loop(b)
        L.b = L.vec(4)
        L.i = L.scalar(torch.int64)
        L.stop = L.flag()

        @L.body("start")
        def start():
            L.i.zero_()
            L.stop.fill_(False)

        @L.body("step")
        def step():
            L.i.add_((~L.stop).long())
            L.stop.copy_(L.i >= 3)
            L.b.add_(1.0)
            count("halo_bytes", 32)
            count("halo_msgs", 1)
        return L

    def schedule(R, L):
        R.go("start")
        R.mark(L.stop)
        for _ in range(10):
            R.go("step")
            R.mark(L.stop)
            if R.stopped():
                break

    L, mode = dl.run(("halo_counter_test",), (), make, {"b": b}, schedule)
    _, _, (i,) = dl.read_out(L.b, [], [L.i], mode)
    return int(i), mode


def test_halo_counters_under_replay_equal_eager(dev):
    """``halo_bytes`` and ``halo_msgs`` count under graph replay as in the
    eager body: a body's share is recorded at capture and added on every
    active replay.  A body that counts a send, and PCG on the one-card
    mesh (8 shards of one card, so no send leaves the rank): graph counts
    equal eager counts, launches included."""
    from hypredrive_tpu_torch.parallel import (DistEllMatrix, make_mesh,
                                               pad_vector)
    from hypredrive_tpu_torch.solvers import device_loop as dl

    runs = []
    for eager in (True, False, False):
        dl.reset_stats()
        with (dl.eager() if eager else contextlib.nullcontext()):
            i, mode = _halo_loop(dev)
        runs.append((i, mode, dl.stats["halo_bytes"], dl.stats["halo_msgs"]))
    assert [r[1] for r in runs] == ["eager", "graph", "graph"]
    assert all(r[0] == 3 and r[2:] == (96, 3) for r in runs), runs

    A = laplacian_3d_7pt(16)
    mesh = make_mesh(8, dev)
    D = DistEllMatrix.from_csr(A, mesh)
    b = pad_vector(np.random.default_rng(6).standard_normal(A.shape[0]),
                   D.shape[0], mesh)
    counters = dl.counted()
    runs = []
    for eager in (True, False, False):
        for f in counters:
            f.launches = 0
        dl.reset_stats()
        with (dl.eager() if eager else contextlib.nullcontext()):
            out = pcg_core(D.matvec, lambda r: r, b, torch.zeros_like(b),
                           1e-8, 0.0, 200, True, 0)
        runs.append((int(out[1]), [f.launches for f in counters],
                     dl.stats["halo_bytes"], dl.stats["halo_msgs"]))
    assert runs[0] == runs[1] == runs[2] and runs[0][1][0] > 0, runs


@pytest.mark.parametrize("m", [30, 50, 300])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_krylov_small_kernels_match_plain(dev, dtype, m):
    """givens_update and hessenberg_backsolve at GMRES(m), j = 0..m-1,
    against their plain versions on the same inputs: bit-identical (both
    round every product and sum, in the same order).  m = 50 is past one
    warp; at m = 300 the float64 triangle is past shared memory and
    streams.  Past m = 50 the back-substitution is held at every 23rd step
    and the last three (its plain version walks m³/6 scalar steps)."""
    from hypredrive_tpu_torch.ops.krylov_small import (
        givens_update, givens_update_plain, hessenberg_backsolve,
        hessenberg_backsolve_plain)

    rng = np.random.default_rng(12)
    state = {d: dict(H=torch.zeros((m + 1, m), dtype=dtype, device=d),
                     cs=torch.zeros(m, dtype=dtype, device=d),
                     sn=torch.zeros(m, dtype=dtype, device=d),
                     g=torch.zeros(m + 1, dtype=dtype, device=d),
                     norm=torch.zeros((), dtype=dtype, device=d),
                     thr=torch.tensor(1e-6, dtype=dtype, device=d),
                     done=torch.zeros((), dtype=torch.bool, device=d),
                     hist=torch.zeros(m + 1, dtype=dtype, device=d),
                     base=torch.zeros((), dtype=torch.int64, device=d),
                     y=torch.zeros(m, dtype=dtype, device=d),
                     count=torch.zeros((), dtype=torch.int64, device=d),
                     on=torch.ones((), dtype=torch.bool, device=d))
             for d in (dev, "cpu")}
    for s in state.values():
        s["g"][0] = 2.5
    solve_at = (set(range(m)) if m <= 50
                else set(range(0, m, 23)) | set(range(m - 3, m)))
    n0 = (givens_update.launches, hessenberg_backsolve.launches)
    for j in range(m):
        col = rng.standard_normal(j + 2)
        for d, s, upd, bsolve in ((dev, state[dev], givens_update,
                                   hessenberg_backsolve),
                                  ("cpu", state["cpu"], givens_update_plain,
                                   hessenberg_backsolve_plain)):
            upd(s["H"], s["cs"], s["sn"], s["g"],
                torch.tensor(col, dtype=dtype, device=d), j, s["on"],
                s["norm"], s["thr"], s["done"], s["hist"], s["base"])
            if j in solve_at:
                s["count"].fill_(j + 1)
                bsolve(s["H"], s["g"], s["y"], s["count"], s["on"])
        for key in ("H", "cs", "sn", "g", "norm", "done", "hist", "y"):
            assert torch.equal(state[dev][key].cpu(), state["cpu"][key]), key
    assert (givens_update.launches, hessenberg_backsolve.launches) == (
        n0[0] + m, n0[1] + len(solve_at))


# (dtype, m, n): the whole triangle in shared memory (f32 m = 64, f64
# m = 200 with n < m), the triangle streamed through two buffers (f32
# m = 400, f64 m = 300), and y in device memory as well (m past a quarter of
# the 227 KB of shared memory); n = jcount rows solved
BACKSOLVE_MODES = [(torch.float32, 64, 64), (torch.float64, 200, 150),
                   (torch.float32, 400, 400), (torch.float64, 300, 300),
                   (torch.float32, 15000, 300), (torch.float64, 7400, 200)]


@pytest.mark.parametrize("dtype,m,n", BACKSOLVE_MODES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_backsolve_staging_modes_match_plain(dev, dtype, m, n):
    """The back-substitution in each staging mode: bit-identical to the
    plain version (with a zero pivot to skip), zero past n, the same from a
    replayed CUDA graph, and zeros when masked."""
    from hypredrive_tpu_torch.ops.krylov_small import (
        hessenberg_backsolve, hessenberg_backsolve_plain)

    rng = np.random.default_rng(m)
    lead = rng.standard_normal((n + 1, n)) / n
    lead[np.arange(n), np.arange(n)] = 1.0 + rng.random(n)
    lead[n // 3, n // 3] = 0.0
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    H[:n + 1, :n] = torch.tensor(lead, dtype=dtype)
    g = torch.tensor(rng.standard_normal(m + 1), dtype=dtype, device=dev)
    count = torch.tensor(n, device=dev)
    on = torch.tensor(True, device=dev)
    y = torch.full((m,), 7.0, dtype=dtype, device=dev)
    hessenberg_backsolve(H, g, y, count, on)
    want = torch.zeros(n, dtype=dtype)
    hessenberg_backsolve_plain(H[:n + 1, :n].cpu(), g[:n + 1].cpu(), want,
                               torch.tensor(n), torch.tensor(True))
    assert torch.equal(y[:n].cpu(), want) and not y[n:].any()
    y2 = torch.full((m,), 7.0, dtype=dtype, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hessenberg_backsolve(H, g, y2, count, on)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y2, y)
    hessenberg_backsolve(H, g, y2, count, torch.tensor(False, device=dev))
    assert not y2.any()


@pytest.mark.parametrize("dtype,m", [(torch.float32, 20000),
                                     (torch.float64, 10000)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_givens_in_device_memory_matches_plain(dev, dtype, m):
    """givens_update at j = m - 1 where its column and rotations (3 j + 10
    entries) do not fit in shared memory and stay in device memory:
    bit-identical to the plain version; nothing written when masked."""
    from hypredrive_tpu_torch.ops.krylov_small import (givens_update,
                                                       givens_update_plain)

    j = m - 1
    rng = np.random.default_rng(j)
    theta = rng.uniform(0, 2 * np.pi, m)
    vals = dict(cs=np.cos(theta), sn=np.sin(theta),
                g=rng.standard_normal(m + 1), col=rng.standard_normal(j + 2))
    st = {}
    for d in (dev, "cpu"):
        s = {k: torch.tensor(v, dtype=dtype, device=d)
             for k, v in vals.items()}
        # only column j is read or written: the plain version gets that
        # column's rows
        s["H"] = torch.zeros((m + 1, m) if d != "cpu" else (j + 2, j + 1),
                             dtype=dtype, device=d)
        s.update(norm=torch.zeros((), dtype=dtype, device=d),
                 thr=torch.tensor(1e-6, dtype=dtype, device=d),
                 done=torch.zeros((), dtype=torch.bool, device=d),
                 hist=torch.zeros(m + 1, dtype=dtype, device=d),
                 base=torch.zeros((), dtype=torch.int64, device=d),
                 on=torch.ones((), dtype=torch.bool, device=d))
        st[d] = s
    args = lambda s: (s["H"], s["cs"], s["sn"], s["g"], s["col"], j,  # noqa
                      s["on"], s["norm"], s["thr"], s["done"], s["hist"],
                      s["base"])
    givens_update(*args(st[dev]))
    givens_update_plain(*args(st["cpu"]))
    a, b = st[dev], st["cpu"]
    assert torch.equal(a["H"][:, j].cpu(), b["H"][:, j])
    for key in ("cs", "sn", "g", "norm", "done", "hist"):
        assert torch.equal(a[key].cpu(), b[key]), key
    snap = {k: v.clone() for k, v in a.items()}
    a["on"].fill_(False)
    givens_update(*args(a))
    assert all(torch.equal(a[k], snap[k]) for k in snap if k != "on")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernels_launch_on_their_tensors_card(dtype):
    """With cuda:0 current, the DIA, CSR, Givens and back-substitution
    kernels on cuda:1 tensors launch there (the wrappers make the
    operands' card current around each launch; the CSR grid is sized for
    that card) and agree with their plain versions; the current card
    stays cuda:0.  Needs two cards."""
    from hypredrive_tpu_torch.ops.krylov_small import (
        givens_update, givens_update_plain, hessenberg_backsolve,
        hessenberg_backsolve_plain)

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    A = sp.random(4000, 4000, density=0.002, random_state=3, format="csr")
    A = sp.csr_matrix(A + laplacian_3d_7pt(16)[:4000, :4000])
    E = EllMatrix.from_csr(A, dtype=dtype, device=d1)
    assert E.dia_data is not None and E.data is not None
    x = torch.tensor(np.random.default_rng(4).standard_normal(4000),
                     dtype=dtype)
    y = E.matvec(x.to(d1))
    assert y.device == d1
    ref = EllMatrix.from_csr(A, dtype=dtype, device="cpu").matvec(x)
    assert _close(y.cpu(), ref, dtype)
    m = 30
    rng = np.random.default_rng(5)
    state = {d: dict(H=torch.zeros((m + 1, m), dtype=dtype, device=d),
                     cs=torch.zeros(m, dtype=dtype, device=d),
                     sn=torch.zeros(m, dtype=dtype, device=d),
                     g=torch.full((m + 1,), 2.5, dtype=dtype, device=d),
                     norm=torch.zeros((), dtype=dtype, device=d),
                     thr=torch.tensor(1e-6, dtype=dtype, device=d),
                     done=torch.zeros((), dtype=torch.bool, device=d),
                     hist=torch.zeros(m + 1, dtype=dtype, device=d),
                     base=torch.zeros((), dtype=torch.int64, device=d),
                     y=torch.zeros(m, dtype=dtype, device=d),
                     count=torch.full((), m, dtype=torch.int64, device=d),
                     on=torch.ones((), dtype=torch.bool, device=d))
             for d in (d1, "cpu")}
    for j in range(m):
        col = rng.standard_normal(j + 2)
        for d, upd in ((d1, givens_update), ("cpu", givens_update_plain)):
            s = state[d]
            upd(s["H"], s["cs"], s["sn"], s["g"],
                torch.tensor(col, dtype=dtype, device=d), j, s["on"],
                s["norm"], s["thr"], s["done"], s["hist"], s["base"])
    for d, bsolve in ((d1, hessenberg_backsolve),
                      ("cpu", hessenberg_backsolve_plain)):
        s = state[d]
        bsolve(s["H"], s["g"], s["y"], s["count"], s["on"])
    torch.cuda.synchronize(d1)
    for key in ("H", "cs", "sn", "g", "y"):
        assert torch.equal(state[d1][key].cpu(), state["cpu"][key]), key
    assert torch.cuda.current_device() == 0


def _epilogue_layout(name, rng):
    """Square (and two rectangular) host matrices whose device form has
    the named parts; ``mixed`` leaves about half the rows with no entry
    in the CSR remainder, ``csr_empty_rows`` half the rows empty."""
    n = 13824
    if name == "dia":
        return laplacian_3d_7pt(24)
    if name == "mixed":
        return sp.csr_matrix(laplacian_3d_7pt(24) + sp.random(
            n, n, density=5e-5, random_state=rng, format="csr"))
    if name == "csr":
        return _csr_case("square", rng)
    if name == "csr_empty_rows":
        return _lengths_csr(np.where(rng.random(6000) < 0.5, 0,
                                     rng.integers(1, 40, 6000)), 6000, rng)
    if name == "csr_long_rows":
        lengths = np.ones(3000, np.int64)
        lengths[[5, 1700]] = (3 * TILE_NNZ + 11, 2 * TILE_NNZ)
        return _lengths_csr(lengths, 3000, rng)
    if name == "rect_mixed":      # a prolongation's shape: DIA and CSR
        return sp.csr_matrix(sp.eye(6000, 2000) + sp.random(
            6000, 2000, density=2e-3, random_state=rng, format="csr"))
    return _csr_case("tall", rng)   # rect_csr


EPILOGUE_LAYOUTS = ("dia", "mixed", "csr", "csr_empty_rows",
                    "csr_long_rows", "rect_mixed", "rect_csr")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout", EPILOGUE_LAYOUTS)
def test_epilogues_equal_the_torch_chain(dev, dtype, layout):
    """Each epilogue (the residual with and without the Chebyshev start,
    the Chebyshev step at a middle and at the last step, with and without
    x, the Jacobi step, the correction x + A·e) against the torch chain
    it replaces, on the same card: bit for bit, every row."""
    from hypredrive_tpu_torch.ops import epilogue as ep
    from hypredrive_tpu_torch.solvers import device_loop as dl

    rng = np.random.default_rng(9)
    A = _epilogue_layout(layout, rng)
    E = EllMatrix.from_csr(A, dtype=dtype, device=dev)
    assert (E.dia_data is not None) == (layout in ("dia", "mixed",
                                                   "rect_mixed"))
    assert (E.data is not None) == (layout != "dia")
    m, n = A.shape

    def vec(k):
        return torch.tensor(rng.standard_normal(k), dtype=dtype,
                            device=dev)

    x, e = vec(m), vec(n)
    pairs = {"add": (lambda: E.matvec_add(x, e),
                     lambda: ep.matvec_add_plain(E, x, e))}
    if m == n:
        b, u, z, d = vec(m), vec(m).abs(), vec(m), vec(m)
        theta, c1, c2 = 1.7, 0.61, 0.93
        r = ep.residual_plain(E, b, x)
        pairs.update({
            "residual": (lambda: E.residual(b, x),
                         lambda: ep.residual_plain(E, b, x)),
            "residual_z0": (lambda: E.residual(b, x, u, theta),
                            lambda: ep.residual_plain(E, b, x, u, theta)),
            "cheby_middle": (lambda: E.cheby_step(r, z, d, u, c1, c2),
                             lambda: ep.cheby_step_plain(E, r, z, d, u,
                                                         c1, c2)),
            "cheby_last_x": (lambda: E.cheby_step(r, z, d, u, c1, c2, x,
                                                  True),
                             lambda: ep.cheby_step_plain(E, r, z, d, u,
                                                         c1, c2, x, True)),
            "cheby_last": (lambda: E.cheby_step(r, z, z, u, c1, c2,
                                                last=True),
                           lambda: ep.cheby_step_plain(E, r, z, z, u, c1,
                                                       c2, last=True)),
            "jacobi": (lambda: E.jacobi_step(x, b, u),
                       lambda: ep.jacobi_step_plain(E, x, b, u))})
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv_epilogue
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv_epilogue

    dl.reset_stats()
    n0 = dia_spmv_epilogue.launches + csr_spmv_epilogue.launches
    for name, (fused, plain) in pairs.items():
        got, want = fused(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            bad = int((g != w).sum())
            assert bad == 0 and torch.equal(g, w), (name, bad)
    assert dl.stats["epilogue_fused"] == len(pairs)
    assert dl.stats["epilogue_plain"] == 0
    # one launch with the epilogue a step, on its own launch counter
    assert (dia_spmv_epilogue.launches + csr_spmv_epilogue.launches
            - n0) == len(pairs)


def _unfused(monkeypatch):
    """The cycles' steps as torch chains on the card: every ``EllMatrix``
    step method takes its plain branch."""
    monkeypatch.setattr(EllMatrix, "_fused", lambda self, x: False)


@pytest.mark.parametrize("relax", ["chebyshev", "l1-jacobi"])
def test_amg_apply_fused_equals_unfused(dev, monkeypatch, relax):
    """One AMG apply on the 32³ Laplacian with the epilogues and with the
    torch chains, on the card: bit-identical."""
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy
    from hypredrive_tpu_torch.solvers import device_loop as dl

    args = AMG_SCHEMA.defaults()
    if relax != "chebyshev":
        args["relaxation"]["down_type"] = args["relaxation"]["up_type"] = 18
    A = laplacian_3d_7pt(32)
    st = setup_hierarchy(A, args, dtype=torch.float64, device=dev)
    assert st.levels[0].smoother == relax
    r = torch.tensor(np.random.default_rng(7).standard_normal(A.shape[0]),
                     device=dev)
    dl.reset_stats()
    z = amg_apply(st, r)
    fused = dl.stats["epilogue_fused"]
    assert fused > 0
    _unfused(monkeypatch)
    z_plain = amg_apply(st, r)
    assert torch.equal(z, z_plain)


def test_mgr_apply_fused_equals_unfused(dev, monkeypatch):
    """ex3's MGR on a 16³ three-field system, with the epilogues and with
    the torch chains, on the card: bit-identical."""
    from hypredrive_tpu_torch.config.sections import MGR_SCHEMA
    from hypredrive_tpu_torch.ops.csr import multiphysics_fv_system
    from hypredrive_tpu_torch.precon.mgr import mgr_apply, setup_mgr
    from hypredrive_tpu_torch.solvers import device_loop as dl

    A, dofmap = multiphysics_fv_system(16, 3, contrast=0.3, coupling=0.12,
                                       convection=0.08)
    args = MGR_SCHEMA.parse(dict(EX3_MGR), "mgr", [])
    st = setup_mgr(A, args, dofmap, torch.float64, device=dev)
    r = torch.tensor(np.random.default_rng(8).standard_normal(A.shape[0]),
                     device=dev)
    dl.reset_stats()
    z = mgr_apply(st, r)
    assert dl.stats["epilogue_fused"] > 0
    _unfused(monkeypatch)
    assert torch.equal(z, mgr_apply(st, r))


def test_epilogue_counts_under_replay_equal_eager(dev):
    """``epilogue_fused`` and ``epilogue_plain`` under graph replay equal
    the eager run's: PCG with the default AMG on 24³, eager, then graph
    (captured), then graph (cached); the solutions bit-identical."""
    from hypredrive_tpu_torch.solvers import device_loop as dl

    mv, pc, b = _graph_problem(dev, "lap24_amg")
    runs = []
    for eager in (True, False, False):
        dl.reset_stats()
        with (dl.eager() if eager else contextlib.nullcontext()):
            out = pcg_core(mv, pc, b, torch.zeros_like(b), 1e-9, 0.0, 100,
                           True, 3)
        torch.cuda.synchronize()
        runs.append((int(out[1]), dl.stats["epilogue_fused"],
                     dl.stats["epilogue_plain"], out[0]))
    assert [r[:3] for r in runs[1:]] == [runs[0][:3]] * 2, runs
    assert runs[0][1] > 0
    assert torch.equal(runs[0][3], runs[1][3])
    assert torch.equal(runs[1][3], runs[2][3])
