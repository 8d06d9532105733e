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
