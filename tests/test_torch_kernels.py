"""The port's SpMV kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain torch versions; those are held
here against the Pallas kernels in interpret mode (the JAX package's own
CPU oracle), against the JAX package's XLA paths and against scipy, on the
same numpy inputs.  The CUDA kernels themselves are held against the plain
versions by tests/test_torch_cuda.py (on a card) and by ``chip_smoke.py``.

Tolerances: float32 kernels sum in other orders than the Pallas kernels
(the (8, 128) pass plan, the tiled DIA), so they agree to float32 rounding
(rel 1e-5); float64 paths agree to float64 rounding (rel 1e-12 and tighter).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hypredrive_tpu.ops.device_matrix import EllMatrix as JaxEll
from hypredrive_tpu.ops.gather_plan import build_plan
from hypredrive_tpu.ops.pallas_dia import DiaSpMV
from hypredrive_tpu.ops.pallas_spmv import GatherSpMV
from hypredrive_tpu_torch.core.errors import HypredrvError
from hypredrive_tpu_torch.ops import kernels
from hypredrive_tpu_torch.ops.csr_spmv import (csr_spmv, csr_spmv_plain,
                                               group_size)
from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain

torch.set_num_threads(1)

# offset cases of test_pallas_dia_windowed_matches_whole (negative,
# unaligned, all-positive) and a rectangular operator
DIA_CASES = {
    "mixed": (3000, 3000, (-1200, -129, -1, 0, 1, 137, 255)),
    "all_positive": (3000, 3000, (3, 130, 300)),
    "rectangular": (1500, 900, (-400, -7, 0, 5, 300)),
}


def _dia_operator(n_rows, n_cols, offsets, seed=5):
    """(dia (D, n_rows) f64 with zeros outside the columns, scipy CSR)."""
    rng = np.random.default_rng(seed)
    dia = rng.standard_normal((len(offsets), n_rows))
    r = np.arange(n_rows)
    parts = []
    for i, off in enumerate(offsets):
        ok = (r + off >= 0) & (r + off < n_cols)
        dia[i, ~ok] = 0.0
        parts.append(sp.csr_matrix((dia[i, ok], (r[ok], r[ok] + off)),
                                   shape=(n_rows, n_cols)))
    return dia, sp.csr_matrix(sum(parts))


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_plain_matches_pallas_interpret_f32(case):
    n_rows, n_cols, offsets = DIA_CASES[case]
    dia, _ = _dia_operator(n_rows, n_cols, offsets)
    x = np.random.default_rng(1).standard_normal(n_cols).astype(np.float32)
    ds = DiaSpMV(offsets, n_rows, n_cols, jnp.float32, interpret=True)
    assert ds.fits
    y_pl = np.asarray(ds(ds.pad_dia(jnp.asarray(dia, jnp.float32)),
                         jnp.asarray(x)))
    y = dia_spmv_plain(torch.tensor(dia, dtype=torch.float32), offsets,
                       torch.from_numpy(x), n_cols).numpy()
    assert np.abs(y - y_pl).max() <= 1e-5 * np.abs(y_pl).max()


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_plain_matches_jax_xla_f64(case):
    n_rows, n_cols, offsets = DIA_CASES[case]
    dia, A = _dia_operator(n_rows, n_cols, offsets)
    x = np.random.default_rng(2).standard_normal(n_cols)
    E = JaxEll.from_csr(A, dtype=jnp.float64, force_dia_offsets=offsets)
    assert E.dia_offsets == tuple(sorted(offsets)) and not E.has_ell
    y_xla = np.asarray(E.matvec(jnp.asarray(x)))
    order = np.argsort(offsets)
    y = dia_spmv_plain(torch.tensor(dia[order]), tuple(sorted(offsets)),
                       torch.from_numpy(x), n_cols).numpy()
    np.testing.assert_allclose(y, y_xla, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)


def _random_csr(m, n, density, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng, format="csr")
    A.data = rng.standard_normal(A.nnz)
    A.sum_duplicates()
    A.sort_indices()
    return A


def _csr_tensors(A, dtype):
    return (torch.from_numpy(A.indptr.astype(np.int64)),
            torch.from_numpy(A.indices.astype(np.int32)),
            torch.tensor(A.data, dtype=dtype))


CSR_CASES = {"square": (600, 600, 0.01), "tall": (600, 280, 0.01),
             "wide": (280, 600, 0.02)}


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_plain_matches_gather_interpret_f32(case):
    m, n, density = CSR_CASES[case]
    A = _random_csr(m, n, density, seed=3)
    coo = A.tocoo()
    plan = build_plan(coo.row.astype(np.int64), coo.col.astype(np.int64),
                      coo.data.astype(np.float32), m, n)
    op = GatherSpMV(plan, dtype=jnp.float32, interpret=True)
    assert op.use_pallas
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    y_pl = np.asarray(op(jnp.asarray(x)))
    y = csr_spmv_plain(*_csr_tensors(A, torch.float32),
                       torch.from_numpy(x), m).numpy()
    assert np.abs(y - y_pl).max() <= 1e-5 * np.abs(y_pl).max()


def test_csr_plain_matches_double_single_f64():
    """On an operator built as in test_double_single_kernel_interpret_
    accuracy, where the double-single kernel is f64-class (on some small
    random operators it is not: about 1e-8, see ROADMAP.md queue 3)."""
    rng = np.random.default_rng(3)
    n = 1200
    A = sp.random(n, n, density=0.003, random_state=rng, format="csr")
    A.data = A.data * np.exp(rng.uniform(-6, 6, A.nnz))
    A = sp.csr_matrix(A + sp.identity(n))
    A.sum_duplicates()
    A.sort_indices()
    coo = A.tocoo()
    x = rng.standard_normal(n) * np.exp(rng.uniform(-3, 3, n))
    plan = build_plan(coo.row.astype(np.int64), coo.col.astype(np.int64),
                      coo.data.astype(np.float64), n, n)
    op = GatherSpMV(plan, dtype=jnp.float64, interpret=True, force_ds=True)
    assert op.ds
    y_ds = np.asarray(op(jnp.asarray(x)))
    y = csr_spmv_plain(*_csr_tensors(A, torch.float64),
                       torch.from_numpy(x), n).numpy()
    ref = A @ x
    assert np.linalg.norm(y - y_ds) <= 1e-13 * np.linalg.norm(ref)
    assert np.linalg.norm(y - ref) <= 1e-14 * np.linalg.norm(ref)


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_plain_matches_scipy_f64(case):
    m, n, density = CSR_CASES[case]
    A = _random_csr(m, n, density, seed=4)
    x = np.random.default_rng(5).standard_normal(n)
    y = csr_spmv_plain(*_csr_tensors(A, torch.float64),
                       torch.from_numpy(x), m).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)


def test_csr_out_accumulates():
    A = _random_csr(400, 300, 0.02, seed=6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(300))
    base = torch.arange(400, dtype=torch.float64)
    y = csr_spmv(*_csr_tensors(A, torch.float64), x, 400,
                 group_size(A.nnz, 400), out=base.clone())
    np.testing.assert_allclose(y.numpy(), base.numpy() + A @ x.numpy(),
                               rtol=1e-13, atol=1e-13)


def test_wrappers_run_plain_on_cpu_without_counting():
    dia, A = _dia_operator(200, 200, (-10, 0, 3))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(200))
    n_dia, n_csr = dia_spmv.launches, csr_spmv.launches
    y = dia_spmv(torch.from_numpy(dia), (-10, 0, 3), x, 200)
    assert torch.equal(y, dia_spmv_plain(torch.from_numpy(dia), (-10, 0, 3),
                                         x, 200))
    B = _random_csr(200, 200, 0.05, seed=9)
    y = csr_spmv(*_csr_tensors(B, torch.float64), x, 200, 4)
    assert torch.equal(y, csr_spmv_plain(*_csr_tensors(B, torch.float64),
                                         x, 200))
    # launches count kernel launches only, never the plain versions
    assert (dia_spmv.launches, csr_spmv.launches) == (n_dia, n_csr)


def test_wrappers_reject_bad_operands():
    dia = torch.zeros(3, 50, dtype=torch.float64)
    x = torch.zeros(50, dtype=torch.float64)
    with pytest.raises(ValueError):
        dia_spmv(dia, (0, 1), x, 50)                     # D mismatch
    with pytest.raises(ValueError):
        dia_spmv(dia, (0, 1, 2), x[:40], 50)              # x length
    with pytest.raises(TypeError):
        dia_spmv(dia, (0, 1, 2), x.float(), 50)           # dtype
    with pytest.raises(ValueError):
        dia_spmv(torch.zeros(49, 5), tuple(range(49)), torch.zeros(5), 5)
    A = _random_csr(50, 50, 0.1, seed=1)
    ip, ix, dd = _csr_tensors(A, torch.float64)
    with pytest.raises(TypeError):
        csr_spmv(ip.int(), ix, dd, x, 50, 4)              # indptr int32
    with pytest.raises(ValueError):
        csr_spmv(ip, ix, dd, x, 49, 4)                    # row count
    with pytest.raises(ValueError):
        csr_spmv(ip, ix, dd, x, 50, 4, out=torch.zeros(49,
                                                       dtype=torch.float64))


@pytest.mark.parametrize("nnz,rows,g", [(0, 10, 2), (7 * 100, 100, 8),
                                        (4 * 100, 100, 4), (10 ** 6, 10, 32),
                                        (30, 10, 4)])
def test_group_size(nnz, rows, g):
    assert group_size(nnz, rows) == g


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises a typed error (no silent fallback)."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "BUILD_ROOT", str(tmp_path))
    with pytest.raises(HypredrvError):
        kernels.build()
