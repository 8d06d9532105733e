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
from hypredrive_tpu_torch.ops.csr_spmv import (TILE_NNZ, TILE_ROWS, csr_spmv,
                                               csr_spmv_plain, csr_tiles)
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


def _tiles(A):
    return torch.from_numpy(csr_tiles(A.indptr))


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
    y = csr_spmv(*_csr_tensors(A, torch.float64), x, 400, _tiles(A),
                 out=base.clone())
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
    y = csr_spmv(*_csr_tensors(B, torch.float64), x, 200, _tiles(B))
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
    tl = _tiles(A)
    with pytest.raises(TypeError):
        csr_spmv(ip.int(), ix, dd, x, 50, tl)             # indptr int32
    with pytest.raises(ValueError):
        csr_spmv(ip, ix, dd, x, 49, tl)                   # row count
    with pytest.raises(ValueError):
        csr_spmv(ip, ix, dd, x, 50, tl, out=torch.zeros(49,
                                                        dtype=torch.float64))
    with pytest.raises(TypeError):
        csr_spmv(ip, ix, dd, x, 50, tl.long())            # tiles int64
    with pytest.raises(ValueError):
        csr_spmv(ip, ix, dd, x, 50, tl[0])                # rows alone
    with pytest.raises(ValueError):
        csr_spmv(ip, ix, dd, x, 50, torch.zeros(2, 53, dtype=torch.int32))
    with pytest.raises(ValueError):
        csr_tiles(A.indptr, tile_nnz=TILE_NNZ + 1)        # above the ring


def _indptr(lengths):
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


_LEN = np.random.default_rng(11)
# row lengths of the partition cases (a rectangular P has its own pattern)
TILE_CASES = {
    "empty_rows": _indptr(np.where(_LEN.random(3000) < 0.4, 0,
                                   _LEN.integers(1, 30, 3000))),
    "one_entry_rows": _indptr(np.ones(2000, np.int64)),       # MGR R0
    "long_row": _indptr([3, 5, 2 * TILE_NNZ + 77, 4, 0, 3 * TILE_NNZ, 9]),
    "one_row": _indptr([40]),
    "a1_like_27": _indptr(np.full(3000, 27)),
    "rectangular_p": _random_csr(1500, 400, 0.008, seed=12).indptr,
}


@pytest.mark.parametrize("tile_nnz,max_rows", [(TILE_NNZ, TILE_ROWS),
                                               (100, 16)])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_csr_tiles_partition(case, tile_nnz, max_rows):
    """Every row in exactly one tile, in order; at most tile_nnz entries
    (or one long row) and max_rows rows a tile."""
    indptr = TILE_CASES[case]
    n = len(indptr) - 1
    t, ent = csr_tiles(indptr, tile_nnz, max_rows)
    assert t.dtype == np.int32 and t[0] == 0 and t[-1] == n
    np.testing.assert_array_equal(ent, indptr[t])
    rows = np.diff(t)
    assert (rows >= 1).all() and (rows <= max_rows).all()
    nnz = indptr[t[1:]] - indptr[t[:-1]]
    assert ((nnz <= tile_nnz) | (rows == 1)).all()
    # greedy: no tile could have taken its successor's first row
    nxt = indptr[np.minimum(t[1:-1] + 1, n)] - indptr[t[:-2]]
    assert ((nxt > tile_nnz) | (rows[:-1] == max_rows)).all()


def _tile_walk(indptr, indices, data, x, tiles, n_threads=256):
    """numpy model of the kernel's sums: per tile (a long row in chunks of
    TILE_NNZ), G lanes a row (G from the tile's row count), each lane
    summing every G-th product, then a shuffle-down tree, chunks added in
    order."""
    y = np.zeros(len(indptr) - 1)
    for r0, r1 in zip(tiles[0, :-1], tiles[0, 1:]):
        tb, te = indptr[r0], indptr[r1]
        g = 32
        while g > 1 and g * (r1 - r0) > n_threads:
            g //= 2
        carry = 0.0
        for c0 in range(tb, max(te, tb + 1), TILE_NNZ):
            c1 = min(te, c0 + TILE_NNZ)
            prod = data[c0:c1] * x[indices[c0:c1]]
            for r in range(r0, r1):
                lo, hi = max(indptr[r], c0) - c0, min(indptr[r + 1], c1) - c0
                lanes = [0.0] * g
                for lane in range(g):
                    for j in range(lo + lane, hi, g):
                        lanes[lane] += prod[j]
                o = g // 2
                while o:
                    for lane in range(o):
                        lanes[lane] += lanes[lane + o]
                    o //= 2
                acc = lanes[0] if c0 == tb else carry + lanes[0]
                if c1 == te:
                    y[r] = acc
                else:
                    carry = acc
    return y


@pytest.mark.parametrize("case", ["long_row", "rectangular_p"])
def test_tile_walk_matches_scipy_and_plain(case):
    """Summed in the kernel's order over its tiles, A·x agrees with scipy
    and with the plain version to float64 rounding (rel 1e-13)."""
    indptr = TILE_CASES[case]
    rng = np.random.default_rng(13)
    n_cols = 400
    indices = rng.integers(0, n_cols, indptr[-1]).astype(np.int32)
    data = rng.standard_normal(indptr[-1])
    A = sp.csr_matrix((data, indices, indptr), shape=(len(indptr) - 1,
                                                      n_cols))
    x = rng.standard_normal(n_cols)
    y = _tile_walk(indptr, indices, data, x, csr_tiles(indptr))
    ref = A @ x
    scale = np.abs(ref).max()
    assert np.abs(y - ref).max() <= 1e-13 * scale
    plain = csr_spmv_plain(torch.from_numpy(indptr),
                           torch.from_numpy(indices),
                           torch.from_numpy(data), torch.from_numpy(x),
                           len(indptr) - 1).numpy()
    assert np.abs(y - plain).max() <= 1e-13 * scale


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises a typed error (no silent fallback)."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "BUILD_ROOT", str(tmp_path))
    with pytest.raises(HypredrvError):
        kernels.build()
