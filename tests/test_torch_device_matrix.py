"""The port's EllMatrix against the JAX package's, on the same matrices.

Both packages choose the same diagonals (same DIA_MIN_FRAC/DIA_MAX_DIAGS
and the same native census).  On the CPU the JAX package stores the rest as
ELL + COO and applies it with XLA gathers, the port as a sorted CSR applied
by the CSR kernel's plain version, and operators of at most 64K elements
are dense in the port only: the two sum in different orders, so matvecs
agree to float64 rounding (rel 1e-13), while the structural results
(offsets, diagonal, to_csr) agree exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hypredrive_tpu.ops.csr import (laplacian_2d_5pt, laplacian_3d_7pt,
                                    laplacian_3d_27pt)
from hypredrive_tpu.ops.device_matrix import EllMatrix as JaxEll
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.ops.device_matrix import (DENSE_MAX_ELEMENTS,
                                                    EllMatrix)

torch.set_num_threads(1)


def _stencil_plus_noise(n=5000, seed=0):
    """A banded operator with scattered entries off the diagonals."""
    rng = np.random.default_rng(seed)
    A = sp.diags([rng.standard_normal(n - abs(o)) for o in (-70, -1, 0, 1, 70)],
                 [-70, -1, 0, 1, 70], shape=(n, n), format="csr")
    R = sp.random(n, n, density=0.0008, random_state=rng, format="csr")
    R.data = rng.standard_normal(R.nnz)
    return sp.csr_matrix(A + R)


def _rectangular(seed=1):
    rng = np.random.default_rng(seed)
    n_r, n_c = 4000, 1500
    r = np.repeat(np.arange(n_r), 3)
    c = np.concatenate([[i // 3, (i // 3 + 1) % n_c, rng.integers(n_c)]
                        for i in range(n_r)])
    return sp.csr_matrix((rng.standard_normal(len(r)), (r, c)),
                         shape=(n_r, n_c))


MATRICES = {
    "lap7_14": lambda: laplacian_3d_7pt(14),
    "lap27_10": lambda: laplacian_3d_27pt(10),
    "lap5_80": lambda: laplacian_2d_5pt(80),
    "stencil_noise": _stencil_plus_noise,
    "rectangular": _rectangular,
    "tiny_dense": lambda: laplacian_3d_7pt(6),
}


@pytest.fixture(params=sorted(MATRICES))
def pair(request):
    A = sp.csr_matrix(MATRICES[request.param]())
    A.sum_duplicates()
    A.sort_indices()
    return (A, JaxEll.from_csr(A, dtype=jnp.float64),
            EllMatrix.from_csr(A, dtype=torch.float64))


def test_same_layout_choice(pair):
    A, J, T = pair
    if A.shape[0] * A.shape[1] <= DENSE_MAX_ELEMENTS:
        assert T.dense is not None and T.dia_data is None
        return
    assert T.dense is None
    assert T.dia_offsets == J.dia_offsets
    if J.dia_data is not None:
        np.testing.assert_array_equal(T.dia_data.numpy(),
                                      np.asarray(J.dia_data))
    n_rest = T.data.numel() if T.data is not None else 0
    dia_nnz = sum(int((np.asarray(J.dia_data)[i] != 0).sum())
                  for i in range(len(J.dia_offsets))) if J.dia_offsets else 0
    assert n_rest + dia_nnz == A.nnz


def test_matvec(pair):
    A, J, T = pair
    x = np.random.default_rng(3).standard_normal(A.shape[1])
    y_t = T.matvec(torch.from_numpy(x)).numpy()
    y_j = np.asarray(J.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-13,
                               atol=1e-13 * np.abs(y_j).max())
    np.testing.assert_allclose(y_t, A @ x, rtol=1e-13,
                               atol=1e-13 * np.abs(y_j).max())


def test_diagonal_and_row_l1(pair):
    A, J, T = pair
    n = min(A.shape)
    np.testing.assert_array_equal(T.diagonal().numpy()[:n],
                                  np.asarray(J.diagonal())[:n])
    np.testing.assert_allclose(T.row_l1_norms().numpy(),
                               np.asarray(J.row_l1_norms()), rtol=1e-14)


def test_to_csr_round_trip(pair):
    A, J, T = pair
    B_t, B_j = T.to_csr(), J.to_csr()
    assert (B_t != B_j).nnz == 0
    np.testing.assert_array_equal(B_t.indptr, B_j.indptr)
    np.testing.assert_array_equal(B_t.indices, B_j.indices)
    np.testing.assert_array_equal(B_t.data, B_j.data)


def test_scale(pair):
    A, J, T = pair
    rng = np.random.default_rng(4)
    sl = rng.uniform(0.5, 2.0, A.shape[0])
    sr = rng.uniform(0.5, 2.0, A.shape[1])
    x = rng.standard_normal(A.shape[1])
    y_t = T.scale(torch.from_numpy(sl), torch.from_numpy(sr)).matvec(
        torch.from_numpy(x)).numpy()
    y_j = np.asarray(J.scale(jnp.asarray(sl), jnp.asarray(sr)).matvec(
        jnp.asarray(x)))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-13,
                               atol=1e-13 * np.abs(y_j).max())


def test_convert_keeps_offsets(pair):
    A, J, T = pair
    C = convert.ell_matrix(J)
    assert C.dia_offsets == T.dia_offsets and C.shape == T.shape
    assert C.nnz == J.nnz
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(A.shape[1]))
    torch.testing.assert_close(C.matvec(x), T.matvec(x), rtol=1e-14,
                               atol=1e-14)


def test_pinned_offsets_and_float32():
    A = laplacian_3d_7pt(12)
    T = EllMatrix.from_csr(A, dtype=torch.float32, dia_offsets=(0, 1, -1))
    assert T.dia_offsets == (-1, 0, 1)
    assert T.data.dtype == torch.float32 and T.indices.dtype == torch.int32
    coo = A.tocoo()
    assert T.data.numel() == int((np.abs(coo.col - coo.row) > 1).sum())
    x = np.random.default_rng(6).standard_normal(A.shape[1]).astype(np.float32)
    y = T.matvec(torch.from_numpy(x)).numpy()
    ref = A @ x.astype(np.float64)
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_empty_operator():
    A = sp.csr_matrix((300, 400))
    T = EllMatrix.from_csr(A)
    assert T.dense is None and T.dia_data is None and T.data is None
    y = T.matvec(torch.ones(400, dtype=torch.float64))
    assert y.shape == (300,) and not y.any()
    assert T.to_csr().nnz == 0
