"""MatrixMarket I/O (ref: linear_system.type mtx, linsys.c:984-991)."""

from __future__ import annotations

import scipy.sparse as sp
import scipy.io


def read_mtx(path: str) -> sp.csr_matrix:
    A = sp.csr_matrix(scipy.io.mmread(path))
    A.sum_duplicates()
    A.sort_indices()
    return A


def write_mtx(path: str, A: sp.csr_matrix):
    scipy.io.mmwrite(path, A)
