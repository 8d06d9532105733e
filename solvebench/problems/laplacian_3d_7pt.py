"""The 7-point 3-D Laplacian behind the JAX package's ``lap128_f64``
path: a frozen copy of ``laplacian_3d_7pt`` in
``hypredrive_tpu_torch/ops/csr.py`` as of this benchmark's first
version.

A configuration names it as ``"problem": {"kind": "laplacian_3d_7pt",
"nx": ...}``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def laplacian_3d_7pt(nx: int) -> sp.csr_matrix:
    """The 7-point 3-D Laplacian on an nx³ grid, Dirichlet boundaries,
    rows x-fastest (hypre's ``ij -laplacian -n nx nx nx``)."""
    e = np.ones(nx)
    T = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1], format="csr")
    eye = sp.identity(nx)
    A = (sp.kron(sp.kron(eye, eye), T) + sp.kron(sp.kron(eye, T), eye)
         + sp.kron(sp.kron(T, eye), eye))
    A = sp.csr_matrix(A, dtype=np.float64)
    A.sort_indices()
    return A


def build(nx: int) -> Tuple[sp.csr_matrix, None]:
    """(A, no dofmap)."""
    return laplacian_3d_7pt(nx), None
