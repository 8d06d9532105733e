"""Null-space handling: Gram-Schmidt orthonormal basis + gauge fixing.

Counterpart of ``hypredrive_tpu/linsys/nullspace.py`` (ref:
src/internal/linsys.c:438-757; gauge fix applied after solve,
src/HYPREDRV.c:3307-3311).  The basis is built on the host once; the
projection runs on the solution's device.
"""

from __future__ import annotations

import numpy as np
import torch


def orthonormalize(vectors: np.ndarray) -> np.ndarray:
    """Modified Gram-Schmidt columns → orthonormal basis (drops
    numerically dependent columns)."""
    V = np.array(vectors, dtype=np.float64, copy=True)
    if V.ndim == 1:
        V = V[:, None]
    out = []
    for j in range(V.shape[1]):
        v = V[:, j]
        for q in out:
            v = v - np.dot(q, v) * q
        norm = np.linalg.norm(v)
        if norm > 1e-12 * max(1.0, np.linalg.norm(V[:, j])):
            out.append(v / norm)
    return np.stack(out, axis=1) if out else np.zeros((V.shape[0], 0))


def project_nullspace(x: torch.Tensor, basis: np.ndarray) -> torch.Tensor:
    """x ← x − N (Nᵀ x): remove null-space components (gauge fix)."""
    N = torch.as_tensor(basis, dtype=x.dtype, device=x.device)
    return x - N @ (N.T @ x)
