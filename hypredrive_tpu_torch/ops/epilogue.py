"""The multigrid cycles' vector chains, folded into the SpMV kernels.

Four expressions of a matvec y = A·x that the AMG, MGR and Chebyshev
cycles compute (``precon/amg/cycle.py``, ``precon/mgr.py``,
``precon/chebyshev.py``), each written here as its chain of torch
operations:

- ``residual``: r = b − A·x; with u and θ also z₀ = u ⊙ r / θ, the
  start of a Chebyshev sweep;
- ``cheby_step``: one inner Chebyshev step, rk = u ⊙ (r − A·z),
  d' = c1·d + c2·rk, z' = z + d'; at a sweep's last step x + z' alone;
- ``jacobi_step``: x + u ⊙ (b − A·x), the (ℓ1-)Jacobi and masked
  Jacobi sweeps;
- ``matvec_add``: x + A·e, the coarse-grid correction.

The cycles call them as methods of the level's operator.  An
``EllMatrix`` (``ops/device_matrix.py``) runs, on a card, the matvec whose
last kernel, DIA or CSR, computes the expression per row in registers from
the vectors it reads there and stores only its outputs
(``csrc/spmv_epilogue.cuh``), and counts ``epilogue_fused``; on the CPU
and on a dense operator it runs the torch chain below, the plain version,
and counts ``epilogue_plain`` (``core/trace.py``).  The row-shard mesh's
``DistEllMatrix`` takes the torch chains below as its methods and counts
neither.

The kernels round each operation on its own in the chain's order, so the
fused result equals the chain's on the card bit for bit.  torch divides a
CUDA tensor by a Python scalar as a product with the scalar's reciprocal,
taken in double and rounded to the tensor's type, so the residual's kernel
is handed 1/θ rounded so (:func:`reciprocal`); on the CPU the chain
divides.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

RESIDUAL, CHEBYSHEV, JACOBI, ADD = 1, 2, 3, 4   # hdtt::EpilogueKind


class EpilogueArgs(ctypes.Structure):
    """``hdtt::EpilogueArgs`` of ``csrc/spmv_epilogue.cuh``."""

    _fields_ = [("kind", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("b", ctypes.c_void_p), ("u", ctypes.c_void_p),
                ("x", ctypes.c_void_p), ("d", ctypes.c_void_p),
                ("x2", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("out2", ctypes.c_void_p), ("s0", ctypes.c_double),
                ("s1", ctypes.c_double)]


def reciprocal(theta: float, dtype: torch.dtype) -> float:
    """1/θ as torch forms it to divide a CUDA tensor of ``dtype`` by θ: in
    double, rounded to ``dtype``."""
    if dtype == torch.float32:
        return float(np.float32(1.0 / theta))
    return 1.0 / theta


def args(kind: int, n_rows: int, like: torch.Tensor, s0: float = 0.0,
         s1: float = 0.0, /, **vectors) -> EpilogueArgs:
    """The kernel's arguments: each vector (None or a contiguous 1-D tensor
    of ``n_rows`` entries, of ``like``'s type and card) by its field."""
    for name, v in vectors.items():
        if v is None:
            continue
        if (v.dim() != 1 or v.shape[0] != n_rows or v.dtype != like.dtype
                or v.device != like.device or not v.is_contiguous()):
            raise ValueError(
                f"epilogue: {name} is {tuple(v.shape)} {v.dtype} on "
                f"{v.device}; wants ({n_rows},) {like.dtype} on "
                f"{like.device}, contiguous")
    return EpilogueArgs(kind=kind, s0=s0, s1=s1,
                        **{k: None if v is None else v.data_ptr()
                           for k, v in vectors.items()})


# -- the torch chains (the plain versions) ----------------------------------

def residual_plain(A, b, x, u=None, theta=None):
    r = b - A.matvec(x)
    if u is None:
        return r
    return r, u * r / theta


def cheby_step_plain(A, r, z, d, u, c1, c2, x=None, last=False):
    rk = u * (r - A.matvec(z))
    d = c1 * d + c2 * rk
    z = z + d
    if not last:
        return z, d
    return z if x is None else x + z


def jacobi_step_plain(A, x, b, u):
    return x + u * (b - A.matvec(x))


def matvec_add_plain(A, x, e):
    return x + A.matvec(e)
