"""Carry the JAX package's objects across to this package, as numpy arrays.

Used by the parity tests: with the same matrix or the same whole AMG
hierarchy on both sides, the two packages' device code can be compared
without any difference from setup.  The argument objects are duck-typed
(``hypredrive_tpu.ops.device_matrix.EllMatrix``,
``hypredrive_tpu.precon.amg.hierarchy.AMGState``); this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.device_matrix import EllMatrix
from .precon.amg.hierarchy import AMGLevel, AMGState


def ell_matrix(E, dtype: torch.dtype = torch.float64,
               device: torch.device = torch.device("cpu")) -> EllMatrix:
    """The JAX package's EllMatrix as this package's, from ``to_csr()`` and
    the same diagonal offsets."""
    out = EllMatrix.from_csr(E.to_csr(), dtype=dtype, device=device,
                             dia_offsets=tuple(E.dia_offsets))
    out.nnz = int(E.nnz)
    return out


def _smoother(kind, arrays, dtype, device):
    if arrays is None:
        return None
    if kind == "chebyshev":
        d_inv, theta, delta, rhos = arrays
        return (torch.tensor(np.array(d_inv), dtype=dtype, device=device),
                float(np.asarray(theta)), float(np.asarray(delta)),
                tuple(float(r) for r in np.asarray(rhos)))
    return tuple(torch.tensor(np.array(a), dtype=dtype, device=device)
                 for a in arrays)


def amg_state(state, dtype: torch.dtype = torch.float64,
              device: torch.device = torch.device("cpu")) -> AMGState:
    """The JAX package's single-device AMGState as this package's."""
    def mat(E):
        return ell_matrix(E, dtype, device) if E is not None else None

    levels = tuple(
        AMGLevel(A=mat(lv.A), P=mat(lv.P), R=mat(lv.R),
                 smooth_arrays=_smoother(lv.smoother, lv.smooth_arrays,
                                         dtype, device),
                 smoother=lv.smoother, pre_sweeps=int(lv.pre_sweeps),
                 post_sweeps=int(lv.post_sweeps),
                 up_smoother=lv.up_smoother,
                 up_arrays=_smoother(lv.up_smoother, lv.up_arrays,
                                     dtype, device))
        for lv in state.levels)
    return AMGState(
        levels=levels,
        coarse_inv=torch.tensor(np.array(state.coarse_inv), dtype=dtype,
                                device=device),
        cycle_type=int(state.cycle_type), max_iter=int(state.max_iter))
