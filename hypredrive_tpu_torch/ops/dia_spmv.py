"""DIA SpMV: ``y[r] = Σ_d dia[d, r] · x[r + off_d]``.

Counterpart of ``hypredrive_tpu/ops/pallas_dia.py``.  The CUDA kernel
(``csrc/dia_spmv.cu``) replaces both Pallas DIA kernels, the whole-x one
(``_make_dia_kernel`` / ``_dia_matvec_call``) and the windowed one
(``_make_dia_kernel_windowed`` / ``_dia_matvec_call_windowed``): their split
and the ``(D, S, 128)`` tiling follow VMEM capacity, which Hopper does not
share.  Diagonals stay row-contiguous ``(D, n_rows)``, as the device matrix
holds them.  The kernel is bound by device-memory bytes,
``(D + 2) · sizeof(T)`` per row.

:func:`dia_spmv` launches the kernel for a CUDA tensor and runs
:func:`dia_spmv_plain` for a CPU tensor; ``dia_spmv.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import kernels

MAX_DIAGS = 48  # kMaxDiags in csrc/dia_spmv.cu; DIA_MAX_DIAGS caps at it


def dia_spmv_plain(dia: torch.Tensor, offsets: Sequence[int],
                   x: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Plain torch version: shifted slices of a zero-padded x."""
    n_rows = dia.shape[1]
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets) + n_rows - n_cols)
    xp = torch.nn.functional.pad(x, (lo, hi)) if lo or hi else x
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    for i, off in enumerate(offsets):
        y += dia[i] * xp[lo + off:lo + off + n_rows]
    return y


def _check(dia, offsets, x, n_cols):
    if dia.dim() != 2 or x.dim() != 1:
        raise ValueError("dia_spmv: dia must be (D, n_rows) and x 1-D")
    if dia.shape[0] != len(offsets) or not 1 <= len(offsets) <= MAX_DIAGS:
        raise ValueError(f"dia_spmv: {dia.shape[0]} diagonals for "
                         f"{len(offsets)} offsets (1..{MAX_DIAGS})")
    if x.shape[0] != n_cols:
        raise ValueError(f"dia_spmv: x has {x.shape[0]} entries, "
                         f"operator has {n_cols} columns")
    if dia.dtype != x.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_spmv: dtypes {dia.dtype}/{x.dtype}; "
                        "float32 or float64 and equal")
    if dia.device != x.device:
        raise ValueError(f"dia_spmv: dia on {dia.device}, x on {x.device}")


def dia_spmv(dia: torch.Tensor, offsets: Sequence[int], x: torch.Tensor,
             n_cols: int) -> torch.Tensor:
    """y = A_dia · x; the CUDA kernel on a CUDA tensor, else the plain
    version (CPU)."""
    _check(dia, offsets, x, n_cols)
    if x.device.type == "cpu":
        return dia_spmv_plain(dia, offsets, x, n_cols)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: unsupported device {x.device}")
    if not (dia.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv: dia and x must be contiguous")
    n_rows = dia.shape[1]
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int32 * len(offsets))(*offsets)
    fn = (kernels.lib().hdtt_dia_spmv_f32 if x.dtype == torch.float32
          else kernels.lib().hdtt_dia_spmv_f64)
    rc = fn(dia.data_ptr(), ctypes.addressof(offs), len(offsets),
            x.data_ptr(), y.data_ptr(), n_rows, n_cols,
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
