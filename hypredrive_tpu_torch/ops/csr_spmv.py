"""CSR SpMV over the off-diagonal remainder of a device matrix.

Counterpart of ``hypredrive_tpu/ops/pallas_spmv.py``.  The CUDA kernel
(``csrc/csr_spmv.cu``) replaces the f32 gather kernel (``_make_kernel`` /
``_gather_spmv_call``) and its double-single f64 variant (``_make_kernel_ds``
/ ``_gather_spmv_call_ds``): Hopper gathers x per entry and has native
``double``, so the (8, 128) pass plan and the split-f32 arithmetic are not
carried over.  A group of 2-32 lanes owns a row; the kernel is bound by
device-memory bytes, ``sizeof(T) + 4`` per entry plus the x gathers.

:func:`csr_spmv` launches the kernel for a CUDA tensor and runs
:func:`csr_spmv_plain` for a CPU tensor; ``csr_spmv.launches`` counts the
kernel launches.  With ``out`` given both add into it (``out += A·x``),
which makes the hybrid DIA + CSR matvec two launches into one vector.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels


def group_size(nnz: int, n_rows: int) -> int:
    """Lanes per row: the power of two ≥ the mean row length, in 2..32."""
    mean = nnz / max(1, n_rows)
    g = 2
    while g < 32 and g < mean:
        g *= 2
    return g


def csr_spmv_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   data: torch.Tensor, x: torch.Tensor, n_rows: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version: ``index_add_`` of ``data · x[indices]``."""
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), indptr[1:] - indptr[:-1])
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device) \
        if out is None else out
    return y.index_add_(0, rows, data * x[indices.long()])


def _check(indptr, indices, data, x, n_rows, out):
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32:
        raise TypeError("csr_spmv: indptr must be int64 and indices int32")
    if indptr.dim() != 1 or indptr.shape[0] != n_rows + 1:
        raise ValueError(f"csr_spmv: indptr has {indptr.shape[0]} entries "
                         f"for {n_rows} rows")
    if indices.shape != data.shape or x.dim() != 1:
        raise ValueError("csr_spmv: indices/data shapes differ or x not 1-D")
    if data.dtype != x.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"csr_spmv: dtypes {data.dtype}/{x.dtype}; "
                        "float32 or float64 and equal")
    devs = {t.device for t in (indptr, indices, data, x)}
    if out is not None:
        if out.shape != (n_rows,) or out.dtype != x.dtype:
            raise ValueError("csr_spmv: out must be (n_rows,) of x's dtype")
        devs.add(out.device)
    if len(devs) != 1:
        raise ValueError(f"csr_spmv: tensors on several devices {devs}")


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor,
             data: torch.Tensor, x: torch.Tensor, n_rows: int, group: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A_csr · x (or ``out += A_csr · x``); the CUDA kernel on a CUDA
    tensor, else the plain version (CPU).  Column indices must lie in
    ``[0, len(x))``: the device matrix guarantees it at construction."""
    _check(indptr, indices, data, x, n_rows, out)
    if x.device.type == "cpu":
        return csr_spmv_plain(indptr, indices, data, x, n_rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: unsupported device {x.device}")
    tensors = (indptr, indices, data, x) + ((out,) if out is not None else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("csr_spmv: tensors must be contiguous")
    if group not in (2, 4, 8, 16, 32):
        raise ValueError(f"csr_spmv: group {group} not in 2..32 (power of 2)")
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device) \
        if out is None else out
    fn = (kernels.lib().hdtt_csr_spmv_f32 if x.dtype == torch.float32
          else kernels.lib().hdtt_csr_spmv_f64)
    rc = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_rows, group, int(out is not None),
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "csr_spmv")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
