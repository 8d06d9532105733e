"""CSR SpMV over the off-diagonal remainder of a device matrix.

Counterpart of ``hypredrive_tpu/ops/pallas_spmv.py``.  The CUDA kernel
(``csrc/csr_spmv.cu``) replaces the f32 gather kernel (``_make_kernel`` /
``_gather_spmv_call``) and its double-single f64 variant (``_make_kernel_ds``
/ ``_gather_spmv_call_ds_inner``): Hopper gathers x per entry and has
native ``double``, so the (8, 128) pass plan and the split-f32 arithmetic
are not carried over.  The kernel walks tiles of at most ``TILE_NNZ``
entries and ``TILE_ROWS`` rows (:func:`csr_tiles`, built once per matrix on
the host), copying each tile's spans into a shared-memory ring with
asynchronous copies; it is bound by device-memory bytes, ``sizeof(T) + 4``
per entry plus indptr, y and x once.

:func:`csr_spmv` launches the kernel for a CUDA tensor and runs
:func:`csr_spmv_plain` for a CPU tensor; ``csr_spmv.launches`` counts the
kernel launches.  With ``out`` given both add into it (``out += A·x``),
which makes the hybrid DIA + CSR matvec two launches into one vector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import kernels

TILE_NNZ = 1024   # kTileNnz in csrc/csr_spmv.cu: most entries in a tile
TILE_ROWS = 512   # kTileRows: most rows in a tile


def csr_tiles(indptr, tile_nnz: int = TILE_NNZ,
              max_rows: int = TILE_ROWS) -> np.ndarray:
    """The kernel's tile table, int32 of shape (2, n_tiles + 1): the first
    row and the first entry of each tile, then n_rows and nnz.

    Greedy over the rows: a tile takes rows while it holds at most
    ``tile_nnz`` entries and ``max_rows`` rows.  A row with more than
    ``tile_nnz`` entries is a tile of its own (the kernel walks it in
    chunks).  Every row lies in exactly one tile, in order.  The entries
    are stored beside the rows so that the kernel reads its bounds without
    a dependent load."""
    if not (1 <= tile_nnz <= TILE_NNZ and 1 <= max_rows <= TILE_ROWS):
        raise ValueError(f"csr_tiles: tile_nnz {tile_nnz} / max_rows "
                         f"{max_rows} outside 1..{TILE_NNZ} / 1..{TILE_ROWS}")
    indptr = np.asarray(indptr, dtype=np.int64)
    n_rows = len(indptr) - 1
    if max(n_rows, int(indptr[-1])) > np.iinfo(np.int32).max:
        raise ValueError(f"csr_tiles: {n_rows} rows / {indptr[-1]} entries "
                         "exceed int32")
    starts = [0]
    r = 0
    while r < n_rows:
        end = int(np.searchsorted(indptr, indptr[r] + tile_nnz,
                                  side="right")) - 1
        r = min(max(end, r + 1), r + max_rows, n_rows)
        starts.append(r)
    return np.stack([starts, indptr[starts]]).astype(np.int32)


def csr_spmv_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   data: torch.Tensor, x: torch.Tensor, n_rows: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version: ``index_add_`` of ``data · x[indices]``."""
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), indptr[1:] - indptr[:-1])
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device) \
        if out is None else out
    return y.index_add_(0, rows, data * x[indices.long()])


def _check(indptr, indices, data, x, n_rows, tiles, out):
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
    if tiles.dtype != torch.int32:
        raise TypeError(f"csr_spmv: tiles must be int32, not {tiles.dtype}")
    # rows and entries of each tile; each tile holds at least one row
    if tiles.dim() != 2 or tiles.shape[0] != 2 or not (
            min(n_rows, 1) + 1 <= tiles.shape[1] <= n_rows + 1):
        raise ValueError(f"csr_spmv: tiles of shape {tuple(tiles.shape)} "
                         f"for {n_rows} rows")
    devs = {t.device for t in (indptr, indices, data, x, tiles)}
    if out is not None:
        if out.shape != (n_rows,) or out.dtype != x.dtype:
            raise ValueError("csr_spmv: out must be (n_rows,) of x's dtype")
        devs.add(out.device)
    if len(devs) != 1:
        raise ValueError(f"csr_spmv: tensors on several devices {devs}")


def csr_spmv(indptr: torch.Tensor, indices: torch.Tensor,
             data: torch.Tensor, x: torch.Tensor, n_rows: int,
             tiles: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A_csr · x (or ``out += A_csr · x``); the CUDA kernel on a CUDA
    tensor, else the plain version (CPU).  ``tiles`` is
    :func:`csr_tiles` of this ``indptr`` and column indices lie in
    ``[0, len(x))``: the device matrix guarantees both at construction."""
    _check(indptr, indices, data, x, n_rows, tiles, out)
    if x.device.type == "cpu":
        return csr_spmv_plain(indptr, indices, data, x, n_rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: unsupported device {x.device}")
    tensors = (indptr, indices, data, x, tiles) \
        + ((out,) if out is not None else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("csr_spmv: tensors must be contiguous")
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device) \
        if out is None else out
    fn = (kernels.lib().hdtt_csr_spmv_f32 if x.dtype == torch.float32
          else kernels.lib().hdtt_csr_spmv_f64)
    rc = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_rows, tiles.data_ptr(),
            tiles.shape[1] - 1, int(out is not None),
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "csr_spmv")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
