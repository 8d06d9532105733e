"""HYPRE IJ file formats: ASCII, single binary, and multipart binary.

Format parity with the reference readers/writers:

ASCII matrix (``HYPRE_IJMatrixRead`` format): first line
``ilower iupper jlower jupper``, then ``row col value`` lines.
ASCII vector: first line ``ilower iupper``, then ``row value`` lines.

Binary matrix part (ref: src/internal/matrix.c:142-230 and the writer
utils/mat2ijbin.c:420-460): 11×uint64 header

    [0] version (=1)         [1] index byte width (4|8)
    [2] value byte width (4|8) [3] global nrows    [4] global ncols
    [5] global nnz           [6] part nnz
    [7] part row lower       [8] part row upper
    [9] part col lower       [10] part col upper

followed by rows[nnz], cols[nnz] (width per [1]) and vals[nnz]
(width per [2]), COO order.

Binary vector part (ref: src/internal/vector.c:92-210): 8×uint64 header
with [1]=value byte width and [5]=part nrows, followed by vals[nrows].

Multipart: parts are ``prefix.00000.bin``, ``prefix.00001.bin``, ...
distributed round-robin across readers (ref: matrix.c:183-199).
Non-finite coefficients are rejected (ref: matrix.c IJMatrixReject-
NonfiniteCoefficient).
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..core.errors import HypredrvError, ErrorCode

_IDX = {4: np.int32, 8: np.int64}
_VAL = {4: np.float32, 8: np.float64}

# Allocation guard for fuzzed/corrupt headers (mirrors the reference's
# HYPREDRV_MAX_DECOMPRESSED_BYTES cap, ref: src/internal/comp.c:36): a
# header-advertised dimension may not demand more index memory than this.
_MAX_ALLOC_BYTES = int(os.environ.get("HYPREDRV_MAX_ALLOC_BYTES",
                                      16 << 30))


def _check_dims(nrows: int, ncols: int, path: str, code):
    """Reject absurd header dimensions before any allocation happens."""
    if nrows < 0 or ncols < 0 or nrows > (1 << 31) or ncols > (1 << 31) \
            or 8 * (nrows + ncols + 2) > _MAX_ALLOC_BYTES:
        raise HypredrvError(
            f"implausible dimensions {nrows}x{ncols} advertised by {path}",
            code)


# ---------------------------------------------------------------------------
# ASCII
# ---------------------------------------------------------------------------

def read_matrix_ascii(path: str) -> Tuple[sp.csr_matrix, int]:
    """Read an ASCII IJ matrix; returns (csr, ilower)."""
    if not os.path.exists(path):
        raise HypredrvError(f"matrix file not found: {path}",
                            ErrorCode.FILE_NOT_FOUND)
    from . import native

    try:
        nat = native.read_matrix_ascii(path)
    except ValueError as e:
        raise HypredrvError(str(e), ErrorCode.MATRIX)
    if nat is not None:
        rows, cols, vals, ilower, iupper, jlower, jupper = nat
        rows = rows - ilower
        cols = cols - jlower
    else:
        with open(path) as f:
            first = f.readline().split()
        if len(first) != 4:
            raise HypredrvError(f"bad IJ ASCII header in {path}",
                                ErrorCode.MATRIX)
        ilower, iupper, jlower, jupper = (int(x) for x in first)
        data = np.loadtxt(path, skiprows=1, ndmin=2)
        if data.size == 0:
            rows = cols = np.empty(0, np.int64)
            vals = np.empty(0, np.float64)
        else:
            rows = data[:, 0].astype(np.int64) - ilower
            cols = data[:, 1].astype(np.int64) - jlower
            vals = data[:, 2].astype(np.float64)
        _check_finite(vals, path)
    nrows = iupper - ilower + 1
    ncols = jupper - jlower + 1
    _check_dims(nrows, ncols, path, ErrorCode.MATRIX)
    if len(rows) and (rows.min() < 0 or cols.min() < 0
                      or rows.max() >= nrows or cols.max() >= ncols):
        raise HypredrvError(
            f"matrix entry outside [{ilower},{iupper}]x[{jlower},{jupper}] "
            f"while reading {path}", ErrorCode.MATRIX)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A, ilower


def write_matrix_ascii(path: str, A: sp.csr_matrix, ilower: int = 0):
    A = A.tocoo()
    from . import native

    if native.write_matrix_ascii(
            path, A.row.astype(np.int64) + ilower,
            A.col.astype(np.int64) + ilower, A.data,
            ilower, ilower + A.shape[0] - 1,
            ilower, ilower + A.shape[1] - 1):
        return
    with open(path, "w") as f:
        f.write(f"{ilower} {ilower + A.shape[0] - 1} "
                f"{ilower} {ilower + A.shape[1] - 1}\n")
        for r, c, v in zip(A.row, A.col, A.data):
            f.write(f"{r + ilower} {c + ilower} {v:.15e}\n")


def read_vector_ascii(path: str) -> Tuple[np.ndarray, int]:
    if not os.path.exists(path):
        raise HypredrvError(f"vector file not found: {path}",
                            ErrorCode.FILE_NOT_FOUND)
    from . import native

    try:
        nat = native.read_vector_ascii(path)
    except ValueError as e:
        raise HypredrvError(str(e), ErrorCode.VECTOR)
    if nat is not None:
        return nat
    with open(path) as f:
        first = f.readline().split()
    if len(first) != 2:
        raise HypredrvError(f"bad IJ ASCII vector header in {path}",
                            ErrorCode.VECTOR)
    ilower, iupper = int(first[0]), int(first[1])
    n = iupper - ilower + 1
    _check_dims(n, 0, path, ErrorCode.VECTOR)
    data = np.loadtxt(path, skiprows=1, ndmin=2)
    out = np.zeros(n, np.float64)
    if data.size:
        out[data[:, 0].astype(np.int64) - ilower] = data[:, 1]
    _check_finite(out, path)
    return out, ilower


def write_vector_ascii(path: str, v: np.ndarray, ilower: int = 0):
    from . import native

    if native.write_vector_ascii(path, v, ilower):
        return
    with open(path, "w") as f:
        f.write(f"{ilower} {ilower + len(v) - 1}\n")
        for i, x in enumerate(v):
            f.write(f"{i + ilower} {x:.15e}\n")


# ---------------------------------------------------------------------------
# binary parts
# ---------------------------------------------------------------------------

def read_matrix_binary_part(path: str):
    """Read one binary matrix part → (rows, cols, vals, header dict)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.uint64, count=11)
        if header.size != 11:
            raise HypredrvError(f"could not read header from {path}",
                                ErrorCode.MATRIX)
        version, iw, vw = int(header[0]), int(header[1]), int(header[2])
        if iw not in _IDX:
            raise HypredrvError(f"invalid row/col data type size {iw} at {path}",
                                ErrorCode.MATRIX)
        if vw not in _VAL:
            raise HypredrvError(f"invalid coefficient data type size {vw} at {path}",
                                ErrorCode.MATRIX)
        nnz = int(header[6])
        row_lower, row_upper = int(header[7]), int(header[8])
        if row_upper < row_lower:
            raise HypredrvError(
                f"invalid matrix row range in {path}: "
                f"row_upper ({row_upper}) < row_lower ({row_lower})",
                ErrorCode.MATRIX)
        # validate the advertised nnz against the actual file size before
        # allocating anything (a fuzzed header must not OOM the process)
        payload = os.path.getsize(path) - 11 * 8
        if nnz < 0 or nnz * (2 * iw + vw) > payload:
            raise HypredrvError(
                f"matrix part header advertises {nnz} entries but {path} "
                f"holds only {max(payload, 0)} payload bytes",
                ErrorCode.MATRIX)
        rows = np.fromfile(f, dtype=_IDX[iw], count=nnz).astype(np.int64)
        cols = np.fromfile(f, dtype=_IDX[iw], count=nnz).astype(np.int64)
        vals = np.fromfile(f, dtype=_VAL[vw], count=nnz).astype(np.float64)
    if len(rows) != nnz or len(cols) != nnz or len(vals) != nnz:
        raise HypredrvError(f"truncated matrix part {path}", ErrorCode.MATRIX)
    nrows_g, ncols_g = int(header[3]), int(header[4])
    _check_dims(nrows_g, ncols_g, path, ErrorCode.MATRIX)
    if nnz and (rows.min() < 0 or cols.min() < 0):
        raise HypredrvError(
            f"detected negative matrix index while reading {path}",
            ErrorCode.MATRIX)
    if nnz and (rows.max() >= nrows_g or cols.max() >= ncols_g):
        raise HypredrvError(
            f"detected out-of-bounds matrix entry while reading {path}",
            ErrorCode.MATRIX)
    _check_finite(vals, path)
    meta = {
        "global_nrows": nrows_g, "global_ncols": ncols_g,
        "global_nnz": int(header[5]), "nnz": nnz,
        "row_lower": row_lower, "row_upper": row_upper,
        "col_lower": int(header[9]), "col_upper": int(header[10]),
    }
    return rows, cols, vals, meta


def write_matrix_binary_part(path: str, rows, cols, vals, global_shape,
                             global_nnz, row_range, col_range=None,
                             index_width: int = 8, value_width: int = 8):
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    col_range = col_range or (0, global_shape[1] - 1)
    header = np.array([
        1, index_width, value_width,
        global_shape[0], global_shape[1], global_nnz, len(vals),
        row_range[0], row_range[1], col_range[0], col_range[1],
    ], dtype=np.uint64)
    with open(path, "wb") as f:
        header.tofile(f)
        rows.astype(_IDX[index_width]).tofile(f)
        cols.astype(_IDX[index_width]).tofile(f)
        vals.astype(_VAL[value_width]).tofile(f)


def read_vector_binary_part(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.uint64, count=8)
        if header.size != 8:
            raise HypredrvError(f"could not read header from {path}",
                                ErrorCode.VECTOR)
        vw = int(header[1])
        if vw not in _VAL:
            raise HypredrvError(f"invalid value type size {vw} at {path}",
                                ErrorCode.VECTOR)
        n = int(header[5])
        payload = os.path.getsize(path) - 8 * 8
        if n < 0 or n * vw > payload:
            raise HypredrvError(
                f"vector part header advertises {n} values but {path} "
                f"holds only {max(payload, 0)} payload bytes",
                ErrorCode.VECTOR)
        vals = np.fromfile(f, dtype=_VAL[vw], count=n).astype(np.float64)
    if len(vals) != n:
        raise HypredrvError(f"truncated vector part {path}", ErrorCode.VECTOR)
    _check_finite(vals, path)
    return vals


def write_vector_binary_part(path: str, vals, global_size: Optional[int] = None,
                             ilower: int = 0, value_width: int = 8):
    vals = np.asarray(vals)
    global_size = global_size if global_size is not None else len(vals)
    header = np.array([
        1, value_width, 0, global_size,
        ilower, len(vals), ilower + len(vals) - 1, 0,
    ], dtype=np.uint64)
    with open(path, "wb") as f:
        header.tofile(f)
        vals.astype(_VAL[value_width]).tofile(f)


# ---------------------------------------------------------------------------
# multipart
# ---------------------------------------------------------------------------

def find_parts(prefix: str) -> List[str]:
    """List part files ``prefix.NNNNN.bin`` in order (ref: utils.c:324
    partition counting)."""
    pattern = re.compile(re.escape(os.path.basename(prefix)) + r"\.(\d+)\.bin$")
    dirname = os.path.dirname(prefix) or "."
    parts = []
    for name in os.listdir(dirname) if os.path.isdir(dirname) else []:
        m = pattern.match(name)
        if m:
            parts.append((int(m.group(1)), os.path.join(dirname, name)))
    parts.sort()
    return [p for _, p in parts]


def read_matrix_auto(path: str) -> Tuple[sp.csr_matrix, int]:
    """Resolve ASCII vs binary vs multipart automatically
    (ref: hypredrv_LinearSystemReadMatrix dispatch, linsys.c:869-1006).

    Returns the *global* matrix (single-controller host read; device
    sharding happens downstream).
    """
    if os.path.exists(path) and path.endswith(".bin"):
        rows, cols, vals, meta = read_matrix_binary_part(path)
        A = sp.coo_matrix(
            (vals, (rows, cols)),
            shape=(meta["global_nrows"], meta["global_ncols"])).tocsr()
        A.sort_indices()
        return A, 0
    if os.path.exists(path):
        return read_matrix_ascii(path)
    parts = find_parts(path)
    if not parts:
        # single binary with implicit .bin?
        if os.path.exists(path + ".bin"):
            return read_matrix_auto(path + ".bin")
        raise HypredrvError(f"matrix file not found: {path}",
                            ErrorCode.FILE_NOT_FOUND)
    all_rows, all_cols, all_vals = [], [], []
    shape = None
    for p in parts:
        rows, cols, vals, meta = read_matrix_binary_part(p)
        shape = (meta["global_nrows"], meta["global_ncols"])
        all_rows.append(rows)
        all_cols.append(cols)
        all_vals.append(vals)
    A = sp.coo_matrix(
        (np.concatenate(all_vals),
         (np.concatenate(all_rows), np.concatenate(all_cols))),
        shape=shape).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A, 0


def read_vector_auto(path: str) -> np.ndarray:
    if os.path.exists(path) and path.endswith(".bin"):
        return read_vector_binary_part(path)
    if os.path.exists(path):
        vec, _ = read_vector_ascii(path)
        return vec
    parts = find_parts(path)
    if not parts:
        if os.path.exists(path + ".bin"):
            return read_vector_binary_part(path + ".bin")
        raise HypredrvError(f"vector file not found: {path}",
                            ErrorCode.FILE_NOT_FOUND)
    return np.concatenate([read_vector_binary_part(p) for p in parts])


def write_matrix_multipart(prefix: str, A: sp.csr_matrix, n_parts: int):
    """Write ``prefix.NNNNN.bin`` parts with contiguous row blocks."""
    from ..ops.csr import row_partition

    offsets = row_partition(A.shape[0], n_parts)
    coo = A.tocoo()
    order = np.argsort(coo.row, kind="stable")
    rows, cols, vals = coo.row[order], coo.col[order], coo.data[order]
    starts = np.searchsorted(rows, offsets)
    for p in range(n_parts):
        lo, hi = starts[p], starts[p + 1]
        write_matrix_binary_part(
            f"{prefix}.{p:05d}.bin",
            rows[lo:hi], cols[lo:hi], vals[lo:hi],
            global_shape=A.shape, global_nnz=A.nnz,
            row_range=(int(offsets[p]), int(offsets[p + 1] - 1)),
        )


def write_vector_multipart(prefix: str, v: np.ndarray, n_parts: int):
    from ..ops.csr import row_partition

    offsets = row_partition(len(v), n_parts)
    for p in range(n_parts):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        write_vector_binary_part(
            f"{prefix}.{p:05d}.bin", v[lo:hi],
            global_size=len(v), ilower=lo)


# ---------------------------------------------------------------------------
# dofmap files (one int per row, ASCII or binary parts;
# ref: linsys.c ReadDofmap)
# ---------------------------------------------------------------------------

def read_dofmap_auto(path: str) -> np.ndarray:
    if os.path.exists(path):
        return np.loadtxt(path, dtype=np.int64, ndmin=1)
    parts = find_parts(path)
    if parts:
        out = []
        for p in parts:
            with open(p, "rb") as f:
                header = np.fromfile(f, dtype=np.uint64, count=8)
                n = int(header[5])
                out.append(np.fromfile(f, dtype=np.int32, count=n).astype(np.int64))
        return np.concatenate(out)
    raise HypredrvError(f"dofmap file not found: {path}", ErrorCode.FILE_NOT_FOUND)


def write_dofmap_ascii(path: str, dofmap: np.ndarray):
    np.savetxt(path, np.asarray(dofmap, dtype=np.int64), fmt="%d")


def _check_finite(vals: np.ndarray, path: str):
    if vals.size and not np.isfinite(vals).all():
        raise HypredrvError(
            f"detected non-finite coefficient while reading {path}",
            ErrorCode.MATRIX)
