"""mat2ijbin — COO/MatrixMarket ASCII → partitioned IJ binary parts.

Reference analogue: utils/mat2ijbin.c (778 LoC): reads a COO text file
(or .mtx), optionally expands a symmetric lower/upper triangle, validates
nnz, and writes N binary part files consumable by the multipart reader
(src/internal/matrix.c:142 format).

Usage:
    python -m hypredrive_tpu_torch.tools.mat2ijbin INPUT OUTPUT_PREFIX \
        [--parts N] [--symmetric] [--one-based] [--rhs RHS_IN RHS_PREFIX]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.sparse as sp


def read_coo_ascii(path: str, one_based: bool = False):
    """Read 'row col val' text (MTX header lines starting with % skipped).

    MatrixMarket files (banner present) honor their own symmetry and
    size line; bare COO files infer the shape from the max index.
    """
    symmetric = False
    is_mtx = False
    rows, cols, vals = [], [], []
    shape = None
    with open(path) as f:
        first = f.readline()
        if first.startswith("%%MatrixMarket"):
            is_mtx = True
            one_based = True
            symmetric = "symmetric" in first.lower()
            line = f.readline()
            while line.startswith("%"):
                line = f.readline()
            m, n, _nnz = (int(t) for t in line.split()[:3])
            shape = (m, n)
        elif not first.startswith("%"):
            parts = first.split()
            if len(parts) >= 2:
                rows.append(int(parts[0]))
                cols.append(int(parts[1]))
                vals.append(float(parts[2]) if len(parts) > 2 else 1.0)
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            parts = line.split()
            rows.append(int(parts[0]))
            cols.append(int(parts[1]))
            vals.append(float(parts[2]) if len(parts) > 2 else 1.0)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if one_based or is_mtx:
        rows -= 1
        cols -= 1
    if shape is None:
        n = int(max(rows.max(initial=-1), cols.max(initial=-1))) + 1
        shape = (n, n)
    return rows, cols, vals, shape, symmetric


def expand_symmetric(rows, cols, vals):
    """Mirror strictly off-diagonal entries (ref: mat2ijbin.c symmetric
    expansion + validate_nnz:38-58)."""
    off = rows != cols
    return (np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]))


def convert(input_path: str, output_prefix: str, n_parts: int = 1,
            symmetric: bool = False, one_based: bool = False) -> sp.csr_matrix:
    rows, cols, vals, shape, file_sym = read_coo_ascii(input_path, one_based)
    if shape[0] != shape[1]:
        raise ValueError(f"matrix must be square, got {shape}")
    if not np.isfinite(vals).all():
        raise ValueError(f"non-finite coefficients in {input_path}")
    if (rows < 0).any() or (rows >= shape[0]).any() or \
            (cols < 0).any() or (cols >= shape[1]).any():
        raise ValueError(f"out-of-bounds indices in {input_path}")
    if symmetric or file_sym:
        rows, cols, vals = expand_symmetric(rows, cols, vals)
    A = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    from ..io.ij import write_matrix_multipart

    write_matrix_multipart(output_prefix, A, n_parts)
    return A


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mat2ijbin",
        description="COO/MatrixMarket ASCII -> partitioned IJ binary")
    ap.add_argument("input")
    ap.add_argument("output_prefix")
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--symmetric", action="store_true",
                    help="expand a stored triangle to the full matrix")
    ap.add_argument("--one-based", action="store_true",
                    help="input indices are 1-based")
    ap.add_argument("--rhs", nargs=2, metavar=("RHS_IN", "RHS_PREFIX"),
                    help="also convert an ASCII vector")
    args = ap.parse_args(argv)

    A = convert(args.input, args.output_prefix, args.parts,
                args.symmetric, args.one_based)
    print(f"wrote {args.parts} part(s): {A.shape[0]} rows, {A.nnz} nnz")
    if args.rhs:
        from ..io.ij import write_vector_multipart

        v = np.loadtxt(args.rhs[0], dtype=np.float64, ndmin=1)
        if v.ndim > 1:  # 'index value' pairs
            v = v[:, -1]
        write_vector_multipart(args.rhs[1], v, args.parts)
        print(f"wrote rhs: {len(v)} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
