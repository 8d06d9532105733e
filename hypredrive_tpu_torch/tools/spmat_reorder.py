#!/usr/bin/env python
"""Reorder a sparse matrix file (RCM / random / natural) and rewrite it.

The port of ``scripts/spmat_reorder.py``, on the port's own readers and
writers (``io/ij.py``): loads any supported matrix format, applies a
symmetric permutation, and writes the result back in IJ ASCII or binary
form (with the permuted RHS when given).  Bandwidth reduction helps the
locality of the CSR kernel's gathers of x.  It works on the host;
``--exec-policy`` is taken as by every tool (the default needs the card).

Usage:
  python -m hypredrive_tpu_torch.tools.spmat_reorder A.ij -o A_rcm.ij --method rcm
  python -m hypredrive_tpu_torch.tools.spmat_reorder A.bin -b rhs.bin -o out_prefix --binary
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core.entry import add_exec_policy, device


def bandwidth(M) -> int:
    coo = M.tocoo()
    return int(np.abs(coo.row - coo.col).max()) if M.nnz else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matrix")
    ap.add_argument("-b", "--rhs", default=None)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--method", choices=("rcm", "random", "natural"),
                    default="rcm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--binary", action="store_true")
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    device(args.exec_policy)

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from ..io import ij

    A, ilower = ij.read_matrix_auto(args.matrix)
    n = A.shape[0]
    if args.method == "rcm":
        perm = reverse_cuthill_mckee(A, symmetric_mode=True)
    elif args.method == "random":
        perm = np.random.default_rng(args.seed).permutation(n)
    else:
        perm = np.arange(n)

    B = sp.csr_matrix(A[perm][:, perm])
    print(f"{args.matrix}: n={n} nnz={A.nnz} "
          f"bandwidth {bandwidth(A)} -> {bandwidth(B)} ({args.method})")

    if args.binary:
        ij.write_matrix_multipart(args.output, B, n_parts=1)
    else:
        ij.write_matrix_ascii(args.output, B, ilower=ilower)
    if args.rhs:
        rhs = ij.read_vector_auto(args.rhs)[perm]
        out_b = args.output + ".b"
        if args.binary:
            ij.write_vector_multipart(out_b, rhs, n_parts=1)
        else:
            ij.write_vector_ascii(out_b, rhs, ilower=ilower)
        print(f"wrote permuted RHS to {out_b}")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
