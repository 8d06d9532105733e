#!/usr/bin/env python
"""Sparsity-pattern plot of a matrix file (IJ ASCII/binary/multipart/MTX).

The port of ``scripts/spyplot.py``, on the port's own readers
(``io/ij.py``), so every supported on-disk format works.  It reads on the
host; ``--exec-policy`` is taken as by every tool (the default needs the
card).  The plot needs matplotlib; without it the tool raises
``HypredrvError`` after the summary line.

Usage:
  python -m hypredrive_tpu_torch.tools.spyplot data/ps3d10pt7/np1/IJ.out.A -o spy.png
"""

from __future__ import annotations

import argparse
import os
import sys

from ..core.entry import add_exec_policy, device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("matrix", help="matrix file or multipart prefix")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--markersize", type=float, default=None)
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    device(args.exec_policy)

    from ..io.ij import read_matrix_auto
    from .plot_convergence import pyplot

    A, _ = read_matrix_auto(args.matrix)
    print(f"{args.matrix}: {A.shape[0]} x {A.shape[1]}, {A.nnz} nonzeros "
          f"({A.nnz / A.shape[0]:.1f} per row)")

    plt = pyplot()
    ms = args.markersize or max(0.05, min(2.0, 2e5 / max(A.nnz, 1)))
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.spy(A, markersize=ms, color="#0072B2")
    ax.set_title(os.path.basename(args.matrix))
    out = args.output or os.path.basename(args.matrix) + ".spy.png"
    fig.tight_layout()
    fig.savefig(out, dpi=160)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
