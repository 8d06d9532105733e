"""The flagship solve step: PCG + AMG on a 16³ Laplacian.

The port of ``__graft_entry__.py::entry`` (the JAX package's "one
jittable PCG+AMG solve step").  :func:`entry` returns ``(fn, args)``:
``fn(*args)`` solves a 16³ (4,096-row) float32 7-point Laplacian with
b = 1 and x0 = 0 by PCG to rtol 1e-6 (at most 50 iterations, the
two-norm test) preconditioned by the default AMG V-cycle, and returns
(x, iters, final norm).  The solve runs through the device loop
(``solvers/device_loop.py``): on the card each PCG iteration is one
replay of a captured CUDA graph and the first call captures them.

    python -m hypredrive_tpu_torch.flagship [--exec-policy host]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .core.entry import add_exec_policy, device


def entry(policy: str = "device"):
    """(fn, example args) of the flagship solve step, on the card unless
    ``policy`` is ``host``."""
    from .config.sections import AMG_SCHEMA
    from .ops.csr import laplacian_3d_7pt
    from .ops.device_matrix import EllMatrix
    from .precon.amg.cycle import amg_apply
    from .precon.amg.hierarchy import setup_hierarchy
    from .solvers.pcg import pcg_core

    dev = device(policy)
    dtype = torch.float32
    A_host = laplacian_3d_7pt(16, dtype=np.float32)   # 4096 rows
    A = EllMatrix.from_csr(A_host, dtype=dtype, device=dev)
    state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(), dtype=dtype,
                            device=dev, fine_matrix=A)
    b = torch.ones(A_host.shape[0], dtype=dtype, device=dev)
    x0 = torch.zeros_like(b)

    def fn(A, state, b, x0):
        x, iters, norm, _, _ = pcg_core(A.matvec,
                                        lambda r: amg_apply(state, r), b,
                                        x0, 1e-6, 0.0, 50, True, 0)
        return x, iters, norm

    return fn, (A, state, b, x0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    fn, fargs = entry(args.exec_policy)
    _, iters, norm = fn(*fargs)
    print("entry: iters", iters, "norm", norm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
