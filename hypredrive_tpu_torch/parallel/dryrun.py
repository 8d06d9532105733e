"""The three distributed solve stacks of the JAX package's
``__graft_entry__.dryrun_multichip``, on this package's mesh.

1. PCG + AMG with the distributed setup from row-block parts (an nx³
   Laplacian, nx = max(4, round(max(8·n_shards, 512)^(1/3)))), to 1e-8;
2. GMRES(30) + the mesh MGR (F = dof 1 with an AMG F-relaxation, coarsest
   AMG) on the two-field CPR system built from that Laplacian, to 1e-6;
3. BiCGSTAB + block-Jacobi ILU(0) on the same system, to 1e-8;

each with b = ones and x0 = 0.  On 8 shards the JAX package takes 6, 5
and 12 iterations (``MULTICHIP_r05.json``).  The shards may be spread over
any number of ranks that divides their count; every rank runs the same
host setup and returns the same records (x gathered once, on every
rank).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import laplacian_3d_7pt
from .dist_matrix import DistEllMatrix, pad_vector
from .mesh import Mesh


def two_field_system(A_host: sp.csr_matrix):
    """Interleaved pressure/saturation CPR-style system from a scalar
    operator, and its dofmap."""
    nc = A_host.shape[0]
    coo = A_host.tocoo()
    i = np.arange(nc)
    rows = np.concatenate([2 * coo.row, 2 * i + 1, 2 * i + 1, 2 * i])
    cols = np.concatenate([2 * coo.col, 2 * i + 1, 2 * i, 2 * i + 1])
    vals = np.concatenate([coo.data, np.full(nc, 2.0), np.full(nc, 0.3),
                           np.full(nc, 0.1)])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(2 * nc, 2 * nc))
    return A, np.tile([0, 1], nc)


def dryrun_multichip(mesh: Mesh, dtype: torch.dtype = torch.float64
                     ) -> List[Dict]:
    """Run the three stacks; per stack its name, rows, iterations,
    relative residual ‖b − A x‖/√n (host), convergence flag and residual
    history."""
    from ..config.sections import AMG_SCHEMA, MGR_SCHEMA
    from ..precon.amg.cycle import amg_apply
    from ..precon.amg.hierarchy import setup_hierarchy
    from ..precon.ilu import tri_jacobi_apply
    from ..precon.mgr import mgr_apply
    from ..solvers.bicgstab import bicgstab_core
    from ..solvers.gmres import gmres_core
    from ..solvers.pcg import pcg_core
    from .dist_precon import build_bj_ilu_dist, setup_mgr_dist
    from .dist_setup import split_rows

    n_sh = mesh.n_shards
    nx = max(4, round(max(8 * n_sh, 512) ** (1 / 3)))
    A = laplacian_3d_7pt(nx)
    out = []

    def record(name, A, D, result):
        x, iters, _, done, hist = result[:5]
        n = A.shape[0]
        xh = mesh.gather(x)[:n].cpu().numpy()
        out.append({"stack": name, "rows": n, "iters": int(iters),
                    "converged": bool(done),
                    "rel": float(np.linalg.norm(np.ones(n) - A @ xh)
                                 / np.sqrt(n)),
                    "history": [float(h) for h in hist[:iters + 1]]})

    D = DistEllMatrix.from_csr(A, mesh, dtype=dtype)
    st = setup_hierarchy(split_rows(A, n_sh), AMG_SCHEMA.defaults(),
                         dtype=dtype, mesh=mesh)
    b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh, dtype)
    record("pcg_amg", A, D, pcg_core(
        D.matvec, lambda r: amg_apply(st, r), b, torch.zeros_like(b), 1e-8,
        0.0, 50, True, 0, group=mesh.reduce_group))

    A2, dofmap = two_field_system(A)
    parts2 = split_rows(A2, n_sh)
    args = MGR_SCHEMA.parse(
        {"level": {0: {"f_dofs": [1],
                       "f_relaxation": {"amg": {"max_iter": 1}}}},
         "coarsest_level": "amg"}, "mgr", [])
    D2 = DistEllMatrix.from_csr(A2, mesh, dtype=dtype)
    b2 = pad_vector(np.ones(A2.shape[0]), D2.shape[0], mesh, dtype)
    sm = setup_mgr_dist(parts2, args, dofmap, mesh, dtype=dtype)
    record("gmres_mgr", A2, D2, gmres_core(
        D2.matvec, lambda r: mgr_apply(sm, r), b2, torch.zeros_like(b2),
        1e-6, 0.0, 100, 30, False, group=mesh.reduce_group))

    si = build_bj_ilu_dist(parts2, mesh, dtype=dtype)
    record("bicgstab_bj_ilu", A2, D2, bicgstab_core(
        D2.matvec, lambda r: tri_jacobi_apply(si, r), b2,
        torch.zeros_like(b2), 1e-8, 0.0, 200, group=mesh.reduce_group))
    return out
