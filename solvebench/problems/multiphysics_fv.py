"""The three-field finite-volume system behind the port's ``mgr_64``
path: a frozen copy of ``multiphysics_fv_system`` in
``hypredrive_tpu_torch/ops/csr.py`` as of this benchmark's first
version, so that a later change to the program's generator cannot change
what the benchmark asks it to solve.

A configuration names it as ``"problem": {"kind": "multiphysics_fv",
...}``; the other keys are :func:`build`'s arguments.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def multiphysics_fv_system(nx: int, ndof: int = 3, seed: int = 7,
                           contrast: float = 3.0, coupling: float = 0.6,
                           anisotropy: float = 0.1, convection: float = 2.0
                           ) -> Tuple[sp.csr_matrix, np.ndarray]:
    """``ndof`` interleaved fields on an nx³ finite-volume grid: field 0
    a pressure diffusion with lognormal permeability (log10 σ =
    ``contrast``), harmonic face averages and a vertical ``anisotropy``;
    the other fields upwinded convection, weak diffusion and a mass term;
    cell-local coupling between the fields.  (A, dofmap)."""
    rng = np.random.default_rng(seed)
    nc = nx ** 3
    n = nc * ndof
    logk = contrast * rng.standard_normal((nx, nx, nx))
    layers = contrast * np.sin(np.arange(nx) * 2.3)[None, None, :]
    K = 10.0 ** (logk * 0.5 + layers * 0.5)
    kz_mult = np.full((nx, nx, nx), anisotropy)
    idx = np.arange(nc).reshape(nx, nx, nx)
    rows, cols, vals = [], [], []

    def faces_along(axis, kmult):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, nx - 1)
        hi[axis] = slice(1, nx)
        a = idx[tuple(lo)].ravel()
        b = idx[tuple(hi)].ravel()
        ka = (K * kmult)[tuple(lo)].ravel()
        kb = (K * kmult)[tuple(hi)].ravel()
        return a, b, 2.0 * ka * kb / (ka + kb)

    ones = np.ones((nx, nx, nx))
    faces = [faces_along(0, ones), faces_along(1, ones),
             faces_along(2, kz_mult)]
    diag_p = np.zeros(nc)
    for a, b, t in faces:
        rows += [a * ndof, b * ndof]
        cols += [b * ndof, a * ndof]
        vals += [-t, -t]
        np.add.at(diag_p, a, t)
        np.add.at(diag_p, b, t)
    diag_p += 1e-3 * K.ravel()
    rows.append(np.arange(nc) * ndof)
    cols.append(np.arange(nc) * ndof)
    vals.append(diag_p)
    vel = [convection * rng.standard_normal(3) for _ in range(ndof)]
    for f in range(1, ndof):
        diag_f = np.full(nc, 1.0)
        for ax, (a, b, t) in enumerate(faces):
            v = vel[f][ax]
            upw = max(v, 0.0)
            dnw = max(-v, 0.0)
            d_small = 0.05 * t / (1.0 + t)
            rows += [b * ndof + f, a * ndof + f]
            cols += [a * ndof + f, b * ndof + f]
            vals += [-(upw + d_small), -(dnw + d_small)]
            np.add.at(diag_f, a, upw + d_small)
            np.add.at(diag_f, b, dnw + d_small)
        rows.append(np.arange(nc) * ndof + f)
        cols.append(np.arange(nc) * ndof + f)
        vals.append(diag_f)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    dA = A.diagonal()
    cr, cc, cv = [], [], []
    u = 0.5 + 0.5 * rng.random((nc, ndof))
    cells = np.arange(nc)
    for f in range(1, ndof):
        rf = cells * ndof + f
        rp = cells * ndof
        cr.append(rf)
        cc.append(rp)
        cv.append(-coupling * u[:, f] * np.abs(dA[rf]))
        cr.append(rp)
        cc.append(rf)
        cv.append(-0.15 * coupling * u[:, f] * np.abs(dA[rp])
                  * np.abs(dA[rf]) / (np.abs(dA[rf]) + np.abs(dA[rp])))
        if f + 1 < ndof:
            rg = cells * ndof + f + 1
            cr.append(rg)
            cc.append(rf)
            cv.append(-0.5 * coupling * u[:, f]
                      * np.sqrt(np.abs(dA[rg]) * np.abs(dA[rf])))
    A = A + sp.csr_matrix((np.concatenate(cv),
                           (np.concatenate(cr), np.concatenate(cc))),
                          shape=(n, n))
    A = sp.csr_matrix(A, dtype=np.float64)
    A.sort_indices()
    return A, np.tile(np.arange(ndof), nc).astype(np.int32)


# (A, dofmap) of the system
build = multiphysics_fv_system
