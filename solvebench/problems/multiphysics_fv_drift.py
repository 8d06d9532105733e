"""A Newton sequence on the three-field finite-volume system behind the
port's ``seq_64`` path: system k is ``multiphysics_fv_system`` of
``multiphysics_fv.py`` with its coupling and convection scaled by

    f_k = 1 + 0.1 sin(2.1 k),

so every system keeps the sparsity pattern of system 0 and stays well
posed, as the systems of one implicit time-stepping run do.

A configuration names it as ``"problem": {"kind":
"multiphysics_fv_drift", ...}``; the other keys are the arguments of
:func:`build` and :func:`sequence`.  The random draws, the pattern and
the terms that do not drift are made once; each system's values are then
the frozen generator's expressions evaluated at its f_k, in its order, so
that system k equals ``multiphysics_fv_system(nx, ndof, seed, contrast,
coupling · f_k, anisotropy, convection · f_k)`` value for value.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp


def drift(k: int) -> float:
    """f_k, the factor on coupling and convection of system k."""
    return 1.0 + 0.1 * np.sin(2.1 * k)


class _Terms:
    """What every system of one sequence shares: the draws of the
    generator's seed, the faces, the pressure block, the pattern, and
    where each entry the generator emits lands in the CSR data."""

    def __init__(self, nx: int, ndof: int, seed: int, contrast: float,
                 anisotropy: float):
        rng = np.random.default_rng(seed)
        nc = nx ** 3
        self.nc, self.ndof, self.n = nc, ndof, nc * ndof
        logk = contrast * rng.standard_normal((nx, nx, nx))
        layers = contrast * np.sin(np.arange(nx) * 2.3)[None, None, :]
        K = 10.0 ** (logk * 0.5 + layers * 0.5)
        kz_mult = np.full((nx, nx, nx), anisotropy)
        idx = np.arange(nc).reshape(nx, nx, nx)

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
        self.faces = [faces_along(0, ones), faces_along(1, ones),
                      faces_along(2, kz_mult)]
        rows, cols, vals = [], [], []
        diag_p = np.zeros(nc)
        for a, b, t in self.faces:
            rows += [a * ndof, b * ndof]
            cols += [b * ndof, a * ndof]
            vals += [-t, -t]
            np.add.at(diag_p, a, t)
            np.add.at(diag_p, b, t)
        diag_p += 1e-3 * K.ravel()
        rows.append(np.arange(nc) * ndof)
        cols.append(np.arange(nc) * ndof)
        vals.append(diag_p)
        self.diag_p, self.pressure_vals = diag_p, vals
        # the draws the generator scales by its convection, and u
        self.z = [rng.standard_normal(3) for _ in range(ndof)]
        self.d_small = [0.05 * t / (1.0 + t) for _, _, t in self.faces]
        for f in range(1, ndof):
            for a, b, _ in self.faces:
                rows += [b * ndof + f, a * ndof + f]
                cols += [a * ndof + f, b * ndof + f]
            rows.append(np.arange(nc) * ndof + f)
            cols.append(np.arange(nc) * ndof + f)
        self.u = 0.5 + 0.5 * rng.random((nc, ndof))
        cells = np.arange(nc)
        for f in range(1, ndof):
            rows += [cells * ndof + f, cells * ndof]
            cols += [cells * ndof, cells * ndof + f]
            if f + 1 < ndof:
                rows.append(cells * ndof + f + 1)
                cols.append(cells * ndof + f)
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        # no entry is emitted twice, so the CSR data is a permutation of
        # the emitted values
        self.order = np.lexsort((c, r))
        r, c = r[self.order], c[self.order]
        if np.any((r[1:] == r[:-1]) & (c[1:] == c[:-1])):
            raise ValueError("the generator emitted an entry twice")
        self.indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(r, minlength=self.n))]
        ).astype(np.int32)
        self.indices = c.astype(np.int32)

    def values(self, coupling: float, convection: float) -> np.ndarray:
        """The CSR data of the system at this coupling and convection: the
        generator's expressions, evaluated in its order."""
        nc, ndof = self.nc, self.ndof
        vals = list(self.pressure_vals)
        dA = np.empty(self.n)
        dA[0::ndof] = self.diag_p
        for f in range(1, ndof):
            vel = convection * self.z[f]
            diag_f = np.full(nc, 1.0)
            for (a, b, _), d_small, v in zip(self.faces, self.d_small, vel):
                upw = max(v, 0.0)
                dnw = max(-v, 0.0)
                vals += [-(upw + d_small), -(dnw + d_small)]
                np.add.at(diag_f, a, upw + d_small)
                np.add.at(diag_f, b, dnw + d_small)
            vals.append(diag_f)
            dA[f::ndof] = diag_f
        u = self.u
        for f in range(1, ndof):
            rf = slice(f, None, ndof)
            rp = slice(0, None, ndof)
            vals.append(-coupling * u[:, f] * np.abs(dA[rf]))
            vals.append(-0.15 * coupling * u[:, f] * np.abs(dA[rp])
                        * np.abs(dA[rf]) / (np.abs(dA[rf]) + np.abs(dA[rp])))
            if f + 1 < ndof:
                rg = slice(f + 1, None, ndof)
                vals.append(-0.5 * coupling * u[:, f]
                            * np.sqrt(np.abs(dA[rg]) * np.abs(dA[rf])))
        return np.concatenate(vals)[self.order]


def sequence(count: int, nx: int, ndof: int = 3, seed: int = 11,
             contrast: float = 0.3, coupling: float = 0.12,
             anisotropy: float = 0.1, convection: float = 0.08
             ) -> Tuple[List[sp.csr_matrix], np.ndarray]:
    """([A_0, …, A_{count−1}], dofmap): system k at coupling · f_k and
    convection · f_k, each a float64 CSR matrix with sorted indices, all
    sharing one ``indptr`` and one ``indices`` array."""
    terms = _Terms(nx, ndof, seed, contrast, anisotropy)
    shape = (terms.n, terms.n)
    systems = []
    for k in range(count):
        f = drift(k)
        systems.append(sp.csr_matrix(
            (terms.values(coupling * f, convection * f), terms.indices,
             terms.indptr), shape=shape, copy=False))
    return systems, np.tile(np.arange(ndof), terms.nc).astype(np.int32)


def build(nx: int, ndof: int = 3, seed: int = 11, contrast: float = 0.3,
          coupling: float = 0.12, anisotropy: float = 0.1,
          convection: float = 0.08) -> Tuple[sp.csr_matrix, np.ndarray]:
    """(system 0, dofmap)."""
    systems, dofmap = sequence(1, nx, ndof, seed, contrast, coupling,
                               anisotropy, convection)
    return systems[0], dofmap
