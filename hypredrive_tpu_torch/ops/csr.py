"""Host-side CSR containers and setup-phase sparse algebra.

The reference delegates all sparse storage to hypre ParCSR; here the host
representation is scipy.sparse CSR (setup phase: coarsening, interpolation,
RAP/SpGEMM, factorizations run on host), and the *solve* phase converts to
the device ELL format in :mod:`hypredrive_tpu.ops.device_matrix`.

Matrix generators reproduce the reference datasets that matter for parity
testing: ``ps3d10pt7`` is the standard 7-point 3-D Laplacian on a 10³ grid
(1000 rows / 6400 nnz — see BASELINE ex1), generated bit-identically here
instead of downloaded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def laplacian_3d_7pt(nx: int, ny: Optional[int] = None, nz: Optional[int] = None,
                     dtype=np.float64) -> sp.csr_matrix:
    """7-point 3-D Laplacian with Dirichlet boundaries.

    ``laplacian_3d_7pt(10)`` reproduces the reference's ps3d10pt7 system
    shape: 1000 rows, 6400 nnz (ref: examples/refOutput/ex1.txt).
    Row ordering is x-fastest (i + nx*(j + ny*k)).
    """
    ny = ny or nx
    nz = nz or nx
    ex = np.ones(nx)
    ey = np.ones(ny)
    ez = np.ones(nz)
    Tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1], format="csr")
    Ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1], format="csr")
    Tz = sp.diags([-ez[:-1], 2 * ez, -ez[:-1]], [-1, 0, 1], format="csr")
    Ix, Iy, Iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    A = (sp.kron(sp.kron(Iz, Iy), Tx)
         + sp.kron(sp.kron(Iz, Ty), Ix)
         + sp.kron(sp.kron(Tz, Iy), Ix))
    A = sp.csr_matrix(A, dtype=dtype)
    A.sort_indices()
    return A


def laplacian_2d_5pt(nx: int, ny: Optional[int] = None,
                     dtype=np.float64) -> sp.csr_matrix:
    ny = ny or nx
    ex = np.ones(nx)
    ey = np.ones(ny)
    Tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1], format="csr")
    Ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1], format="csr")
    A = sp.kron(sp.identity(ny), Tx) + sp.kron(Ty, sp.identity(nx))
    A = sp.csr_matrix(A, dtype=dtype)
    A.sort_indices()
    return A


def convection_diffusion_2d(nx: int, ny: Optional[int] = None,
                            eps: float = 1.0e-2,
                            velocity=(1.0, 0.5),
                            dt: float = 0.0,
                            dtype=np.float64) -> sp.csr_matrix:
    """Upwind FD convection-diffusion  −ε∆u + v·∇u (+ u/dt when dt>0)
    on the unit square with Dirichlet boundaries.

    The transient form (dt > 0) is the operator the reference's
    ``convdif`` example driver assembles per timestep
    (ref: examples/src/C_convdif/convdif.c); the steady advection-
    dominated form is what its ``gmres-air.yml`` config targets.
    Row ordering is x-fastest.
    """
    ny = ny or nx
    h = 1.0 / (nx + 1)
    bx, by = float(velocity[0]), float(velocity[1])

    def upwind_1d(n, v):
        """−ε u'' + v u' with first-order upwinding, scaled by 1/h²."""
        e = np.ones(n)
        diff = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
        adv_c = abs(v) * h * e
        lo = -(v + abs(v)) / 2.0 * h * e[:-1]   # sub-diag: −max(v,0)·h
        up = (v - abs(v)) / 2.0 * h * e[:-1]    # super-diag: min(v,0)·h
        adv = sp.diags([lo, adv_c, up], [-1, 0, 1])
        return (eps * diff + adv) / (h * h)

    Ix, Iy = sp.identity(nx), sp.identity(ny)
    A = sp.kron(Iy, upwind_1d(nx, bx)) + sp.kron(upwind_1d(ny, by), Ix)
    if dt > 0:
        A = A + sp.identity(nx * ny) / dt
    A = sp.csr_matrix(A, dtype=dtype)
    A.sort_indices()
    return A


def laplacian_3d_27pt(nx: int, ny: Optional[int] = None, nz: Optional[int] = None,
                      dtype=np.float64) -> sp.csr_matrix:
    """27-point 3-D Laplacian (the reference's lap-27 scaling case,
    ref: docs/usrman-src/performance.rst)."""
    ny = ny or nx
    nz = nz or nx
    # 1-D stencil [1 1 1]; 27-pt operator = 27·I − kron(Sz,Sy,Sx)
    # (center 26, all 26 neighbors −1).
    def ones_tridiag(n):
        e = np.ones(n)
        return sp.diags([e[:-1], e, e[:-1]], [-1, 0, 1], format="csr")

    K = sp.kron(sp.kron(ones_tridiag(nz), ones_tridiag(ny)), ones_tridiag(nx))
    A = sp.diags(np.full(nx * ny * nz, 27.0)) - K
    A = sp.csr_matrix(A, dtype=dtype)
    A.sort_indices()
    return A


def elasticity_3d(nx: int, ny: Optional[int] = None, nz: Optional[int] = None,
                  E: float = 1.0, nu: float = 0.3,
                  dtype=np.float64) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Simple 3-D linear elasticity (Q1 hexahedra, uniform grid).

    Returns (A, coords) with 3 dofs per node interleaved — the multi-dof
    test problem for AMG num_functions/RBM paths (reference analogue:
    examples elasticity driver).  Small and deterministic, not a FEM
    package: one assembled reference element stiffness, summed over cells.
    """
    ny = ny or nx
    nz = nz or nx
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))

    # 2x2x2 Gauss quadrature over the reference hexahedron [-1,1]^3
    g = 1.0 / np.sqrt(3.0)
    pts = np.array([[sx * g, sy * g, sz * g]
                    for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)])
    corners = np.array([[sx, sy, sz]
                        for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)])

    def shape_grads(xi):
        grads = np.zeros((8, 3))
        for a in range(8):
            cx, cy, cz = corners[a]
            grads[a, 0] = cx * (1 + cy * xi[1]) * (1 + cz * xi[2]) / 8.0
            grads[a, 1] = cy * (1 + cx * xi[0]) * (1 + cz * xi[2]) / 8.0
            grads[a, 2] = cz * (1 + cx * xi[0]) * (1 + cy * xi[1]) / 8.0
        return grads

    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[3:, 3:] = np.eye(3) * mu

    Ke = np.zeros((24, 24))
    for q in range(8):
        grads = shape_grads(pts[q])  # (8, 3), unit jacobian (h=2 ref cell)
        B = np.zeros((6, 24))
        for a in range(8):
            gx, gy, gz = grads[a]
            c = 3 * a
            B[0, c] = gx
            B[1, c + 1] = gy
            B[2, c + 2] = gz
            B[3, c] = gy
            B[3, c + 1] = gx
            B[4, c + 1] = gz
            B[4, c + 2] = gy
            B[5, c] = gz
            B[5, c + 2] = gx
        Ke += B.T @ D @ B  # weight 1 per point

    nnx, nny, nnz_ = nx + 1, ny + 1, nz + 1
    nnode = nnx * nny * nnz_

    def node(i, j, k):
        return i + nnx * (j + nny * k)

    rows, cols, vals = [], [], []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                nodes = [node(i + sx, j + sy, k + sz)
                         for sz in (0, 1) for sy in (0, 1) for sx in (0, 1)]
                dofs = np.array([3 * n + d for n in nodes for d in range(3)])
                rows.append(np.repeat(dofs, 24))
                cols.append(np.tile(dofs, 24))
                vals.append(Ke.ravel())
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(3 * nnode, 3 * nnode),
    ).tocsr()

    # Dirichlet-pin the z=0 face to make it SPD
    fixed = np.array([3 * node(i, j, 0) + d
                      for j in range(nny) for i in range(nnx) for d in range(3)])
    keep = np.setdiff1d(np.arange(3 * nnode), fixed)
    # row then column slicing keeps memory linear in nnz (fancy-indexing
    # both at once goes through a dense index grid); dropping the explicit
    # zeros the slicing leaves gives the same stored pattern
    A = sp.csr_matrix(A[keep][:, keep], dtype=dtype)
    A.eliminate_zeros()
    A.sort_indices()

    xs, ys, zs = np.meshgrid(np.arange(nnx), np.arange(nny), np.arange(nnz_),
                             indexing="ij")
    coords = np.stack([
        xs.ravel(order="F"), ys.ravel(order="F"), zs.ravel(order="F")
    ], axis=1).astype(np.float64)
    coords = np.repeat(coords, 3, axis=0)[keep]
    return A, coords


def rigid_body_modes(coords: np.ndarray, ndim: int = 3) -> np.ndarray:
    """Rigid body modes for elasticity near-null-space (ref: AMGSetRBMs,
    src/internal/amg.c:602).  coords: (ndof, ndim) node position per dof,
    dofs interleaved.  Returns (ndof, 6) for 3-D (3 translations +
    3 rotations)."""
    n = coords.shape[0]
    comp = np.arange(n) % ndim
    if ndim == 3:
        rbm = np.zeros((n, 6))
        for d in range(3):
            rbm[comp == d, d] = 1.0
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        # rotation about z: (-y, x, 0)
        rbm[comp == 0, 3] = -y[comp == 0]
        rbm[comp == 1, 3] = x[comp == 1]
        # rotation about x: (0, -z, y)
        rbm[comp == 1, 4] = -z[comp == 1]
        rbm[comp == 2, 4] = y[comp == 2]
        # rotation about y: (z, 0, -x)
        rbm[comp == 0, 5] = z[comp == 0]
        rbm[comp == 2, 5] = -x[comp == 2]
        return rbm
    rbm = np.zeros((n, 3))
    for d in range(2):
        rbm[comp == d, d] = 1.0
    x, y = coords[:, 0], coords[:, 1]
    rbm[comp == 0, 2] = -y[comp == 0]
    rbm[comp == 1, 2] = x[comp == 1]
    return rbm


def multiphysics_block_system(ncell: int, ndof: int = 3, seed: int = 7,
                              coupling: float = 0.1,
                              dtype=np.float64) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Generated multiphysics test system: ``ndof`` interleaved fields on a
    1-D chain of ``ncell`` cells, diffusion per field plus random coupling.

    Standing in for the reference's compflow6k/poromech2k datasets (GEOS
    exports, not shipped — ref: data/README.md); gives the dofmap-driven
    MGR paths a deterministic target.  Returns (A, dofmap) with dofmap[i]
    the field label of row i (ref: dofmap semantics, linsys.h:176-248).
    """
    rng = np.random.default_rng(seed)
    n = ncell * ndof
    blocks = []
    for f in range(ndof):
        scale = 10.0 ** (-f)  # fields at different magnitudes
        # only field 0 is elliptic (pressure-like); the rest are
        # mass-like (strongly diagonally dominant), mirroring the
        # locally-eliminable density/saturation dofs of the reference's
        # compflow-class systems (MGR f_dofs targets)
        off = 1.0 if f == 0 else 0.05
        T = sp.diags(
            [-off * scale * np.ones(ncell - 1),
             2.1 * scale * np.ones(ncell),
             -off * scale * np.ones(ncell - 1)],
            [-1, 0, 1],
        )
        blocks.append(T)
    A = sp.block_diag(blocks, format="csr")
    # interleave: interleaved row t = cell t//ndof, field t%ndof
    # ↔ field-blocked row (t%ndof)*ncell + t//ndof
    t = np.arange(n)
    p = (t % ndof) * ncell + t // ndof
    A = A[np.ix_(p, p)].tolil()
    # random sparse coupling between fields within a cell, scaled
    # geometrically so no field's diagonal is overwhelmed
    couple = rng.uniform(-coupling, coupling, size=(ncell, ndof, ndof))
    for c in range(ncell):
        base = c * ndof
        for a in range(ndof):
            for b in range(ndof):
                if a != b:
                    s_ab = 10.0 ** (-(a + b) / 2.0)
                    A[base + a, base + b] += couple[c, a, b] * s_ab
    A = sp.csr_matrix(A, dtype=dtype)
    A.sort_indices()
    dofmap = np.tile(np.arange(ndof), ncell).astype(np.int32)
    return A, dofmap


def multiphysics_fv_system(nx: int, ndof: int = 3, seed: int = 7,
                           contrast: float = 3.0, coupling: float = 0.6,
                           anisotropy: float = 0.1, convection: float = 2.0,
                           dtype=np.float64
                           ) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Reference-difficulty multiphysics system: ``ndof`` interleaved
    fields on an ``nx³`` finite-volume grid.

    Stands in for the reference's compflow6k / poromech2k GEOS exports
    (Zenodo-only, ref: data/README.md) at their *difficulty* — the
    published goldens take 8-18 GMRES+MGR iterations
    (refOutput/ex3.txt: 8, ex7.txt: 13/18/12/…), which requires

    * high-contrast lognormal permeability (``contrast`` = log10 σ,
      SPE10-class channels) with harmonic face averaging,
    * vertical ``anisotropy`` (kz multiplier),
    * an upwinded convection field on the transported dofs
      (non-symmetric stencils, Péclet ~ ``convection``),
    * strong two-way inter-field coupling (Biot/compressibility-style
      dense cell blocks scaled by ``coupling``) so the MGR Schur
      complement genuinely differs from the pressure block.

    Returns (A, dofmap); field 0 is the elliptic (pressure) dof the MGR
    configs keep coarse, fields 1.. are the eliminable transported dofs.
    """
    rng = np.random.default_rng(seed)
    nc = nx ** 3
    n = nc * ndof

    # lognormal permeability with layered channels (SPE10 flavor)
    logk = contrast * rng.standard_normal((nx, nx, nx))
    layers = contrast * np.sin(np.arange(nx) * 2.3)[None, None, :]
    K = 10.0 ** (logk * 0.5 + layers * 0.5)
    kz_mult = np.full((nx, nx, nx), anisotropy)

    idx = np.arange(nc).reshape(nx, nx, nx)
    rows, cols, vals = [], [], []

    def add_faces(axis, kmult):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(0, nx - 1)
        sl_hi[axis] = slice(1, nx)
        a = idx[tuple(sl_lo)].ravel()
        b = idx[tuple(sl_hi)].ravel()
        ka = (K * kmult)[tuple(sl_lo)].ravel()
        kb = (K * kmult)[tuple(sl_hi)].ravel()
        t = 2.0 * ka * kb / (ka + kb)          # harmonic face perm
        return a, b, t

    ones = np.ones((nx, nx, nx))
    faces = [add_faces(0, ones), add_faces(1, ones), add_faces(2, kz_mult)]

    # field 0: pressure diffusion
    diag_p = np.zeros(nc)
    for a, b, t in faces:
        rows += [a * ndof, b * ndof]
        cols += [b * ndof, a * ndof]
        vals += [-t, -t]
        np.add.at(diag_p, a, t)
        np.add.at(diag_p, b, t)
    diag_p += 1e-3 * K.ravel()                 # compressibility
    rows.append(np.arange(nc) * ndof)
    cols.append(np.arange(nc) * ndof)
    vals.append(diag_p)

    # transported fields: upwind convection + weak diffusion + mass
    vel = [convection * rng.standard_normal(3) for _ in range(ndof)]
    for f in range(1, ndof):
        diag_f = np.full(nc, 1.0)              # mass/time term
        for ax, (a, b, t) in enumerate(faces):
            v = vel[f][ax]
            upw = max(v, 0.0)
            dnw = max(-v, 0.0)
            d_small = 0.05 * t / (1.0 + t)     # weak diffusion
            # upwind flux a -> b
            rows += [b * ndof + f, a * ndof + f]
            cols += [a * ndof + f, b * ndof + f]
            vals += [-(upw + d_small), -(dnw + d_small)]
            np.add.at(diag_f, a, upw + d_small)
            np.add.at(diag_f, b, dnw + d_small)
        rows.append(np.arange(nc) * ndof + f)
        cols.append(np.arange(nc) * ndof + f)
        vals.append(diag_f)

    A = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))

    # cell-local inter-field coupling, GEOS-flavored: the transported
    # fields depend strongly on pressure (flux derivatives), pressure
    # feels a weak feedback (compressibility/mobility) — one-way-
    # dominant, so the cell blocks stay well-conditioned while the MGR
    # Schur complement genuinely differs from the pressure block
    dA = A.diagonal()
    cr, cc, cv = [], [], []
    u = 0.5 + 0.5 * rng.random((nc, ndof))
    cells = np.arange(nc)
    for f in range(1, ndof):
        rf = cells * ndof + f
        rp = cells * ndof
        # transported field f <- pressure (strong)
        cr.append(rf)
        cc.append(rp)
        cv.append(-coupling * u[:, f] * np.abs(dA[rf]))
        # pressure <- field f (weak feedback)
        cr.append(rp)
        cc.append(rf)
        cv.append(-0.15 * coupling * u[:, f] * np.abs(dA[rp])
                  * np.abs(dA[rf]) / (np.abs(dA[rf]) + np.abs(dA[rp])))
        # chain coupling between consecutive transported fields
        if f + 1 < ndof:
            rg = cells * ndof + f + 1
            cr.append(rg)
            cc.append(rf)
            cv.append(-0.5 * coupling * u[:, f]
                      * np.sqrt(np.abs(dA[rg]) * np.abs(dA[rf])))
    A = A + sp.csr_matrix(
        (np.concatenate(cv), (np.concatenate(cr), np.concatenate(cc))),
        shape=(n, n))
    A = sp.csr_matrix(A, dtype=dtype)
    A.sort_indices()
    dofmap = np.tile(np.arange(ndof), nc).astype(np.int32)
    return A, dofmap


# ---------------------------------------------------------------------------
# small CSR helpers used by setup-phase algorithms
# ---------------------------------------------------------------------------

def csr_from_coo(rows, cols, vals, shape, dtype=np.float64) -> sp.csr_matrix:
    A = sp.coo_matrix((np.asarray(vals, dtype=dtype),
                       (np.asarray(rows), np.asarray(cols))), shape=shape).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def row_partition(n_rows: int, n_parts: int) -> np.ndarray:
    """Contiguous block-row partition offsets (ParCSR-style), length
    n_parts+1."""
    base = n_rows // n_parts
    rem = n_rows % n_parts
    sizes = np.full(n_parts, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def max_row_nnz(A: sp.csr_matrix) -> int:
    return int(np.diff(A.indptr).max(initial=0))


# -- structured-grid incidence operators (AMS/ADS test problems) -----------
# ref capability: HYPREDRV_LinearSystemSetDiscreteGradient/Curl/Coordinates
# (include/HYPREDRV.h:749-793) feeding hypre AMS/ADS (src/internal/ams.c,
# ads.c).  These generators build the de Rham complex on an n^d node grid:
# G (edges x nodes), C (faces x edges), D (cells x faces) with C@G = 0 and
# D@C = 0, plus model edge/face systems.

def grid_incidence_2d(n: int):
    """(G, C, coords) on an n x n node grid.

    Nodes (i,j) -> i*n+j with coords (j, i).  Edges: x-edges (along j)
    then y-edges (along i).  C is the scalar curl (cells x edges).
    """
    node = lambda i, j: i * n + j
    nxe = n * (n - 1)           # x-edges: (i, j)-(i, j+1)
    xe = lambda i, j: i * (n - 1) + j
    ye = lambda i, j: nxe + i * n + j   # y-edges: (i, j)-(i+1, j)
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(n - 1):
            rows += [xe(i, j)] * 2
            cols += [node(i, j), node(i, j + 1)]
            vals += [-1.0, 1.0]
    for i in range(n - 1):
        for j in range(n):
            rows += [ye(i, j)] * 2
            cols += [node(i, j), node(i + 1, j)]
            vals += [-1.0, 1.0]
    n_edges = nxe + (n - 1) * n
    G = csr_from_coo(rows, cols, vals, (n_edges, n * n))
    rows, cols, vals = [], [], []
    for i in range(n - 1):          # cell (i, j): ccw circulation
        for j in range(n - 1):
            f = i * (n - 1) + j
            rows += [f] * 4
            cols += [xe(i, j), ye(i, j + 1), xe(i + 1, j), ye(i, j)]
            vals += [1.0, 1.0, -1.0, -1.0]
    C = csr_from_coo(rows, cols, vals, ((n - 1) ** 2, n_edges))
    coords = np.column_stack([np.tile(np.arange(n), n),          # x = j
                              np.repeat(np.arange(n), n)]).astype(np.float64)
    return G, C, coords


def grid_incidence_3d(n: int):
    """(G, C, D, coords) de Rham complex on an n^3 node grid."""
    def node(i, j, k):
        return (i * n + j) * n + k

    # edges along axis d: base node (i,j,k) with i_d < n-1
    e_count = [0, 0, 0]
    e_index = {}
    cnt = 0
    for d in range(3):
        dims = [n, n, n]
        dims[d] -= 1
        e_count[d] = dims[0] * dims[1] * dims[2]
        for i in range(dims[0]):
            for j in range(dims[1]):
                for k in range(dims[2]):
                    e_index[(d, i, j, k)] = cnt
                    cnt += 1
    n_edges = cnt
    step = [np.array(s) for s in ((1, 0, 0), (0, 1, 0), (0, 0, 1))]
    rows, cols, vals = [], [], []
    for (d, i, j, k), e in e_index.items():
        b = np.array((i, j, k))
        h = b + step[d]
        rows += [e, e]
        cols += [node(*b), node(*h)]
        vals += [-1.0, 1.0]
    G = csr_from_coo(rows, cols, vals, (n_edges, n ** 3))

    # faces normal to axis d, spanned by d1=(d+1)%3, d2=(d+2)%3
    f_index = {}
    cnt = 0
    for d in range(3):
        dims = [n, n, n]
        dims[(d + 1) % 3] -= 1
        dims[(d + 2) % 3] -= 1
        for i in range(dims[0]):
            for j in range(dims[1]):
                for k in range(dims[2]):
                    f_index[(d, i, j, k)] = cnt
                    cnt += 1
    n_faces = cnt
    rows, cols, vals = [], [], []
    for (d, i, j, k), f in f_index.items():
        d1, d2 = (d + 1) % 3, (d + 2) % 3
        b = np.array((i, j, k))
        rows += [f] * 4
        cols += [e_index[(d1, *b)], e_index[(d2, *(b + step[d1]))],
                 e_index[(d1, *(b + step[d2]))], e_index[(d2, *b)]]
        vals += [1.0, 1.0, -1.0, -1.0]
    C = csr_from_coo(rows, cols, vals, (n_faces, n_edges))

    rows, cols, vals = [], [], []
    m = n - 1
    for i in range(m):
        for j in range(m):
            for k in range(m):
                c = (i * m + j) * m + k
                b = np.array((i, j, k))
                for d in range(3):
                    rows += [c, c]
                    cols += [f_index[(d, *(b + step[d]))], f_index[(d, *b)]]
                    vals += [1.0, -1.0]
    D = csr_from_coo(rows, cols, vals, (m ** 3, n_faces))
    coords = np.array([(i, j, k) for i in range(n)
                       for j in range(n) for k in range(n)], dtype=np.float64)
    return G, C, D, coords


def maxwell_edge_system(n: int, eps: float = 0.1, dim: int = 2):
    """Edge-element curl-curl system A = C^T C + eps*M_e (AMS target).

    Returns (A, G, coords).  The near-null space of the curl-curl term is
    range(G) — exactly what AMS's gradient-space correction handles.
    """
    if dim == 2:
        G, C, coords = grid_incidence_2d(n)
    else:
        G, C, _, coords = grid_incidence_3d(n)
    A = (C.T @ C + eps * sp.identity(G.shape[0])).tocsr()
    A.sort_indices()
    return A, G, coords


def graddiv_face_system(n: int, eps: float = 0.1):
    """Face-element grad-div system A = D^T D + eps*M_f (ADS target).

    Returns (A, C, G, coords); the problematic near-null space of the
    div-div term is range(C).
    """
    G, C, D, coords = grid_incidence_3d(n)
    A = (D.T @ D + eps * sp.identity(C.shape[0])).tocsr()
    A.sort_indices()
    return A, C, G, coords
