"""AMS: the auxiliary-space Maxwell solver (edge elements).

Counterpart of ``hypredrive_tpu/precon/ams.py`` (ref: src/internal/ams.c
wrapping HYPRE_AMS: the discrete gradient G (n_edges × n_nodes) and the
vertex coordinates; the α/β AMG option groups, include/internal/ams.h:24-63).
The Hiptmair-Xu decomposition

    z = S(r)  +  G · B_G⁻¹ · Gᵀ r  +  Π · B_Π⁻¹ · Πᵀ r

* S: ℓ1-Jacobi (or Chebyshev, ``relax_type: 16``) on the edge matrix A,
* B_G: an AMG hierarchy on the scalar potential space GᵀAG,
* Π: the nodal vector interpolation (Π_d[e, v] = t_e[d]/2 from G's edge
  endpoints and the coordinates), B_Π: AMG on the dim·n_nodes vector
  space ΠᵀAΠ (dof_func = component index),

combined by hypre's cycle types 1-8 and 11-14 (the latter with the
per-component spaces Π_d).  The host setup is the JAX package's code on
this package's AMG; every operator goes to the device as an
:class:`~hypredrive_tpu_torch.ops.device_matrix.EllMatrix`, so the apply is
eager torch whose matvecs are the DIA and CSR kernels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .base import Preconditioner, precon_matrix
from ..core.errors import ErrorCode, HypredrvError


def build_pi(G: sp.csr_matrix, coords: np.ndarray) -> sp.csr_matrix:
    """Nodal vector interpolation Π (n_edges × dim·n_nodes).

    For edge e with endpoints (i, j) (signs from G): tangent
    t_e = x_j − x_i;  Π[e, dim·v + d] = t_e[d] / 2 for v ∈ {i, j}.
    Rows without exactly one +1/−1 endpoint pair (boundary-eliminated
    edges) stay zero.
    """
    G = sp.csr_matrix(G)
    G.sort_indices()
    n_edges, n_nodes = G.shape
    dim = coords.shape[1]
    counts = np.diff(G.indptr)
    rows_e = np.repeat(np.arange(n_edges), counts)
    nodes = G.indices.astype(np.int64)
    signs = G.data

    # per-edge tangent t_e = Σ_v sign(e,v) · x_v — for interior edges
    # (one +1, one −1) this is x_head − x_tail
    t = np.zeros((n_edges, dim))
    np.add.at(t, rows_e, signs[:, None] * coords[nodes])
    t[counts != 2] = 0.0                   # eliminated edges: no entry

    # Π entries: one (edge, dim·node + d) entry of t_e[d]/2 per
    # (G entry, component)
    pr = np.repeat(rows_e, dim)
    pc = (nodes[:, None] * dim + np.arange(dim)[None, :]).reshape(-1)
    pv = (t[rows_e] / 2.0).reshape(-1)
    Pi = sp.csr_matrix((pv, (pr, pc)), shape=(n_edges, dim * n_nodes))
    Pi.eliminate_zeros()
    Pi.sort_indices()
    return Pi


# hypre's AMS cycle table (HYPRE ref manual / ams.c SetCycleType):
# digits are spaces (0 = smoothing on A, 1 = B_G gradient space,
# 2 = B_Π full vector space, 3/4/5 = B_Πx/Πy/Πz component spaces),
# "+" is additive combination.  Encoded as BRANCHES (additive, all from
# the original residual), each branch a multiplicative GROUP sequence,
# each group an additive set of space corrections.
_AMS_CYCLES = {
    1: [[{0}, {1}, {2}, {1}, {0}]],               # 01210
    2: [[{0, 1, 2}]],                             # 0+1+2
    3: [[{0}, {2}, {1}, {2}, {0}]],               # 02120
    4: [[{0}, {1}, {0}], [{2}]],                  # 010+2
    5: [[{0}, {1}, {0}, {2}, {0}, {1}, {0}]],     # 0102010
    6: [[{1}], [{0}, {2}, {0}]],                  # 1+020
    7: [[{0}, {2}, {0}, {1}, {0}, {2}, {0}]],     # 0201020
    8: [[{0}, {1, 2}, {0}]],                      # 0(1+2)0
    11: [[{0}, {1}, {3}, {4}, {5}, {4}, {3}, {1}, {0}]],   # 013454310
    12: [[{0, 1, 3, 4, 5}]],                      # 0+1+3+4+5
    13: [[{0}, {3}, {4}, {5}, {1}, {5}, {4}, {3}, {0}]],   # 034515430
    14: [[{0}, {1}, {3, 4, 5}, {1}, {0}]],        # 01(3+4+5)10
}


def needs_component_spaces(cycle_type: int) -> bool:
    return int(cycle_type) >= 11


class AMSState:
    """The AMS apply's operands.  ``bg_state`` is the gradient space's AMG
    state, a nested AMSState (ADS's curl space) or None (hypre's
    beta_is_zero); ``smooth`` is (d_inv,) for ℓ1-Jacobi or (d_inv, θ, δ,
    ρ_k) for Chebyshev, the scalars as Python floats."""

    def __init__(self, A, smooth, G, GT, Pi, PiT, bg_state, bpi_state,
                 comp_spaces=(), cycle_type=1, relax_times=1,
                 smoother="l1-jacobi"):
        (self.A, self.smooth, self.G, self.GT, self.Pi, self.PiT,
         self.bg_state, self.bpi_state) = (A, smooth, G, GT, Pi, PiT,
                                           bg_state, bpi_state)
        # comp_spaces: tuple of (Pi_d, Pi_dT, state) per dimension
        self.comp_spaces = tuple(comp_spaces)
        self.cycle_type = int(cycle_type)
        self.relax_times = int(relax_times)
        self.smoother = smoother


def _ams_smooth(state, res):
    """relax_times sweeps of the configured smoother as an error
    correction z ≈ A⁻¹ res (ref: ams.h relax_type/relax_times/
    relax_weight; ℓ1-Jacobi replaces hypre's ℓ1-GS, Chebyshev is
    relax_type 16)."""
    A = state.A
    if state.smoother == "chebyshev":
        d_inv, theta, delta, rhos = state.smooth
        z = d_inv * res / theta
        d = z
        rho_prev = rhos[0]
        for k in range(1, len(rhos)):
            rk = d_inv * (res - A.matvec(z))
            d = rhos[k] * rho_prev * d + (2.0 * rhos[k] / delta) * rk
            z = z + d
            rho_prev = rhos[k]
        return z
    (d_inv,) = state.smooth
    z = d_inv * res
    for _ in range(max(0, state.relax_times - 1)):
        z = z + d_inv * (res - A.matvec(z))
    return z


def _ams_apply(state, r):
    from .amg.cycle import amg_apply

    def corr(space, res):
        if space == 0:
            return _ams_smooth(state, res)
        if space == 1:
            # bg_state None = hypre's beta_is_zero mode
            # (SetBetaPoissonMatrix NULL): gradient correction skipped —
            # also the nested AMS inside ADS, where curl∘grad = 0
            if state.bg_state is None:
                return torch.zeros_like(res)
            if isinstance(state.bg_state, AMSState):
                # ADS: space 1 is the curl (edge) space solved by a
                # nested AMS (ref: ads.h AMS option group)
                return state.G.matvec(_ams_apply(state.bg_state,
                                                 state.GT.matvec(res)))
            return state.G.matvec(amg_apply(state.bg_state,
                                            state.GT.matvec(res)))
        if space == 2:
            return state.Pi.matvec(amg_apply(state.bpi_state,
                                             state.PiT.matvec(res)))
        d = space - 3
        if d < len(state.comp_spaces):
            Pd, PdT, st_d = state.comp_spaces[d]
            return Pd.matvec(amg_apply(st_d, PdT.matvec(res)))
        return torch.zeros_like(res)

    branches = _AMS_CYCLES.get(int(state.cycle_type), _AMS_CYCLES[1])
    z_total = None
    for branch in branches:
        z = None
        for group in branch:
            res = r if z is None else r - state.A.matvec(z)
            dz = None
            for space in sorted(group):
                c = corr(space, res)
                dz = c if dz is None else dz + c
            z = dz if z is None else z + dz
        z_total = z if z_total is None else z_total + z
    return z_total


def build_ams_state(A_host: sp.csr_matrix, G: sp.csr_matrix,
                    coords: np.ndarray, args, dtype: torch.dtype,
                    device: torch.device = torch.device("cpu"),
                    fine_matrix=None, mesh=None) -> AMSState:
    """Construct the AMS state on ``device``; ``fine_matrix`` (the solver's
    device copy of A_host) is reused as the smoother's A when given.  With
    ``mesh`` every operator is a row-sharded DistEllMatrix on the mesh's
    device, the smoother vectors are padded with 1.0 (the padded A's
    identity rows) and both auxiliary hierarchies run the distributed
    setup, so the same cycle code serves one device and the mesh."""
    from .amg.hierarchy import _power_lambda_max, setup_hierarchy
    from ..config.sections import AMG_SCHEMA
    from ..parallel import mesh_ops

    op, vec = mesh_ops(mesh, dtype, device)

    coords = np.asarray(coords, dtype=np.float64)
    dim = coords.shape[1]
    A_host = sp.csr_matrix(A_host)
    G = sp.csr_matrix(G)

    B_G = sp.csr_matrix(G.T @ A_host @ G)
    B_G = B_G + 1e-12 * sp.identity(B_G.shape[0])  # gauge regularization
    Pi = build_pi(G, coords)
    B_Pi = sp.csr_matrix(Pi.T @ A_host @ Pi)
    B_Pi = B_Pi + 1e-12 * sp.identity(B_Pi.shape[0])

    errors = []
    alpha_args = AMG_SCHEMA.parse(
        dict(args.get("alpha_amg") or {}), "ams:alpha", errors) \
        if isinstance(args.get("alpha_amg"), dict) \
        else args.get("alpha_amg") or AMG_SCHEMA.defaults()
    beta_args = args.get("beta_amg") or AMG_SCHEMA.defaults()

    def hierarchy(B, amg_args, dof_func=None):
        return setup_hierarchy(B, amg_args, dtype=dtype, device=device,
                               dof_func=dof_func, mesh=mesh)

    dof_func_pi = (np.arange(B_Pi.shape[0]) % dim).astype(np.int64)
    bg_state = hierarchy(B_G, beta_args)
    bpi_state = hierarchy(B_Pi, alpha_args, dof_func_pi)

    cycle_type = int(args.get("cycle_type", 1))
    # 5-level cycles (11-14) use per-component Π_d spaces
    # (ref: ams.h cycle_type; hypre Pix/Piy/Piz)
    comp_spaces = []
    if needs_component_spaces(cycle_type):
        for d in range(dim):
            cols = np.arange(Pi.shape[1] // dim) * dim + d
            Pd = sp.csr_matrix(Pi[:, cols])
            B_d = sp.csr_matrix(Pd.T @ A_host @ Pd)
            B_d = B_d + 1e-12 * sp.identity(B_d.shape[0])
            comp_spaces.append((op(Pd), op(Pd.T), hierarchy(B_d, alpha_args)))

    # smoothing on A (ref: ams.h relax_type/relax_times/relax_weight
    # — the ℓ1-GS family maps to ℓ1-Jacobi; 16 = Chebyshev)
    relax_type = int(args.get("relax_type", 2))
    relax_times = max(1, int(args.get("relax_times", 1)))
    weight = float(args.get("relax_weight", 1.0))

    if relax_type == 16:
        from .chebyshev import cheby_coefficients

        diag = A_host.diagonal()
        dj = np.where(diag != 0, 1.0 / diag, 1.0)
        lam = _power_lambda_max(A_host, dj, 10) * 1.1
        theta, delta, rhos = cheby_coefficients(lam, 0.3, 2)
        smooth = (vec(dj), float(theta), float(delta),
                  tuple(float(r) for r in rhos))
        smoother = "chebyshev"
    else:
        l1 = np.asarray(np.abs(A_host).sum(axis=1)).ravel()
        smooth = (vec(np.where(l1 != 0, weight / l1, 1.0)),)
        smoother = "l1-jacobi"

    A = fine_matrix if fine_matrix is not None and mesh is None \
        else op(A_host)
    return AMSState(
        A, smooth, op(G), op(G.T), op(Pi), op(Pi.T), bg_state, bpi_state,
        comp_spaces=tuple(comp_spaces), cycle_type=cycle_type,
        relax_times=relax_times, smoother=smoother)


class AMSPrecon(Preconditioner):
    method = "ams"

    def setup(self, system):
        A_host, fine = precon_matrix(system)
        if system.G_host is None or system.coords is None:
            # operator-completeness guard (ref: precon.c:648-707)
            raise HypredrvError(
                "AMS requires the discrete gradient (set_discrete_gradient)"
                " and vertex coordinates (set_coordinates)",
                ErrorCode.INVALID_PRECON)
        self.state = build_ams_state(A_host, system.G_host, system.coords,
                                     self.args, system.dtype, system.device,
                                     fine)
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return _ams_apply(self.state, r)
