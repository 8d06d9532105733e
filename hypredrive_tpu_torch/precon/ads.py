"""ADS: the auxiliary-space divergence solver (face elements).

Counterpart of ``hypredrive_tpu/precon/ads.py`` (ref: src/internal/ads.c
wrapping HYPRE_ADS: the discrete curl C (n_faces × n_edges), the discrete
gradient G (n_edges × n_nodes) and the vertex coordinates; the nested
AMS and AMG option groups, include/internal/ads.h:24-57).

    z = S(r)  +  C · B_C⁻¹ · Cᵀ r  +  Π · B_Π⁻¹ · Πᵀ r

* S: ℓ1-Jacobi on the face matrix A,
* B_C: a nested AMS on the curl (edge) space CᵀAC, with beta_is_zero
  (curl∘grad = 0): its smoother and its Π_edge-space AMG,
* Π = C·Π_edge (the RT0 nodal interpolation through the edge-space Π),
  B_Π: AMG on ΠᵀAΠ.

The state is an :class:`~hypredrive_tpu_torch.precon.ams.AMSState` whose
gradient slot holds C and the nested AMS, so the AMS cycle machinery
applies it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .ams import AMSState, _ams_apply, build_pi
from .base import Preconditioner, precon_matrix
from ..core.errors import ErrorCode, HypredrvError


def _ads_apply(state, r):
    """ADS shares the AMS cycle machinery: spaces are 0 = smoothing on
    the face matrix, 1 = curl (edge) space solved by a nested AMS,
    2 = Π_RT vector space (ref: ads.h cycle_type — same digit grammar
    as ams.h)."""
    return _ams_apply(state, r)


def build_ads_state(A_host: sp.csr_matrix, C: sp.csr_matrix,
                    G: sp.csr_matrix, coords: np.ndarray, args,
                    dtype: torch.dtype,
                    device: torch.device = torch.device("cpu"),
                    fine_matrix=None, mesh=None) -> AMSState:
    """Construct the ADS state (an AMSState with spaces 0/1/2 =
    smoothing / nested AMS on the curl space / Π_RT) on ``device``;
    ``fine_matrix`` is reused as the smoother's A when given.  With
    ``mesh`` every operator is a row-sharded DistEllMatrix and every
    hierarchy runs the distributed setup (as in ``build_ams_state``)."""
    from .amg.hierarchy import setup_hierarchy
    from ..config.sections import AMG_SCHEMA
    from ..parallel import mesh_ops

    op, vec = mesh_ops(mesh, dtype, device)
    device = mesh.device if mesh is not None else device

    coords = np.asarray(coords, dtype=np.float64)
    dim = coords.shape[1]
    A_host = sp.csr_matrix(A_host)
    C = sp.csr_matrix(C)

    B_C = sp.csr_matrix(C.T @ A_host @ C)
    B_C = B_C + 1e-12 * sp.identity(B_C.shape[0])
    # face-space vector interpolation via the edge-space Π composed
    # through C (RT0 nodal interpolation approximation)
    Pi_edge = build_pi(G, coords)
    Pi = sp.csr_matrix(C @ Pi_edge)
    B_Pi = sp.csr_matrix(Pi.T @ A_host @ Pi)
    B_Pi = B_Pi + 1e-12 * sp.identity(B_Pi.shape[0])

    amg_args = args.get("amg") or AMG_SCHEMA.defaults()
    dof_func_pi = (np.arange(B_Pi.shape[0]) % dim).astype(np.int64)
    # nested AMS on the curl space (edge elements): beta_is_zero —
    # curl∘grad = 0 means the scalar-potential space is degenerate,
    # so the nested solve is smoother + Π_edge-space AMG (the hypre
    # ADS composition, ref: ads.h AMS option group)
    B_Pi_edge = sp.csr_matrix(Pi_edge.T @ B_C @ Pi_edge)
    B_Pi_edge = B_Pi_edge + 1e-12 * sp.identity(B_Pi_edge.shape[0])
    dof_func_e = (np.arange(B_Pi_edge.shape[0]) % dim).astype(np.int64)
    l1c = np.asarray(np.abs(B_C).sum(axis=1)).ravel()
    ams_sub = dict(args.get("ams") or {})
    bc_state = AMSState(
        op(B_C),
        (vec(np.where(l1c != 0, 1.0 / l1c, 1.0)),),
        None, None,
        op(Pi_edge), op(Pi_edge.T),
        None,
        setup_hierarchy(B_Pi_edge, amg_args, dtype=dtype, device=device,
                        dof_func=dof_func_e, mesh=mesh),
        cycle_type=int(ams_sub.get("cycle_type", 1) or 1),
        relax_times=max(1, int(ams_sub.get("relax_times", 1) or 1)),
    )
    bpi_state = setup_hierarchy(B_Pi, amg_args, dtype=dtype, device=device,
                                dof_func=dof_func_pi, mesh=mesh)

    relax_times = max(1, int(args.get("relax_times", 1)))
    weight = float(args.get("relax_weight", 1.0))
    l1 = np.asarray(np.abs(A_host).sum(axis=1)).ravel()
    A = fine_matrix if fine_matrix is not None and mesh is None \
        else op(A_host)
    return AMSState(
        A,
        (vec(np.where(l1 != 0, weight / l1, 1.0)),),
        op(C), op(C.T),
        op(Pi), op(Pi.T),
        bc_state, bpi_state,
        cycle_type=int(args.get("cycle_type", 1)),
        relax_times=relax_times,
    )


class ADSPrecon(Preconditioner):
    method = "ads"

    def setup(self, system):
        A_host, fine = precon_matrix(system)
        if system.C_host is None or system.G_host is None \
                or system.coords is None:
            raise HypredrvError(
                "ADS requires the discrete curl (set_discrete_curl), "
                "discrete gradient (set_discrete_gradient) and vertex "
                "coordinates (set_coordinates)",
                ErrorCode.INVALID_PRECON)
        self.state = build_ads_state(A_host, system.C_host, system.G_host,
                                     system.coords, self.args, system.dtype,
                                     system.device, fine)
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return _ads_apply(self.state, r)
