"""AMG preconditioner: the BoomerAMG-equivalent.

Config surface: AMG_SCHEMA (ref: src/internal/amg.c arg structs).  Setup
builds the hierarchy on the host and uploads it to the system's device;
apply runs V/W cycles there.  Near-null-space vectors set through the API
(``set_near_nullspace``, the elasticity rigid-body modes) become the
hierarchy's interpolation vectors (ref: amg.c:602 AMGSetRBMs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import Preconditioner, precon_matrix
from ...core.logging import log
from .cycle import amg_apply
from .hierarchy import hierarchy_summary, setup_hierarchy


class AMGPrecon(Preconditioner):
    method = "amg"

    def setup(self, system):
        A_host, fine = precon_matrix(system)
        dof_func = None
        if int(self.args.coarsening.num_functions) > 1 \
                and system.dofmap is not None:
            dof_func = np.asarray(system.dofmap)
        self.state = setup_hierarchy(
            A_host, self.args, dtype=system.dtype, device=system.device,
            fine_matrix=fine, dof_func=dof_func,
            interp_vectors=getattr(system, "near_nullspace", None))
        log(2, hierarchy_summary(self.state))
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return amg_apply(self.state, r)
