"""Preconditioner protocol and dispatch.

A preconditioner builds its state on setup (host setup allowed) and
applies ``z = M⁻¹ r`` on the system's device (ref: hypre's precond
callback pair, src/internal/solver.c:268-337).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.errors import ErrorCode, HypredrvError


def precon_matrix(system):
    """(host matrix a preconditioner is built from, device matrix its
    finest level may reuse or None): the separate preconditioning matrix
    (precmat) when the system has one, else A and the solver's own device
    matrix."""
    M_host = getattr(system, "M_host", None)
    if M_host is not None:
        return M_host, None
    A_host = system.A_host if system.A_host is not None \
        else system.A.to_csr()
    return A_host, getattr(system, "A", None)


class Preconditioner:
    """Base preconditioner; the identity until a subclass overrides it."""

    method = "base"

    def __init__(self, args, input_args=None):
        self.args = args
        self.input_args = input_args
        self.state: Any = None
        self.is_setup = False

    def setup(self, system):
        """Build device state from the system."""
        self.is_setup = True

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return r


class NonePrecon(Preconditioner):
    method = "none"


# preconditioners of the JAX package this package has not ported yet
NOT_PORTED = ("ams", "ads")


def create_precon(precon_config, input_args=None) -> Preconditioner:
    """ref: hypredrv_PreconCreate dispatch (precon.c:461-563)."""
    from .amg import AMGPrecon
    from .chebyshev import ChebyshevPrecon
    from .fsai import FSAIPrecon
    from .ilu import ILUPrecon
    from .jacobi import GaussSeidelPrecon, JacobiPrecon
    from .mgr import MGRPrecon
    from .schwarz import SchwarzPrecon

    registry = {
        "none": NonePrecon,
        "jacobi": JacobiPrecon,
        "gauss-seidel": GaussSeidelPrecon,
        "chebyshev": ChebyshevPrecon,
        "ilu": ILUPrecon,
        "fsai": FSAIPrecon,
        "amg": AMGPrecon,
        "mgr": MGRPrecon,
        "schwarz": SchwarzPrecon,
    }
    method = precon_config.method
    cls = registry.get(method)
    if cls is None:
        if method in NOT_PORTED:
            raise HypredrvError(
                f"preconditioner '{method}' is not yet ported to "
                f"hypredrive_tpu_torch (available: {', '.join(registry)})",
                ErrorCode.NOT_IMPLEMENTED)
        raise HypredrvError(f"preconditioner '{method}' not implemented",
                            ErrorCode.INVALID_PRECON)
    return cls(precon_config.args, input_args)
