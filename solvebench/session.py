"""The system under test, driven through its public entry:
``hypredrive_tpu_torch.api.HypreDrive`` in library mode, one process on
one device.

A session holds one configuration's operator and preconditioner, set up
once, and solves one right-hand side per call as a user would: the
vector in from the host, a solve from x0 = 0 to the configuration's
tolerance, the solution back on the host.  The three steps are the host
spans ``set_rhs``, ``apply`` and ``get_solution`` of a trace.  Any
solver and preconditioner the library takes from a YAML file can be
named in a configuration's ``solver`` and ``preconditioner`` sections.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

SPANS = ("set_rhs", "apply", "get_solution")


def solver_of(cfg: dict) -> Tuple[str, dict]:
    """(method, arguments) of the configuration's one solver."""
    (method, args), = cfg["solver"].items()
    return method, args


def tolerance(cfg: dict) -> float:
    """The relative tolerance the configuration states."""
    return float(solver_of(cfg)[1]["relative_tol"])


def int_keys(section):
    """A configuration section with JSON's digit-string keys (MGR's
    ``level`` numbers) as the integers YAML would give."""
    if isinstance(section, dict):
        return {int(k) if isinstance(k, str) and k.isdigit() else k:
                int_keys(v) for k, v in section.items()}
    return section


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LibrarySession:
    def __init__(self, cfg: dict, A: sp.csr_matrix, dofmap, device,
                 dtype: str):
        from hypredrive_tpu_torch import HypreDrive

        self.device = device
        general = {"dtype": dtype, "statistics": "off"}
        if device.type == "cpu":
            general["exec_policy"] = "host"
        self.drv = HypreDrive()
        self.drv.set_library_mode()
        self.drv.input_args_from_dict({
            "general": general, "linear_system": {},
            "solver": cfg["solver"],
            "preconditioner": int_keys(cfg["preconditioner"])})
        self.drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
        if dofmap is not None:
            self.drv.set_dofmap(dofmap)

    def setup(self, b0: np.ndarray) -> float:
        """The preconditioner's setup; its seconds on the host clock,
        ending in a synchronise."""
        self.drv.set_rhs(b0)
        self.drv.precon_create()
        self.drv.linear_solver_create()
        sync(self.device)
        t0 = time.perf_counter()
        self.drv.linear_solver_setup()
        sync(self.device)
        return time.perf_counter() - t0

    def solve(self, b: np.ndarray):
        from torch.profiler import record_function

        with record_function("set_rhs"):
            self.drv.set_rhs(b)
            self.drv.reset_initial_guess()
        with record_function("apply"):
            res = self.drv.linear_solver_apply()
        with record_function("get_solution"):
            x = self.drv.get_solution()
        return x, res.iters, res.converged

    def operators(self) -> List[tuple]:
        """(name, operator) of the finest level's A, P and R."""
        lv = self.drv.precon.state.levels[0]
        return [("A0", lv.A), ("P0", lv.P), ("R0", lv.R)]

    def free(self) -> None:
        self.drv.destroy()
        self.drv = None

