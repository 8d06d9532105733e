"""Scheduled linear-system dumps (``linear_system.print_system``).

Counterpart of ``hypredrive_tpu/linsys/printsys.py``: the same triggers,
layout and IJ text formats; the system's vectors are read back from its
device before they are written.

Reference: src/internal/linsys_print.c — dump matrix/precmat/rhs/x0/xref/
solution/dofmap/metadata at build/setup/apply stages, triggered by
all / every_n_systems / every_n_timesteps / ids / ranges /
iterations_over / setup_time_over / solve_time_over / selectors
(enums include/internal/linsys.h:26-73; matcher PrintSystemSelector-
Matches:1415; directory layout :1767-1830).

Output layout:  {dirname}/ls_{id:05d}/{stage}/IJ.out.A …  in the same IJ
formats the readers accept (round-trippable).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..core.errors import HypredrvError, ErrorCode
from ..core.logging import log
from ..io import ij as ij_io

STAGES = ("build", "setup", "apply")
ARTIFACTS = ("matrix", "precmat", "rhs", "x0", "xref", "solution",
             "dofmap", "metadata")


class PrintSystemContext:
    """Built once per run from the print_system Args
    (ref: BuildPrintSystemContext, src/HYPREDRV.c:533-605)."""

    def __init__(self, args):
        self.enabled = bool(args.get("enable"))
        self.trigger = str(args.get("trigger") or "all").lower()
        self.value = args.get("value")
        self.stages = {s.lower() for s in (args.get("stages") or ["build"])}
        self.artifacts = [a.lower() for a in
                          (args.get("artifacts") or ["matrix", "rhs", "x0"])]
        self.dirname = args.get("dirname") or "print_system"
        self.overwrite = bool(args.get("overwrite"))
        bad = [s for s in self.stages if s not in STAGES]
        if bad:
            raise HypredrvError(f"print_system: unknown stage(s) {bad}",
                                ErrorCode.INVALID_VAL)
        bad = [a for a in self.artifacts if a not in ARTIFACTS]
        if bad:
            raise HypredrvError(f"print_system: unknown artifact(s) {bad}",
                                ErrorCode.INVALID_VAL)

    # -- trigger matching ---------------------------------------------------

    def matches(self, stage: str, ls_id: int, stats=None,
                timestep: Optional[int] = None) -> bool:
        if not self.enabled or stage not in self.stages:
            return False
        t, v = self.trigger, self.value
        if t == "all":
            return True
        if t == "every_n_systems":
            n = max(1, int(v or 1))
            return ls_id % n == 0
        if t == "every_n_timesteps":
            if timestep is None:
                return False
            n = max(1, int(v or 1))
            return timestep % n == 0
        if t == "ids":
            ids = v if isinstance(v, (list, tuple)) else [v]
            return ls_id in [int(i) for i in ids]
        if t == "ranges":
            # list of [lo, hi] pairs (inclusive)
            for pair in (v or []):
                lo, hi = int(pair[0]), int(pair[1])
                if lo <= ls_id <= hi:
                    return True
            return False
        if t == "iterations_over":
            return (stats is not None and stats.entries
                    and stats.num_iterations() > int(v or 0))
        if t == "setup_time_over":
            return (stats is not None and stats.entries
                    and stats.setup_time() > float(v or 0))
        if t == "solve_time_over":
            return (stats is not None and stats.entries
                    and stats.solve_time() > float(v or 0))
        if t == "selectors":
            # list of {basis: ..., op: over/under, value: N} maps
            return self._selectors_match(v, ls_id, stats, timestep)
        raise HypredrvError(f"print_system: unknown trigger '{t}'",
                            ErrorCode.INVALID_VAL)

    def _selectors_match(self, selectors, ls_id, stats, timestep) -> bool:
        for sel in (selectors or []):
            basis = str(sel.get("basis", "linear_system")).lower()
            op = str(sel.get("op", "over")).lower()
            val = float(sel.get("value", 0))
            cur = {
                "linear_system": float(ls_id),
                "timestep": float(timestep or 0),
                "iterations": float(stats.num_iterations()
                                    if stats and stats.entries else 0),
                "setup_time": float(stats.setup_time()
                                    if stats and stats.entries else 0),
                "solve_time": float(stats.solve_time()
                                    if stats and stats.entries else 0),
            }.get(basis)
            if cur is None:
                raise HypredrvError(
                    f"print_system: unknown selector basis '{basis}'",
                    ErrorCode.INVALID_VAL)
            ok = cur > val if op == "over" else cur < val
            if ok:
                return True
        return False

    # -- dumping -------------------------------------------------------------

    def dump(self, system, stage: str, ls_id: int, stats=None,
             timestep: Optional[int] = None):
        if not self.matches(stage, ls_id, stats, timestep):
            return None
        outdir = os.path.join(self.dirname, f"ls_{ls_id:05d}", stage)
        if os.path.exists(outdir) and not self.overwrite:
            # versioned sibling instead of clobbering (ref overwrite
            # handling, linsys_print.c:1767-1830)
            k = 1
            while os.path.exists(f"{outdir}.{k}"):
                k += 1
            outdir = f"{outdir}.{k}"
        os.makedirs(outdir, exist_ok=True)

        for art in self.artifacts:
            try:
                self._dump_one(system, art, outdir, stage, ls_id)
            except Exception as exc:
                log(1, f"print_system: failed to dump {art}: {exc}")
        log(1, f"print_system: wrote {outdir}")
        return outdir

    def _dump_one(self, system, art: str, outdir: str, stage: str,
                  ls_id: int):
        def host(v):
            return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)

        path = os.path.join(outdir, {
            "matrix": "IJ.out.A", "precmat": "IJ.out.M",
            "rhs": "IJ.out.b", "x0": "IJ.out.x0", "xref": "IJ.out.xref",
            "solution": "IJ.out.x", "dofmap": "dofmap.out",
            "metadata": "metadata.yml",
        }[art])
        if art == "matrix" and system.A_host is not None:
            ij_io.write_matrix_ascii(path, system.A_host)
        elif art == "precmat" and system.M_host is not None:
            ij_io.write_matrix_ascii(path, system.M_host)
        elif art == "rhs" and system.b is not None:
            ij_io.write_vector_ascii(path, host(system.b))
        elif art == "x0" and system.x0 is not None:
            ij_io.write_vector_ascii(path, host(system.x0))
        elif art == "xref" and system.xref is not None:
            ij_io.write_vector_ascii(path, host(system.xref))
        elif art == "solution" and system.x is not None:
            ij_io.write_vector_ascii(path, host(system.x))
        elif art == "dofmap" and system.dofmap is not None:
            ij_io.write_dofmap_ascii(path, system.dofmap)
        elif art == "metadata":
            with open(path, "w") as f:
                f.write(f"ls_id: {ls_id}\n")
                f.write(f"stage: {stage}\n")
                f.write(f"num_rows: {system.num_rows}\n")
                f.write(f"nnz: {system.nnz}\n")
                f.write(f"dtype: {str(system.dtype).replace('torch.', '')}\n")
                if system.pattern_id is not None:
                    f.write(f"pattern_id: {system.pattern_id}\n")
                f.write(f"written: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
