"""Named solver/preconditioner presets.

Built-ins match the reference (ref: src/internal/presets.c:17-33):
``poisson``, ``elasticity_2d``, ``elasticity_3d``.  Users can register
named presets at runtime (ref: HYPREDRV_PreconPresetRegister /
SolverPresetRegister, include/HYPREDRV.h:570-641).  Names are normalized
case-insensitively with ``-``/``_`` treated as equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Preset:
    name: str
    kind: str  # "precon" | "solver"
    text: str  # YAML snippet
    description: str = ""


def _norm(name: str) -> str:
    return name.strip().lower().replace("-", "_")


_BUILTINS = {
    ("precon", "poisson"): Preset(
        "poisson", "precon", "amg", "BoomerAMG-equivalent for Poisson"),
    ("precon", "elasticity_2d"): Preset(
        "elasticity_2d", "precon",
        "amg:\n  coarsening:\n    num_functions: 2\n    strong_th: 0.8",
        "AMG for 2D elasticity"),
    ("precon", "elasticity_3d"): Preset(
        "elasticity_3d", "precon",
        "amg:\n  coarsening:\n    num_functions: 3\n    strong_th: 0.8",
        "AMG for 3D elasticity"),
}

_user_presets: Dict[tuple, Preset] = {}


def get_preset(name: str, kind: str = "precon") -> Optional[Preset]:
    key = (kind, _norm(name))
    return _user_presets.get(key) or _BUILTINS.get(key)


def register_precon_preset(name: str, text: str, description: str = ""):
    _user_presets[("precon", _norm(name))] = Preset(
        _norm(name), "precon", text, description)


def register_solver_preset(name: str, text: str, description: str = ""):
    _user_presets[("solver", _norm(name))] = Preset(
        _norm(name), "solver", text, description)


def list_presets():
    out = dict(_BUILTINS)
    out.update(_user_presets)
    return list(out.values())
