"""Public solve result (ref: interfaces/python/src/result.py:15-33)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class SolveResult:
    x: np.ndarray
    iters: int = 0
    rel_res_norm: float = 0.0
    converged: bool = True
    solution_norm: float = 0.0
    res_history: Optional[np.ndarray] = None
