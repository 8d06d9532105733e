"""The plain reference: judges a solution by its true residual.

A solve to a relative tolerance is correct when ``‖b − A x‖₂ / ‖b‖₂``,
computed here in float64 from the benchmark's own A and b, is at most
that tolerance.  The program's solution is only read.  Imports NumPy and
SciPy only, never the program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def relative_residual(A: sp.csr_matrix, b: np.ndarray, x: np.ndarray
                      ) -> float:
    """‖b − A x‖₂ / ‖b‖₂ in float64; NaN where x is not finite."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape != b.shape or not np.all(np.isfinite(x)):
        return float("nan")
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def within(value: float, limit: float) -> bool:
    """value ≤ limit, NaN failing."""
    return bool(value <= limit)
