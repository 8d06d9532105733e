"""Chebyshev polynomial coefficients for the AMG smoother.

Counterpart of ``hypredrive_tpu/precon/chebyshev.py::cheby_coefficients``
(host numpy, identical arithmetic).  The standalone Chebyshev
preconditioner is not ported yet.
"""

from __future__ import annotations

import numpy as np


def cheby_coefficients(lam_max: float, fraction: float, order: int):
    """Three-term recurrence factors for the interval
    [fraction·λmax, λmax]."""
    lam_min = fraction * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta if delta > 0 else 1.0
    rhos = np.zeros(max(order, 1))
    rho = 1.0 / sigma
    rhos[0] = rho
    for k in range(1, order):
        rho = 1.0 / (2.0 * sigma - rho)
        rhos[k] = rho
    return theta, delta, rhos
