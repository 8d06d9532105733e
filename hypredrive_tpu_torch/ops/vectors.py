"""Vector reductions for the Krylov solvers: plain torch ops on one device.

The result stays a 0-d tensor on the vectors' device, so a solver reads
it to the host only where it needs the value.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def norm2(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(a, a))
