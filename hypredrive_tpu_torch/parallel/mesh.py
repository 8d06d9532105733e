"""The row-shard mesh.

Counterpart of ``hypredrive_tpu/parallel/mesh.py``.  The JAX package's
1-D ``jax.sharding.Mesh`` over the ``rows`` axis becomes ``n_shards`` row
shards on one ``torch.device``: a global vector is one padded tensor on
that device whose shard s owns rows ``[s·m, (s+1)·m)``, so no sharding
object is needed and the Krylov cores run unchanged on the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.errors import ErrorCode, HypredrvError

ROWS_AXIS = "rows"


@dataclass(frozen=True)
class Mesh:
    n_shards: int
    device: torch.device


def make_mesh(n_shards: Optional[int] = None, device=None) -> Mesh:
    """``n_shards`` row shards on ``device`` (default: the current CUDA
    device; ``n_shards`` defaults to the number of CUDA devices, as the
    JAX package's mesh takes every device).  Without a card and without an
    explicit device it raises, as ``exec_policy: device`` does."""
    if device is None:
        if not torch.cuda.is_available():
            raise HypredrvError(
                "make_mesh: no CUDA device is available (pass device='cpu' "
                "to run the mesh on the CPU)", ErrorCode.EXTERNAL)
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if n_shards is None:
        n_shards = torch.cuda.device_count() if device.type == "cuda" else 1
    if int(n_shards) < 1:
        raise HypredrvError(f"make_mesh: {n_shards} shards",
                            ErrorCode.INVALID_VAL)
    return Mesh(int(n_shards), device)
