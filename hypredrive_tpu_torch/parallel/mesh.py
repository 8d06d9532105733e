"""The row-shard mesh.

Counterpart of ``hypredrive_tpu/parallel/mesh.py``.  The JAX package's
1-D ``jax.sharding.Mesh`` over the ``rows`` axis becomes ``n_shards`` row
shards spread over the ranks of a ``torch.distributed`` group, one rank
per card (the JAX package's multi-controller mode, and hypredrive's one
MPI rank per GPU).  Rank r holds ``k = n_shards / world`` consecutive
shards, ``[r·k, (r+1)·k)``, on its own device; a vector is the rank's
block of the padded global vector, rows ``[r·n/world, (r+1)·n/world)``
of a global length n, so the Krylov cores run on plain local tensors and
reach the other ranks only in their reductions and the halo exchange.

Without a group the mesh is one rank holding every shard on one device:
the layer as it was before it spanned cards.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core.errors import ErrorCode, HypredrvError

ROWS_AXIS = "rows"


@dataclass(frozen=True)
class Mesh:
    n_shards: int
    device: torch.device
    group: Any = None        # a torch.distributed process group, or None
    rank: int = 0
    world: int = 1

    @property
    def shard_range(self) -> range:
        """The global indices of this rank's shards."""
        k = self.n_shards // self.world
        return range(self.rank * k, (self.rank + 1) * k)

    @property
    def reduce_group(self):
        """The group a solve on this mesh sums its dot products over: None
        on one rank, whose local dot is already the whole one."""
        return self.group if self.world > 1 else None

    def rows(self, n: int) -> slice:
        """This rank's rows of a padded global length ``n`` (a multiple of
        ``n_shards``)."""
        m = n // self.world
        return slice(self.rank * m, (self.rank + 1) * m)

    def local(self, v):
        """This rank's block of a padded global vector (tensor or array)."""
        return v[self.rows(v.shape[0])]

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """The padded global vector from every rank's block, on every rank
        (a copy for the host or a replicated operand)."""
        if self.group is None or self.world == 1:
            return v
        import torch.distributed as dist

        out = torch.empty(v.shape[0] * self.world, dtype=v.dtype,
                          device=v.device)
        dist.all_gather_into_tensor(out, v.contiguous(), group=self.group)
        return out


def _default_group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_mesh(n_shards: Optional[int] = None, device=None,
              group=None) -> Mesh:
    """``n_shards`` row shards over the ranks of ``group`` (default: the
    initialized default group, else none).  ``n_shards`` defaults to one
    shard per rank (1 without a group) and must be a multiple of the
    group's size.  ``device`` defaults to ``cuda:LOCAL_RANK`` in a group
    (the current CUDA device without ``LOCAL_RANK`` or without a group).
    Without a card and without an explicit device it raises, as
    ``exec_policy: device`` does."""
    if group is None:
        group = _default_group()
    rank = world = None
    if group is not None:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        if not torch.cuda.is_available():
            raise HypredrvError(
                "make_mesh: no CUDA device is available (pass device='cpu' "
                "to run the mesh on the CPU)", ErrorCode.EXTERNAL)
        index = (int(os.environ["LOCAL_RANK"])
                 if group is not None and "LOCAL_RANK" in os.environ
                 else torch.cuda.current_device())
        device = torch.device("cuda", index)
    device = torch.device(device)
    if n_shards is None:
        n_shards = world or 1
    if int(n_shards) < 1:
        raise HypredrvError(f"make_mesh: {n_shards} shards",
                            ErrorCode.INVALID_VAL)
    if group is None:
        return Mesh(int(n_shards), device)
    if int(n_shards) % world:
        raise HypredrvError(f"make_mesh: {n_shards} shards over {world} "
                            "ranks (a multiple of the ranks is needed)",
                            ErrorCode.INVALID_VAL)
    return Mesh(int(n_shards), device, group, int(rank), int(world))

