"""Vector reductions for the Krylov solvers.

The result stays a 0-d tensor on the vectors' device, so a solver reads
it to the host only where it needs the value.  On a mesh that spans
ranks each rank holds its block of every vector: the local ``torch.dot``
is then summed over the mesh's group by an ``all_reduce`` (the ``psum``
XLA inserts for the JAX package's sharded dots), so every rank holds the
same value.  A solver takes the group from its caller or, failing
that, from the operator (:func:`group_of`); without one a reduction is
the plain ``torch.dot``.
"""

from __future__ import annotations

import torch

from ..core.errors import ErrorCode, HypredrvError

# the default of a solver's ``group=``: read it from the operator
FROM_OPERATOR = object()


def group_of(matvec, group=FROM_OPERATOR):
    """The process group a Krylov solve on ``matvec`` reduces over.

    ``group`` when the caller names it (None: the dots are whole on each
    rank).  Else the mesh's of the operator whose bound method ``matvec``
    is (``Mesh.reduce_group``; None for an operator without a mesh).  Any
    other callable (a lambda, a ``functools.partial``) cannot be read:
    when ``torch.distributed`` joins more than one rank its vectors may be
    ranks' blocks, and rank-local dots would part the ranks' convergence
    flags, so it raises instead of guessing."""
    if group is not FROM_OPERATOR:
        return group
    owner = getattr(matvec, "__self__", None)
    if owner is not None:
        mesh = getattr(owner, "mesh", None)
        return None if mesh is None else mesh.reduce_group
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise HypredrvError(
            f"the Krylov solve cannot tell which process group {matvec!r} "
            "reduces over: pass group= (the mesh's reduce_group, or None "
            "for an operator held whole on each rank)", ErrorCode.INVALID_ARG)
    return None


def dot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    d = torch.dot(a, b)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(d, group=group)
    return d


def norm2(a: torch.Tensor, group=None) -> torch.Tensor:
    return torch.sqrt(dot(a, a, group))


def reductions(group=None):
    """(dot, norm2) summed over ``group`` (:func:`group_of`), or the plain
    ones without a group."""
    if group is None:
        return dot, norm2
    return (lambda a, b: dot(a, b, group)), (lambda a: norm2(a, group))
