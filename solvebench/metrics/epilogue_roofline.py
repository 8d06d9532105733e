"""epilogue_roofline: the finest level's steps that the cycle runs as one
SpMV with the vector chain in its last kernel's epilogue (the residual,
with the Chebyshev start where the level smooths by Chebyshev; each
Chebyshev step; the Jacobi step where the level relaxes by (masked)
Jacobi; the correction x + P·e), each called as the cycle calls it, through
the level operator's method, and timed alone at its real shape by graph
replay over copies of the operator and its vectors that fill four times
the L2.  The sum of their least-bytes bounds (each stored value and the
operand read once, each other vector read or written once) over 3.35
TB/s, divided by the sum of their times, in %.  Moves solve_ms.  Nothing
off the card, nor where the operators have no such methods."""

import dataclasses

from solvebench.timing import HBM_BYTES_S, operand_copies, replay_ms

THETA, C1, C2 = 1.7, 0.61, 0.93   # the timing does not depend on them


def _level(ctx):
    """The finest level of the session's preconditioner, or None."""
    session = getattr(ctx.operators, "__self__", None)
    try:
        return session.drv.precon.state.levels[0]
    except (AttributeError, IndexError, TypeError):
        return None


def _steps(level, A, P):
    """(operator, vectors besides the operand read or written, call of
    the method on an operator and vectors v) of each step."""
    out = [(A, 2, lambda M, v: M.residual(v[0], v[1]))]
    if getattr(level, "smoother", None) == "chebyshev":
        rhos = level.smooth_arrays[3]
        out.append((A, 4, lambda M, v: M.residual(v[0], v[1], v[2],
                                                  THETA)))
        for k in range(1, len(rhos)):
            if k < len(rhos) - 1:
                out.append((A, 5, lambda M, v: M.cheby_step(
                    v[0], v[1], v[3], v[2], C1, C2)))
            else:
                out.append((A, 5, lambda M, v: M.cheby_step(
                    v[0], v[1], v[3], v[2], C1, C2, v[4], True)))
    if (getattr(level, "smoother", None) in ("jacobi", "l1-jacobi")
            or getattr(level, "f_kind", None) == "masked-jacobi"):
        out.append((A, 3, lambda M, v: M.jacobi_step(v[1], v[0], v[2])))
    if P is not None:
        out.append((P, 2, lambda M, v: M.matvec_add(v[0], v[5])))
    return out


def _time_ms(op, call):
    """Device ms of ``call(op, v)`` alone, operand evicted from the L2:
    copies of every tensor field of ``op`` (a dataclass) and of the
    vectors."""
    import torch

    n_rows, n_cols = op.shape
    tensors = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)
               if isinstance(getattr(op, f.name), torch.Tensor)}

    def vectors():
        v = [torch.randn(n_rows, dtype=op.dtype, device=op.device)
             for _ in range(5)]
        v[2] = v[2].abs()   # the smoother's diagonal scaling
        return v + [torch.randn(n_cols, dtype=op.dtype, device=op.device)]

    per_copy = (sum(t.numel() * t.element_size() for t in tensors.values())
                + (5 * n_rows + n_cols) * op.dtype.itemsize)
    ops = [op] + [dataclasses.replace(op, **{k: t.clone()
                                             for k, t in tensors.items()})
                  for _ in range(operand_copies(per_copy) - 1)]
    vs = [vectors() for _ in ops]
    return replay_ms([lambda o=o, v=v: call(o, v) for o, v in zip(ops, vs)])


def read(ctx):
    if not ctx.on_card:
        return None
    ops = dict(ctx.operators())
    A, P = ops.get("A0"), ops.get("P0")
    if A is None or not all(hasattr(A, m) for m in (
            "residual", "cheby_step", "jacobi_step", "matvec_add")):
        return None
    bound_s = time_s = 0.0
    for op, n_vec, call in _steps(_level(ctx), A, P):
        n_rows, n_cols = op.shape
        least = (int(op.nnz) + n_cols + n_vec * n_rows) * op.dtype.itemsize
        bound_s += least / HBM_BYTES_S
        time_s += _time_ms(op, call) / 1e3
    return 100.0 * bound_s / time_s if time_s else None
