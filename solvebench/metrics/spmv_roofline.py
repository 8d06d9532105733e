"""spmv_roofline: the finest level's A, P and R, each ``matvec`` timed
alone at its real shape by graph replay over operand copies that fill
four times the L2; the sum of their least-bytes bounds over 3.35 TB/s
divided by the sum of their times, in %.  Moves solve_ms.  Nothing off
the card."""

from solvebench.timing import HBM_BYTES_S, matvec_ms, spmv_least_bytes


def read(ctx):
    if not ctx.on_card:
        return None
    bound_s = time_s = 0.0
    for _, op in ctx.operators():
        if op is None:
            continue
        itemsize = op.dtype.itemsize
        bound_s += spmv_least_bytes(op.nnz, op.shape, itemsize) / HBM_BYTES_S
        time_s += matvec_ms(op, op.shape[1]) / 1e3
    return 100.0 * bound_s / time_s if time_s else None
