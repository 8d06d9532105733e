"""host_reads_per_solve: the device loop's host reads of the convergence
flag over the window (``device_loop.stats["host_reads"]``) per solve.
Moves solve_ms."""


def read(ctx):
    if not ctx.solves:
        return None
    return (ctx.after["host_reads"] - ctx.before["host_reads"]) / len(ctx.solves)
