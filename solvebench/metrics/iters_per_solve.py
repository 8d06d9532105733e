"""iters_per_solve: the mean of the window's solves' own iteration
counts.  Moves solve_ms."""


def read(ctx):
    return sum(s[1] for s in ctx.solves) / len(ctx.solves) if ctx.solves \
        else None
