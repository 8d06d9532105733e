"""solve_ms: the window's wall time over the solves it completed, in ms.
Each solve is the user's whole call: right-hand side in, solve, solution
back on the host."""


def read(ctx):
    return ctx.window_s * 1e3 / len(ctx.solves) if ctx.solves else None
