"""graph_lookup_ms: the host's seconds in the program's span
``graph_lookup`` (the device loop's graph cache key and look-up, on the
card only) over the window, per solve, in ms.  Moves solve_ms.  Nothing
where the span did not run in the window (the CPU; a program that has no
such span)."""

KEY = "graph_lookup"


def read(ctx):
    n0, n1 = ctx.before.get(KEY + "_n", 0), ctx.after.get(KEY + "_n", 0)
    if not ctx.solves or n1 <= n0:
        return None
    return 1e3 * (ctx.after[KEY + "_s"] - ctx.before[KEY + "_s"]) \
        / len(ctx.solves)
