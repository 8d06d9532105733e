"""idle_share: 100 × (1 − the union of the device operations' intervals
over the wall of the traced stretch), in %.  Moves solve_ms.  Nothing
where no device operation was traced."""

from solvebench.timing import busy_s


def read(ctx):
    if not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(ctx.trace) / ctx.trace.window_s)
