"""solve_ms_p95: the 95th percentile of every solve's wall time in the
window, in ms (not a median of chunks)."""

from solvebench.timing import quantile


def read(ctx):
    q = quantile([s[0] for s in ctx.solves], 0.95)
    return None if q is None else q * 1e3
