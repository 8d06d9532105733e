"""flag_wait_ms: the host's seconds in the program's span ``flag_wait``
(the device loop's waits for and reads of its convergence flags) over the
window, per solve, in ms.  Moves solve_ms.  Nothing where the span did
not run in the window (a program that has no such span).

Most of it is the device's own time seen from the host: the host waits
there while the graphs it launched run, so faster kernels move it as much
as a cheaper loop does.  The part the host causes is the device idle that
falls inside the span, which only a profiled stretch shows
(``tools/profile_solve.py``'s idle by span)."""

KEY = "flag_wait"


def read(ctx):
    n0, n1 = ctx.before.get(KEY + "_n", 0), ctx.after.get(KEY + "_n", 0)
    if not ctx.solves or n1 <= n0:
        return None
    return 1e3 * (ctx.after[KEY + "_s"] - ctx.before[KEY + "_s"]) \
        / len(ctx.solves)
