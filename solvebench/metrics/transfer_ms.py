"""transfer_ms: the host's seconds in the program's spans ``rhs_upload``
(the right-hand side to the device) and ``solution_download`` (x back to
the host) over the window, per solve, in ms.  Moves solve_ms.  Nothing
where the spans did not run in the window (a program that has no such
spans)."""

KEYS = ("rhs_upload", "solution_download")


def read(ctx):
    if not ctx.solves or any(ctx.after.get(k + "_n", 0)
                             <= ctx.before.get(k + "_n", 0) for k in KEYS):
        return None
    return 1e3 * sum(ctx.after[k + "_s"] - ctx.before[k + "_s"]
                     for k in KEYS) / len(ctx.solves)
