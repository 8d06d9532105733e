"""capture_per_system_s: the program's own seconds spent capturing CUDA
graphs over the window (Δ``device_loop.stats["capture_s"]``), per system,
in s: every new matrix, and every rebuilt preconditioner, is captured
anew.  Moves system_s.  Nothing where nothing was captured in the window
(the CPU)."""


def read(ctx):
    if not ctx.solves or ctx.after.get("captures", 0) <= \
            ctx.before.get("captures", 0):
        return None
    return (ctx.after["capture_s"] - ctx.before["capture_s"]) \
        / len(ctx.solves)
