"""system_s: the window's wall time over the systems it completed, in s.
Each system is the user's whole call for one Newton system: the new
matrix values, b and the dofmap in, the preconditioner rebuilt or reused
as the library's reuse engine decides, the solve, the solution back on
the host.  The window holds whole time steps, so every rebuild in it
comes with its reuses."""


def read(ctx):
    return ctx.window_s / len(ctx.solves) if ctx.solves else None
