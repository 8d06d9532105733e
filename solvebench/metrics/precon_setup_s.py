"""precon_setup_s: the preconditioner's setup on the benchmark's host
clock, ending in a synchronise (``linear_solver_setup()``, or
``setup_mgr_dist`` on a mesh), in s.  Moves setup_s."""


def read(ctx):
    return ctx.precon_setup_s
