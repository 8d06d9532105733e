"""rebuild_setup_s: the mean host wall of ``linear_solver_setup()``,
ending in a synchronise, over the window's systems on which the reuse
engine rebuilt the preconditioner, in s.  Moves system_s.  Nothing where
the window rebuilt none."""


def read(ctx):
    rebuilt = [s["setup_s"] for s in getattr(ctx, "systems", None) or ()
               if s["rebuilt"]]
    return sum(rebuilt) / len(rebuilt) if rebuilt else None
