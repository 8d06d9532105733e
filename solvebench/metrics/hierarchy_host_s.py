"""hierarchy_host_s: the program's count of seconds in its span
``hierarchy_host`` (each AMG or MGR level's host construction: strength
graph or F/C split to the coarse product) up to the end of the warm-up,
in s.  Moves setup_s.  Nothing where the span did not run (a program
that has no such span)."""

KEY = "hierarchy_host"


def read(ctx):
    if not ctx.before.get(KEY + "_n"):
        return None
    return ctx.before[KEY + "_s"]
