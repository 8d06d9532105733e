"""operator_build_s: the program's count of seconds in its span
``operator_build`` (the host conversion and upload of every device
operator, A at ingest included) up to the end of the warm-up, in s.
Moves setup_s.  Nothing where the span did not run (a program that has
no such span)."""

KEY = "operator_build"


def read(ctx):
    if not ctx.before.get(KEY + "_n"):
        return None
    return ctx.before[KEY + "_s"]
