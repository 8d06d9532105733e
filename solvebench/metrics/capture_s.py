"""capture_s: the program's own count of seconds spent capturing CUDA
graphs up to the end of the warm-up (``device_loop.stats["capture_s"]``).
Moves setup_s.  Nothing when nothing was captured (the CPU)."""


def read(ctx):
    return ctx.capture_s if ctx.before.get("captures") else None
