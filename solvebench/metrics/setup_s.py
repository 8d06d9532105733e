"""setup_s: process start to the first timed solve, in s: CUDA (and
NCCL) init, the system made from the seed, upload, the preconditioner's
host setup, the warm-up solves and their graph captures, and the kernel
build where the checkout has none yet."""


def read(ctx):
    return ctx.setup_s
