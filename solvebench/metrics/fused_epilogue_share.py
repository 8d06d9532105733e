"""fused_epilogue_share: of the cycles' steps (residual, Chebyshev step,
Jacobi step, coarse correction) that the program ran over the window, the
share that ran inside an SpMV kernel's epilogue rather than as a chain of
torch operations: 100 · Δ``epilogue_fused`` / (Δ``epilogue_fused`` +
Δ``epilogue_plain``), in %.  Moves solve_ms.  Nothing where neither
counter grew (a program that has no such counters)."""

FUSED, PLAIN = "epilogue_fused", "epilogue_plain"


def read(ctx):
    fused = ctx.after.get(FUSED, 0) - ctx.before.get(FUSED, 0)
    plain = ctx.after.get(PLAIN, 0) - ctx.before.get(PLAIN, 0)
    if fused + plain <= 0:
        return None
    return 100.0 * fused / (fused + plain)
