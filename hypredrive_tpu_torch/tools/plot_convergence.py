#!/usr/bin/env python
"""Run a config and plot the Krylov residual-norm history.

The port of ``scripts/plot_convergence.py``: the solvers return the
history directly (``res_history``), so the tool runs the solve itself,
on the card unless ``--exec-policy host`` is given.  The plot needs
matplotlib; without it :func:`main` raises ``HypredrvError`` (the solve
figures are not printed without their plot).

Usage:
  python -m hypredrive_tpu_torch.tools.plot_convergence examples/ex1.yml -o conv.png
  python -m hypredrive_tpu_torch.tools.plot_convergence cfg1.yml cfg2.yml -o cmp.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core.entry import add_exec_policy, device, policy_overrides
from ..core.errors import ErrorCode, HypredrvError


def run_config(path: str, policy: str = "device"):
    """(finite residual history, the solve's result) of one config."""
    from ..api import HypreDrive

    device(policy)
    drv = HypreDrive()
    try:
        drv.input_args_parse(path, policy_overrides(policy))
        drv.linear_system_build()
        drv.precon_create()
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        hist = np.asarray(res.res_history, dtype=float)
        hist = hist[np.isfinite(hist)]
        return hist, res
    finally:
        drv.destroy()


def pyplot():
    """matplotlib's pyplot on the Agg backend, or a typed error without
    matplotlib."""
    try:
        import matplotlib
    except ImportError as exc:
        raise HypredrvError("plotting needs matplotlib, which is not "
                            f"installed ({exc})", ErrorCode.EXTERNAL) from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="+", help="YAML config files")
    ap.add_argument("-o", "--output", default="convergence.png")
    ap.add_argument("--relative", action="store_true", default=True,
                    help="normalize by the initial residual (default)")
    add_exec_policy(ap)
    args = ap.parse_args(argv)

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    for cfg in args.configs:
        hist, res = run_config(cfg, args.exec_policy)
        if hist.size == 0:
            print(f"{cfg}: no residual history", file=sys.stderr)
            continue
        ys = hist / hist[0] if args.relative and hist[0] > 0 else hist
        label = os.path.basename(cfg)
        ax.semilogy(range(len(ys)), ys, marker="o", markersize=4,
                    label=f"{label} ({res.iters} iters)")
        print(f"{cfg}: {res.iters} iters, final relres {res.rel_res_norm:.3e}")
    ax.set_xlabel("iteration")
    ax.set_ylabel("relative residual norm" if args.relative
                  else "residual norm")
    ax.grid(alpha=0.4, which="both")
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.output, dpi=160)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
