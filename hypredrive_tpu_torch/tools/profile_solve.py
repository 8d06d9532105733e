"""Run a config under torch.profiler and summarise its phases.

The port of ``scripts/profile_solve.py`` (the reference's Caliper report,
ref: include/internal/stats.h:47-80).  Phases are bracketed by the stats
spans (``hypredrv::*``) and by this tool's own spans: the system build,
the preconditioner and solver setup, the first solve (with the capture of
its graphs on the card) and a second, warm solve from the same initial
guess (graph replays only).  The Chrome trace (``--trace FILE``, open it
in Perfetto or chrome://tracing) shows the idle gaps between the device's
kernels; the summary gives each phase's host wall, the device time of
the kernels that started inside it and their ratio (the busy share), and
the device loop's replays, host reads and capture.

Usage: python -m hypredrive_tpu_torch.tools.profile_solve CONFIG
           [--trace FILE] [-a PATH VALUE]... [--exec-policy host]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..core.entry import add_exec_policy, device, policy_overrides

PHASES = ("linear_system_build", "precon_setup", "solve", "solve_warm")


def phase_times(prof) -> dict:
    """Per phase span: host wall s, device s of the kernels (and copies)
    that started inside it, and their ratio."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name() in PHASES
             and e.device_type() == DeviceType.CPU}
    device = [(e.start_ns(), e.duration_ns()) for e in events
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    out = {}
    for name in PHASES:
        if name not in spans:
            continue
        t0, t1 = spans[name]
        dev_ns = sum(d for s, d in device if t0 <= s < t1)
        wall = (t1 - t0) / 1e9
        out[name] = {"wall_s": wall, "device_s": dev_ns / 1e9,
                     "busy": dev_ns / 1e9 / wall if wall > 0 else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace (Perfetto) to this file")
    ap.add_argument("-a", nargs=2, action="append", default=[],
                    metavar=("PATH", "VALUE"), help="config override")
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    dev = device(args.exec_policy)

    from torch.profiler import ProfilerActivity, profile, record_function

    from .. import HypreDrive
    from ..solvers import device_loop

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    drv = HypreDrive()
    try:
        drv.input_args_parse(args.config, overrides=[
            *map(tuple, args.a), *policy_overrides(args.exec_policy)])
        loops = {}
        with profile(activities=activities) as prof:
            with record_function("linear_system_build"):
                drv.linear_system_build()
            with record_function("precon_setup"):
                drv.precon_create()
                drv.linear_solver_create()
                drv.linear_solver_setup()
            for name in ("solve", "solve_warm"):
                if name == "solve_warm":
                    drv.reset_initial_guess()
                device_loop.reset_stats()
                with record_function(name):
                    res = drv.linear_solver_apply()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                loops[name] = dict(device_loop.stats)
        drv.stats_print()
        print(f"\nconverged={res.converged} iters={res.iters} "
              f"relres={res.rel_res_norm:.3e}")
        times = phase_times(prof)
        for name, t in times.items():
            if dev.type == "cuda":
                print(f"{name}: {t['wall_s']:.6f} s wall, "
                      f"{t['device_s']:.6f} s of device time, "
                      f"{100 * t['busy']:.1f}% busy")
            else:
                print(f"{name}: {t['wall_s']:.6f} s wall on the CPU "
                      "(device time not measured)")
        for name, s in loops.items():
            print(f"{name} device loop: {int(s['replays'])} replays "
                  f"({int(s['masked'])} masked), {int(s['host_reads'])} host "
                  f"reads, {int(s['captures'])} captures in "
                  f"{s['capture_s']:.6f} s, {int(s['nodes'])} graph nodes")
        if args.trace:
            prof.export_chrome_trace(args.trace)
            print(f"trace written to {args.trace} (open with Perfetto)")
        return 0
    finally:
        drv.destroy()


if __name__ == "__main__":
    sys.exit(main())
