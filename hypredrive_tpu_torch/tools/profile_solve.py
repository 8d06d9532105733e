"""Run a config under torch.profiler and summarise its phases.

The port of ``scripts/profile_solve.py`` (the reference's Caliper report,
ref: include/internal/stats.h:47-80).  Phases are bracketed by the stats
spans (``hypredrv::*``) and by this tool's own spans: the system build,
the preconditioner and solver setup, the first solve (with the capture of
its graphs on the card) and a second, warm solve from the same initial
guess (graph replays only).  Each solve is a caller's round trip: the
system's own right-hand side uploaded again (``set_rhs``), the solve, and
x read back (``get_solution``).  The Chrome trace (``--trace FILE``, open it
in Perfetto or chrome://tracing) shows the idle gaps between the device's
kernels; the summary gives each phase's host wall, the device time of
the kernels that started inside it and their ratio (the busy share), and
the device loop's replays, host reads and capture.  On the card it also
puts each idle gap between the device's operations inside the solves
down to the innermost ``hypredrv::`` span (``core/trace.py``) open on the
host at the gap's middle, the rest as time between spans; and it prints
the program's span counters (seconds and entries) of each solve phase,
with the bytes each transfer moved (and the rate they give) and, on a
mesh, the halo bytes and messages sent to other ranks.

Usage: python -m hypredrive_tpu_torch.tools.profile_solve CONFIG
           [--trace FILE] [-a PATH VALUE]... [--exec-policy host]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..core.entry import add_exec_policy, device, policy_overrides

PHASES = ("linear_system_build", "precon_setup", "solve", "solve_warm")
BETWEEN = "between spans"
# each transfer span and the counter of the bytes it moved
TRANSFERS = (("rhs_upload", "h2d_bytes"), ("solution_download", "d2h_bytes"))


def trace_events(prof):
    """(phase spans {name: (start, end)}, the device operations [(start,
    duration)], the host's ``hypredrv::`` spans [(name, start, end)]) of a
    finished profile, in ns on one clock."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    phases = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if e.name() in PHASES
              and e.device_type() == DeviceType.CPU}
    device = [(e.start_ns(), e.duration_ns()) for e in events
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    spans = [(e.name()[len("hypredrv::"):], e.start_ns(),
              e.start_ns() + e.duration_ns()) for e in events
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("hypredrv::")]
    return phases, device, spans


def idle_by_span(device, spans, within) -> dict:
    """Seconds of device idle by host span: every gap between the merged
    device operations whose middle lies inside one of the ``within``
    intervals goes to the innermost span (the latest started) open at
    that middle, else to ``BETWEEN``.  ``device`` holds (start,
    duration), ``spans`` (name, start, end), all in ns."""
    busy: list = []
    for s, d in sorted(device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], s + d)
        else:
            busy.append([s, s + d])
    out: dict = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        if not any(lo <= mid < hi for lo, hi in within):
            continue
        open_ = [sp for sp in spans if sp[1] <= mid < sp[2]]
        name = max(open_, key=lambda sp: sp[1])[0] if open_ else BETWEEN
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def span_counters(stats) -> dict:
    """{span: (seconds, entries)} of the spans that ran, from a copy of
    the counter registry (``core/trace.py``)."""
    return {k[:-2]: (stats.get(k[:-2] + "_s", 0.0), int(v))
            for k, v in stats.items() if k.endswith("_n") and v}


def transfers(stats) -> str:
    """The bytes of each transfer span that ran (with the rate over its
    seconds) and the halo's bytes and messages to other ranks, from a
    copy of the counter registry."""
    parts = []
    for name, key in TRANSFERS:
        nbytes, sec = stats.get(key, 0), stats.get(name + "_s", 0.0)
        if nbytes:
            rate = f"{nbytes / sec / 1e9:.3f} GB/s" if sec > 0 else "no time"
            parts.append(f"{name} {int(nbytes)} B ({rate})")
    if stats.get("halo_msgs"):
        parts.append(f"halo {int(stats['halo_bytes'])} B in "
                     f"{int(stats['halo_msgs'])} messages")
    return ", ".join(parts) or "none"


def phase_times(prof) -> dict:
    """Per phase span: host wall s, device s of the kernels (and copies)
    that started inside it, and their ratio."""
    spans, device, _ = trace_events(prof)
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
                b = drv.system.b.cpu().numpy()
                device_loop.reset_stats()
                with record_function(name):
                    drv.set_rhs(b)
                    res = drv.linear_solver_apply()
                    drv.get_solution()
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
            print(f"{name} spans: " + ", ".join(
                f"{k} {v[0]:.6f} s ({v[1]})"
                for k, v in span_counters(s).items()))
            print(f"{name} transfers: {transfers(s)}")
        phases, ops, spans = trace_events(prof)
        for name in ("solve", "solve_warm"):
            if dev.type != "cuda":
                print(f"{name} idle by span: not measured (no device)")
                continue
            idle = idle_by_span(ops, spans, [phases[name]])
            total = sum(idle.values())
            print(f"{name} idle by span: {total:.6f} s; " + ", ".join(
                f"{k} {v:.6f} s ({100 * v / total:.1f}%)" for k, v in
                sorted(idle.items(), key=lambda kv: -kv[1])))
        if args.trace:
            prof.export_chrome_trace(args.trace)
            print(f"trace written to {args.trace} (open with Perfetto)")
        return 0
    finally:
        drv.destroy()


if __name__ == "__main__":
    sys.exit(main())
