"""A Newton sequence driven through the library: one new system a solve.

The system under test is ``hypredrive_tpu_torch.api.HypreDrive`` in
library mode, one process on one device, told the time steps of the
sequence through its ``linear_system: timestep_filename`` schedule, so
that the configuration's ``reuse: per_timestep`` rebuilds the
preconditioner on the first system of each step and keeps it for the
others.  One timed call is the user's whole call for one system, in this
order: the new matrix values, b, the dofmap and x0 = 0 in (the span
``set_matrix``); the preconditioner created, where the reuse engine
decides, the solver created and set up, ending in a synchronise
(``setup``); the solve (``apply``); the solution back on the host
(``get_solution``); the preconditioner handed back, which the engine may
keep.

The run: the systems and right-hand sides made in set-up, one time step
of warm-up (the first rebuild, the kernels built), then the window, whole
time steps until ``--seconds`` have passed or the systems left are the
traced stretch's, then the traced stretch (``trace_solves`` systems, whole
time steps), the readers, and the reference's check of a sample of the
window's systems, each against its own matrix and right-hand side.  A
run whose rebuild decisions are not one per time step (and one after a
solve that failed, which the reuse engine forces) exits 1 with no
result.
"""

from __future__ import annotations

import gc
import os
import resource
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from . import reference, timing
from .lifecycle import boot_now
from .measure import Reservoir
from .session import int_keys, sync, tolerance

SPANS = ("set_matrix", "setup", "apply", "get_solution")


def schedule_text(count: int, per_step: int) -> str:
    """A timestep file: the number of steps, then "step first-system" a
    line, ``per_step`` systems to a step."""
    steps = count // per_step
    return "".join([f"{steps}\n"] + [f"{t} {t * per_step}\n"
                                    for t in range(steps)])


class SequenceSession:
    """One configuration's solver and preconditioner over a sequence of
    systems on one pattern, one system per call."""

    def __init__(self, cfg: dict, dofmap, count: int, per_step: int,
                 device, dtype: str):
        from hypredrive_tpu_torch import HypreDrive

        self.device, self.dofmap, self.held = device, dofmap, None
        general = {"dtype": dtype, "statistics": "off"}
        if device.type == "cpu":
            general["exec_policy"] = "host"
        self.drv = HypreDrive()
        self.drv.set_library_mode()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "timesteps.txt")
            with open(path, "w") as f:
                f.write(schedule_text(count, per_step))
            # the library reads the schedule while it takes the options
            self.drv.input_args_from_dict({
                "general": general,
                "linear_system": {"timestep_filename": path},
                "solver": cfg["solver"],
                "preconditioner": int_keys(cfg["preconditioner"])})

    def solve(self, A: sp.csr_matrix, b: np.ndarray, hold: bool = False
              ) -> dict:
        """One system, the user's whole call: its record (``wall_s``,
        ``ingest_s``, ``setup_s``, ``rebuilt``, ``iters``, ``converged``,
        ``x``).  ``hold`` keeps the finest level of the preconditioner it
        used for :meth:`operators`."""
        from torch.profiler import record_function

        drv = self.drv
        t0 = time.perf_counter()
        with record_function("set_matrix"):
            drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
            t1 = time.perf_counter()
            drv.set_rhs(b)
            t2 = time.perf_counter()
            drv.set_dofmap(self.dofmap)
            t3 = time.perf_counter()
            drv.reset_initial_guess()
        with record_function("setup"):
            before = drv.precon
            drv.precon_create()
            rebuilt = drv.precon is not before
            drv.linear_solver_create()
            t4 = time.perf_counter()
            drv.linear_solver_setup()
            sync(self.device)
            t5 = time.perf_counter()
        with record_function("apply"):
            res = drv.linear_solver_apply()
        with record_function("get_solution"):
            x = drv.get_solution()
        if hold:
            self.held = drv.precon.state.levels[0]
        drv.precon_destroy()
        te = time.perf_counter()
        return {"wall_s": te - t0, "ingest_s": (t1 - t0) + (t3 - t2),
                "setup_s": t5 - t4, "rebuilt": rebuilt,
                "iters": int(res.iters), "converged": bool(res.converged),
                "x": x}

    def operators(self) -> List[tuple]:
        """(name, operator) of the finest level's A, P and R of the
        preconditioner of the last system solved with ``hold``."""
        lv = self.held
        return [("A0", lv.A), ("P0", lv.P), ("R0", lv.R)]

    def free(self) -> None:
        self.drv.destroy()
        self.drv = self.held = None


class ReuseError(RuntimeError):
    """The library did not rebuild the preconditioner once per time
    step."""


def measure_sequence(session: SequenceSession, systems, rhs: np.ndarray,
                     cfg: dict, mix: dict, seed: int, seconds: float,
                     trace: bool, device,
                     readers: Optional[Dict[str, Callable]] = None) -> dict:
    """The raw record of one run, in ``measure.measure``'s keys (see
    ``run.py`` for the reduction), with each window system's record
    under ``systems``."""
    import torch
    from hypredrive_tpu_torch.solvers import device_loop as dl

    on_card = device.type == "cuda"
    per = int(mix["newton_per_timestep"])
    traced = int(cfg["trace_solves"])
    if traced < per or traced % per or len(systems) < 2 * per + traced:
        raise ValueError(f"trace_solves={traced} and systems_count="
                         f"{len(systems)} leave no whole time step of "
                         f"{per} systems for the warm-up, the window and "
                         "the traced stretch")
    decisions = []   # (rebuilt, converged) of every system solved

    def step(k0: int) -> List[dict]:
        recs = [session.solve(systems[k], rhs[k]) for k in range(k0, k0 + per)]
        decisions.extend((r["rebuilt"], r["converged"]) for r in recs)
        return recs

    step(0)   # the first rebuild; builds the kernels on a first run
    before = dict(dl.stats)
    usage = resource.getrusage(resource.RUSAGE_SELF)
    opened = boot_now()
    window, kept = [], Reservoir(int(mix["check_sample"]), seed)
    k = per
    t0 = time.perf_counter()
    while k + per <= len(systems) - traced:
        for rec in step(k):
            kept.offer(len(window), (k, rec.pop("x")))
            window.append(rec)
            k += 1
        te = time.perf_counter()
        if te - t0 >= seconds:
            break
    window_s = te - t0
    after = dict(dl.stats)
    print_window(window, usage, window_s)
    solves = [(r["wall_s"], r["iters"], r["converged"]) for r in window]
    out = {"window_open": opened, "window_s": window_s, "solves": solves,
           "systems": window,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if on_card else 0),
           "captures_in_window": after["captures"] - before["captures"]}
    if trace:
        tr = traced_stretch(session, systems, rhs, k, traced, device,
                            decisions)
        out["busy_s"] = timing.busy_s(tr)
        out["trace_window_s"] = tr.window_s
        out["breakdown"] = timing.breakdown(tr)
        ctx = SimpleNamespace(
            on_card=on_card, before=before, after=after, solves=solves,
            systems=window, trace=tr, operators=session.operators)
        out["per_layer"] = {name: read(ctx)
                            for name, read in (readers or {}).items()}
    session.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rebuilt = [r for r, _ in decisions]
    # one rebuild per time step, and one after each solve that failed
    # (the engine's rebuild_on_solver_failure)
    want = [i % per == 0 or not decisions[i - 1][1]
            for i in range(len(decisions))]
    print(f"solvebench: rebuild decisions {rebuilt}", file=sys.stderr)
    if rebuilt != want:
        raise ReuseError(f"rebuild decisions {rebuilt}, not one rebuild "
                         f"per time step of {per} systems and one after "
                         f"each failed solve ({want})")
    out["checks"] = check(systems, rhs, cfg, kept.items, solves)
    out["sampled"] = len(kept.items)
    return out


def print_window(window: List[dict], usage, window_s: float) -> None:
    """Each window system's wall, set-up and iterations, and the process's
    CPU seconds over the window, on stderr."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    print("solvebench: window systems (rebuilt, wall s, setup s, iters): "
          + " ".join(f"({int(r['rebuilt'])} {r['wall_s']:.3f} "
                     f"{r['setup_s']:.3f} {r['iters']})" for r in window),
          file=sys.stderr)
    print(f"solvebench: window CPU: user {now.ru_utime - usage.ru_utime:.2f}"
          f" s, sys {now.ru_stime - usage.ru_stime:.2f} s over "
          f"{window_s:.2f} s", file=sys.stderr)


def traced_stretch(session, systems, rhs, k0: int, n: int, device,
                   decisions: list) -> timing.Trace:
    """Systems k0 … k0 + n − 1 under torch.profiler (host spans, and the
    device's operations on a card), after the window; the last one's
    finest operators held for the readers.  The seconds each of the
    program's spans took in the stretch's first system, a rebuild, go to
    stderr."""
    from torch.profiler import ProfilerActivity, profile
    from hypredrive_tpu_torch.solvers import device_loop as dl

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(k0, k0 + n):
            before = dict(dl.stats)
            rec = session.solve(systems[k], rhs[k], hold=k == k0 + n - 1)
            decisions.append((rec["rebuilt"], rec["converged"]))
            if k == k0:
                split = {key: v - before.get(key, 0)
                         for key, v in dl.stats.items()
                         if key.endswith("_s") and v > before.get(key, 0)}
                print("solvebench: traced rebuild: setup "
                      f"{rec['setup_s']!r} s, wall {rec['wall_s']!r} s; "
                      "spans (s) " + ", ".join(
                          f"{key[:-2]} {v!r}" for key, v in sorted(
                              split.items(), key=lambda kv: -kv[1])),
                      file=sys.stderr)
        sync(device)
        wall = time.perf_counter() - t0
    return timing.trace_of(prof, wall, n, SPANS)


def check(systems, rhs, cfg: dict, kept, solves) -> Dict[str, dict]:
    """Each number compared, with its limit: the largest true relative
    residual among the sampled solutions, each against its own system
    (limit: the configuration's tolerance), and the solves the program
    left unconverged (limit 0)."""
    res = [reference.relative_residual(systems[k], rhs[k], x)
           for k, x in kept]
    worst = (float("nan") if any(np.isnan(r) for r in res)
             else max(res, default=float("nan")))
    return {"residual": {"value": worst, "limit": tolerance(cfg)},
            "unconverged": {"value": sum(not c for _, _, c in solves),
                            "limit": 0}}


def run_sequence(man, cfg: dict, mix: dict, args, device,
                 readers: Optional[Dict[str, Callable]]) -> dict:
    """Set-up and measurement of a Newton-sequence cell: the systems and
    right-hand sides from the configuration and the seed, the session,
    and :func:`measure_sequence`."""
    from .mix import drift_right_hand_sides

    count = int(mix["systems_count"])
    systems, dofmap = man.sequence(cfg["problem"], count)
    rhs = drift_right_hand_sides(mix, systems[0].shape[0], args.seed)
    session = SequenceSession(cfg, dofmap, count,
                              int(mix["newton_per_timestep"]), device,
                              cfg["dtype"])
    return measure_sequence(session, systems, rhs, cfg, mix, args.seed,
                            args.seconds, bool(args.trace), device,
                            readers=readers)
