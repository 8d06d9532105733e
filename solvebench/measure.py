"""One run's measurement, in the process that holds the session: set-up,
warm-up, the window, the traced stretch, the per-layer readers and the
check of the window's answers against the reference.

The order is the contract's: the device's peak memory is read when the
window closes, the traced stretch and the readers come after it, and the
reference runs only once the program's state is freed.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np

from . import reference, timing
from .lifecycle import boot_now
from .session import SPANS, sync, tolerance

FORBIDDEN = ("jax", "jaxlib", "flax", "hypredrive_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``k`` of the window's solves, drawn from the
    seed as they complete."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = item


def measure(session, A, rhs: np.ndarray, cfg: dict, mix: dict, seed: int,
            seconds: float, trace: bool, device,
            readers: Optional[Dict[str, Callable]] = None) -> dict:
    """The raw record of one run (see ``run.py`` for the reduction)."""
    import torch
    from hypredrive_tpu_torch.solvers import device_loop as dl

    on_card = device.type == "cuda"
    precon_setup_s = session.setup(rhs[0])
    session.solve(rhs[0])   # captures the graphs every later solve replays
    capture_s = dl.stats["capture_s"]
    before = dict(dl.stats)
    opened = boot_now()
    solves, kept = [], Reservoir(int(mix["check_sample"]), seed)
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % len(rhs)
        ts = time.perf_counter()
        x, iters, converged = session.solve(rhs[k])
        te = time.perf_counter()
        solves.append((te - ts, int(iters), bool(converged)))
        kept.offer(i, (k, x))
        i += 1
        if te - t0 >= seconds:
            break
    window_s = te - t0
    after = dict(dl.stats)
    out = {"window_open": opened, "window_s": window_s, "solves": solves,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if on_card else 0),
           "captures_in_window": after["captures"] - before["captures"]}
    if trace:
        tr = traced_stretch(session, rhs, int(cfg["trace_solves"]), device)
        out["busy_s"] = timing.busy_s(tr)
        out["trace_window_s"] = tr.window_s
        out["breakdown"] = timing.breakdown(tr)
        ctx = SimpleNamespace(
            on_card=on_card, precon_setup_s=precon_setup_s,
            capture_s=capture_s, before=before, after=after, solves=solves,
            trace=tr, operators=session.operators)
        out["per_layer"] = {name: read(ctx)
                            for name, read in (readers or {}).items()}
    session.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["checks"] = check(A, rhs, cfg, kept.items, solves)
    out["sampled"] = len(kept.items)
    return out


def traced_stretch(session, rhs, n: int, device) -> timing.Trace:
    """``n`` solves under torch.profiler (host spans, and the device's
    operations on a card), after the window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in range(n):
            session.solve(rhs[j % len(rhs)])
        sync(device)
        wall = time.perf_counter() - t0
    return timing.trace_of(prof, wall, n, SPANS)


def check(A, rhs, cfg: dict, kept, solves) -> Dict[str, dict]:
    """Each number compared, with its limit: the largest true relative
    residual among the sampled solutions (limit: the configuration's
    tolerance) and the solves the program left unconverged (limit 0)."""
    res = [reference.relative_residual(A, rhs[k], x) for k, x in kept]
    worst = (float("nan") if any(np.isnan(r) for r in res)
             else max(res, default=float("nan")))
    return {"residual": {"value": worst, "limit": tolerance(cfg)},
            "unconverged": {"value": sum(not c for _, _, c in solves),
                            "limit": 0}}
