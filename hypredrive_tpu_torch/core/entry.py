"""What the entry points around the package share: the bench, the example
drivers and the tools.

Each runs on the card unless the caller passes ``--exec-policy host``, the
command-line form of the config's ``general:exec_policy: host``.  Without a
card and without that option :func:`device` raises the typed error that
``exec_policy: device`` raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional, Tuple

import torch

EXEC_POLICIES = ("device", "host")


def add_exec_policy(ap) -> None:
    """The one option that asks for the CPU, on an ``argparse`` parser."""
    ap.add_argument("--exec-policy", choices=EXEC_POLICIES, default="device",
                    help="device: the CUDA card (the default); host: the CPU, "
                         "with the kernels' plain torch versions")


def device(policy: str = "device") -> torch.device:
    """The torch device of an exec policy; raises without a card unless
    the policy is ``host``."""
    from ..linsys.system import resolve_device

    return resolve_device({"exec_policy": 0 if policy == "host" else 1})


def policy_overrides(policy: str) -> List[Tuple[str, str]]:
    """Config overrides (``-a`` pairs) that carry an exec policy."""
    return [("general:exec_policy", "host")] if policy == "host" else []


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def replay_ms(fns, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call on the card: a CUDA graph of ``reps`` calls,
    replayed ``replays`` times between two CUDA events, so the calls run
    back to back with no host gaps.  ``fns`` is one callable, or copies of
    one call over copies of its operand, which the graph cycles through
    (then at least once each).  The first runs once before and once on a
    side stream, as capture requires; temporaries come from the graph's
    private pool.  A launch counter ticks at capture, not at replay."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    reps = max(reps, len(fns))
    fns[0]()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def profiled_device_s(run) -> float:
    """The summed device time of the kernels ``run()`` launches, from
    torch.profiler's raw device events (device activity only; the
    record_function spans mirrored on the device are left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and not e.name().startswith("hypredrv::")) / 1e9


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, and its L2 size as
    torch reports it; None for each where there is no card."""
    out = {"device": None, "power_limit": None, "nvidia_smi": None,
           "l2_bytes": None}
    if not torch.cuda.is_available():
        return out
    out["device"] = torch.cuda.get_device_name(0)
    out["l2_bytes"] = getattr(torch.cuda.get_device_properties(0),
                              "L2_cache_size", None)
    smi: Optional[str] = shutil.which("nvidia-smi")
    if smi:
        proc = subprocess.run([smi, "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60)
        line = proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
            else ""
        out["nvidia_smi"] = line or None
        if "," in line:
            out["power_limit"] = line.rsplit(",", 1)[1].strip()
    return out
