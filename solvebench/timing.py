"""The yardstick's arithmetic: the card's peaks, an operator's least
bytes, graph-replay timing, and the reduction of a profiler trace.

``replay_ms`` is a copy of ``hypredrive_tpu_torch/core/entry.py::
replay_ms`` and ``operand_copies`` of ``tools/bench_kernels.py``'s, kept
here so that a change to the program cannot change how it is measured.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

HBM_BYTES_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20   # H100 SXM L2 cache (NVIDIA data sheet)


def spmv_least_bytes(nnz: int, shape: Tuple[int, int], itemsize: int) -> int:
    """The least bytes one y = A x moves: each stored value read once, x
    read once, y written once.  No index bytes, so the count is the same
    whatever format or kernel holds the operator."""
    return (int(nnz) + int(shape[0]) + int(shape[1])) * int(itemsize)


def operand_copies(nbytes: int) -> int:
    """Copies of an operand that fill four times the L2, so that every
    call reads its operand from device memory."""
    return max(1, -(-4 * L2_BYTES // max(1, nbytes)))


def replay_ms(fns, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call: a CUDA graph of ``reps`` calls cycling
    through ``fns`` (copies of one call over copies of its operand),
    replayed ``replays`` times between two CUDA events."""
    import torch

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


def matvec_ms(op, n_cols: int) -> float:
    """Device ms of ``op.matvec(x)`` alone, operand evicted from the L2:
    copies of every tensor field of ``op`` (a dataclass) and of x."""
    import torch

    tensors = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)
               if isinstance(getattr(op, f.name), torch.Tensor)}
    x = torch.randn(n_cols, dtype=op.dtype, device=op.device)
    per_copy = (sum(t.numel() * t.element_size() for t in tensors.values())
                + 2 * x.numel() * x.element_size())
    ops = [op] + [dataclasses.replace(op, **{k: t.clone()
                                             for k, t in tensors.items()})
                  for _ in range(operand_copies(per_copy) - 1)]
    xs = [x] + [x.clone() for _ in ops[1:]]
    return replay_ms([lambda o=o, v=v: o.matvec(v) for o, v in zip(ops, xs)])


@dataclasses.dataclass
class Trace:
    """A profiled stretch of solves: its wall, its device operations
    (name, start ns, duration ns) and the benchmark's host spans (name,
    start ns, end ns), on one clock."""

    window_s: float
    solves: int
    ops: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]


def trace_of(prof, window_s: float, solves: int, span_names) -> Trace:
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append((e.name(), e.start_ns(), e.duration_ns()))
        elif (e.device_type() == DeviceType.CPU and e.is_user_annotation()
              and e.name() in span_names):
            spans.append((e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns()))
    return Trace(window_s, solves, ops, spans)


def busy_intervals(ops) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, merged and sorted."""
    merged: List[List[int]] = []
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    return [(a, b) for a, b in merged]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.ops)) / 1e9


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps
    between device operations by the host span open at their middle."""
    by_op: Dict[str, float] = {}
    for name, _, d in trace.ops:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + d / 1e9
    gaps: Dict[str, float] = {}
    busy = busy_intervals(trace.ops)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        open_ = [s for s in trace.spans if s[1] <= mid < s[2]]
        name = (max(open_, key=lambda s: s[1])[0] if open_
                else "between solves")
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


def quantile(values, q: float) -> Optional[float]:
    """The q-quantile (0 < q < 1) by linear interpolation between order
    statistics."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
