"""The device loop: a Krylov solve as CUDA graphs that the host replays.

Counterpart of the JAX package's jitted ``lax.while_loop`` cores
(``hypredrive_tpu/solvers/base.py::jitted_core``).  A solver core is
written as a :class:`Loop`: persistent state buffers, a few named
*bodies* that read and write only those buffers, and a *schedule* that
says in which order the bodies run and after which one a device flag
says stop.  Every body is written in the JAX ``body`` form, masked by a
device flag ``active``: an iteration that runs after convergence changes
no state and is not counted, and an active one computes what the unmasked
iteration computes.

One code path, three ways to run it (:func:`run`):

- ``graph`` (a CUDA device, the main path): each body is captured once
  into a CUDA graph, and the schedule replays the graphs.  The host
  enqueues the next replay *before* it reads the flag of the one before,
  which comes by a non-blocking copy into pinned memory and an event, so
  the device never waits on the host; at most one masked replay runs
  past each stop.  A capture or replay that fails raises: nothing drops
  back to the eager loop.
- ``eager`` (the CPU, where the tests run; and on the card inside
  :func:`eager`, the plain version that ``chip_smoke.py`` and the card
  tests compare against): the same bodies and the same schedule, called
  eagerly, each flag read one body late as on the card.
- ``unroll`` (a solve nested in a body that is being captured, such as a
  ``krylov`` preconditioner component or the GMRES-Schur ILU, where no
  graph can be replayed): the schedule runs every body of its fixed
  budget, in order, with the same masks, and reads no flag.  The JAX
  package nests its ``while_loop``s the same way.

Graphs are cached by the solver's statics, dtype, length and device and
by the identity of the operator and preconditioner: every object, tensor
and scalar their callables reach (:func:`_fingerprint`).  An entry is
dropped when one of those objects is freed, when :func:`release` names it
(the driver's destroy and rebuild verbs), or when the cache holds more
than ``MAX_ENTRIES`` entries.  Its graphs share one memory pool; their
temporaries live only inside one replay, since the state that crosses
replays lives in the buffers allocated before capture.  This cache takes
the place of the JAX package's ``lru_cache`` of jitted closures.

The kernel wrappers' launch counters (:func:`counted`) tick where a
kernel is launched eagerly.  A capture records each graph's launches and
restores the counters; every replay of an active body adds them, so the
counts mean what the eager loop's meant.  Warm-up launches and masked
replays are not counted.  The halo and epilogue counters of the registry
(:data:`REPLAYED`) are recorded and added the same way.  :data:`stats`
(the registry of ``core/trace.py``) counts the replays, masked replays,
host reads, captures, graph nodes and the nodes replayed; the spans
``graph_lookup``, ``capture``, ``launch``, ``flag_wait`` and ``read_out``
time the host's part of a solve.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import types
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.trace import STAT_KEYS, reset_stats, span, stats  # noqa: F401

MAX_ENTRIES = 8          # cached solves (each: its buffers and graphs)
_FINGERPRINT_DEPTH = 12  # nesting levels of a preconditioner state walked
# attributes a preconditioner object keeps for its setup, not its apply
_SKIP_ATTRS = frozenset(("args", "input_args", "_component_cache",
                         "_setup_count"))

_local = threading.local()
_cache: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
_dead: List[tuple] = []
_capture_stream: Optional[torch.cuda.Stream] = None

# the registry's counters that a captured body adds to on every replay
REPLAYED = ("halo_bytes", "halo_msgs", "epilogue_fused", "epilogue_plain")


def counted():
    """The kernel wrappers whose ``launches`` count kernel launches."""
    from ..ops.csr_spmv import csr_spmv, csr_spmv_epilogue
    from ..ops.dia_spmv import dia_spmv, dia_spmv_epilogue
    from ..ops.krylov_small import givens_update, hessenberg_backsolve

    return (dia_spmv, csr_spmv, givens_update, hessenberg_backsolve,
            dia_spmv_epilogue, csr_spmv_epilogue)


def _counts():
    return [f.launches for f in counted()] + [stats[k] for k in REPLAYED]


def _set_counts(values) -> None:
    fns = counted()
    for f, n in zip(fns, values):
        f.launches = n
    stats.update(zip(REPLAYED, values[len(fns):]))


def _add_counts(delta, sign=1):
    fns = counted()
    for f, d in zip(fns, delta):
        f.launches += sign * d
    for k, d in zip(REPLAYED, delta[len(fns):]):
        stats[k] += sign * d


@contextlib.contextmanager
def uncounted():
    """Launches, halo sends and epilogue steps inside do not count: a
    timing loop or a comparison with a plain version, not the work of a
    solve (every count ends as it began)."""
    saved = _counts()
    try:
        yield
    finally:
        _set_counts(saved)


@contextlib.contextmanager
def eager():
    """Run the solves inside on the card as the eager loop (the plain
    version the graphs are checked against); no graph is captured."""
    prev = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def mode_for(device: torch.device, unroll: bool = False,
             group=None) -> str:
    """``graph``, ``eager`` or ``unroll`` for a solve on ``device`` whose
    reductions and halos go over ``group`` (None: one rank).  Only NCCL's
    collectives can be captured, so a solve over another backend's group
    (gloo carrying CUDA tensors) runs eagerly."""
    if unroll or (device.type == "cuda"
                  and torch.cuda.is_current_stream_capturing()):
        return "unroll"
    if device.type == "cuda" and not getattr(_local, "eager", False) \
            and (group is None or _is_nccl(group)):
        return "graph"
    return "eager"


def _is_nccl(group) -> bool:
    import torch.distributed as dist

    return str(dist.get_backend(group)).lower() == "nccl"


# ---------------------------------------------------------------------------
# masked device updates
# ---------------------------------------------------------------------------

def put(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
        on: torch.Tensor) -> None:
    """``buf[idx] = val`` where the device flag ``on`` holds; ``idx`` is a
    0-d int64 device index inside ``buf``."""
    i = idx.reshape(1)
    old = buf.index_select(0, i)
    buf.index_copy_(0, i, torch.where(on, val, old))


def keep(dst: torch.Tensor, new: torch.Tensor, on: torch.Tensor) -> None:
    """``dst = new`` where ``on`` holds, else ``dst`` stays."""
    dst.copy_(torch.where(on, new, dst))


# ---------------------------------------------------------------------------
# the loop and its runner
# ---------------------------------------------------------------------------

class Loop:
    """One solve's state: tensors set as attributes (allocated before any
    capture), the bodies (``body(name)`` decorates them, in warm-up order)
    and the flags the schedule reads."""

    def __init__(self, like: torch.Tensor):
        self.device = like.device
        self.dtype = like.dtype
        self.bodies: Dict[str, Callable[[], None]] = {}
        self.warm: List[str] = []

    def vec(self, n: int, dtype=None) -> torch.Tensor:
        return torch.zeros(n, dtype=dtype or self.dtype, device=self.device)

    def scalar(self, dtype=None, fill=0) -> torch.Tensor:
        return torch.full((), fill, dtype=dtype or self.dtype,
                          device=self.device)

    def flag(self, fill=False) -> torch.Tensor:
        return torch.full((), fill, dtype=torch.bool, device=self.device)

    def body(self, name: str, warm: bool = True):
        """Register a body; ``warm=False`` skips its eager warm-up before
        capture (a body that runs the same operations as one warmed up)."""
        def deco(fn):
            self.bodies[name] = fn
            if warm:
                self.warm.append(name)
            return fn
        return deco


class _Entry:
    """A cached solve: its loop (buffers only) and graphs, and weak
    references to the objects whose death drops it."""

    def __init__(self, loop: Loop):
        self.loop = loop
        self.owner_ids: set = set()
        self.refs: list = []
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.deltas: Dict[str, List[int]] = {}
        self.nodes: Dict[str, int] = {}
        self.pinned = torch.zeros(4, dtype=torch.bool, pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(4)]


class Runner:
    """What a schedule calls: ``go(name)`` runs a body (replays its
    graph), ``mark(flag)`` notes a device flag after it, ``stopped()``
    reads the flag marked before the last ``go``: True means that ``go``
    ran masked.  In ``unroll`` mode nothing is read and ``stopped()`` is
    False, so the schedule runs its whole budget."""

    def __init__(self, mode: str, loop: Loop, entry: Optional[_Entry]):
        self.mode, self.loop, self.entry = mode, loop, entry
        self.reads = mode != "unroll"
        self.marks: list = []
        self.before = -1
        self.delta = None
        self.replays = self.masked = self.host_reads = 0
        self.replayed_nodes = 0

    def go(self, name: str) -> None:
        self.before = len(self.marks) - 1
        self.replays += 1
        if self.mode == "graph":
            with span("launch"):
                self.entry.graphs[name].replay()
            self.replayed_nodes += self.entry.nodes[name]
            self.delta = self.entry.deltas[name]
            _add_counts(self.delta)
        elif self.mode == "eager":
            c0 = _counts()
            self.loop.bodies[name]()
            self.delta = [b - a for a, b in zip(c0, _counts())]
        else:
            self.loop.bodies[name]()

    def mark(self, flag: torch.Tensor) -> None:
        if not self.reads:
            return
        if self.mode == "graph":
            slot = len(self.marks) % len(self.entry.events)
            self.entry.pinned[slot:slot + 1].copy_(flag.reshape(1),
                                                   non_blocking=True)
            self.entry.events[slot].record()
            self.marks.append(slot)
        else:
            self.marks.append(flag.clone())

    def stopped(self) -> bool:
        if not self.reads or self.before < 0:
            return False
        self.host_reads += 1
        m = self.marks[self.before]
        with span("flag_wait"):
            if self.mode == "graph":
                self.entry.events[m].synchronize()
                stop = bool(self.entry.pinned[m])
            else:
                stop = bool(m)
        if stop:
            self.masked += 1
            _add_counts(self.delta, -1)
        return stop


# ---------------------------------------------------------------------------
# the graph cache
# ---------------------------------------------------------------------------

def _leaves(obj, out: list, seen: set, owners: list, depth: int) -> None:
    """Append what identifies ``obj`` for a captured graph: each tensor's
    address, shape, strides, dtype and device, each scalar's value, each
    other object's type and identity; objects are walked through their
    attributes, items and closures."""
    if isinstance(obj, torch.Tensor):
        out.append(("T", obj.data_ptr(), tuple(obj.shape), obj.stride(),
                    obj.dtype, obj.device))
        return
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes, torch.dtype, torch.device)):
        out.append(obj)
        return
    if isinstance(obj, (np.ndarray, np.generic)):
        out.append(("N", id(obj), np.shape(obj)))
        return
    if isinstance(obj, (type, types.ModuleType, types.BuiltinFunctionType,
                        types.CodeType)) or depth > _FINGERPRINT_DEPTH:
        out.append(("O", id(obj)))
        return
    if id(obj) in seen:
        out.append(("S", id(obj)))
        return
    seen.add(id(obj))
    if isinstance(obj, types.MethodType):
        out.append(("M", obj.__func__))
        owners.append(obj.__self__)
        _leaves(obj.__self__, out, seen, owners, depth + 1)
    elif isinstance(obj, types.FunctionType):
        # a function is identified by its code and what it closes over,
        # so a fresh lambda over the same objects finds the same graphs
        out.append(("F", obj.__code__))
        for cell in obj.__closure__ or ():
            v = cell.cell_contents
            if not isinstance(v, (types.FunctionType, types.MethodType)):
                owners.append(v)
            _leaves(v, out, seen, owners, depth + 1)
        for v in obj.__defaults__ or ():
            _leaves(v, out, seen, owners, depth + 1)
    elif isinstance(obj, (tuple, list)):
        out.append(("L", type(obj), len(obj)))
        for v in obj:
            _leaves(v, out, seen, owners, depth + 1)
    elif isinstance(obj, dict):
        out.append(("D", len(obj)))
        for k, v in obj.items():
            out.append(k if isinstance(k, (str, int)) else ("O", id(k)))
            _leaves(v, out, seen, owners, depth + 1)
    elif hasattr(obj, "__dict__"):
        out.append(("C", type(obj), id(obj)))
        for k, v in vars(obj).items():
            if k not in _SKIP_ATTRS:
                out.append(k)
                _leaves(v, out, seen, owners, depth + 1)
    else:
        out.append(("O", type(obj), id(obj)))


def _fingerprint(fns):
    """(key, owners): the identity of the callables ``fns``, and the
    objects they are bound to or close over, whose death drops the entry
    (a graph is replayed only when the key matches, so the tensors it
    reads are alive; the owners free the memory of graphs that can no
    longer match)."""
    out: list = []
    owners: list = []
    seen: set = set()
    for fn in fns:
        _leaves(fn, out, seen, owners, 0)
    return tuple(out), owners


def _drop_dead() -> None:
    while _dead:
        _cache.pop(_dead.pop(), None)


def release(*objs) -> int:
    """Drop the cached graphs of every solve whose operator or
    preconditioner reaches one of ``objs``; the number dropped."""
    _drop_dead()
    ids = {id(o) for o in objs if o is not None}
    gone = [k for k, e in _cache.items() if ids & e.owner_ids]
    for k in gone:
        del _cache[k]
    return len(gone)


def clear() -> None:
    """Drop every cached graph."""
    _dead.clear()
    _cache.clear()


def cached() -> int:
    """The number of cached solves."""
    _drop_dead()
    return len(_cache)


def _stream() -> torch.cuda.Stream:
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    return _capture_stream


def _capture(loop: Loop, group=None) -> _Entry:
    """Warm the bodies up on the capture stream (first use of cuBLAS
    handles, kernel attributes and allocator pools on that stream; with a
    ``group``, a collective first, so that its communicator exists before
    any capture), then capture each into a graph of one shared pool; the
    counters end as they began."""
    from ..ops.krylov_small import graph_nodes

    entry = _Entry(loop)
    with span("capture"):       # capture_s; its entries count in captures
        c0 = _counts()
        side = _stream()
        side.wait_stream(torch.cuda.current_stream())
        pool = None
        with torch.cuda.stream(side):
            if group is not None:
                import torch.distributed as dist

                dist.all_reduce(torch.zeros(1, device=loop.device),
                                group=group)
            for name in loop.warm:
                loop.bodies[name]()
            for name, fn in loop.bodies.items():
                g = torch.cuda.CUDAGraph(keep_graph=True)
                before = _counts()
                g.capture_begin(pool=pool)
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        g.capture_end()
                    raise
                g.capture_end()
                entry.deltas[name] = [b - a for a, b in
                                      zip(before, _counts())]
                entry.nodes[name] = graph_nodes(g)
                g.instantiate()
                pool = g.pool() if pool is None else pool
                entry.graphs[name] = g
        torch.cuda.current_stream().wait_stream(side)
        _set_counts(c0)
        torch.cuda.synchronize(loop.device)
    loop.bodies = {}      # the graphs hold the work; drop the callables
    return entry


def run(key: tuple, fns, make: Callable[[], Loop], inputs: Dict[str, object],
        schedule: Callable[[Runner, Loop], None], unroll: bool = False,
        group=None) -> tuple:
    """Run one solve: ``make()`` builds the loop, ``inputs`` are copied
    into its buffers of the same names, ``schedule`` drives it.  Returns
    (loop, mode); in ``graph`` mode the loop's buffers belong to the
    cache, so the caller copies out what it keeps.  ``group`` is the
    process group of the solve's collectives (None on one rank): they are
    captured with the bodies, after the eager warm-up on the capture
    stream has made the group's communicator, and every rank replays the
    same bodies, since every flag derives from reduced values."""
    dev = next(iter(inputs.values())).device
    mode = mode_for(dev, unroll, group)
    entry = full = owners = None
    if mode == "graph":
        with span("graph_lookup"):
            _drop_dead()
            fp, owners = _fingerprint(fns)
            full = (key, fp)
            entry = _cache.get(full)
            if entry is not None:
                _cache.move_to_end(full)
    loop = entry.loop if entry is not None else make()
    for name, v in inputs.items():
        getattr(loop, name).copy_(v)
    if mode == "graph" and entry is None:
        if group is not None:
            from ..core import runtime

            # a captured NCCL collective holds its communicator until the
            # graph is destroyed, and destroying the communicator waits
            # for those: finalize drops the graphs before the group
            runtime.at_finalize(clear)
        entry = _capture(loop, group)
        entry.owner_ids = {id(o) for o in owners}
        for o in owners:
            with contextlib.suppress(TypeError):
                entry.refs.append(weakref.ref(
                    o, lambda _r, k=full: _dead.append(k)))
        _cache[full] = entry
        while len(_cache) > MAX_ENTRIES:
            _cache.popitem(last=False)
        stats["graphs"] += len(entry.graphs)
        stats["nodes"] += sum(entry.nodes.values())
        stats["max_nodes"] = max(stats["max_nodes"],
                                 max(entry.nodes.values()))
    R = Runner(mode, loop, entry)
    schedule(R, loop)
    stats["solves"] += 1
    stats["graph_solves"] += mode == "graph"
    stats["replays"] += R.replays
    stats["masked"] += R.masked
    stats["host_reads"] += R.host_reads + (mode != "unroll")
    stats["replayed_nodes"] += R.replayed_nodes
    return loop, mode


def read_out(x: torch.Tensor, arrays, scalars, mode: str):
    """(x, the arrays as float64 numpy, the scalars as Python numbers)
    after the loop, in one device read; in ``unroll`` mode nothing is
    read and the device tensors come back."""
    if mode == "unroll":
        return x, list(arrays), list(scalars)
    with span("read_out"):
        if mode == "graph":
            x = x.clone()
        vals = torch.cat([a.reshape(-1).double() for a in arrays]
                         + [torch.stack([s.double() for s in scalars])]
                         ).cpu().numpy()
    out, k = [], 0
    for a in arrays:
        out.append(vals[k:k + a.numel()].reshape(a.shape))
        k += a.numel()
    return x, out, vals[k:].tolist()
