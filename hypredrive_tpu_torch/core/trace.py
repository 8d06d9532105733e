"""The program's counters and spans: one registry, one span primitive.

:data:`stats` is the process's counter registry.  The device loop's
counts (solves, replays, host reads, captures, graph nodes) live here,
and :func:`span` adds the wall time and the entries of each named stretch
of work: ``<name>_s`` and ``<name>_n``.  A reader copies the dict before
and after a stretch of solves and takes the difference, so a counter
added here reaches it with no change on its side.

A span costs two clock reads and two dict updates (its counters' keys
are built once per name).  Only while a torch
profiler is recording does it also open ``record_function(
"hypredrv::<name>")``, which puts the stretch in the profiler trace on
the device operations' clock, so that each idle gap of the device can be
put down to the host work open around it.  With no profiler it enters no
``record_function``.

The spans, where they are opened, and the counters they add to (besides
``<name>_s``/``_n``):

- ``rhs_upload``: ``LinearSystem.set_rhs_array`` (``h2d_bytes``);
- ``solution_download``: ``LinearSystem.get_solution`` (``d2h_bytes``);
- ``residual_check``: ``Solver.apply``, the true residuals before and
  after the timed solve and ‖b‖, one entry a solve;
- ``graph_lookup``: ``device_loop.run``, the graph cache's key and look-up;
- ``capture``: ``device_loop._capture``, counted as ``capture_s`` and
  ``captures`` (the cached solves captured);
- ``launch``: a CUDA graph's replay in ``device_loop.Runner.go``;
- ``flag_wait``: ``device_loop.Runner.stopped``, the wait for and read of
  a convergence flag;
- ``read_out``: ``device_loop.read_out``, the results' copy to the host;
- ``hierarchy_host``: one AMG or MGR level's host construction (strength
  graph to Galerkin product; F/C split to coarse product);
- ``operator_build``: ``EllMatrix.from_csr`` and
  ``DistEllMatrix.from_csr``, a device operator's host conversion and
  upload;
- ``component_<kind>`` and ``ilu0_factor``.

The statistics phases of ``core/stats.py`` (``matrix``, ``prec``,
``solve``, the caller's own annotations) are ranges only
(``counted=False``): they keep their own timers, and a caller's tag never
reaches a counter.

``halo_bytes`` and ``halo_msgs`` count the bytes and messages a rank's
halo exchanges send to other ranks; a captured body adds its share on
every replay (``device_loop``).  ``tools/profile_solve.py`` prints them,
and the transfers' bytes, beside the spans.  ``epilogue_fused`` and
``epilogue_plain`` count the cycles' steps of ``ops/epilogue.py`` that
ran inside an SpMV kernel and those that ran as torch chains, one a
call of an ``EllMatrix`` step method; they too are added on every
replay.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, Tuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

STAT_KEYS = (
    # the device loop (solvers/device_loop.py)
    "solves", "graph_solves", "replays", "masked", "host_reads",
    "captures", "capture_s", "graphs", "max_nodes", "nodes",
    "replayed_nodes",
    # the spans around a solve and its transfers
    "rhs_upload_s", "rhs_upload_n", "h2d_bytes",
    "solution_download_s", "solution_download_n", "d2h_bytes",
    "residual_check_s", "residual_check_n",
    "graph_lookup_s", "graph_lookup_n", "launch_s", "launch_n",
    "flag_wait_s", "flag_wait_n", "read_out_s", "read_out_n",
    # preconditioner set-up
    "hierarchy_host_s", "hierarchy_host_n",
    "operator_build_s", "operator_build_n",
    # the mesh's halo exchanges to other ranks
    "halo_bytes", "halo_msgs",
    # the cycles' steps in an SpMV kernel's epilogue, and as torch chains
    "epilogue_fused", "epilogue_plain")
stats: Dict[str, float] = dict.fromkeys(STAT_KEYS, 0)


def reset_stats() -> None:
    """Zero every counter of :data:`stats`."""
    stats.update(dict.fromkeys(stats, 0))
    stats.update(dict.fromkeys(STAT_KEYS, 0))


def count(key: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``key``."""
    stats[key] = stats.get(key, 0) + n


# a span's range name and its two counters, built once per name; the
# capture span counts its entries in the device loop's ``captures``
_KEYS: Dict[str, Tuple[str, str, str]] = {
    "capture": ("hypredrv::capture", "capture_s", "captures")}


def _keys(name: str) -> Tuple[str, str, str]:
    keys = _KEYS.get(name)
    if keys is None:
        keys = _KEYS[name] = ("hypredrv::" + name, name + "_s", name + "_n")
    return keys


class span:
    """``with span(name):`` adds the stretch's wall time to ``<name>_s``
    and ``n`` (default 1) to ``<name>_n``; under a recording profiler it
    is also the ``hypredrv::<name>`` range.  ``n`` may be changed inside
    (a stretch that turned out to build nothing counts its time only).
    With ``counted=False`` it is the range alone: no clock read and no
    counter.  ``begin()``/``end()`` are the same for a stretch that is not
    a block of code."""

    __slots__ = ("n", "_keys", "_t0", "_range")

    def __init__(self, name: str, n: int = 1, counted: bool = True):
        self.n = n
        self._keys = ((_KEYS.get(name) or _keys(name)) if counted
                      else ("hypredrv::" + name, None, None))

    def begin(self) -> "span":
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = record_function(self._keys[0])
            self._range.__enter__()
        if self._keys[1] is not None:
            self._t0 = perf_counter()
        return self

    def end(self) -> None:
        _, ks, kn = self._keys
        if ks is not None:
            dt = perf_counter() - self._t0
            stats[ks] = stats.get(ks, 0) + dt
            stats[kn] = stats.get(kn, 0) + self.n
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    __enter__ = begin

    def __exit__(self, *exc) -> None:
        self.end()
