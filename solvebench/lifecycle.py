"""Process lifetimes: no process a run starts outlives it.

A run is one process.  What it starts (the program's kernel builds) it
waits for; before its last line it walks ``/proc`` for any descendant
still alive, kills it and reaps it, and says so on stderr.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, List


def boot_now() -> float:
    """Seconds since boot, the clock of :func:`process_start`."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start(pid="self") -> float:
    """When a process started, in :func:`boot_now`'s seconds."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _parents() -> Dict[int, int]:
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                out[int(entry)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):   # gone meanwhile
            continue
    return out


def descendants(pid: int) -> List[int]:
    parents = _parents()
    found, frontier = [], [pid]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parents.items() if pp == p]
        found += kids
        frontier += kids
    return found


def reap_descendants() -> List[int]:
    """Kill every descendant of this process that is still alive, reap
    the children among them; the pids found."""
    left = descendants(os.getpid())
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:   # a grandchild: init reaps it
            pass
    return left
