"""Statistics: phase timers, per-solve entries, and the ASCII summary table.

Counterpart of ``hypredrive_tpu/core/stats.py`` (ref: src/internal/stats.c,
include/internal/stats.h): an annotation state machine where named
begin/end marks drive timers —

  * ``"matrix"`` begin opens a *new* linear-system entry
    (ref: src/internal/stats.c:315 HandleAnnotationBegin),
  * ``"rhs"``/``"dofmap"`` accumulate into the current entry's build time,
  * ``"prec"`` is preconditioner setup, ``"solve"`` is the Krylov solve,
  * any other name is a custom application annotation.

Hierarchical *level* annotations (up to 4 deep — e.g. timestep → Newton
iteration) tag entries with a dotted path like ``1.2`` and feed per-level
rollup tables (ref: src/internal/stats.c:957 StatsAnnotateLevelBegin,
:1689 StatsLevelPrint); the reuse engine reads the open frames and the
closed records.

Each phase also opens a ``torch.profiler.record_function`` span named
``hypredrv::<phase>``, visible in a profiler trace.

The summary table format is byte-compatible with the reference
(ref: src/internal/stats.c:1222-1365; examples/refOutput/ex1.txt).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.profiler import record_function

_BUILD_PHASES = ("matrix", "rhs", "dofmap")
_KNOWN_PHASES = _BUILD_PHASES + ("prec", "solve")

MAX_LEVELS = 4  # ref: include/internal/stats.h level annotation depth


@dataclass
class StatsEntry:
    """One solve entry (ref: include/internal/stats.h:100-160)."""

    ls_id: int = 0
    build_times: Dict[str, float] = field(default_factory=dict)
    setup_time: float = 0.0
    solve_time: float = 0.0
    iters: int = 0
    initial_res_norm: float = 0.0
    rel_res_norm: float = 0.0
    converged: bool = True
    path: str = ""  # hierarchical level path label like "1.2"
    is_rerun: bool = False  # variant/repetition on the same system
                            # (blank LS-build column, ref: ex8 output)

    @property
    def build_time(self) -> float:
        return sum(self.build_times.values())


@dataclass
class _LevelFrame:
    name: str
    index: int
    t_start: float
    first_entry: int


class Stats:
    """Annotation-driven statistics collector."""

    def __init__(self, use_millisec: bool = True, name: str = ""):
        self.use_millisec = use_millisec
        self.name = name
        self.entries: List[StatsEntry] = []
        self._open: Dict[str, float] = {}
        self._custom: Dict[str, List[float]] = {}
        self._custom_open: Dict[str, float] = {}
        self._levels: List[_LevelFrame] = []
        self._level_records: List[dict] = []
        self._ls_counter = -1
        self._spans: Dict[str, record_function] = {}

    def _span_begin(self, tag: str):
        span = record_function(f"hypredrv::{tag}")
        span.__enter__()
        self._spans[tag] = span

    def _span_end(self, tag: str):
        span = self._spans.pop(tag, None)
        if span is not None:
            span.__exit__(None, None, None)

    def annotate_begin(self, name: str, index: Optional[int] = None):
        now = time.perf_counter()
        key = name.lower()
        tag = key if index is None else f"{key}:{index}"
        self._span_begin(tag)
        if key == "matrix":
            # A new matrix read opens a new entry (ref: stats.c:315).
            self._ls_counter += 1
            self.entries.append(StatsEntry(ls_id=self._ls_counter,
                                           path=self._current_path()))
            self._open[key] = now
        elif key in _KNOWN_PHASES:
            if (key == "prec" and self.entries
                    and self.entries[-1].solve_time > 0.0):
                # a new precon setup after a completed solve (variant
                # sweep / repetition) opens a fresh entry on the same
                # system — ref: ex8 refOutput rows 1-4 have no LS-build
                self.entries.append(
                    StatsEntry(ls_id=self._ls_counter,
                               path=self._current_path(), is_rerun=True))
            self._open[key] = now
        else:
            self._custom_open[tag] = now

    def annotate_end(self, name: str, index: Optional[int] = None):
        now = time.perf_counter()
        key = name.lower()
        tag = key if index is None else f"{key}:{index}"
        self._span_end(tag)
        if key in _KNOWN_PHASES:
            t0 = self._open.pop(key, None)
            if t0 is None:
                return
            dt = now - t0
            if key in _BUILD_PHASES:
                entry = self._current_entry()
                entry.build_times[key] = entry.build_times.get(key, 0.0) + dt
            elif key == "prec":
                self._current_entry().setup_time += dt
            elif key == "solve":
                self._current_entry().solve_time += dt
        else:
            t0 = self._custom_open.pop(tag, None)
            if t0 is not None:
                self._custom.setdefault(tag, []).append(now - t0)

    # ---- hierarchical level annotations --------------------------------

    def annotate_level_begin(self, name: str, index: int):
        if len(self._levels) >= MAX_LEVELS:
            raise ValueError(
                f"level annotations nest at most {MAX_LEVELS} deep")
        self._levels.append(
            _LevelFrame(name, index, time.perf_counter(), len(self.entries)))

    def annotate_level_end(self, name: str, index: int):
        if not self._levels:
            return
        frame = self._levels.pop()
        self._level_records.append({
            "depth": len(self._levels),
            "name": frame.name,
            "index": frame.index,
            "time": time.perf_counter() - frame.t_start,
            "entries": (frame.first_entry, len(self.entries)),
            "path": ".".join(str(f.index) for f in self._levels + [frame]),
        })

    def _current_path(self) -> str:
        return ".".join(str(f.index) for f in self._levels)

    def _current_entry(self) -> StatsEntry:
        if not self.entries:
            self._ls_counter += 1
            self.entries.append(StatsEntry(ls_id=self._ls_counter,
                                           path=self._current_path()))
        return self.entries[-1]

    def record_solve(self, iters: int, initial_res_norm: float,
                     rel_res_norm: float, converged: bool = True):
        e = self._current_entry()
        e.iters = iters
        e.initial_res_norm = float(initial_res_norm)
        e.rel_res_norm = float(rel_res_norm)
        e.converged = converged

    # getters mirroring HYPREDRV_LinearSolverGet* (ref: src/HYPREDRV.c:3665-3820)
    def num_iterations(self, entry: int = -1) -> int:
        return self.entries[entry].iters if self.entries else 0

    def final_rel_res_norm(self, entry: int = -1) -> float:
        return self.entries[entry].rel_res_norm if self.entries else 0.0

    def setup_time(self, entry: int = -1) -> float:
        return self.entries[entry].setup_time if self.entries else 0.0

    def solve_time(self, entry: int = -1) -> float:
        return self.entries[entry].solve_time if self.entries else 0.0

    def summary_table(self) -> str:
        """ASCII summary, format-parity with ref stats.c:1222-1365."""
        unit = "ms" if self.use_millisec else "s"
        scale = 1e3 if self.use_millisec else 1.0
        header = "STATISTICS SUMMARY"
        header += f" for {self.name}:" if self.name else ":"
        sep = (
            "+--------+-------------+-------------+-------------+"
            "------------+------------+--------+"
        )
        h1 = (
            "|        |    LS build |       setup |       solve |"
            "    initial |   relative |        |"
        )
        tcol = f"  times [{unit}]".ljust(13)
        h2 = (
            f"|  Entry |{tcol}|{tcol}|{tcol}|"
            "  res. norm |  res. norm |  iters |"
        )
        lines = ["", header, "", sep, h1, h2, sep]
        for i, e in enumerate(self.entries):
            label = f"{e.path}.{i}" if e.path else str(i)
            build = ("".ljust(11) if e.is_rerun
                     else f"{e.build_time * scale:>11.3f}")
            lines.append(
                f"| {label:>6} | {build} |"
                f" {e.setup_time * scale:>11.3f} | {e.solve_time * scale:>11.3f} |"
                f" {e.initial_res_norm:>10.2e} | {e.rel_res_norm:>10.2e} |"
                f" {e.iters:>6} |"
            )
        lines.append(sep)
        if self._custom:
            lines.append("")
            lines.append("Custom annotations:")
            for tag, times in sorted(self._custom.items()):
                total = sum(times) * scale
                lines.append(
                    f"  {tag:<24} count {len(times):>4}  total {total:.3f} [{unit}]"
                )
        return "\n".join(lines) + "\n"

    def level_table(self) -> str:
        """Per-level rollup (ref: src/internal/stats.c:1689 StatsLevelPrint)."""
        if not self._level_records:
            return ""
        unit = "ms" if self.use_millisec else "s"
        scale = 1e3 if self.use_millisec else 1.0
        lines = ["", "LEVEL SUMMARY:", ""]
        lines.append(f"{'path':>8} {'name':<16} {'time [' + unit + ']':>12} "
                     f"{'entries':>8}")
        for rec in self._level_records:
            lo, hi = rec["entries"]
            lines.append(f"{rec['path']:>8} {rec['name']:<16} "
                         f"{rec['time'] * scale:>12.3f} {hi - lo:>8}")
        for name in dict.fromkeys(r["name"] for r in self._level_records):
            lines.append(self.level_aggregate_table(name))
        return "\n".join(lines) + "\n"

    def level_aggregate(self, name: str) -> Optional[dict]:
        """Aggregate linear-solver stats over every frame of a level name
        (ref: StatsLevelPrint's Aggregate Summary,
        src/internal/stats.c:1693-1768): totals and per-solve / per-frame
        averages of iterations and setup/solve times."""
        frames = [r for r in self._level_records if r["name"] == name]
        if not frames:
            return None
        total_solves = total_iters = 0
        total_setup = total_solve = 0.0
        for r in frames:
            lo, hi = r["entries"]
            for e in self.entries[lo:hi]:
                total_solves += 1
                total_iters += e.iters
                total_setup += e.setup_time
                total_solve += e.solve_time
        n_frames = len(frames)
        return {
            "frames": n_frames,
            "total_solves": total_solves,
            "total_iters": total_iters,
            "total_setup": total_setup,
            "total_solve": total_solve,
            "avg_iters_per_solve": (total_iters / total_solves
                                    if total_solves else 0.0),
            "avg_iters_per_frame": total_iters / n_frames,
            "avg_setup_per_frame": total_setup / n_frames,
            "avg_solve_per_frame": total_solve / n_frames,
        }

    def level_aggregate_table(self, name: str) -> str:
        """Reference-format aggregate block for one level name
        (ref: stats.c:1749-1768 'Aggregate Summary')."""
        a = self.level_aggregate(name)
        if a is None:
            return ""
        s, v, ff = a["total_setup"], a["total_solve"], a["frames"]
        out = [
            "",
            f"Aggregate Summary ({name}):",
            "-" * 62,
            f"Total number of {name} frames:         {ff}",
            f"Total number of linear iterations:     {a['total_iters']}",
            f"Avg. LS iterations:                    "
            f"{a['avg_iters_per_solve']:.2f}",
            f"Total LS times: (setup, solve, total): "
            f"{s:.4f}, {v:.4f}, {s + v:.4f}",
            f"Avg. LS iterations per {name}:         "
            f"{a['avg_iters_per_frame']:.2f}",
            f"Avg. LS times per {name}: (s, s, t):   "
            f"{a['avg_setup_per_frame']:.4f}, {a['avg_solve_per_frame']:.4f}"
            f", {a['avg_setup_per_frame'] + a['avg_solve_per_frame']:.4f}",
        ]
        return "\n".join(out)

    # programmatic level getters (ref: HYPREDRV_StatsLevelGet*/Print,
    # include/HYPREDRV.h:2223-2262)
    def level_records(self, name: Optional[str] = None):
        """All closed level frames, optionally filtered by name."""
        if name is None:
            return list(self._level_records)
        return [r for r in self._level_records if r["name"] == name]

    def level_time(self, name: str, index: Optional[int] = None) -> float:
        """Total wall time of level annotations with this name (one
        specific index, or summed over all)."""
        return sum(r["time"] for r in self._level_records
                   if r["name"] == name
                   and (index is None or r["index"] == index))

    def level_entry_range(self, name: str, index: int):
        """(first, last) stats-entry indices covered by a level frame."""
        for r in self._level_records:
            if r["name"] == name and r["index"] == index:
                return tuple(r["entries"])
        return None

    def print(self, file=None, filename: Optional[str] = None):
        text = self.summary_table() + self.level_table()
        if filename:
            # Append mode, like general.statistics_filename
            # (ref: src/HYPREDRV.c:468-502).
            with open(filename, "a") as f:
                f.write(text)
        else:
            print(text, file=file or sys.stdout)
