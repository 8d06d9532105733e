"""Preconditioner reuse engine: static + adaptive policies.

Counterpart of ``hypredrive_tpu/precon/reuse.py`` (a copy: pure host
logic; the collective decision is the local one, since this package runs
one process).  Reference: include/internal/precon_reuse.h +
src/internal/precon_reuse.c.
Skip preconditioner rebuilds across a sequence of systems.  Pure host
logic:

* **static** — rebuild every N systems (``frequency``), on explicit ids
  (``linear_system_ids``), per timestep, or never ("always" reuse).
* **adaptive** — a weighted score over observation components
  (metrics iterations / solve_time / setup_time / total_time /
  solve_overhead_vs_setup; transforms raw / delta / ratio /
  relative_increase vs the post-rebuild or window-mean baseline;
  arithmetic / power / geometric / harmonic / rms / min / max means
  over a bounded history window drawn from linear solves or the level
  tables), compared against ``rebuild_threshold``, with guard rails
  (min/max reuse solves, iteration/time ratio caps, rebuild on new
  timestep / new level / solver failure).

The timestep schedule comes from ``linear_system.timestep_filename`` or
the lsseq container's timestep table (ref: src/HYPREDRV.c:1258-1281,
src/internal/lsseq.c:2029-2107) as a (timestep_id, ls_start) table;
the timestep *index* of a system is the last start ≤ ls_id.

The decision is logged with a summary string (ref:
PreconReuseDecision.summary).
"""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np

from ..core.logging import log

from ..core.stats import MAX_LEVELS


class PreconReuseState:
    def __init__(self, reuse_args):
        self.args = reuse_args
        self.enabled = bool(reuse_args.enabled)
        self.solves_since_rebuild = 0
        self.observations: List[dict] = []      # all solves
        self.baseline: Optional[dict] = None     # first solve after rebuild
        self.last_rebuild_id: Optional[int] = None
        self.bad_decisions = 0
        # (timestep_id, ls_start) schedule; timestep INDEX is positional
        self.ts_starts: Optional[List[int]] = None
        self.ts_ids: Optional[List[int]] = None
        self.last_timestep: Optional[int] = None
        self.last_rebuild_level_ids = [-1] * MAX_LEVELS
        self.force_rebuild = False

    # -- timestep schedule (from file or lsseq; ref PreconReuseTimesteps) --

    def set_timesteps(self, schedule, ids=None):
        """``schedule`` is either the lsseq-style (timestep, ls_start)
        tuple list or a plain ls_start list (with optional ``ids``)."""
        if schedule and isinstance(schedule[0], (tuple, list)):
            self.ts_ids = [int(t) for t, _ in schedule]
            self.ts_starts = [int(s) for _, s in schedule]
        else:
            self.ts_starts = [int(s) for s in (schedule or [])]
            self.ts_ids = [int(i) for i in ids] if ids else None

    def _timestep_of(self, ls_id: int) -> Optional[int]:
        """Timestep INDEX of a system: last schedule start ≤ ls_id
        (ref: PreconReuseTimestepIndex, src/HYPREDRV.c:429-459)."""
        if not self.ts_starts:
            return None
        idx = bisect.bisect_right(self.ts_starts, ls_id) - 1
        return idx if idx >= 0 else None

    # -- stats level snapshot ----------------------------------------------

    @staticmethod
    def _current_level_ids(stats) -> List[int]:
        """Active level index per depth (ref: PreconReuseCurrentLevelID,
        precon_reuse.c:863-878)."""
        ids = [-1] * MAX_LEVELS
        frames = getattr(stats, "_levels", None) if stats else None
        if frames:
            for d, f in enumerate(frames[:MAX_LEVELS]):
                ids[d] = int(f.index)
        return ids

    # -- decision ----------------------------------------------------------

    def note_rebuild(self, ls_id: int, stats=None):
        """Record an unconditional rebuild (first build of a precon)."""
        self.solves_since_rebuild = 0
        self.baseline = None
        self.bad_decisions = 0
        self.force_rebuild = False
        self.last_rebuild_id = ls_id
        self.last_timestep = self._timestep_of(ls_id)
        self.last_rebuild_level_ids = self._current_level_ids(stats)

    def should_rebuild(self, ls_id: int, stats=None) -> bool:
        """Collective rebuild decision
        (ref: PreconReuseShouldRebuildCollective)."""
        if not self.enabled:
            return True
        decision, summary = self._decide(ls_id, stats)
        decision = self._sync(decision)
        log(2, f"precon reuse decision for ls #{ls_id}: "
               f"{'REBUILD' if decision else 'REUSE'} ({summary})")
        if decision:
            self.note_rebuild(ls_id, stats)
        return decision

    def _decide(self, ls_id: int, stats=None):
        a = self.args
        guards = a.get("guards") or {}

        if self.force_rebuild:
            return True, "forced (solver failure)"
        if self.last_rebuild_id is None:
            return True, "no preconditioner built yet"

        # timestep guard
        ts = self._timestep_of(ls_id)
        if guards.get("rebuild_on_new_timestep") and ts is not None \
                and ts != self.last_timestep:
            return True, f"new timestep {ts}"
        if a.get("per_timestep") and ts is not None \
                and ts != self.last_timestep:
            return True, f"per_timestep: timestep {ts}"

        # new-level guard: watched stats-level depths whose active index
        # moved since the last rebuild (ref: guards.rebuild_on_new_level
        # IntArray, precon_reuse.c:1304-1324)
        watch = guards.get("rebuild_on_new_level")
        if watch:
            depths = (range(MAX_LEVELS) if watch is True
                      else [int(d) for d in np.atleast_1d(watch)])
            cur = self._current_level_ids(stats)
            for d in depths:
                if 0 <= d < MAX_LEVELS and cur[d] >= 0 \
                        and cur[d] != self.last_rebuild_level_ids[d]:
                    return True, (f"new level: depth {d} "
                                  f"{self.last_rebuild_level_ids[d]}→{cur[d]}")

        # static schedules
        ids = a.get("linear_system_ids")
        if ids is not None:
            if isinstance(ids, str) and ids.strip().lower() == "always":
                return False, "static: always reuse"
            if isinstance(ids, (list, tuple)):
                hit = ls_id in [int(i) for i in ids]
                return hit, f"static ids: {'hit' if hit else 'miss'}"
        freq = int(a.get("frequency") or 0)
        if freq > 0:
            hit = (ls_id % freq) == 0
            return hit, f"static frequency {freq}"

        # guard rails
        min_reuse = int(guards.get("min_reuse_solves") or 0)
        if min_reuse and self.solves_since_rebuild < min_reuse:
            return False, f"min_reuse_solves {min_reuse} not reached"
        max_reuse = int(guards.get("max_reuse_solves") or 0)
        if max_reuse and self.solves_since_rebuild >= max_reuse:
            return True, f"max_reuse_solves {max_reuse} reached"

        last = self.observations[-1] if self.observations else None
        if last is not None and self.baseline is not None:
            cap = float(guards.get("max_iteration_ratio") or 0)
            if cap > 0 and self.baseline["iters"] > 0:
                ratio = last["iters"] / self.baseline["iters"]
                if ratio > cap:
                    return True, f"iteration ratio {ratio:.2f} > {cap}"
            cap = float(guards.get("max_solve_time_ratio") or 0)
            if cap > 0 and self.baseline["solve_time"] > 0:
                ratio = last["solve_time"] / self.baseline["solve_time"]
                if ratio > cap:
                    return True, f"solve time ratio {ratio:.2f} > {cap}"

        if int(a.get("policy") or 0) == 1:  # adaptive
            return self._adaptive_decide(ls_id, stats)
        # static policy with no schedule: reuse until a guard fires
        return False, "static: reuse"

    # -- adaptive scorer ------------------------------------------------------

    def _adaptive_decide(self, ls_id: int, stats=None):
        a = self.args
        adaptive = a.get("adaptive") or {}
        guards = a.get("guards") or {}
        components = adaptive.get("components") or []
        min_hist = int(guards.get("min_history_points") or 1)
        if len(self.observations) < max(1, min_hist):
            return False, "adaptive: insufficient history"
        if not components:
            components = [{"metric": "iterations", "weight": 1.0,
                           "transform": {"kind": "relative_increase"}}]

        floor = float(adaptive.get("positive_floor") or 0.0)
        score = 0.0
        wsum = 0.0
        details = []
        for comp in components:
            c = dict(comp) if isinstance(comp, dict) else {}
            weight = float(c.get("weight", 1.0))
            val = self._component_value(c, stats, floor)
            score += weight * val
            wsum += abs(weight)
            details.append(f"{c.get('metric', 'iterations')}={val:.3f}")
        if wsum > 0:
            score /= wsum
        score = max(score, floor) if floor else score
        threshold = float(adaptive.get("rebuild_threshold") or 0.5)
        decision = score >= threshold
        summary = (f"adaptive score {score:.3f} "
                   f"{'≥' if decision else '<'} threshold {threshold} "
                   f"[{', '.join(details)}]")
        if decision:
            self.bad_decisions += 1
            bad_cap = int(guards.get("bad_decisions_to_rebuild") or 1)
            if self.bad_decisions < bad_cap:
                return False, summary + f" (bad {self.bad_decisions}/{bad_cap})"
        else:
            self.bad_decisions = 0
        return decision, summary

    # -- sample collection (ref: PreconReuseCollectSamples) -----------------

    def _collect_samples(self, comp: dict, stats) -> List[dict]:
        """History samples newest-last; each is {num_solves, iters,
        setup_time, solve_time}."""
        hist = comp.get("history") or {}
        source = hist.get("source", 0)
        source = {0: "linear_solves", "entries": "linear_solves",
                  1: "active_level", "levels": "active_level",
                  2: "completed_level"}.get(source, source)
        level = int(hist.get("level", -1) if hist.get("level") is not None
                    else -1)
        max_points = int(hist.get("max_points", 8) or 8)

        def from_obs(obs):
            return {"num_solves": 1, "iters": float(obs["iters"]),
                    "setup_time": float(obs.get("setup_time", 0.0)),
                    "solve_time": float(obs["solve_time"])}

        if source == "active_level" and 0 <= level < MAX_LEVELS:
            cur = self._current_level_ids(stats)
            if cur[level] < 0:
                return []
            picked = [from_obs(o) for o in self.observations
                      if o.get("level_ids", [-1] * MAX_LEVELS)[level]
                      == cur[level]]
            return picked[-max_points:]
        if source == "completed_level" and 0 <= level < MAX_LEVELS \
                and stats is not None:
            base_ls = (self.baseline["ls_id"]
                       if self.baseline is not None else 0)
            out = []
            for rec in getattr(stats, "_level_records", []):
                if rec.get("depth") != level:
                    continue
                e0, e1 = rec.get("entries", (0, 0))
                entries = stats.entries[e0:e1]
                if not entries or entries[0].ls_id < base_ls:
                    continue
                out.append({
                    "num_solves": len(entries),
                    "iters": float(sum(e.iters for e in entries)),
                    "setup_time": float(sum(e.setup_time for e in entries)),
                    "solve_time": float(sum(e.solve_time for e in entries)),
                })
            return out[-max_points:]
        return [from_obs(o) for o in self.observations[-max_points:]]

    @staticmethod
    def _sample_metric(sample: dict, metric: str, reduction) -> float:
        """ref: PreconReuseSampleMetricGet (precon_reuse.c:827-860)."""
        if metric == "iterations":
            v = sample["iters"]
        elif metric == "solve_time":
            v = sample["solve_time"]
        elif metric == "setup_time":
            v = sample["setup_time"]
        elif metric == "total_time":
            v = sample["setup_time"] + sample["solve_time"]
        elif metric == "solve_overhead_vs_setup":
            return sample["solve_time"]
        else:
            v = 0.0
        red = {0: "none", 1: "mean", 2: "sum"}.get(reduction, reduction)
        if red == "mean" and sample.get("num_solves", 1) > 0:
            v /= sample["num_solves"]
        return float(v)

    @staticmethod
    def _generalized_mean(vals, mean_cfg, floor) -> float:
        """ref: PreconReuseGeneralizedMean (precon_reuse.c:1000-1113)."""
        vals = np.asarray(vals, dtype=float)
        if vals.size == 0:
            return -1.0
        kind = mean_cfg.get("kind", 0)
        kind = {0: "arithmetic", 1: "power", 2: "geometric", 3: "harmonic",
                4: "rms", 5: "min", 6: "max"}.get(kind, kind)
        if kind == "min":
            return float(vals.min())
        if kind == "max":
            return float(vals.max())
        if kind == "geometric":
            return float(np.exp(np.mean(np.log(
                np.maximum(vals, max(floor, 1e-300))))))
        if kind == "harmonic":
            den = float(np.sum(1.0 / np.maximum(vals, max(floor, 1e-300))))
            return len(vals) / den if den > 0 else 0.0
        if kind == "rms":
            return float(np.sqrt(np.mean(vals ** 2)))
        if kind == "power":
            p = float(mean_cfg.get("power", 1.0))
            if abs(p) < 1e-12:
                return PreconReuseState._generalized_mean(
                    vals, {"kind": "geometric"}, floor)
            v = np.where(vals < floor, floor, vals) if p <= 0 else vals
            return float(np.mean(v ** p) ** (1.0 / p))
        return float(np.mean(vals))

    def _component_value(self, comp: dict, stats=None,
                         floor: float = 0.0) -> float:
        metric = comp.get("metric", "iterations")
        if isinstance(metric, int):
            metric = {0: "iterations", 1: "solve_time", 2: "setup_time",
                      3: "total_time",
                      4: "solve_overhead_vs_setup"}.get(metric, "iterations")
        metric = str(metric).lower()
        hist_cfg = comp.get("history") or {}
        reduction = hist_cfg.get("reduction", 0)
        samples = self._collect_samples(comp, stats)
        if not samples:
            return 0.0

        tr = comp.get("transform") or {}
        baseline_kind = tr.get("baseline", 0)
        baseline_kind = {0: "rebuild", 1: "window_mean"}.get(
            baseline_kind, baseline_kind)

        # baseline value (ref: PreconReuseBaselineValue)
        if metric == "solve_overhead_vs_setup":
            base = 1.0
        elif baseline_kind == "window_mean":
            base = float(np.mean([
                self._sample_metric(s, metric, reduction)
                for s in samples]))
        elif self.baseline is not None:
            bs = {"num_solves": 1, "iters": float(self.baseline["iters"]),
                  "setup_time": float(self.baseline.get("setup_time", 0.0)),
                  "solve_time": float(self.baseline["solve_time"])}
            base = self._sample_metric(bs, metric, 0)
        else:
            base = floor

        # per-sample transform (ref: PreconReuseTransformSample)
        tkind = tr.get("kind", 0)
        tkind = {0: "raw", 1: "delta", 2: "ratio", 3: "relative_increase"
                 }.get(tkind if isinstance(tkind, int) else -1, tkind)
        amort = int(tr.get("amortization_window") or 10)

        tvals = []
        for s in samples:
            if metric == "solve_overhead_vs_setup":
                b_setup = (float(self.baseline.get("setup_time", 0.0))
                           if self.baseline is not None else 0.0)
                b_solve = (float(self.baseline["solve_time"])
                           if self.baseline is not None else 0.0)
                budget = max(b_setup / max(1, amort), max(floor, 1e-300))
                sv = self._sample_metric(s, "solve_time", reduction)
                tvals.append(max(sv - b_solve, 0.0) / budget)
                continue
            raw = self._sample_metric(s, metric, reduction)
            b = max(base, max(floor, 1e-300))
            if tkind == "delta":
                tvals.append(max(raw - b, 0.0))
            elif tkind == "ratio":
                tvals.append(raw / b)
            elif tkind == "relative_increase":
                tvals.append(max(raw - b, 0.0) / b)
            else:
                tvals.append(raw)

        m = self._generalized_mean(tvals, comp.get("mean") or {}, floor)
        direction = comp.get("direction", 0)
        if direction in (1, "lower_is_worse"):
            m = -m
        scale = float(comp.get("scale", 1.0))
        target = float(comp.get("target", 0.0))
        return (m - target) * scale

    def should_keep(self, ls_id: int, stats=None) -> bool:
        """Whether to keep the precon alive after this solve.  Mirrors
        HYPREDRV_PreconDestroy: evaluate the rebuild decision for the
        NEXT system without committing it; keep only when the engine
        would reuse (ref: src/HYPREDRV.c PreconDestroy →
        PreconReuseShouldRebuildCollective(next_ls_id))."""
        if not self.enabled:
            return False
        decision, summary = self._decide(ls_id + 1, stats)
        decision = self._sync(decision)
        log(2, f"precon keep decision after ls #{ls_id}: "
               f"{'DESTROY' if decision else 'KEEP'} ({summary})")
        return not decision

    def _sync(self, decision: bool) -> bool:
        """The collective agreement (reference: MPI_Allreduce MAX); this
        package runs one process, so the local decision is the agreed
        one."""
        return decision

    # -- observations ------------------------------------------------------

    def record_observation(self, ls_id: int, stats, result):
        """ref: hypredrv_PreconReuseBuildObservation (precon_reuse.c:476)."""
        self.solves_since_rebuild += 1
        obs = {
            "ls_id": ls_id,
            "iters": result.iters,
            "solve_time": result.solve_time,
            "setup_time": (stats.setup_time() if stats and stats.entries
                           else 0.0),
            "converged": result.converged,
            "timestep": self._timestep_of(ls_id),
            "level_ids": self._current_level_ids(stats),
        }
        self.observations.append(obs)
        if self.baseline is None:
            self.baseline = obs
        guards = self.args.get("guards") or {}
        if not result.converged and guards.get("rebuild_on_solver_failure",
                                               True):
            self.force_rebuild = True
