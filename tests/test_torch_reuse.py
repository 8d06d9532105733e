"""The preconditioner reuse engine, timestep schedules and level frames.

``precon/reuse.py`` is a copy of the JAX package's host logic; these tests
drive both copies through the same scripted sequence of systems (level
frames, setup and solve times, iteration counts, a solver failure) and
require the same rebuild and keep decision at every step, for the static
schedules, each guard, and the adaptive scorer with each metric, mean,
transform and history source.  A bad ``timestep_filename`` raises the same
``ErrorCode`` in both packages; the stats level frames roll up the same.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from hypredrive_tpu import api as jax_api
from hypredrive_tpu.config import sections as jax_sections
from hypredrive_tpu.core import stats as jax_stats
from hypredrive_tpu.precon import reuse as jax_reuse
from hypredrive_tpu_torch import api
from hypredrive_tpu_torch.config import sections
from hypredrive_tpu_torch.core import stats
from hypredrive_tpu_torch.core.errors import HypredrvError
from hypredrive_tpu_torch.precon import reuse

# one scripted run: iterations per system, the systems whose solve fails,
# and a schedule of timesteps of three systems (two Newton levels each)
ITERS = [10, 12, 15, 30, 11, 13, 40, 12, 14, 16, 50, 12, 13, 35, 12, 11]
FAILED = {8}
SCHEDULE = [(0, 0), (1, 3), (2, 6), (3, 9), (4, 12), (5, 15)]


def _script(state_cls, stats_cls, cfg, schedule=None):
    """(rebuild, keep, adaptive component values) at every system of the
    scripted run."""
    st = state_cls(cfg)
    if schedule:
        st.set_timesteps(schedule)
    sts = stats_cls()
    open_ts = None
    out = []
    for ls_id, iters in enumerate(ITERS):
        ts, newton = ls_id // 3, (ls_id % 3) // 2
        if open_ts != ts:
            if open_ts is not None:
                sts.annotate_level_end("newton", -1)
                sts.annotate_level_end("timestep", open_ts)
            sts.annotate_level_begin("timestep", ts)
            sts.annotate_level_begin("newton", newton)
            open_ts = ts
        elif ls_id % 3 == 2:
            sts.annotate_level_end("newton", 0)
            sts.annotate_level_begin("newton", newton)
        sts.annotate_begin("matrix")
        sts.annotate_end("matrix")
        if ls_id == 0:
            st.note_rebuild(0, sts)
            rebuild = True
        else:
            rebuild = st.should_rebuild(ls_id, sts)
        entry = sts.entries[-1]
        entry.setup_time = 0.5 + 0.01 * ls_id if rebuild else 1e-5
        converged = ls_id not in FAILED
        sts.record_solve(iters, 1.0, 1e-7, converged)
        entry.solve_time = 0.02 * iters
        st.record_observation(ls_id, sts, SimpleNamespace(
            iters=iters, solve_time=entry.solve_time, converged=converged))
        adaptive = cfg.get("adaptive") or {}
        floor = float(adaptive.get("positive_floor") or 0.0)
        values = tuple(st._component_value(dict(c), sts, floor)
                       for c in (adaptive.get("components") or []))
        out.append((rebuild, st.should_keep(ls_id, sts), values))
    return out


def _component(metric="iterations", mean=None, transform=None, history=None,
               **kw):
    return {"metric": metric, "mean": mean or {},
            "transform": transform or {"kind": "relative_increase"},
            "history": history or {}, **kw}


CASES = {
    "frequency": {"frequency": 3},
    "ids": {"linear_system_ids": [0, 4, 7, 11]},
    "always": {"linear_system_ids": "always"},
    "per_timestep": {"per_timestep": True},
    "new_timestep_guard": {"guards": {"rebuild_on_new_timestep": True}},
    "reuse_bounds": {"guards": {"min_reuse_solves": 2,
                                "max_reuse_solves": 4}},
    "iteration_ratio": {"guards": {"max_iteration_ratio": 2.0}},
    "solve_time_ratio": {"guards": {"max_solve_time_ratio": 1.5,
                                    "rebuild_on_solver_failure": False}},
    "solver_failure": {"guards": {"min_reuse_solves": 20}},
    "new_level_all": {"guards": {"rebuild_on_new_level": True}},
    "new_level_depth1": {"guards": {"rebuild_on_new_level": [1]}},
    "adaptive_default": {"policy": "adaptive"},
    "adaptive_guarded": {"policy": "adaptive", "guards": {
        "min_history_points": 3, "bad_decisions_to_rebuild": 2},
        "adaptive": {"rebuild_threshold": 0.8}},
}
MEANS = [{"kind": "arithmetic"}, {"kind": "power", "power": 2.0},
         {"kind": "power", "power": 0.0}, {"kind": "power", "power": -1.0},
         {"kind": "geometric"}, {"kind": "harmonic"}, {"kind": "rms"},
         {"kind": "min"}, {"kind": "max"}]
for _m in MEANS:
    CASES[f"mean_{_m['kind']}_{_m.get('power', '')}"] = {
        "policy": "adaptive", "adaptive": {"components": [
            _component(mean=_m, history={"max_points": 3})],
            "positive_floor": 0.01}}
for _t in ("raw", "delta", "ratio", "relative_increase"):
    for _b in (0, 1):
        CASES[f"transform_{_t}_baseline{_b}"] = {
            "policy": "adaptive", "adaptive": {
                "rebuild_threshold": 1.2 if _t in ("raw", "ratio") else 0.4,
                "components": [_component(
                    metric="solve_time",
                    transform={"kind": _t, "baseline": _b})]}}
CASES.update({
    "metrics_mixed": {"policy": "adaptive", "adaptive": {"components": [
        _component("setup_time", weight=0.5),
        _component("total_time", direction="lower_is_worse", target=-1.0,
                   scale=0.5),
        _component("solve_overhead_vs_setup",
                   transform={"amortization_window": 4})]}},
    "history_active_level": {"policy": "adaptive", "adaptive": {
        "components": [_component(history={"source": "levels",
                                           "level": 0})]}},
    "history_completed_level": {"policy": "adaptive", "adaptive": {
        "rebuild_threshold": 0.3, "components": [_component(
            history={"source": "completed_level", "level": 0,
                     "reduction": "mean"})]}},
})


@pytest.mark.parametrize("name", sorted(CASES))
def test_reuse_decisions_match_jax(name):
    cfg = dict(CASES[name], enabled=True)
    schedule = SCHEDULE if ("timestep" in name) else None
    got = _script(reuse.PreconReuseState, stats.Stats,
                  sections.REUSE_SCHEMA.parse(cfg, "reuse", []), schedule)
    ref = _script(jax_reuse.PreconReuseState, jax_stats.Stats,
                  jax_sections.REUSE_SCHEMA.parse(cfg, "reuse", []),
                  schedule)
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    for g, r in zip(got, ref):
        assert g[2] == pytest.approx(r[2], rel=1e-12, abs=1e-300)
    assert got[0][0]                     # the first system always builds


def test_reuse_cases_exercise_both_decisions():
    """The cases together make the engine both rebuild and reuse."""
    seen = set()
    for name, case in CASES.items():
        cfg = sections.REUSE_SCHEMA.parse(dict(case, enabled=True),
                                          "reuse", [])
        schedule = SCHEDULE if ("timestep" in name) else None
        seen.update(r[0] for r in _script(reuse.PreconReuseState,
                                          stats.Stats, cfg, schedule)[1:])
    assert seen == {True, False}


def _timestep_error(drive_cls, path):
    drv = drive_cls()
    with pytest.raises(Exception) as exc:
        drv.input_args_from_dict({
            "linear_system": {"timestep_filename": str(path)},
            "solver": "gmres", "preconditioner": "none"})
    return exc.value


@pytest.mark.parametrize("content", [
    None, "", "x\n0 0\n", "0\n", "3\n0 0\n1 2\n", "2\n0 0\n1 b\n",
    "2\n0 0\n1 -2\n"], ids=["missing", "empty", "bad_header", "zero_count",
                           "short", "bad_entry", "negative_start"])
def test_bad_timestep_file_error_codes_match_jax(content, tmp_path):
    path = tmp_path / "timesteps.txt"
    if content is not None:
        path.write_text(content)
    got = _timestep_error(api.HypreDrive, path)
    ref = _timestep_error(jax_api.HypreDrive, path)
    assert isinstance(got, HypredrvError)
    assert got.code.name == ref.code.name
    assert str(got) == str(ref)


def test_timestep_schedule_feeds_the_reuse_engine(tmp_path):
    path = tmp_path / "timesteps.txt"
    path.write_text("3\n0 0\n1 2\n2 5\n")
    drv = api.HypreDrive()
    drv.input_args_from_dict({
        "linear_system": {"timestep_filename": str(path)},
        "solver": "gmres", "preconditioner": {
            "amg": {}, "reuse": {"enabled": True, "per_timestep": True}}})
    assert drv._timestep_schedule == [(0, 0), (1, 2), (2, 5)]
    assert drv._reuse_state.ts_starts == [0, 2, 5]
    assert [drv._timestep_index(i) for i in range(7)] == \
        [0, 0, 1, 1, 1, 2, 2]


def _levels(stats_cls):
    sts = stats_cls(use_millisec=False)
    for t in range(3):
        sts.annotate_level_begin("timestep", t)
        for n in range(t + 1):
            sts.annotate_level_begin("newton", n)
            sts.annotate_begin("matrix")
            sts.annotate_end("matrix")
            sts.record_solve(10 + t + n, 1.0, 1e-7)
            sts.entries[-1].setup_time = 0.25 * (n == 0)
            sts.entries[-1].solve_time = 0.5
            sts.annotate_level_end("newton", n)
        sts.annotate_level_end("timestep", t)
    return sts


def test_level_frames_roll_up_as_jax():
    got, ref = _levels(stats.Stats), _levels(jax_stats.Stats)
    strip = [{k: v for k, v in r.items() if k != "time"}
             for r in got.level_records()]
    assert strip == [{k: v for k, v in r.items() if k != "time"}
                     for r in ref.level_records()]
    assert [e.path for e in got.entries] == [e.path for e in ref.entries]
    for name in ("timestep", "newton"):
        assert got.level_aggregate(name) == ref.level_aggregate(name)
        assert got.level_entry_range(name, 1) == \
            ref.level_entry_range(name, 1)
    assert "|  2.1.4 |" in got.summary_table()
    assert "Aggregate Summary (timestep):" in got.level_table()
    with pytest.raises(ValueError):
        deep = stats.Stats()
        for d in range(stats.MAX_LEVELS + 1):
            deep.annotate_level_begin("x", d)


def test_api_level_verbs():
    drv = api.HypreDrive()
    drv.annotate_level_begin("timestep", 0)
    drv.stats.annotate_begin("matrix")
    drv.stats.annotate_end("matrix")
    drv.stats.record_solve(7, 1.0, 1e-7)
    drv.annotate_level_end("timestep", 0)
    assert drv.stats_level_get_count("timestep") == 1
    n, iters, setup, solve = drv.stats_level_get_entry_summary("timestep", 0)
    assert (n, iters) == (1, 7)
    assert drv.get_level_records("timestep")[0]["path"] == "0"
    assert drv.get_level_time("timestep") >= 0.0
    with pytest.raises(HypredrvError):
        drv.stats_level_get_entry_summary("timestep", 1)
    assert np.isfinite(drv.get_level_time("timestep", 0))
