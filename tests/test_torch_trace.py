"""The port's counters and spans (``hypredrive_tpu_torch/core/trace.py``)
and the benchmark's readers of them, on the CPU.

Two small systems go through the library verbs as the benchmark drives
them (right-hand side in, solve from x0 = 0, solution out): an 8³
7-point Laplacian with PCG + the default AMG, and the 6³ three-field
multiphysics system with ex3's GMRES(30) + MGR (AMG coarsest).  Per solve
the spans around the solve count one entry each, the bytes moved are the
vector's, and every flag the device loop reads is one ``flag_wait``.  No
``record_function`` is entered unless a profiler records; under one, the
``hypredrv::`` ranges lie inside the caller's own.  The spans that exist
only on the card (``graph_lookup``, ``launch``, ``capture``) do not run
here, and their readers give nothing; ``tests/test_torch_cuda.py`` holds
them, and the halo counters under graph replay, on the card.
"""

import contextlib
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hypredrive_tpu_torch import HypreDrive
from hypredrive_tpu_torch.core import trace
from hypredrive_tpu_torch.ops.csr import (laplacian_3d_7pt,
                                          multiphysics_fv_system)
from hypredrive_tpu_torch.solvers import device_loop as dl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EX3_MGR = {"mgr": {
    "level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
              1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                  "restriction_type": "columped"}},
    "coarsest_level": "amg"}}
CASES = {
    "poisson": (lambda: (laplacian_3d_7pt(8), None),
                {"pcg": {"relative_tol": 1e-8, "max_iter": 100}}, "amg"),
    "multiphys": (lambda: multiphysics_fv_system(
        6, 3, contrast=0.3, coupling=0.12, convection=0.08),
        {"gmres": {"relative_tol": 1e-6, "max_iter": 300,
                   "krylov_dim": 30}}, EX3_MGR),
}
NEW_READERS = ("transfer_ms", "residual_check_ms", "graph_lookup_ms",
               "launch_ms", "flag_wait_ms", "hierarchy_host_s",
               "operator_build_s")
CARD_ONLY = ("graph_lookup_ms", "launch_ms")


def _set_up(case, dtype="float64"):
    """(a HypreDrive set up on the CPU, A, three seeded right-hand sides)."""
    make, solver, precon = CASES[case]
    A, dofmap = make()
    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict({
        "general": {"exec_policy": "host", "statistics": "off",
                    "dtype": dtype},
        "linear_system": {}, "solver": solver, "preconditioner": precon})
    drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
    if dofmap is not None:
        drv.set_dofmap(dofmap)
    rng = np.random.default_rng(3)
    bs = [rng.standard_normal(A.shape[0]) for _ in range(3)]
    drv.set_rhs(bs[0])
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    return drv, A, bs


def _solve(drv, b):
    """One solve as a caller makes it."""
    drv.set_rhs(b)
    drv.reset_initial_guess()
    res = drv.linear_solver_apply()
    drv.get_solution()
    return res


def _delta(before):
    return {k: trace.stats[k] - before.get(k, 0) for k in trace.stats}


def test_registry_is_the_device_loops_and_reset_zeroes_it():
    assert dl.stats is trace.stats
    assert dl.STAT_KEYS is trace.STAT_KEYS
    assert dl.reset_stats is trace.reset_stats
    for k in ("rhs_upload_n", "h2d_bytes", "residual_check_s",
              "flag_wait_n", "hierarchy_host_s", "operator_build_n",
              "halo_bytes", "halo_msgs", "capture_s", "captures"):
        assert k in trace.STAT_KEYS
    for k in trace.STAT_KEYS:
        trace.stats[k] = 3
    trace.count("some_annotation_s", 1.5)
    dl.reset_stats()
    assert set(trace.STAT_KEYS) <= set(trace.stats)
    assert not any(trace.stats.values())


def test_span_adds_seconds_and_entries():
    trace.reset_stats()
    with trace.span("outer"):
        with trace.span("inner", n=0):
            pass
        with trace.span("inner") as s:
            s.n = 2
    s = trace.span("outer").begin()
    s.end()
    with pytest.raises(ValueError), trace.span("failing"):
        raise ValueError("counted all the same")
    st = trace.stats
    assert (st["outer_n"], st["inner_n"], st["failing_n"]) == (2, 2, 1)
    assert st["outer_s"] >= st["inner_s"] >= 0 and st["failing_s"] >= 0


def test_capture_counts_its_entries_in_captures_and_ranges_count_nothing():
    """The ``capture`` span adds to ``capture_s`` and the device loop's
    ``captures``; a span with ``counted=False`` is a range alone."""
    trace.reset_stats()
    before = set(trace.stats)
    with trace.span("capture"):
        pass
    with trace.span("ranged", counted=False):
        pass
    s = trace.span("ranged", counted=False).begin()
    s.end()
    assert trace.stats["captures"] == 1 and trace.stats["capture_s"] > 0
    assert set(trace.stats) == before


def test_annotations_reach_no_counter():
    """A caller's statistics annotations, whatever their tag, add to no
    counter of the program and no key to the registry; the statistics
    keep their own times, and a profiler sees each as ``hypredrv::<tag>``."""
    from torch.profiler import ProfilerActivity, profile

    from hypredrive_tpu_torch.core.stats import Stats

    trace.reset_stats()
    before = dict(trace.stats)
    st = Stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name, index in (("capture", None), ("launch", None),
                            ("flag_wait", 3), ("Solve", None)):
            st.annotate_begin(name, index)
            st.annotate_end(name, index)
    assert trace.stats == before
    assert set(st._custom) == {"capture", "launch", "flag_wait:3"}
    names = {n for n, _, _ in _cpu_ranges(prof)}
    assert {"hypredrv::capture", "hypredrv::launch",
            "hypredrv::flag_wait:3", "hypredrv::solve"} <= names


@pytest.mark.parametrize("case,dtype", [("poisson", "float64"),
                                        ("poisson", "float32"),
                                        ("multiphys", "float64")])
def test_counters_per_solve(case, dtype):
    """Per solve: one entry each of residual_check, rhs_upload and
    solution_download; n × itemsize bytes each way; one flag_wait per host
    read but the last (``run`` counts ``read_out`` as a read); one
    read_out; no graph look-up, launch or capture on the CPU."""
    drv, A, bs = _set_up(case, dtype)
    try:
        nbytes = A.shape[0] * (4 if dtype == "float32" else 8)
        for b in bs:
            before = dict(trace.stats)
            res = _solve(drv, b)
            d = _delta(before)
            assert res.converged and res.iters > 0
            assert d["residual_check_n"] == 1 and d["residual_check_s"] > 0
            assert d["rhs_upload_n"] == d["solution_download_n"] == 1
            assert d["h2d_bytes"] == d["d2h_bytes"] == nbytes
            assert d["solves"] == 1 and d["read_out_n"] == 1
            assert d["flag_wait_n"] == d["host_reads"] - 1 > 0
            assert "solve_n" not in d and "solve_s" not in d
            assert d["graph_lookup_n"] == d["launch_n"] == 0
            assert d["captures"] == 0 and "capture_n" not in d
            assert d["hierarchy_host_n"] == d["operator_build_n"] == 0
    finally:
        drv.destroy()


def test_hierarchy_host_counts_the_levels_built():
    """AMG: one entry per level that is coarsened (all but the
    coarsest).  MGR: one per MGR level, plus its AMG coarsest solver's.
    Every device operator built is one operator_build, A at ingest
    included."""
    trace.reset_stats()
    drv, A, _ = _set_up("poisson")
    try:
        levels = drv.precon.state.levels
        assert len(levels) > 2
        assert trace.stats["hierarchy_host_n"] == len(levels) - 1
        assert trace.stats["hierarchy_host_s"] > 0
        # A at ingest; each coarsened level's P and R; every coarse A
        assert trace.stats["operator_build_n"] == 1 + 3 * (len(levels) - 1)
    finally:
        drv.destroy()
    trace.reset_stats()
    drv, A, _ = _set_up("multiphys")
    try:
        st = drv.precon.state
        assert st.coarsest_kind == "amg"
        amg_levels = len(st.coarsest_state.levels)
        assert trace.stats["hierarchy_host_n"] == \
            len(st.levels) + amg_levels - 1
        assert trace.stats["operator_build_n"] > 1
    finally:
        drv.destroy()


def test_no_record_function_without_profiler(monkeypatch):
    """Set-up and solves, with no profiler recording, enter no
    record_function (whatever name a module imported it under)."""
    entered = []
    rf = torch.autograd.profiler.record_function
    orig = rf.__enter__

    def spy(self):
        entered.append(self.name)
        return orig(self)

    monkeypatch.setattr(rf, "__enter__", spy)
    assert not torch.autograd.profiler._is_profiler_enabled
    for case in CASES:
        drv, _, bs = _set_up(case)
        try:
            for b in bs:
                _solve(drv, b)
        finally:
            drv.destroy()
    assert entered == []


def _cpu_ranges(prof):
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.is_user_annotation()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiler_sees_spans_inside_the_callers(case):
    """Under torch.profiler the program's spans are ``hypredrv::`` ranges
    that lie inside the caller's own ``set_rhs``, ``apply`` and
    ``get_solution``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    drv, _, bs = _set_up(case)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert torch.autograd.profiler._is_profiler_enabled
            with record_function("set_rhs"):
                drv.set_rhs(bs[1])
                drv.reset_initial_guess()
            with record_function("apply"):
                drv.linear_solver_apply()
            with record_function("get_solution"):
                drv.get_solution()
        assert not torch.autograd.profiler._is_profiler_enabled
    finally:
        drv.destroy()
    ranges = _cpu_ranges(prof)
    callers = {n: (a, b) for n, a, b in ranges
               if n in ("set_rhs", "apply", "get_solution")}
    inside = {"rhs_upload": "set_rhs", "solution_download": "get_solution",
              "residual_check": "apply", "solve": "apply",
              "flag_wait": "apply", "read_out": "apply"}
    seen = {}
    for n, a, b in ranges:
        if n.startswith("hypredrv::"):
            seen.setdefault(n[len("hypredrv::"):], []).append((a, b))
    assert set(inside) <= set(seen), sorted(seen)
    for name, caller in inside.items():
        lo, hi = callers[caller]
        assert all(lo <= a <= b <= hi for a, b in seen[name]), name
    assert len(seen["residual_check"]) == 2   # before and after the solve
    (sa, sb), = seen["solve"]
    assert all(sa <= a <= b <= sb for a, b in seen["flag_wait"])
    assert not any(sa <= a < sb for a, _ in seen["residual_check"])


def _reader(name):
    from solvebench.manifest import Manifest

    return Manifest().reader(name)


def _ctx(case):
    """A reader's context from a set-up and a window of three solves, as
    ``solvebench/measure.py`` fills it."""
    trace.reset_stats()
    drv, _, bs = _set_up(case)
    try:
        _solve(drv, bs[0])          # the warm-up
        before = dict(dl.stats)
        solves = []
        for b in bs:
            res = _solve(drv, b)
            solves.append((0.01, res.iters, res.converged))
        after = dict(dl.stats)
    finally:
        drv.destroy()
    return SimpleNamespace(before=before, after=after, solves=solves)


@pytest.mark.parametrize("name", NEW_READERS)
def test_readers_of_the_new_counters(name):
    """Each reader gives a number where its counter ticked, and nothing
    where it did not: the card-only spans on the CPU, and every span on a
    program that has none (a registry holding the device loop's counters
    only, as before these spans existed)."""
    read = _reader(name)
    for case in CASES:
        ctx = _ctx(case)
        v = read(ctx)
        if name in CARD_ONLY:
            assert v is None
        else:
            assert isinstance(v, float) and v > 0, (case, v)
    old = ("solves", "graph_solves", "replays", "masked", "host_reads",
           "captures", "capture_s", "graphs", "max_nodes", "nodes",
           "replayed_nodes")
    bare = SimpleNamespace(before=dict.fromkeys(old, 0),
                           after=dict.fromkeys(old, 5),
                           solves=[(0.01, 5, True)] * 5)
    assert read(bare) is None


def test_window_readers_divide_by_the_solves():
    """A window reader is the counter's growth in ms per solve; a set-up
    reader the counter as the warm-up left it, in s."""
    before = {"flag_wait_n": 10, "flag_wait_s": 1.0, "rhs_upload_n": 1,
              "rhs_upload_s": 0.5, "solution_download_n": 1,
              "solution_download_s": 0.25, "hierarchy_host_n": 4,
              "hierarchy_host_s": 2.5}
    after = dict(before, flag_wait_n=40, flag_wait_s=1.3, rhs_upload_n=4,
                 rhs_upload_s=0.53, solution_download_n=4,
                 solution_download_s=0.28)
    ctx = SimpleNamespace(before=before, after=after,
                          solves=[(0.01, 9, True)] * 3)
    assert _reader("flag_wait_ms")(ctx) == pytest.approx(100.0)
    assert _reader("transfer_ms")(ctx) == pytest.approx(20.0)
    assert _reader("hierarchy_host_s")(ctx) == 2.5
    assert _reader("launch_ms")(ctx) is None


def test_idle_by_span_takes_the_innermost_open_span():
    from hypredrive_tpu_torch.tools.profile_solve import (BETWEEN,
                                                          idle_by_span)

    ops = [(0, 10), (5, 10), (30, 10), (60, 10), (100, 10), (200, 10)]
    spans = [("solve", 0, 150), ("flag_wait", 20, 50),
             ("launch", 75, 80), ("read_out", 80, 120)]
    # gaps: 15-30 (mid 22: flag_wait), 40-60 (mid 50: solve, flag_wait
    # has ended), 70-100 (mid 85: read_out), 110-200 (mid 155: none)
    idle = idle_by_span(ops, spans, [(0, 300)])
    assert idle == pytest.approx({"flag_wait": 15e-9, "solve": 20e-9,
                                  "read_out": 30e-9, BETWEEN: 90e-9})
    assert idle_by_span(ops, spans, [(0, 45)]) == \
        pytest.approx({"flag_wait": 15e-9})
    assert idle_by_span(ops[:1], spans, [(0, 300)]) == {}


def test_halo_counters_are_replayed_and_restored():
    """The halo counters travel with the kernels' launch counts: a body's
    recorded delta adds on replay and is taken back from a masked one,
    and nothing inside ``uncounted`` stays counted."""
    trace.reset_stats()
    c0 = dl._counts()
    n_fns = len(dl.counted())
    assert len(c0) == n_fns + len(dl.REPLAYED)
    trace.count("halo_bytes", 64)
    trace.count("halo_msgs", 2)
    delta = [b - a for a, b in zip(c0, dl._counts())]
    assert dict(zip(dl.REPLAYED, delta[n_fns:])) == dict.fromkeys(
        dl.REPLAYED, 0) | {"halo_bytes": 64, "halo_msgs": 2}
    assert not any(delta[:n_fns])
    dl._add_counts(delta)
    dl._add_counts(delta)
    dl._add_counts(delta, -1)
    assert (trace.stats["halo_bytes"], trace.stats["halo_msgs"]) == (128, 4)
    with dl.uncounted():
        trace.count("halo_bytes", 1000)
    assert trace.stats["halo_bytes"] == 128


def test_profile_solve_prints_the_span_counters():
    from hypredrive_tpu_torch.tools import profile_solve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert profile_solve.main([os.path.join(REPO, "examples",
                                                "ex1.yml"),
                                   "--exec-policy", "host"]) == 0
    text = out.getvalue()
    assert "solve_warm device loop: 7 replays (1 masked)" in text
    line = next(ln for ln in text.splitlines()
                if ln.startswith("solve_warm spans: "))
    assert "residual_check" in line and "(1)" in line
    assert "flag_wait" in line and "(6)" in line
    assert "solve_warm idle by span: not measured (no device)" in text
    nbytes = 8 * 10 ** 3        # ex1: the 10³ Laplacian in float64
    line = next(ln for ln in text.splitlines()
                if ln.startswith("solve_warm transfers: "))
    assert f"rhs_upload {nbytes} B (" in line
    assert f"solution_download {nbytes} B (" in line


def test_transfers_reads_the_bytes_and_the_halo():
    from hypredrive_tpu_torch.tools.profile_solve import transfers

    assert transfers(dict.fromkeys(trace.STAT_KEYS, 0)) == "none"
    st = dict(dict.fromkeys(trace.STAT_KEYS, 0), rhs_upload_s=0.002,
              h2d_bytes=4e6, solution_download_s=0.0, d2h_bytes=8,
              halo_bytes=4096, halo_msgs=6)
    assert transfers(st) == ("rhs_upload 4000000 B (2.000 GB/s), "
                             "solution_download 8 B (no time), "
                             "halo 4096 B in 6 messages")


def test_no_level_spans_left():
    """The per-level ``amg_L*``/``mgr_L*`` ranges are gone: on the card
    they existed only while a graph was captured."""
    roots = [os.path.join(REPO, "hypredrive_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    found = []
    for root in roots:
        files = ([root] if root.endswith(".py") else
                 [os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".py")])
        for path in files:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            if "amg_L" in text or "mgr_L" in text:
                found.append(path)
    assert found == []
