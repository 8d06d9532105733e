"""The manifest meets the contract's shape, every piece is found by its
name, added files add a cell, a mix the harness does not drive is
refused, and the last line has the contract's keys only."""

import json
import os
import re

import pytest

from solvebench import mix as mixes
from solvebench.manifest import FOLDER, ROOT, Manifest
from solvebench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_manifest_shape():
    man = Manifest()
    d = man.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == [FOLDER] and 1 <= d["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in d[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in d["workloads"]}
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"{FOLDER}/configs/{c['name']}.json"
        assert 1 <= len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert man.config(c["name"])["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in d["workloads"]}
    for w in cells.values():
        assert 1 <= len(w["why"]) <= 200 and w["chips"] == 1
        e2e_here = {m["name"] for m in man.metrics("end_to_end", w["name"])}
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert man.metrics("per_layer", w["name"])
    for m in d["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {x["name"] for x in
                                  man.metrics("end_to_end", cell)}


def test_every_piece_is_found_by_name():
    man = Manifest()
    for w in man.data["workloads"]:
        cfg = man.config(w["config"])
        assert cfg["name"] == w["config"]
        assert man.traffic(w["traffic"])["loop"] == "closed"
        assert os.path.exists(os.path.join(
            ROOT, FOLDER, "problems", cfg["problem"]["kind"] + ".py"))
    for kind in ("end_to_end", "per_layer"):
        for m in man.data[kind]:
            assert callable(man.reader(m["name"]))
            assert os.path.exists(os.path.join(ROOT, FOLDER, "metrics",
                                               m["name"] + ".py"))


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(tmp_path, trace):
    root = tiny.make_root(tmp_path)
    cell = "poisson128_pcg_amg.steady_rhs"
    rc, out, err = tiny.run(root, cell, trace=trace)
    assert rc == 0, err
    line = tiny.last_line(out)
    keys = LINE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    man = Manifest(root)
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) <= {m["name"]
                                    for m in man.metrics(kind, cell)}
    if not trace:
        assert set(line["metrics"]) == {"solve_ms", "solve_ms_p95",
                                        "setup_s"}
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert all(set(c) == {"value", "limit"}
               for c in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")


NEWTON = tiny.NEWTON


def decisions(err: str) -> list:
    """The rebuild decisions a sequence run names on stderr."""
    line, = [x for x in err.splitlines()
             if x.startswith("solvebench: rebuild decisions ")]
    return json.loads(line.split("decisions ", 1)[1].lower())


@pytest.mark.parametrize("trace", [0, 1])
def test_a_newton_sequence_line_has_the_contract_keys(tmp_path, trace):
    """A tiny run of the Newton sequence: the contract's keys, the cell's
    metrics (``system_s`` and ``setup_s`` untraced), every system solved,
    and the preconditioner rebuilt on the first system of each time step
    only, over the warm-up, the window and the traced step."""
    root = tiny.make_root(tmp_path)
    rc, out, err = tiny.run(root, NEWTON, trace=trace)
    assert rc == 0, err
    line = tiny.last_line(out)
    assert list(line) == LINE_KEYS + (["breakdown"] if trace else []) \
        + ["checks"]
    man = Manifest(root)
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) <= {m["name"]
                                    for m in man.metrics(kind, NEWTON)}
    if trace:
        assert {"ingest_s", "rebuild_setup_s", "iters_per_solve",
                "host_reads_per_solve"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"system_s", "setup_s"}
    assert line["correct"] and line["failed"] == 0
    mix = man.traffic("newton_seq")
    per = mix["newton_per_timestep"]
    assert line["attempted"] > 0 and line["attempted"] % per == 0
    got = decisions(err)
    assert got == [True, False] * (len(got) // 2)
    traced = man.config("multiphys64_fgmres_mgr")["trace_solves"]
    assert len(got) == per + line["attempted"] + (traced if trace else 0)
    assert err.strip().splitlines()[-1].startswith("check ")


REBUILD_ALWAYS = """
from hypredrive_tpu_torch.precon.reuse import PreconReuseState
PreconReuseState.should_keep = lambda self, ls_id, stats=None: False
"""


def test_a_sequence_run_without_reuse_fails(tmp_path):
    """A program that rebuilds the preconditioner on every system, though
    every solve converges: the run exits nonzero and prints no result."""
    d = tmp_path / "fault"
    d.mkdir()
    (d / "sitecustomize.py").write_text(
        f"import sys\nsys.path.insert(0, {ROOT!r})\n" + REBUILD_ALWAYS)
    root = tiny.make_root(tmp_path)
    rc, out, err = tiny.run(root, NEWTON, seconds=0.5,
                            env=tiny.cpu_env(PYTHONPATH=str(d)))
    assert rc != 0 and out.strip() == ""
    assert decisions(err)[:2] == [True, True] and "ReuseError" in err


POISSON_2D = '''
import numpy as np
import scipy.sparse as sp


def build(nx):
    T = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    I = sp.identity(nx)
    A = sp.csr_matrix(sp.kron(I, T) + sp.kron(T, I), dtype=np.float64)
    A.sort_indices()
    return A, None
'''


def test_added_files_add_a_cell(tmp_path):
    """A problem generator, a configuration file, a mix file and manifest
    entries, no code of the harness: a new cell runs and is checked."""
    root = tiny.make_root(tmp_path)
    with open(os.path.join(root, FOLDER, "problems", "poisson_2d_5pt.py"),
              "w") as f:
        f.write(POISSON_2D)
    with open(os.path.join(root, FOLDER, "traffic", "steady_rhs.json")) as f:
        mix = json.load(f)
    mix["rhs_count"], mix["check_sample"] = 3, 4
    with open(os.path.join(root, FOLDER, "traffic", "three_rhs.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, FOLDER, "configs",
                           "poisson128_pcg_amg.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "poisson6_pcg_jacobi"
    cfg["problem"] = {"kind": "poisson_2d_5pt", "nx": 12}
    cfg["preconditioner"] = "jacobi"
    with open(os.path.join(root, FOLDER, "configs",
                           "poisson6_pcg_jacobi.json"), "w") as f:
        json.dump(cfg, f)
    man = json.load(open(os.path.join(root, "BENCHMARK.json")))
    man["configs"].append({"name": "poisson6_pcg_jacobi", "source": "test",
                           "file": f"{FOLDER}/configs/poisson6_pcg_jacobi"
                                   ".json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": "poisson6_pcg_jacobi.three_rhs",
                             "config": "poisson6_pcg_jacobi",
                             "traffic": "three_rhs", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m and "poisson128_pcg_amg.steady_rhs" in \
                m["workloads"]:
            m["workloads"].append("poisson6_pcg_jacobi.three_rhs")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    rc, out, err = tiny.run(root, "poisson6_pcg_jacobi.three_rhs")
    assert rc == 0, err
    line = tiny.last_line(out)
    assert line["correct"] and set(line["metrics"]) == {
        "solve_ms", "solve_ms_p95", "setup_s"}
    assert "4 solutions checked" in err


@pytest.mark.parametrize("change", [
    {"x0": "previous"}, {"callers": 4}, {"loop": "open"},
    {"solution_to_host": False}, {"arrival_rate": 10.0},
    {"rhs": "from_file"}, {"rhs_count": 0}])
def test_a_mix_the_harness_does_not_drive_is_refused(tmp_path, change):
    """A mix file with a key or a value the harness does not drive: the
    run exits nonzero, names it and prints no result."""
    root = tiny.make_root(tmp_path)
    path = os.path.join(root, FOLDER, "traffic", "steady_rhs.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(change)
    with open(path, "w") as f:
        json.dump(mix, f)
    rc, out, err = tiny.run(root, "poisson128_pcg_amg.steady_rhs")
    assert rc != 0 and out.strip() == ""
    assert next(iter(change)) in err


def test_no_card_no_result():
    """The benchmark's own command exits nonzero and prints nothing on
    stdout where there is no card."""
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "-m", "solvebench.run",
                        "--workload", "poisson128_pcg_amg.steady_rhs",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=tiny.cpu_env(), capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("change", [
    {"rhs_count": 8}, {"matrix": "fixed"},
    {"newton_per_timestep": 0}, {"systems_count": 25}, {"x0": "previous"},
    {"callers": 2}, {"arrival_rate": 10.0}])
def test_a_sequence_mix_the_harness_does_not_drive_is_refused(tmp_path,
                                                            change):
    """The Newton-sequence mix with a key or a value the harness does not
    drive: the run exits nonzero, names it and prints no result."""
    root = tiny.make_root(tmp_path)
    path = os.path.join(root, FOLDER, "traffic", "newton_seq.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(change)
    with open(path, "w") as f:
        json.dump(mix, f)
    rc, out, err = tiny.run(root, NEWTON)
    assert rc != 0 and out.strip() == ""
    assert next(iter(change)) in err


def test_mix_check_drives_both_shapes():
    """``mix.check`` takes the steady mix and the Newton sequence as
    written, and refuses a sequence key in the steady mix, a steady key in
    the sequence, and a sequence that lacks one of its keys."""
    man = Manifest()
    steady, newton = man.traffic("steady_rhs"), man.traffic("newton_seq")
    assert not mixes.is_sequence(steady) and mixes.is_sequence(newton)
    with pytest.raises(ValueError, match="matrix"):
        mixes.check(dict(steady, matrix="new_each_solve"))
    with pytest.raises(ValueError, match="rhs_count"):
        mixes.check(dict(newton, rhs_count=8))
    lacking = {k: v for k, v in newton.items() if k != "systems_count"}
    with pytest.raises(ValueError, match="systems_count"):
        mixes.check(lacking)
