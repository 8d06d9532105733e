"""The port's tools (``hypredrive_tpu_torch.tools``) against the JAX
package on the CPU.

- ``profile_setup``: its hierarchy has the JAX package's level count, its
  host loop the JAX host functions' level count, its adaptive FSAI build
  the JAX package's G entries, and its phases (laps of one clock) add up
  to its total.
- ``node_scaling``: on ``make_mesh(k, device="cpu")`` for k = 1, 2, 4 and
  8 at 216 rows a shard, the rows and PCG + AMG counts of
  ``scripts/node_scaling.py`` on the JAX package's 8-device CPU mesh.
- ``parity_report --fast``: a table whose counts equal the JAX package's
  in ``data/golden/jax_counts.json`` (residuals to rel 1e-6, ex8's
  adaptive-FSAI variant included), elasticity marked skipped.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypredrive_tpu.config.sections import AMG_SCHEMA as JAX_AMG_SCHEMA
from hypredrive_tpu.ops.csr import laplacian_3d_7pt
from hypredrive_tpu.precon.amg.coarsen import coarsen as jax_coarsen
from hypredrive_tpu.precon.amg.hierarchy import \
    setup_hierarchy as jax_setup_hierarchy
from hypredrive_tpu.precon.amg.interp import \
    build_interpolation as jax_interp
from hypredrive_tpu.precon.amg.strength import strength_graph as jax_strength
from hypredrive_tpu.precon.fsai import \
    build_fsai_adaptive as jax_fsai_adaptive
from hypredrive_tpu_torch.core.errors import HypredrvError
from hypredrive_tpu_torch.tools import node_scaling, parity_report, \
    profile_setup

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_host_levels(A):
    """scripts/profile_setup.py's host loop through the JAX package's host
    functions: its level count."""
    A_l, levels = A, 0
    while A_l.shape[0] > 64 and levels < 24:
        S = jax_strength(A_l, theta=0.25)
        cf = jax_coarsen(S, ctype=8, seed=levels)
        nC = int((cf > 0).sum())
        if nC == 0 or nC >= A_l.shape[0]:
            break
        P = jax_interp(A_l, S, cf, prolongation_type=6)
        A_l = sp.csr_matrix(P.T @ A_l @ P)
        levels += 1
    return levels + 1


@pytest.mark.parametrize("n1", [12, 16])
def test_profile_setup_matches_jax(n1):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        r = profile_setup.run(n1, "host")
    A = laplacian_3d_7pt(n1)
    st = jax_setup_hierarchy(A, JAX_AMG_SCHEMA.defaults(), dtype=np.float32)
    assert r["levels"] == len(st.levels)
    assert r["host_levels"] == _jax_host_levels(A)
    assert r["fsai_nnz"] == jax_fsai_adaptive(A)[0].to_csr().nnz
    # every phase is a lap of one clock: they add up to the total
    assert sum(r["phases"].values()) == pytest.approx(r["total_s"],
                                                      rel=1e-12)
    assert r["host_graph_s"] == pytest.approx(sum(
        t for k, t in r["phases"].items() if k.startswith("host_")),
        rel=1e-12)
    assert r["upload_bytes"] > 0 and r["cycle_s"] > 0
    out = buf.getvalue()
    assert f"host graph total: " in out and "setup_hierarchy total:" in out
    assert "AMG hierarchy:" in out and "matvec launch" in out


def test_node_scaling_matches_jax_mesh(tmp_path):
    """Weak mode, 216 rows a shard: 1, 2, 4 and 8 shards give the JAX
    script's rows and counts on its 1-, 2-, 4- and 8-device CPU meshes."""
    with contextlib.redirect_stdout(io.StringIO()):
        ours = node_scaling.run("weak", 216, reps=1, policy="host")
        path = tmp_path / "jax.jsonl"
        assert _script("node_scaling").main(
            ["--mode", "weak", "--rows-per-chip", "216", "--reps", "1",
             "--json", str(path)]) == 0
    theirs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["shards"], r["rows"], r["nnz"], r["iters"]) for r in ours] \
        == [(r["chips"], r["rows"], r["nnz"], r["iters"]) for r in theirs]
    assert [r["shards"] for r in ours] == [1, 2, 4, 8]
    assert ours[0]["efficiency_pct"] == pytest.approx(100.0, rel=1e-12)


def test_node_scaling_options_match_jax(tmp_path, monkeypatch):
    """The JAX script's options with the same defaults; --exec-policy in
    place of --virtual.  --json appends one line per mesh."""
    parse = argparse.ArgumentParser.parse_args
    got = {}

    class Parsed(Exception):
        pass

    def spy(self, args=None, namespace=None):
        ns = parse(self, args, namespace)
        got[len(got)] = vars(ns)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    for main in (_script("node_scaling").main, node_scaling.main):
        with pytest.raises(Parsed):
            main([])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    theirs, ours = got[0], got[1]
    assert theirs.pop("virtual") == 0
    assert ours.pop("exec_policy") == "device"
    assert ours == theirs
    out = tmp_path / "ns.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        assert node_scaling.main(["--rows-per-chip", "64", "--reps", "1",
                                  "--json", str(out), "--exec-policy",
                                  "host"]) == 0
    assert len(out.read_text().splitlines()) == 4


def test_tools_without_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stdout(io.StringIO()):
        for run in (lambda: profile_setup.run(8),
                    lambda: node_scaling.run("weak", 64, reps=1),
                    lambda: parity_report.run(fast=True)):
            with pytest.raises(HypredrvError):
                run()


def test_parity_report_fast_matches_jax_counts(tmp_path):
    """Every case of --fast: counts equal the JAX package's, residuals to
    rel 1e-6; the table lists them and marks elasticity skipped."""
    path = tmp_path / "PARITY_torch.md"
    with contextlib.redirect_stdout(io.StringIO()):
        results, gaps = parity_report.run(fast=True, output=str(path),
                                          policy="host")
    jax = parity_report.jax_counts()
    assert results["elasticity"] == parity_report.SKIPPED
    assert gaps.pop("elasticity") is None
    assert set(gaps) == set(parity_report.REF) - {"elasticity"}
    assert all(g == 0 for g in gaps.values()), gaps
    for case, ours in results.items():
        if ours == parity_report.SKIPPED:
            continue
        for (it_o, rr_o), (it_j, rr_j) in zip(ours, jax[case]):
            assert it_o == it_j
            # float64 summation order: rel 1e-6, and 1e-13 of ‖r0‖ where
            # a solve ends near the rounding floor (ex8 at 1e-9)
            assert rr_o == pytest.approx(rr_j, rel=1e-6, abs=1e-13)
    table = path.read_text()
    for case, ours in results.items():
        if ours != parity_report.SKIPPED:
            its = "/".join(str(i) for i, _ in ours)
            assert f"| {case} | {its} | {its} |" in table
    assert f"| elasticity | {parity_report.SKIPPED} | 17 |" in table
