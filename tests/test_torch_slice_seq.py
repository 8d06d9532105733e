"""The sequence path end to end against the JAX package, on the CPU.

* The example configs that run ILU, hybrid GS, FSAI and preconditioner
  reuse (ex4, ex7, ex7-reuse, ex7-mgr-frelax-reuse, ex2, ex8) through the
  port's CLI with ``exec_policy: host`` take exactly the JAX package's
  iteration count per stats entry (``JAX_ITERS``: its ``run_one_config``
  on this repository's CPU, float64), converge to the config's tolerance,
  and the entries that reuse the preconditioner spend next to nothing on
  setup.
* A Newton sequence built in memory (``chip_smoke.drift_sequence`` at
  nx = 12: two timesteps of two systems, per-timestep reuse, FGMRES +
  ex7-reuse's MGR) through both packages' library API: the same rebuild
  decisions, the same counts, and FGMRES histories equal to rel 1e-8 with
  a floor of 1e-11·‖r0‖ (float64 summation order, as in PR 2's tests).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from hypredrive_tpu import api as jax_api
from hypredrive_tpu_torch import api, cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = [("general:exec_policy", "host"),
        ("general:print_config_params", "off")]

# config → (the JAX package's iterations per entry, rel tol, reused entries)
JAX_ITERS = {
    "ex4.yml": (chip_smoke.JAX_ITERS_EX4, 1e-6, ()),
    "ex7.yml": (chip_smoke.JAX_ITERS_EX7, 1e-6, ()),
    "ex7-reuse.yml": (chip_smoke.JAX_ITERS_EX7_REUSE, 1e-6, (1, 3, 5, 7)),
    "ex7-mgr-frelax-reuse.yml": (chip_smoke.JAX_ITERS_EX7_FRELAX_REUSE, 1e-6,
                                 (1, 3, 5, 7)),
    "ex2.yml": (chip_smoke.JAX_ITERS_EX2, 1e-6, ()),
    "ex8.yml": (chip_smoke.JAX_ITERS_EX8, 1e-9, ()),
}


@pytest.fixture(autouse=True)
def _cwd_repo(monkeypatch):
    monkeypatch.chdir(REPO)    # the examples name their data relative to it


@pytest.mark.parametrize("name", sorted(JAX_ITERS))
def test_example_counts_match_jax(name):
    iters, rtol, reused = JAX_ITERS[name]
    collect = []
    assert cli.run_one_config(os.path.join(REPO, "examples", name),
                              overrides=list(HOST), collect=collect) == 0
    entries = collect[0].stats.entries
    assert tuple(e.iters for e in entries) == iters
    for e in entries:
        assert e.converged and e.rel_res_norm <= rtol
    if reused:
        rebuilt = [e.setup_time for i, e in enumerate(entries)
                   if i not in reused]
        for i in reused:
            assert entries[i].setup_time < 0.2 * min(rebuilt)


def _sequence(drive_cls, seq, dofmap, ts_file):
    drv = drive_cls()
    drv.set_library_mode()
    drv.input_args_from_dict({
        "general": {"exec_policy": "host", "statistics": False},
        "linear_system": {"timestep_filename": ts_file},
        "solver": chip_smoke.EX7_FGMRES,
        "preconditioner": {"mgr": chip_smoke.EX7_MGR, "reuse": {
            "enabled": True, "per_timestep": True}}})
    out = []
    for A, b in seq:
        drv.set_matrix_from_csr(A.indptr, A.indices, A.data)
        drv.set_rhs(b)
        drv.set_dofmap(dofmap)
        before = drv.precon
        drv.precon_create()
        rebuilt = drv.precon is not before
        drv.linear_solver_create()
        drv.linear_solver_setup()
        res = drv.linear_solver_apply()
        drv.precon_destroy()
        out.append((rebuilt, res))
    return out


def test_drift_sequence_matches_jax(tmp_path):
    seq, dofmap = chip_smoke.drift_sequence(12, 4)
    assert all((A.indices == seq[0][0].indices).all() for A, _ in seq)
    ts_file = tmp_path / "timesteps.txt"
    ts_file.write_text("2\n0 0\n1 2\n")
    got = _sequence(api.HypreDrive, seq, dofmap, str(ts_file))
    ref = _sequence(jax_api.HypreDrive, seq, dofmap, str(ts_file))
    assert [r for r, _ in got] == [r for r, _ in ref] == \
        [True, False, True, False]
    for (_, rt), (_, rj) in zip(got, ref):
        assert rt.iters == rj.iters and rt.converged
        assert rt.rel_res_norm <= 1e-6
        h_j = np.asarray(rj.res_history)[:rj.iters + 1]
        np.testing.assert_allclose(rt.res_history[:rt.iters + 1], h_j,
                                   rtol=1e-8, atol=1e-11 * h_j[0])
