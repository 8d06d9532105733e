"""The control: the program's own float32 path (``general: dtype:
float32``, the nearest precision below the float64 every configuration
states) put in the program's place fails the harness's own check, which
the float64 program passes.

Each reading is a whole run of ``solvebench.run`` on a manifest root
whose configuration says float32, read from its last line.  On the CPU
at the tiny sizes: the float64 runs are correct, the control runs are
not, and the control's smallest residual is at least three times the
program's largest.  Each tiny reading covers the whole mix: the root's
mixes check every solve of the window, and a run whose window held fewer
solves than the mix has right-hand sides is run again with a window twice
as long (a sequence's run has a window that outlasts its systems), so
that a loaded machine, which fits fewer solves into a window, reads the
same.  Marked ``cuda``: the control
at the cells' own sizes on the card, on three seeds, is not correct."""

import json
import os

import pytest

from solvebench.manifest import FOLDER, Manifest
from solvebench.mix import is_sequence
from solvebench.tests import tiny

CONFIGS = {"poisson128_pcg_amg": "poisson128_pcg_amg.steady_rhs",
           "multiphys64_gmres_mgr": "multiphys64_gmres_mgr.steady_rhs",
           "multiphys64_fgmres_mgr": "multiphys64_fgmres_mgr.newton_seq"}
CONTROL = {"dtype": "float32"}


def readings(root, cell, seeds, card=False, seconds=2.0,
             whole=False) -> list:
    """The last line of a run of ``cell`` on each seed; with ``whole``,
    of a run whose window held the whole mix (the window doubled until
    it did)."""
    man = Manifest(root)
    mix = man.traffic(man.cell(cell)["traffic"])
    cfg = man.config(man.cell(cell)["config"])
    need = (mix["systems_count"] - mix["newton_per_timestep"]
            - cfg["trace_solves"] if is_sequence(mix) else mix["rhs_count"])
    lines = []
    for seed in seeds:
        # a sequence's window also closes when its systems run out
        window = 3600.0 if whole and is_sequence(mix) else seconds
        while True:
            rc, out, err = tiny.run(root, cell, seed=seed, seconds=window,
                                    card=card, timeout=600)
            assert rc == 0, err[-3000:]
            line = tiny.last_line(out)
            if not whole or line["attempted"] >= need or window >= 64:
                break
            window *= 2
        assert not whole or line["attempted"] >= need, (seed, window)
        print(cell, seed, window, line["attempted"], line["correct"],
              line["checks"])
        lines.append(line)
    return lines


def whole_mix_root(tmp, configs=None) -> str:
    """A tiny root whose mixes check every solve of the window."""
    root = tiny.make_root(tmp, configs=configs)
    folder = os.path.join(root, FOLDER, "traffic")
    for name in os.listdir(folder):
        with open(os.path.join(folder, name)) as f:
            mix = json.load(f)
        mix["check_sample"] = 100000
        with open(os.path.join(folder, name), "w") as f:
            json.dump(mix, f)
    return root


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_control_fails_at_tiny_sizes(tmp_path, config):
    cell = CONFIGS[config]
    program = readings(whole_mix_root(tmp_path / "program"), cell,
                       [1, 2, 3], whole=True)
    control = readings(whole_mix_root(tmp_path / "control",
                                      configs={config: CONTROL}),
                       cell, [4, 5, 6], whole=True)
    assert all(line["correct"] for line in program)
    assert not any(line["correct"] for line in control)
    lower = max(line["checks"]["residual"]["value"] for line in program)
    upper = min(line["checks"]["residual"]["value"] for line in control)
    assert upper >= 3 * lower


SEEDS = [2147483931, 2147483932, 2147483933]
# a window that holds as many of the control's solves as a benchmark run
# compares: 16 solves of a steady mix, 8 systems of the Newton sequence
FULL_SECONDS = {"poisson128_pcg_amg": 8, "multiphys64_gmres_mgr": 8,
                "multiphys64_fgmres_mgr": 80}


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_control_fails_at_full_size(card, tmp_path, config):
    """Each control run compares as many solves as a benchmark run does
    (16, or 8 systems of the sequence), so its window holds that many of
    the control's slowest solves."""
    root = tiny.make_root(tmp_path, cut=False, configs={config: CONTROL})
    for line in readings(root, CONFIGS[config], SEEDS, card=True,
                         seconds=FULL_SECONDS[config]):
        assert line["correct"] is False
        res = line["checks"]["residual"]
        assert res["value"] is None or res["value"] > res["limit"]
