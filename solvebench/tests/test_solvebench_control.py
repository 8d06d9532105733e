"""The control: the program's own float32 path (``general: dtype:
float32``, the nearest precision below the float64 every configuration
states) put in the program's place fails the harness's own check, which
the float64 program passes.

Each reading is a whole run of ``solvebench.run`` on a manifest root
whose configuration says float32, read from its last line.  On the CPU
at the tiny sizes: the float64 runs are correct, the control runs are
not, and the control's smallest residual is at least three times the
program's largest (each window long enough for every right-hand side of
the mix).  Marked ``cuda``: the control at the cells' own sizes
on the card, on three seeds, is not correct."""

import pytest

from solvebench.tests import tiny

CONFIGS = {"poisson128_pcg_amg": "poisson128_pcg_amg.steady_rhs",
           "multiphys64_gmres_mgr": "multiphys64_gmres_mgr.steady_rhs"}
CONTROL = {"dtype": "float32"}


def readings(root, cell, seeds, card=False, seconds=2.0) -> list:
    lines = []
    for seed in seeds:
        rc, out, err = tiny.run(root, cell, seed=seed, seconds=seconds,
                                card=card, timeout=600)
        assert rc == 0, err[-3000:]
        line = tiny.last_line(out)
        print(cell, seed, line["correct"], line["checks"])
        lines.append(line)
    return lines


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_control_fails_at_tiny_sizes(tmp_path, config):
    cell = CONFIGS[config]
    program = readings(tiny.make_root(tmp_path / "program"), cell, [1, 2, 3])
    control = readings(tiny.make_root(tmp_path / "control",
                                      configs={config: CONTROL}),
                       cell, [4, 5, 6])
    assert all(line["correct"] for line in program)
    assert not any(line["correct"] for line in control)
    lower = max(line["checks"]["residual"]["value"] for line in program)
    upper = min(line["checks"]["residual"]["value"] for line in control)
    assert upper >= 3 * lower


SEEDS = [2147483931, 2147483932, 2147483933]


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_control_fails_at_full_size(card, tmp_path, config):
    """Each control run compares as many solves as a benchmark run does
    (16), so its window holds 16 of the control's slowest solves."""
    root = tiny.make_root(tmp_path, cut=False, configs={config: CONTROL})
    for line in readings(root, CONFIGS[config], SEEDS, card=True,
                         seconds=8):
        assert line["correct"] is False
        res = line["checks"]["residual"]
        assert res["value"] is None or res["value"] > res["limit"]
