"""A run with the timed path broken underneath reports ``correct``
false: the harness's look for a card skipped, the rest of a run driven
at a tiny size, with one fault planted in the program at interpreter
start (a ``sitecustomize`` on ``PYTHONPATH``):

- the solve returns its state unchanged (x0);
- the answer is altered where it is produced (one entry of x);
- half of the answer is left out (the second half of x zero);
- in the Newton sequence, the program keeps the previous system's matrix
  (each new set of values handed to it is the one before).

A cell on one card has no exchange between chips to leave out.
"""

import pytest

from solvebench.manifest import ROOT
from solvebench.tests import tiny

UNCHANGED = """
from hypredrive_tpu_torch.solvers import fgmres, gmres, pcg

def unchanged(core):
    def solve_core(self, A, b, x0):
        out = core(self, A, b, x0)
        return (x0.clone(),) + tuple(out[1:])
    return solve_core

for cls in (pcg.PCGSolver, gmres.GMRESSolver, fgmres.FGMRESSolver):
    cls.solve_core = unchanged(cls.solve_core)
"""

ALTERED = """
from hypredrive_tpu_torch.linsys.system import LinearSystem
get = LinearSystem.get_solution

def get_solution(self):
    x = get(self).copy()
    x[len(x) // 2] += 1e-3 * (abs(x).max() + 1.0)
    return x

LinearSystem.get_solution = get_solution
"""

HALF = """
from hypredrive_tpu_torch.linsys.system import LinearSystem
get = LinearSystem.get_solution

def get_solution(self):
    x = get(self).copy()
    x[len(x) // 2:] = 0.0
    return x

LinearSystem.get_solution = get_solution
"""

STALE = """
from hypredrive_tpu_torch.api import HypreDrive
set_matrix = HypreDrive.set_matrix_from_csr
last = []

def set_matrix_from_csr(self, indptr, indices, data, *args, **kwargs):
    last.append(data.copy())
    return set_matrix(self, indptr, indices, last[max(0, len(last) - 2)],
                      *args, **kwargs)

HypreDrive.set_matrix_from_csr = set_matrix_from_csr
"""

CELLS = {"poisson": "poisson128_pcg_amg.steady_rhs",
         "multiphys": "multiphys64_gmres_mgr.steady_rhs",
         "newton": "multiphys64_fgmres_mgr.newton_seq"}


def run_with(tmp_path, fault: str, cell: str) -> dict:
    d = tmp_path / "fault"
    d.mkdir()
    # the checkout is not yet on sys.path while site runs
    (d / "sitecustomize.py").write_text(
        f"import sys\nsys.path.insert(0, {ROOT!r})\n" + fault)
    root = tiny.make_root(tmp_path)
    rc, out, err = tiny.run(root, cell, env=tiny.cpu_env(
        PYTHONPATH=str(d)), seconds=0.5, timeout=600)
    assert rc == 0, err[-3000:]
    return tiny.last_line(out)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
def test_a_broken_solve_is_not_correct(tmp_path, fault, cell):
    src = {"unchanged": UNCHANGED, "altered": ALTERED, "half": HALF}[fault]
    line = run_with(tmp_path, src, CELLS[cell])
    assert line["correct"] is False
    assert line["checks"]["residual"]["value"] is None or \
        line["checks"]["residual"]["value"] > \
        line["checks"]["residual"]["limit"]


def test_a_stale_matrix_is_not_correct(tmp_path):
    """Each system solved with the values of the one before: the reference
    judges every solution against its own system, so the run is not
    correct, though every solve converges."""
    line = run_with(tmp_path, STALE, CELLS["newton"])
    assert line["correct"] is False and line["failed"] == 0
    assert line["checks"]["residual"]["value"] > \
        line["checks"]["residual"]["limit"]


def test_the_sound_program_is_correct(tmp_path):
    line = run_with(tmp_path, "", CELLS["poisson"])
    assert line["correct"] is True


def test_the_sound_sequence_is_correct(tmp_path):
    line = run_with(tmp_path, "", CELLS["newton"])
    assert line["correct"] is True and line["failed"] == 0
