"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole); the reference loads nothing of the port; a run
that finds them loaded fails."""

import subprocess
import sys

from solvebench.manifest import ROOT
from solvebench.measure import FORBIDDEN, forbidden_modules
from solvebench.tests import tiny

# a CPU run, then the top-level names of every module it loaded
PROBE = """
import json, sys
from solvebench.run import main
argv = sys.argv[1:]
i = argv.index("--root")
root = argv[i + 1]
del argv[i:i + 2]
rc = main(argv, root=root, require_card=False)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
sys.exit(rc)
"""


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    for cell in ("poisson128_pcg_amg.steady_rhs",
                 "multiphys64_gmres_mgr.steady_rhs",
                 "multiphys64_fgmres_mgr.newton_seq"):
        p = subprocess.run([sys.executable, "-c", PROBE, "--root", root,
                            "--workload", cell, "--seed", "3", "--seconds",
                            "0.5", "--trace", "1"], cwd=ROOT,
                           env=tiny.cpu_env(), capture_output=True,
                           text=True, timeout=240)
        assert p.returncode == 0, p.stderr
        loaded = set(eval(p.stdout.strip().splitlines()[-1]))
        assert not loaded & set(FORBIDDEN)
        assert "hypredrive_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, solvebench.reference, solvebench.mix; "
            "from solvebench.problems import laplacian_3d_7pt, "
            "multiphysics_fv, multiphysics_fv_drift; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    loaded = set(eval(p.stdout))
    assert not loaded & ({"hypredrive_tpu_torch", "torch"} | set(FORBIDDEN))


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hypredrive_tpu_torch_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hypredrive_tpu.api", sys)
    assert forbidden_modules() == ["hypredrive_tpu"]


def test_a_run_that_loads_jax_fails(tmp_path):
    """A module named jax, loaded at start, makes the run exit nonzero
    with no result, naming it on stderr."""
    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "jax.py").write_text("")
    (fake / "sitecustomize.py").write_text("import jax\n")
    root = tiny.make_root(tmp_path)
    env = tiny.cpu_env(PYTHONPATH=str(fake))
    rc, out, err = tiny.run(root, "poisson128_pcg_amg.steady_rhs",
                                env=env, seconds=0.3)
    assert rc != 0 and out.strip() == "" and "jax" in err
