"""The port's counterparts of the repo's JAX-bound scripts
(``hypredrive_tpu_torch/tools/{generate_example_output,plot_convergence,
spyplot,spmat_reorder,fuzz_loop,bench_kernels}.py``) against the scripts
themselves, on the CPU in float64.

- ``generate_example_output`` on ex1, ex3 and ex8 gives the committed JAX
  outputs (``data/golden/example_output_jax/``, made by
  ``scripts/generate_example_output.py``) exactly once times and banners
  are normalised; its ``compare`` flags a residual off by more than rel
  2e-2 and a changed count, and lets times differ.
- ``plot_convergence.run_config`` gives the JAX script's history on ex1
  (PCG + AMG) to rel 1e-12 and on ex3 (GMRES + MGR) to rel 1e-8, the bound
  of tests/test_torch_slice_mgr.py: float64 summation order over eight
  decades (measured 4.4e-9); ``main`` writes a PNG, or raises a typed error
  without matplotlib.
- ``spmat_reorder`` writes files byte-equal to the script's; ``spyplot``
  prints the script's line.
- ``bench_kernels`` runs its rows on the CPU at nx = 8, through ``run``
  and as ``BK_NX=8 ... --exec-policy host``.
- Without a card and without ``--exec-policy host`` every tool raises
  ``HypredrvError``; none imports jax, the JAX package or ``scripts/``.
"""

import ast
import contextlib
import importlib
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypredrive_tpu_torch.core.errors import HypredrvError
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.tools import bench_kernels, fuzz_loop
from hypredrive_tpu_torch.tools import generate_example_output as geo
from hypredrive_tpu_torch.tools import plot_convergence, spmat_reorder, \
    spyplot

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "data", "golden", "example_output_jax")
TOOLS = ("generate_example_output", "plot_convergence", "spyplot",
         "spmat_reorder", "fuzz_loop", "bench_kernels")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden(cfg):
    with open(os.path.join(GOLDEN, cfg.replace(".yml", ".txt"))) as f:
        return f.read()


@pytest.mark.parametrize("cfg", ["ex1.yml", "ex3.yml", "ex8.yml"])
def test_example_output_equals_jax_golden(cfg, tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        res = geo.run([cfg], str(tmp_path), GOLDEN, policy="host")
    assert res[cfg]["rc"] == 0 and res[cfg]["problems"] == []
    text = (tmp_path / cfg.replace(".yml", ".txt")).read_text()
    assert geo.normalize_for_compare(text) == \
        geo.normalize_for_compare(_golden(cfg))


def test_example_output_compare_bounds():
    """ex8 entry 3 at the residual the port printed before its FSAI solve
    was repaired (4.02e-10 against 3.40e-10, rel 0.18) fails; a third-digit
    change passes; a count change and a text change fail; times never
    count."""
    gold = _golden("ex8.yml")
    row = "|   3.16e+01 |   3.40e-10 |      6 |"
    assert row in gold
    assert geo.compare(gold, gold) == []
    assert geo.compare(gold.replace(row, row.replace("3.40e-10",
                                                     "3.41e-10")), gold) == []
    off = geo.compare(gold.replace(row, row.replace("3.40e-10", "4.02e-10")),
                      gold)
    assert len(off) == 1 and "residual 4.02e-10" in off[0]
    assert geo.compare(gold.replace(row, row.replace("|      6 |",
                                                     "|      7 |")), gold)
    assert geo.compare(gold.replace("solver:", "solvers:"), gold)
    timed = gold.replace("|     MASKED |", "|    123.456 |")
    assert geo.compare(timed, gold) == []


@pytest.mark.parametrize("cfg,rtol", [("ex1.yml", 1e-12), ("ex3.yml", 1e-8)])
def test_plot_convergence_history_matches_jax_script(cfg, rtol):
    path = os.path.join(REPO, "examples", cfg)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            h_jax, r_jax = _script("plot_convergence").run_config(path)
            h, r = plot_convergence.run_config(path, "host")
    finally:
        os.chdir(cwd)
    assert r.iters == r_jax.iters and len(h) == len(h_jax) == r.iters + 1
    np.testing.assert_allclose(h, h_jax, rtol=rtol)


def test_plot_convergence_writes_png(tmp_path):
    out = tmp_path / "conv.png"
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = plot_convergence.main([os.path.join("examples", "ex1.yml"),
                                        "-o", str(out), "--exec-policy",
                                        "host"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "5 iters, final relres 4.203e-07" in buf.getvalue()


def test_plotting_without_matplotlib_raises_typed(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(HypredrvError, match="matplotlib"):
        plot_convergence.main([os.path.join(REPO, "examples", "ex1.yml"),
                               "--exec-policy", "host"])


def _run_main(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert main(argv) == 0
    return buf.getvalue()


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("method,binary", [("rcm", False), ("random", True),
                                           ("natural", False)])
def test_spmat_reorder_byte_equal_to_script(method, binary, tmp_path):
    rng = np.random.default_rng(7)
    A = sp.random(60, 60, density=0.08, random_state=rng, format="csr")
    A = sp.csr_matrix(A + A.T + sp.identity(60))
    src = tmp_path / "A.ij"
    rhs = tmp_path / "b.ij"
    ij.write_matrix_ascii(str(src), A)
    ij.write_vector_ascii(str(rhs), rng.standard_normal(60))
    outs = []
    for tag, main in (("jax", _script("spmat_reorder").main),
                      ("port", spmat_reorder.main)):
        d = tmp_path / tag
        d.mkdir()
        argv = [str(src), "-b", str(rhs), "-o", str(d / "out"), "--method",
                method, "--seed", "3"] + (["--binary"] if binary else [])
        if tag == "port":
            argv += ["--exec-policy", "host"]
        text = _run_main(main, argv)
        outs.append((text.replace(str(d), "OUT"), _files(d)))
    assert outs[0] == outs[1]
    assert len(outs[1][1]) >= 2


def test_spyplot_prints_script_line(tmp_path):
    mat = os.path.join(REPO, "data", "ps3d10pt7", "np1", "IJ.out.A")
    lines = []
    for tag, main, extra in (("jax", _script("spyplot").main, []),
                             ("port", spyplot.main,
                              ["--exec-policy", "host"])):
        png = tmp_path / f"{tag}.png"
        text = _run_main(main, [mat, "-o", str(png)] + extra)
        lines.append(text.splitlines()[0])
        assert png.read_bytes()[:4] == b"\x89PNG"
    assert lines[0] == lines[1]
    assert "1000 x 1000, 6400 nonzeros (6.4 per row)" in lines[1]


def test_bench_kernels_on_the_cpu():
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = bench_kernels.run(8, "float64", "host")
    assert out["probe"]["launch_ok"]
    names = [r["name"] for r in out["rows"]]
    assert names[0] == "triad" and names[-1] == "vcycle"
    spmv = [r for r in out["rows"] if r["name"].endswith("_spmv")]
    assert {r["name"] for r in spmv} == {"dia_spmv", "csr_spmv"}
    assert all(r["rel_err"] <= 1e-12 and r["ms"] > 0 and r["bound_ms"] is None
               for r in spmv)
    assert [lv["n"] for lv in out["levels"]][0] == 512
    assert "csr_spmv  A1 " in buf.getvalue()


def test_bench_kernels_main_on_the_cpu(monkeypatch):
    """The tool as a user runs it: ``BK_NX=8`` and ``--exec-policy host``
    (float32 rows against scipy's float64 product)."""
    monkeypatch.setenv("BK_NX", "8")
    text = _run_main(bench_kernels.main, ["--exec-policy", "host"])
    assert "device=cpu nx=8 dtype=float32" in text
    assert "probe: kernels built" in text and ": OK" in text
    rels = [float(t.split()[0]) for t in text.split("  rel ")[1:]]
    assert len(rels) == 3 and max(rels) <= 1e-6


def test_bench_kernels_helpers():
    """The least bytes of a DIA and a CSR part, the L2-filling copies and
    the library product of a DIA part, on a small operator."""
    from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu_torch.ops.device_matrix import EllMatrix

    A = laplacian_3d_7pt(20)
    E = EllMatrix.from_csr(A)
    n = A.shape[0]
    assert bench_kernels.spmv_bytes("dia_spmv", E, 8) == (A.nnz + 2 * n) * 8
    assert bench_kernels.operand_copies(bench_kernels.L2_BYTES) == 4
    assert bench_kernels.operand_copies(10 * bench_kernels.L2_BYTES) == 1
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    crow, col, val = bench_kernels.dia_as_csr(E.dia_data, E.dia_offsets, n)
    y = bench_kernels.library_spmv(crow, col, val, E.shape)(x)
    np.testing.assert_allclose(y.numpy(), A @ x.numpy(), rtol=1e-13)


_NEED_CARD = {
    "generate_example_output": ["--examples", "ex1.yml"],
    "plot_convergence": [os.path.join(REPO, "examples", "ex1.yml")],
    "spyplot": [os.path.join(REPO, "data", "ps3d10pt7", "np1", "IJ.out.A")],
    "spmat_reorder": [os.path.join(REPO, "data", "ps3d10pt7", "np1",
                                   "IJ.out.A"), "-o", "unused"],
    "fuzz_loop": ["--seconds", "1"],
    "bench_kernels": [],
}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_needs_the_card_without_host(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BK_NX", "8")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"hypredrive_tpu_torch.tools.{tool}")
    with pytest.raises(HypredrvError, match="CUDA"):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(_NEED_CARD[tool])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax(tool):
    """No import of jax, the JAX package or scripts/ in the source."""
    path = os.path.join(REPO, "hypredrive_tpu_torch", "tools", f"{tool}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "hypredrive_tpu", "scripts"), \
            name


def test_tools_load_without_jax():
    """Importing every tool loads no jax or JAX-package module."""
    code = ("import sys\n"
            + "".join(f"import hypredrive_tpu_torch.tools.{t}\n"
                      for t in TOOLS)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'hypredrive_tpu') or m.startswith("
              "'scripts')]\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_fuzz_tool_aims_at_the_port():
    """The fuzzer's coverage is over the port's files, and its corpus
    directory is the port's own."""
    assert fuzz_loop.CORPUS_DIR.endswith(os.path.join("tests",
                                                      "fuzz_corpus_torch"))
    edges = fuzz_loop.EdgeTracer().run(
        lambda: _swallow(fuzz_loop.target_parse, b"solver: [unclosed"))
    assert edges
    assert all(os.sep + "hypredrive_tpu_torch" + os.sep in e[0]
               for e in edges)


def _swallow(fn, data):
    try:
        fn(data)
    except HypredrvError:
        pass
