#!/usr/bin/env python
"""Regenerate the example outputs, and hold them against stored ones.

The port of ``scripts/generate_example_output.py`` (the reference's
scripts/generate_example_output.sh): runs every example config through
``hypredrive_tpu_torch.cli``, masks timestamps, times and the repository's
path as that script does, and writes ``<cfg>.txt`` for each into the out
directory (``build/refOutput_torch/`` by default).

``--compare DIR`` also holds each output against ``DIR/<cfg>.txt``, e.g.
the JAX package's own outputs in ``data/golden/example_output_jax/`` (made
by ``python scripts/generate_example_output.py
data/golden/example_output_jax``):

1. both texts get the normalisation of ``scripts/compare_output.py``
   (this module keeps its own copy), every time cell and total masked, and
   the banner lines dropped (``Using …``, ``Running on …``, any
   ``exec_policy`` line, ``… done!``);
2. every line outside the statistics tables must then be equal;
3. in each table row the iteration count must be equal and each printed
   residual norm within rel ``RES_RTOL`` (2e-2, about one unit in the
   third printed digit) of the stored one.

Runs on the card unless ``--exec-policy host`` is given.

Usage:
  python -m hypredrive_tpu_torch.tools.generate_example_output [outdir]
      [--compare DIR] [--examples ex1.yml ...] [--exec-policy host]
Exit status 1 if a config fails or an output differs from its stored one.
"""

from __future__ import annotations

import argparse
import io
import os
import re
import sys
from contextlib import redirect_stdout
from typing import List

from ..core.entry import add_exec_policy, device, policy_overrides

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

EXAMPLES = ["ex1.yml", "ex1-jacobi.yml", "ex2.yml", "ex3.yml", "ex4.yml",
            "ex5.yml", "ex6.yml", "ex7.yml", "ex8.yml"]

# what the JAX script masks before it writes a file
MASKS = [
    (re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}"),
     "YYYY-MM-DD HH:MM:SS"),
    (re.compile(r"\|\s+[0-9]+\.[0-9]{3}\s+\|"), "|     MASKED |"),
    (re.compile(r"total\s+[0-9.]+ \[ms\]"), "total MASKED [ms]"),
    (re.compile(re.escape(REPO)), "${REPO}"),
]

# scripts/compare_output.py's normalisers, then the cells and totals the
# masks above leave in either form
COMPARE_NORMALIZERS = [
    (re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}"), "DATE TIME"),
    (re.compile(r"hypredrive-tpu v[\d.]+\S*"), "hypredrive-tpu vX.Y.Z"),
    (re.compile(r"(/[\w.+-]+)+/"), "PATH/"),
    (re.compile(r"(?<=\|)\s*\d+\.\d{3}\s*(?=\|)"), "   T   "),
    (re.compile(r"\d+\.\d+\s*(ms|s)\b"), "T \\1"),
    (re.compile(r"(?<=\|)\s*MASKED\s*(?=\|)"), "   T   "),
    (re.compile(r"total\s+(MASKED|[0-9.]+) \[m?s\]"), "total T"),
]

BANNER = re.compile(r"^\s*(Using |Running on |.*exec_policy|.* done!)")

# a statistics row: | entry | 3 times | initial | relative | iters |
STATS_ROW = re.compile(r"^\|\s*\d+\s*\|")

RES_RTOL = 2e-2


def normalize(text: str) -> str:
    """What the JAX script writes: its masks applied."""
    for pat, repl in MASKS:
        text = pat.sub(repl, text)
    return text


def normalize_for_compare(text: str) -> str:
    """Both texts before a comparison: compare_output's normalisation, the
    remaining time cells and totals masked, banner lines dropped."""
    out = []
    for line in normalize(text).splitlines():
        if BANNER.match(line):
            continue
        for pat, rep in COMPARE_NORMALIZERS:
            line = pat.sub(rep, line)
        out.append(line.rstrip())
    return "\n".join(out) + "\n"


def _row_cells(line: str) -> List[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def compare(text: str, golden: str, res_rtol: float = RES_RTOL) -> List[str]:
    """The differences of ``text`` from ``golden`` (empty when they agree):
    lines outside the statistics rows equal, iteration counts equal,
    residual norms within rel ``res_rtol``."""
    a = normalize_for_compare(text).splitlines()
    b = normalize_for_compare(golden).splitlines()
    if len(a) != len(b):
        return [f"{len(a)} lines, expected {len(b)}"]
    problems = []
    for no, (la, lb) in enumerate(zip(a, b), start=1):
        if la == lb:
            continue
        if not (STATS_ROW.match(la) and STATS_ROW.match(lb)):
            problems.append(f"line {no}: {la!r} != {lb!r}")
            continue
        ca, cb = _row_cells(la), _row_cells(lb)
        if len(ca) != len(cb) or ca[0] != cb[0] or ca[-1] != cb[-1]:
            problems.append(f"line {no}: entry/iterations {la!r} != {lb!r}")
            continue
        for x, y in zip(ca[1:-1], cb[1:-1]):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                problems.append(f"line {no}: {x!r} != {y!r}")
                continue
            if abs(fx - fy) > res_rtol * abs(fy):
                problems.append(f"line {no}: residual {x} against {y} "
                                f"(rel {abs(fx - fy) / abs(fy):.3g} > "
                                f"{res_rtol})")
    return problems


def run_example(cfg: str, policy: str = "device") -> tuple:
    """(rc, masked output) of one example config through the CLI."""
    from ..cli import run_one_config

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run_one_config(os.path.join(REPO, "examples", cfg),
                            overrides=policy_overrides(policy))
    return rc, normalize(buf.getvalue())


def run(examples=EXAMPLES, outdir=None, compare_dir=None,
        policy: str = "device") -> dict:
    """Each example through the CLI, written to ``outdir`` and held
    against ``compare_dir`` when given; {cfg: {"rc", "path",
    "problems"}}, printing a line per example."""
    device(policy)
    outdir = os.path.abspath(outdir or os.path.join(REPO, "build",
                                                    "refOutput_torch"))
    compare_dir = os.path.abspath(compare_dir) if compare_dir else None
    os.makedirs(outdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(REPO)   # the examples name their data relative to the repo
    results = {}
    try:
        for cfg in examples:
            if not os.path.exists(os.path.join("examples", cfg)):
                continue
            rc, out = run_example(cfg, policy)
            dest = os.path.join(outdir, cfg.replace(".yml", ".txt"))
            with open(dest, "w") as f:
                f.write(out)
            print(f"{cfg}: rc={rc} -> {dest}", flush=True)
            res = results[cfg] = {"rc": rc, "path": dest, "problems": None}
            if compare_dir:
                ref = os.path.join(compare_dir, cfg.replace(".yml", ".txt"))
                with open(ref) as f:
                    res["problems"] = compare(out, f.read())
                print(f"  vs {ref}: " + (
                    "match" if not res["problems"] else
                    f"{len(res['problems'])} difference(s)"), flush=True)
                for p in res["problems"]:
                    print(f"    {p}")
    finally:
        os.chdir(cwd)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=None,
                    help="default: build/refOutput_torch")
    ap.add_argument("--compare", default=None, metavar="DIR",
                    help="hold each output against DIR/<cfg>.txt")
    ap.add_argument("--examples", nargs="+", default=EXAMPLES,
                    help="example configs to run (default: all)")
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    results = run(args.examples, args.outdir, args.compare, args.exec_policy)
    return 1 if any(r["rc"] or r["problems"] for r in results.values()) \
        else 0


if __name__ == "__main__":
    sys.exit(main())
