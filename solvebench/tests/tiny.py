"""Manifest roots for the tests: a temporary directory holding the real
manifest, traffic mixes, problem generators and metric readers, with
the configurations cut to a few hundred rows (or left at their size).

A root also holds the Newton-sequence cell that ``BENCHMARK.json``
leaves out (``HELD_OUT``), so that the sequence path stays tested: its
configuration, its cell, ``system_s``, its three per-layer metrics, and
the cell added to the per-layer metrics whose readers mean the same per
system."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

from solvebench.manifest import FOLDER, PKG, ROOT

# the real configurations' problem sections, cut
TINY = {
    "poisson128_pcg_amg": {"nx": 8},
    "multiphys64_gmres_mgr": {"nx": 6},
    "multiphys64_fgmres_mgr": {"nx": 6},
}

NEWTON = "multiphys64_fgmres_mgr.newton_seq"
HELD_OUT = {
    "configs": [{
        "name": "multiphys64_fgmres_mgr",
        "source": "https://github.com/hypre-space/hypredrive/blob/master/"
                  "examples/ex7.yml",
        "file": "solvebench/configs/multiphys64_fgmres_mgr.json",
        "reduced": [], "why": "ex7's FGMRES + MGR over a drifting sequence"}],
    "workloads": [{"name": NEWTON, "config": "multiphys64_fgmres_mgr",
                   "traffic": "newton_seq", "chips": 1,
                   "why": "a new system each solve, MGR rebuilt every 2nd"}],
    "end_to_end": [{"name": "system_s", "unit": "s", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": [NEWTON]}],
    "per_layer": [
        {"name": name, "unit": "s", "better": "lower", "source": source,
         "layer": layer, "moves": "system_s", "workloads": [NEWTON]}
        for name, source, layer in (
            ("ingest_s", "host_clock", "entry"),
            ("rebuild_setup_s", "host_clock", "precon setup"),
            ("capture_per_system_s", "program_counter", "Krylov loop"))],
}
# per-layer readers that mean the same per system as per right-hand side
PER_SYSTEM = ("iters_per_solve", "host_reads_per_solve", "flag_wait_ms",
              "launch_ms", "idle_share", "spmv_roofline")


def with_held_out(man: dict) -> dict:
    """``man`` with the held-out cell and its metrics added."""
    for key, entries in HELD_OUT.items():
        man[key] += copy.deepcopy(entries)
    for m in man["per_layer"]:
        if m["name"] in PER_SYSTEM:
            m["workloads"] = m["workloads"] + [NEWTON]
    return man


def held_out_config() -> dict:
    """The held-out cell's configuration, as its file has it."""
    with open(os.path.join(ROOT, HELD_OUT["configs"][0]["file"])) as f:
        return json.load(f)


def real_manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_root(tmp, cut: bool = True, configs=None) -> str:
    """A manifest root under ``tmp`` holding every cell of the real
    manifest and the held-out one, at its tiny size where ``cut``; ``configs`` maps a
    configuration's name to keys that replace its own."""
    root = os.path.join(str(tmp), "bench")
    dst = os.path.join(root, FOLDER)
    os.makedirs(os.path.join(dst, "configs"), exist_ok=True)
    for sub in ("traffic", "metrics", "problems"):
        shutil.copytree(os.path.join(PKG, sub), os.path.join(dst, sub),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    man = with_held_out(copy.deepcopy(real_manifest()))
    for entry in man["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        if cut:
            cfg["problem"].update(TINY[entry["name"]])
        cfg.update((configs or {}).get(entry["name"], {}))
        with open(os.path.join(root, entry["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def command(root, workload, seed=1234, seconds=1.0, trace=0, card=False):
    """The command that runs a cell of ``root`` (on the CPU, without the
    harness's look for a card, unless ``card``)."""
    return ([sys.executable, "-m", "solvebench.tests.run_root", "--root",
             root] + ([] if card else ["--no-card"])
            + ["--workload", workload, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)])


def cpu_env(**extra) -> dict:
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                **extra)


def run(root, workload, timeout=240, env=None, card=False, **kw):
    """(returncode, stdout, stderr) of one run; on the CPU unless
    ``card``."""
    if env is None:
        env = dict(os.environ) if card else cpu_env()
    p = subprocess.run(command(root, workload, card=card, **kw), cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
