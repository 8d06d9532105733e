"""Run one cell once and print its result as the last line of stdout.

    python3 -m solvebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by name, makes the system
(or a Newton sequence's systems, ``sequence.py``) and the right-hand
sides from the seed, sets up, warms up, measures for ``--seconds``,
checks the window's answers against the plain reference and prints one
JSON object.  ``--trace 1`` adds a profiled stretch after the window and
reports the per-layer metrics in place of the end-to-end ones.  Without
as many CUDA cards as the cell asks for it exits 2 and prints no result;
a cell, configuration or mix the harness cannot drive as written exits 1
and prints none.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from types import SimpleNamespace

from . import lifecycle
from .manifest import ROOT, Manifest
from .measure import forbidden_modules

# fixed cache directories inside the checkout: only a cell's first run in
# a checkout builds or compiles
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda_cache"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m solvebench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_caches(root: str) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(root, "build", "solvebench", sub)


def finite(v):
    return v if v is not None and math.isfinite(v) else None


def main(argv=None, root: str = ROOT, require_card: bool = True) -> int:
    args = parse(argv)
    man = Manifest(root)
    cell = man.cell(args.workload)
    cfg = man.config(cell["config"])
    chips = int(cell["chips"])
    try:
        mix = man.traffic(cell["traffic"])
        if chips != 1:
            raise ValueError(f"{chips} chips asked for; the harness drives "
                             "one card a run")
    except ValueError as exc:
        print(f"solvebench: {cell['name']}: {exc}", file=sys.stderr)
        return 1
    set_caches(man.root)
    import torch

    card = torch.cuda.is_available()
    if require_card and (not card or torch.cuda.device_count() < chips):
        print(f"solvebench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if card else 0} available",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(man, cell, cfg, mix, args, card)
        line = result_line(man, cell, out, args.trace, card, chips)
    finally:
        left = lifecycle.reap_descendants()
        if left:
            print(f"solvebench: killed leftover processes {left}",
                  file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"solvebench: loaded {found}: the run must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def run_cell(man, cell, cfg, mix, args, card) -> dict:
    import torch

    from .measure import measure
    from .mix import is_sequence, right_hand_sides
    from .session import LibrarySession

    device = torch.device("cuda", 0) if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(device)
    readers = ({m["name"]: man.reader(m["name"])
                for m in man.metrics("per_layer", cell["name"])}
               if args.trace else None)
    if is_sequence(mix):
        from .sequence import run_sequence

        out = run_sequence(man, cfg, mix, args, device, readers)
    else:
        A, dofmap = man.system(cfg["problem"])
        rhs = right_hand_sides(mix, A.shape[0], args.seed)
        session = LibrarySession(cfg, A, dofmap, device, cfg["dtype"])
        out = measure(session, A, rhs, cfg, mix, args.seed, args.seconds,
                      bool(args.trace), device, readers=readers)
    out["setup_s"] = out["window_open"] - lifecycle.process_start()
    return out


def result_line(man, cell, out, trace, card, chips) -> dict:
    """The contract's last line from a run's raw record: the end-to-end
    metrics (``--trace 0``) or the per-layer ones (``--trace 1``), each
    read by its reader in ``metrics/``; ``checks`` last."""
    import torch

    from . import reference

    kind = "per_layer" if trace else "end_to_end"
    wanted = man.metrics(kind, cell["name"])
    if trace:
        values = out["per_layer"]
    else:
        ctx = SimpleNamespace(solves=out["solves"], window_s=out["window_s"],
                              setup_s=out["setup_s"])
        values = {m["name"]: man.reader(m["name"])(ctx) for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if finite(values.get(m["name"])) is not None}
    device = {"platform": "gpu" if card else "cpu",
              "kind": torch.cuda.get_device_name(0) if card else "cpu",
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    correct = all(reference.within(c["value"], c["limit"])
                  for c in out["checks"].values())
    checks = {k: {"value": finite(c["value"]), "limit": c["limit"]}
              for k, c in out["checks"].items()}
    line = {"correct": correct, "attempted": len(out["solves"]),
            "failed": sum(not s[2] for s in out["solves"]),
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
        line["breakdown"] = out["breakdown"]
    from .timing import quantile

    ms = [s[0] * 1e3 for s in out["solves"]]
    print(f"solvebench: {cell['name']}: {len(ms)} solves in "
          f"{out['window_s']:.3f} s (ms a solve: median "
          f"{quantile(ms, 0.5):.3f}, p95 {quantile(ms, 0.95):.3f}, max "
          f"{max(ms):.3f}), {out['captures_in_window']} captures in the "
          f"window, {out['sampled']} solutions checked", file=sys.stderr)
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
