"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root names the cells, configurations and
metrics.  Each piece lives in a file of its own under this folder, found
by its name alone, so a later cell or metric is added as files and
manifest entries, with no edit here:

- a configuration: the ``file`` its manifest entry gives
  (``solvebench/configs/<config>.json``);
- a traffic mix: ``solvebench/traffic/<mix>.json``, checked by
  ``mix.py`` against what the harness drives;
- the system a configuration solves: ``solvebench/problems/<kind>.py``
  for its ``problem`` section's ``kind``, whose ``build(**arguments)``
  makes it, and, for a mix that brings a new system on every solve, whose
  ``sequence(count, **arguments)`` makes that many on one pattern;
- a metric: ``solvebench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the metric's value or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List, Optional, Tuple

from . import mix as mixes

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FOLDER = os.path.basename(PKG)


class Manifest:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root,
                               self._named("configs", name)["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        """The mix's parameters; ValueError where the harness does not
        drive one of them."""
        with open(os.path.join(self.root, FOLDER, "traffic",
                               name + ".json")) as f:
            return mixes.check(json.load(f))

    def metrics(self, kind: str, cell: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports: a
        metric without ``workloads`` is reported in every cell."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def _module(self, sub: str, name: str):
        path = os.path.join(self.root, FOLDER, sub, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"{FOLDER}_{sub}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable[[object], Optional[float]]:
        return self._module("metrics", metric).read

    def system(self, problem: dict) -> Tuple[object, Optional[object]]:
        """(A, dofmap or None) of a configuration's ``problem`` section:
        its ``kind`` names the file, the other keys are the arguments."""
        args = {k: v for k, v in problem.items() if k != "kind"}
        return self._module("problems", problem["kind"]).build(**args)

    def sequence(self, problem: dict, count: int
                 ) -> Tuple[List[object], Optional[object]]:
        """([A_0, …, A_{count−1}], dofmap or None) of a configuration whose
        ``problem`` kind gives a sequence of systems on one pattern: its
        file's ``sequence(count, **arguments)``."""
        args = {k: v for k, v in problem.items() if k != "kind"}
        return self._module("problems", problem["kind"]).sequence(count,
                                                                  **args)

