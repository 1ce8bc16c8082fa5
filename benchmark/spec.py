"""Resolve a cell from files alone: ``BENCHMARK.json`` lists the cells and
metrics; a configuration, a traffic mix and a per-layer metric's reader are
found by name beside this file (or beside another root, for tests).

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes,
  source, cuts, guarantees and the limits of its comparisons;
- ``<root>/benchmark/traffic/<mix>.json``: the jobs a cell runs;
- ``<root>/benchmark/metrics/<metric>.py``: a module with
  ``read(run) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

__all__ = ["Cell", "Spec", "load"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Spec:
    """``BENCHMARK.json`` under ``root``, and the files it names."""

    def __init__(self, root: str = REPO_ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)
        self._bench = os.path.join(root, "benchmark")

    def _path(self, *parts: str) -> str:
        return os.path.join(self._bench, *parts)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise KeyError(
                f"no workload {name!r}; known: {', '.join(sorted(cells))}"
            )
        w = cells[name]
        configs = {c["name"]: c for c in self.doc["configs"]}
        with open(os.path.join(self.root, configs[w["config"]]["file"])) as f:
            config = json.load(f)
        with open(self._path("traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        return Cell(
            name=name,
            config=config,
            mix=mix,
            end_to_end=[m for m in self.doc["end_to_end"] if _applies(m, name)],
            per_layer=[m for m in self.doc["per_layer"] if _applies(m, name)],
        )

    def reader(self, metric: str) -> Callable[[object], Optional[float]]:
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self._path("metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path,
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def readers(self, cell: Cell) -> Dict[str, Callable]:
        return {m["name"]: self.reader(m["name"]) for m in cell.per_layer}


def load(root: str = REPO_ROOT) -> Spec:
    return Spec(root)
