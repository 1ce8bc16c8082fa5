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
    chips: int  # the cards the cell runs on, as the workload asks


def _applies(metric: dict, cell: str, reported=None) -> bool:
    """Whether ``metric`` is read in ``cell``: in the cells its
    ``workloads`` lists; else an end-to-end metric in every cell, and a
    per-layer one in every cell that reports the metric it ``moves``
    (``reported``: the cell's end-to-end metrics)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


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
        end_to_end = [m for m in self.doc["end_to_end"] if _applies(m, name)]
        reported = {m["name"] for m in end_to_end}
        return Cell(
            name=name,
            config=config,
            mix=mix,
            end_to_end=end_to_end,
            per_layer=[m for m in self.doc["per_layer"]
                       if _applies(m, name, reported)],
            chips=int(w["chips"]),
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
