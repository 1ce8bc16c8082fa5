"""A cell, a configuration, a traffic mix and a per-layer metric are found
from files alone: a new one is new files, and no file that exists changes."""

import json
import os

import pytest

from benchmark import harness, spec as spec_mod
from benchmark.tests.conftest import ROOT, small_configs, write_root

DUMMY_METRIC = '''
def read(run):
    return float(len(run.jobs))
'''


def _committed():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_committed_cells_resolve():
    spec = spec_mod.load()
    doc = _committed()
    for w in doc["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        names = {m["name"] for m in cell.end_to_end}
        assert {"peak_card_mib", "setup_s"} <= names
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
        for reader in spec.readers(cell).values():
            assert callable(reader)
        limits = cell.config["limits"]
        # the reference MLlib bar, or tighter where the control meets it
        assert 0 < limits["coord_gap"] <= 1e-4
        assert limits["route_misses"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_cell_is_files_alone(tmp_path, trace):
    """A dummy cell, its configuration, its mix and a per-layer metric, all
    new files under a temporary root, run through the committed harness."""
    config = small_configs()[0]
    config["name"] = "dummy-config"
    mix = {"why": "test", "regions": {"span_bp": 10000}, "sites": 1024,
           "pca_mode": "auto", "expect": {"sketch_jobs": "none"}}
    root = write_root(
        str(tmp_path), {"dummy-config": config}, {"dummy-mix": mix},
        {"dummy.cell": ("dummy-config", "dummy-mix")},
        metrics={"dummy_jobs": DUMMY_METRIC})
    spec = spec_mod.load(root)
    cell = spec.cell("dummy.cell")
    assert cell.mix == mix and cell.config["sites"] == 4096
    result = harness.run_cell(spec, "dummy.cell", 5, 0.2, trace=trace,
                              device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    if trace:
        assert result["metrics"]["dummy_jobs"]["value"] == result["attempted"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"job_s", "peak_card_mib", "setup_s"}
    assert list(result)[-1] == "checks"


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec_mod.load().cell("no.such.cell")


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.-]{1,16}"


def test_benchmark_json_keeps_to_its_limits():
    import re

    doc = _committed()
    assert list(doc) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert 1 <= doc["run_seconds"] <= 51
    names = [c["name"] for c in doc["configs"]] + [
        w["name"] for w in doc["workloads"]] + [
        m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert re.fullmatch(NAME, name), name
    for text in ([c["source"] for c in doc["configs"]]
                 + [x["why"] for x in doc["configs"] + doc["workloads"]]
                 + [m["layer"] for m in doc["per_layer"]] + doc["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    used = {w["config"] for w in doc["workloads"]}
    assert used == {c["name"] for c in doc["configs"]}
    cells = {w["name"] for w in doc["workloads"]}
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert re.fullmatch(UNIT, m["unit"]) and m["better"] in (
            "lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25
    reported = {w: {m["name"] for m in doc["end_to_end"]
                    if w in m.get("workloads", cells)} for w in cells}
    for w in cells:
        assert "setup_s" in reported[w] and len(reported[w]) >= 2
    for m in doc["per_layer"]:
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}
        assert m["layer"]
        for w in m.get("workloads", []):
            assert m["moves"] in reported[w], (m["name"], w)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_a_per_layer_metric_without_cells_follows_what_it_moves():
    """A per-layer metric with no ``workloads`` is read in every cell that
    reports the end-to-end metric it moves, and only there."""
    spec = spec_mod.load()
    doc = _committed()
    for w in doc["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        read = {m["name"] for m in cell.per_layer}
        for m in doc["per_layer"]:
            if "workloads" not in m:
                assert (m["name"] in read) == (m["moves"] in names)


def test_the_chrom_readers_read_as_their_originals():
    """``<name>.chrom`` reads what ``<name>`` reads; ``job_s.chrom`` is the
    window's seconds over its jobs, as ``job_s``."""
    import types

    from benchmark.trace import Trace

    spec = spec_mod.load()
    ranges = {"bench.window": [(1, 0, 4000)],
              "shard.wait": [(2, 0, 400)], "callsets.index": [(1, 10, 60)],
              "rows.sort": [(1, 100, 300)]}
    trace = Trace([(0, 500, "k", 0)], ranges, {}, (0, 4000))
    jobs = [types.SimpleNamespace(construct_s=0.25 * i, stages={
        "ingest+gramian": 1.0 + i, "pca": 0.5, "emit": 0.125 * i})
        for i in range(1, 4)]
    run = harness.Run(jobs=jobs, trace=trace, window_s=9.0)
    names = [m["name"] for m in _committed()["per_layer"]]
    split = [n[:-len(".chrom")] for n in names if n.endswith(".chrom")]
    assert "construct_s" in split and "device_idle" in split
    for base in split:
        if base in names:
            value = spec.reader(base + ".chrom")(run)
            assert value == spec.reader(base)(run) and value is not None
    assert spec.reader("job_s.chrom")(run) == 3.0
