"""Fixtures of the benchmark's tests: a benchmark root of small cells,
written into a temporary folder from files alone, and the ``card``
marker for tests that need a CUDA card (they skip here, decided inside
the test)."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def small_configs():
    """The two configurations at a size a test holds: every key as
    committed but the sample and site counts."""
    kg = _config("kg1000-p3")
    kg["samples"] = 150
    for p in kg["populations"]:
        if p.get("size"):
            p["size"] = 30
    kg["sites"] = 4096
    uk = _config("ukb-wgs")
    uk["samples"] = 3000
    for p, size in zip(uk["populations"], (2000, 300, 300, 200, 200)):
        p["size"] = size
    uk["sites"] = 1024
    uk["carriers"]["max"] = 64
    return kg, uk


def write_root(path, configs, mixes, workloads, metrics=None):
    """A benchmark root under ``path``: ``BENCHMARK.json`` naming
    ``workloads`` (name → (config, mix)), the configuration and mix files,
    and the committed metric readers (or ``metrics``: name → source)."""
    bench = os.path.join(path, "benchmark")
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "traffic"))
    if metrics is None:
        shutil.copytree(os.path.join(BENCH, "metrics"),
                        os.path.join(bench, "metrics"))
    else:
        os.makedirs(os.path.join(bench, "metrics"))
        for name, source in metrics.items():
            with open(os.path.join(bench, "metrics", name + ".py"), "w") as f:
                f.write(source)
    for name, cfg in configs.items():
        with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
    for name, mix in mixes.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    doc["configs"] = [
        {"name": n, "source": "test", "file": f"benchmark/configs/{n}.json",
         "reduced": [], "why": "test"} for n in configs]
    doc["workloads"] = [
        {"name": w, "config": c, "traffic": m, "chips": 1, "why": "test"}
        for w, (c, m) in workloads.items()]
    if metrics is not None:
        doc["per_layer"] = [
            {"name": n, "unit": "s", "better": "lower",
             "source": "host_clock", "layer": "test", "moves": "job_s"}
            for n in metrics]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return path


# Mixes that no committed cell runs, kept here so the generator's region
# rotation (``span_bp``) and carrier-share cap (``af_max``) stay tested.
GENE_MIX = {"why": "test: consecutive regions of a segment, rotated",
            "sites": 2048, "regions": {"span_bp": 15000},
            "pca_mode": "auto",
            "expect": {"scatter_launches": "zero", "sketch_jobs": "none"}}
RARE_SPARSE_MIX = {"why": "test: rare sites only, every window scattered",
                   # past 256 carried sites a sample: bfloat16 rounds G
                   "sites": 49152, "af_max": 0.01, "regions": "segment",
                   "pca_mode": "sparse",
                   "expect": {"scatter_launches": "positive",
                              "sketch_jobs": "none"}}


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    """The committed cells at a small size (sketch forced: auto flips only
    past N = 32768), and two cells of the test mixes above."""
    kg, uk = small_configs()
    gene = dict(GENE_MIX)
    sketch = _mix("sketch")
    sketch["pca_mode"] = "sketch"
    rare = dict(RARE_SPARSE_MIX)
    return write_root(
        str(tmp_path_factory.mktemp("bench")),
        {"kg1000-p3": kg, "ukb-wgs": uk},
        {"chrom": _mix("chrom"), "gene": gene, "rare-sparse": rare,
         "sketch": sketch},
        {"kg1000.chrom": ("kg1000-p3", "chrom"),
         "ukb-wgs.sketch": ("ukb-wgs", "sketch"),
         "kg1000.gene": ("kg1000-p3", "gene"),
         "kg1000.rare-sparse": ("kg1000-p3", "rare-sparse")},
    )
