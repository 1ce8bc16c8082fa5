"""Two gloo ranks of the port against one process: the data-parallel
regime.

Spawns two processes, as ``tests/test_multihost.py::_run_workers`` does
for the JAX package (a free port, hard timeouts), with the standard
``torch.distributed`` launcher variables. Each runs the port's own path:
``initialize_from_env`` (gloo, since ``--device cpu``), ``shards[r::2]``
of the manifest, its partial G or sketch panel, the merge over the group,
the merged IoStats, and emission on rank 0 alone. Rank 0's TSV must be
the one-process port's within 1e-4 in ``auto``, ``sparse`` and the
meshless ``sketch`` (and with ``--mesh-shape``, whose mesh spans the two
ranks: a pod), G bit-identical, the IoStats merged; rank 1 emits nothing;
``allreduce_gramian`` refuses a tile grid.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.parallel import (
    ShardedGramian,
    allreduce_gramian,
    allreduce_host_stats,
    make_mesh,
)
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.stats import IoStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORD_TOL = 1e-4
FIXTURE = ["--fixture-samples", "24", "--fixture-variants", "300",
           "--fixture-seed", "5", "--bases-per-partition", "20000",
           "--block-variants", "32", "--device", "cpu"]
RUNS = {
    "auto": ["--pca-mode", "auto"],
    "sparse": ["--pca-mode", "sparse", "--sparse-density-threshold", "0.5"],
    "sketch": ["--pca-mode", "sketch", "--sketch-power-iters", "1"],
    "mesh-stream": ["--pca-mode", "stream", "--mesh-shape", "data:2,model:2"],
    "mesh-sparse": ["--pca-mode", "sparse", "--mesh-shape", "data:2",
                    "--sparse-density-threshold", "0.5"],
}
DRIVER = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
              bases_per_partition=20_000, block_variants=32,
              sparse_density_threshold=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(script_path, argv, n=2, timeout=120):
    """Spawn ``n`` ranks of one process group and collect their logs; a
    rank left blocked in a collective is killed, never leaked."""
    port = _free_port()
    env = {
        **os.environ,
        "PYTHONPATH": ROOT,
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "WORLD_SIZE": str(n),
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(script_path)] + [str(a) for a in argv],
            env={**env, "RANK": str(i), "LOCAL_RANK": str(i)},
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(n)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


_WORKER = textwrap.dedent(
    """
    import contextlib, io, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from spark_examples_tpu_torch.cli import main as cli
    from spark_examples_tpu_torch.genomics.fixtures import synthetic_cohort
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.parallel import (
        ShardedGramian, distributed, make_mesh)
    from spark_examples_tpu_torch.utils.config import PcaConfig

    out_dir, fixture, runs, driver_kw = (
        sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]),
        json.loads(sys.argv[4]))
    assert distributed.initialize_from_env("cpu"), "no process group"
    rank = distributed.process_index()
    assert distributed.process_count() == 2
    report = {"rank": rank, "stdout": {}}
    for name, extra in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["pca", *fixture, *extra, "--output-path",
                             os.path.join(out_dir, f"{name}-r{rank}")]) == 0
        report["stdout"][name] = buf.getvalue()
    for mode in ("auto", "sparse"):
        driver = VariantsPcaDriver(
            PcaConfig(device="cpu", pca_mode=mode, **driver_kw),
            synthetic_cohort(24, 300, seed=5))
        with contextlib.redirect_stdout(io.StringIO()):
            driver.run()
        report[f"shards_{mode}"] = len(driver._manifest())
        if rank == 0:
            np.save(os.path.join(out_dir, f"g-{mode}.npy"), driver.g.numpy())
    try:
        distributed.allreduce_gramian(
            ShardedGramian.zeros(4, make_mesh("data:2", device="cpu")))
    except ValueError as e:
        report["refused"] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    """
)


def _tsv_rows(out):
    return [line.split("\t") for line in out.splitlines()
            if line.count("\t") == 3]


def _stats(out):
    return [line for line in out.splitlines() if line.startswith("# of")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_workers(script, [work, json.dumps(FIXTURE), json.dumps(RUNS),
                          json.dumps(DRIVER)])
    reports = [json.loads((work / f"rank{r}.json").read_text())
               for r in (0, 1)]
    return work, reports


def _one_process(name, capsys, tmp_path):
    assert cli.main(["pca", *FIXTURE, *RUNS[name], "--output-path",
                     str(tmp_path / name)]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_0_prints_the_one_process_rows(name, two_ranks, capsys,
                                            tmp_path):
    work, (r0, r1) = two_ranks
    alone = _one_process(name, capsys, tmp_path)
    got, want = _tsv_rows(r0["stdout"][name]), _tsv_rows(alone)
    assert len(got) == 24
    assert [(r[0], r[1]) for r in got] == [(r[0], r[1]) for r in want]
    err = max(max(abs(float(a[2]) - float(b[2])),
                  abs(float(a[3]) - float(b[3]))) for a, b in zip(got, want))
    assert err <= COORD_TOL, err
    # The merged IoStats, printed by rank 0: the one process's partitions,
    # bases and variants (each rank listed the callsets once more: one
    # more request).
    merged, one = _stats(r0["stdout"][name]), _stats(alone)
    for line in ("partitions", "reference bases", "variants read"):
        assert [s for s in merged if line in s] == [s for s in one if line in s]
    want = int(next(s for s in one if "API requests" in s).split(": ")[1])
    assert f"# of API requests: {want + 1}" in merged
    assert (work / f"{name}-r0-pca.tsv").exists()


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_1_emits_nothing(name, two_ranks):
    work, (_, r1) = two_ranks
    assert r1["rank"] == 1
    assert _tsv_rows(r1["stdout"][name]) == []
    assert _stats(r1["stdout"][name]) == []
    assert not (work / f"{name}-r1-pca.tsv").exists()


@pytest.mark.parametrize("mode", ["auto", "sparse"])
def test_merged_g_is_the_one_process_g(mode, two_ranks, capsys):
    work, (r0, r1) = two_ranks
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", pca_mode=mode, **DRIVER),
        synthetic_cohort(24, 300, seed=5),
    )
    driver.run()
    capsys.readouterr()
    np.testing.assert_array_equal(
        np.load(work / f"g-{mode}.npy"), driver.g.numpy()
    )
    # Each rank ingested its round-robin slice of the manifest.
    total = len(driver._manifest())
    assert r0[f"shards_{mode}"] + r1[f"shards_{mode}"] == total
    assert r0[f"shards_{mode}"] == (total + 1) // 2


def test_allreduce_refuses_a_tile_grid(two_ranks):
    _, reports = two_ranks
    for report in reports:
        assert "tile grid" in report["refused"]
    grid = ShardedGramian.zeros(4, make_mesh("data:2", device="cpu"))
    with pytest.raises(ValueError, match="tile grid"):
        allreduce_gramian(grid)


def test_one_process_is_the_identity():
    g = torch.arange(9.0).reshape(3, 3)
    assert allreduce_gramian(g) is g
    stats = IoStats(partitions=2)
    assert allreduce_host_stats(stats) is stats


def test_merged_panels_are_the_jax_float32_merge(monkeypatch):
    """The data-parallel sketch merge is float32, as the JAX package's
    (it runs without 64-bit floats): rank 0's merge of two float64
    partial panels (the group's all-gather stood in for by rank 1's
    panel) equals the JAX merge's own ops on the same panels."""
    import jax.numpy as jnp
    import torch.distributed as dist

    from spark_examples_tpu_torch.ops.sketch import _merge_partial_panels
    from spark_examples_tpu_torch.parallel import distributed

    rng = np.random.default_rng(4)
    mine, theirs = (rng.standard_normal((24, 11)) for _ in range(2))

    def all_gather(parts, part):
        parts[0].copy_(part)
        parts[1].copy_(torch.from_numpy(theirs.astype(np.float32)))

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(dist, "all_gather", all_gather)
    port_merge = _merge_partial_panels(mine)
    jax_merge = np.asarray(
        jnp.sum(jnp.asarray(np.stack([mine, theirs])), axis=0)
    )
    assert port_merge.dtype == jax_merge.dtype == np.float32
    np.testing.assert_array_equal(port_merge, jax_merge)
