"""The port's pod Gramians against the meshless port and the JAX package.

A pod is a mesh that spans the ranks of one process group: here two or
four gloo ranks spawned as ``tests/test_torch_multihost.py`` spawns them
(a free port, hard timeouts), each contributing ``want // world`` copies
of its CPU device. One spawned pod per world size runs every case of the
module (a module fixture); rank 0 saves each case's G. On the same seeded
inputs, split round-robin over the ranks (so the ranks feed unequal
numbers of blocks and the drained one zero-fills):

- ``gramian_blockwise_global`` (G replicated), ``sharded_gramian_
  blockwise_global`` (packed and unpacked) and the sparse pod path of
  ``sparse_sharded_gramian_blockwise`` give a G bit-identical to the port's
  meshless G and to the JAX package's single-controller G on the same
  mesh shape (the JAX package pins its pod G to that one,
  ``tests/test_sparse_gramian.py:1147``), on ``data:2``, ``data:4``,
  ``data:2,model:2`` and ``data:2,model:4`` (the square grids with the
  mirror), at every ``--pod-pipeline-depth`` (0, 2, 8) and
  ``--pod-coalesce-variants`` (0, 256), in shuffled window orders and on
  both density routes;
- the driver and the CLI on a pod with ``--sample-sharded`` and a
  ``--dense-eigh-limit`` below N: rank 0's rows are within 1e-4 of the
  one-process port's (``tests/test_multihost.py:574``), the other ranks
  print none, and the pod routes as the JAX driver does.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from spark_examples_tpu.parallel import (
    gramian_blockwise_global as jax_global,
    make_mesh as jax_make_mesh,
    sharded_gramian_blockwise as jax_sharded_blockwise,
    sparse_sharded_gramian_blockwise as jax_sparse_sharded,
)
from spark_examples_tpu_torch.arrays.blocks import windows_from_calls
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.ops.gramian import gramian_blockwise
from spark_examples_tpu_torch.ops.sparse import sparse_gramian_blockwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, V = 13, 160
# Window (and block) width per world size: with these, the round-robin
# split gives every rank the same route at every step of a mixed stream.
BLOCK = {2: 32, 4: 16}
MIXED = 0.3  # rare windows scatter, common ones go dense
COORD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cohort(seed=0):
    """(N, V) 0/1 int8: rare variants (1–2 carriers) in the first half,
    common ones in the second."""
    rng = np.random.default_rng(seed)
    x = np.zeros((N, V), np.int8)
    for v in range(V // 2):
        x[rng.choice(N, size=rng.integers(1, 3), replace=False), v] = 1
    x[:, V // 2:] = rng.random((N, V - V // 2)) < 0.5
    return x


def _blocks(x, block):
    return [x[:, i:i + block] for i in range(0, x.shape[1], block)]


def _windows(x, block):
    calls = [np.nonzero(x[:, v])[0] for v in range(x.shape[1])]
    return list(windows_from_calls(iter(calls), block))


# Sparse pod settings: (threshold, pipeline depth, coalesce variants,
# shuffled). A shuffled order keeps one route per stream (threshold 2.0:
# every window scatters; 0.0: every window goes dense), since the route is
# a per-step global decision and mixed shuffled streams diverge.
SPARSE = {
    "mixed": (MIXED, 2, 256, False),
    "mixed-lockstep": (MIXED, 0, 256, False),
    "mixed-solo": (MIXED, 8, 0, False),
    "scatter-shuffled": (2.0, 2, 256, True),
    "scatter-shuffled-solo": (2.0, 0, 0, True),
    "dense-shuffled": (0.0, 8, 256, True),
}
DENSE_FNS = ["replicated-packed", "replicated-unpacked", "sharded-packed",
             "sharded-unpacked"]
# At four ranks solo steps of the mixed stream would put scatter and dense
# windows in one step; the coalesced ones keep each step on one route.
FNS = {2: DENSE_FNS + [f"sparse-{k}" for k in SPARSE],
       4: DENSE_FNS + [f"sparse-{k}" for k in SPARSE if k != "mixed-solo"]}
SPECS = {2: ["data:2", "data:4", "data:2,model:2", "data:2,model:4"],
         4: ["data:4", "data:2,model:2"]}
CLI_FIXTURE = ["--fixture-samples", "24", "--fixture-variants", "96",
               "--fixture-seed", "3", "--bases-per-partition", "20000",
               "--block-variants", "32", "--device", "cpu",
               "--dense-eigh-limit", "8"]
CLI_RUNS = {
    "sparse-2x4": ["--mesh-shape", "data:2,model:4", "--pca-mode", "sparse",
                   "--sparse-density-threshold", "0.5"],
    "auto-2x2": ["--mesh-shape", "data:2,model:2", "--pca-mode", "auto",
                 "--sample-sharded", "--sparse-density-threshold", "0.5",
                 "--pod-pipeline-depth", "0"],
    "stream-2x2": ["--mesh-shape", "data:2,model:2", "--pca-mode", "stream",
                   "--sample-sharded"],
    "replicated-2": ["--mesh-shape", "data:2", "--pca-mode", "auto",
                     "--no-sample-sharded"],
}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(script_path, argv, n=2, timeout=120):
    """Spawn ``n`` ranks of one process group and collect their logs; a
    rank left blocked is killed, never leaked."""
    env = {
        **os.environ,
        "PYTHONPATH": ROOT,
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(_free_port()),
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

    from spark_examples_tpu_torch.arrays.blocks import windows_from_calls
    from spark_examples_tpu_torch.cli import main as cli
    from spark_examples_tpu_torch.parallel import (
        ShardedGramian, distributed, make_mesh, mesh_spans_processes)
    from spark_examples_tpu_torch.parallel.sharded import (
        gramian_blockwise_global, sharded_gramian_blockwise_global,
        sparse_sharded_gramian_blockwise)

    out_dir, plan = sys.argv[1], json.loads(sys.argv[2])
    assert distributed.initialize_from_env("cpu")
    rank, world = distributed.process_index(), distributed.process_count()
    N, V, BLOCK = plan["n"], plan["v"], plan["block"]
    rng = np.random.default_rng(0)
    x = np.zeros((N, V), np.int8)
    for v in range(V // 2):
        x[rng.choice(N, size=rng.integers(1, 3), replace=False), v] = 1
    x[:, V // 2:] = rng.random((N, V - V // 2)) < 0.5
    blocks = [x[:, i:i + BLOCK] for i in range(0, V, BLOCK)]
    calls = [np.nonzero(x[:, v])[0] for v in range(V)]
    windows = list(windows_from_calls(iter(calls), BLOCK))
    report = {"rank": rank, "spans": {}, "tiles": {}, "stdout": {}}
    for spec in plan["specs"]:
        mesh = make_mesh(spec, device="cpu")
        report["spans"][spec] = mesh_spans_processes(mesh)
        for fn in plan["fns"]:
            mine = blocks[rank::world]
            if fn.startswith("replicated"):
                g = gramian_blockwise_global(
                    iter(mine), N, mesh, packed=fn.endswith("-packed"))
            elif fn.startswith("sharded"):
                g = sharded_gramian_blockwise_global(
                    iter(mine), N, mesh, packed=fn.endswith("-packed"))
            else:
                threshold, depth, coalesce, shuffled = plan["sparse"][fn[7:]]
                wins = windows[rank::world]
                if shuffled:
                    order = np.random.default_rng(7 + rank).permutation(
                        len(wins))
                    wins = [wins[i] for i in order]
                g = sparse_sharded_gramian_blockwise(
                    iter(wins), N, mesh, density_threshold=threshold,
                    block_variants=BLOCK, pipeline_depth=depth,
                    coalesce_variants=coalesce)
            if isinstance(g, ShardedGramian):
                assert not g.is_fully_addressable
                report["tiles"][f"{spec} {fn}"] = sum(
                    t is not None for t in g.tiles.flat)
                full = g.full()
            else:
                full = g
            if rank == 0:
                np.save(os.path.join(out_dir, f"{spec}-{fn}.npy"),
                        full.numpy())
    for name, argv in plan["cli"].items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["pca", *argv]) == 0
        report["stdout"][name] = buf.getvalue()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    # Tear the group down together before exiting, as torch asks, so no
    # rank's exit races a peer's teardown.
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    """
)


def _pod(tmp_path_factory, world, cli_runs):
    work = tmp_path_factory.mktemp(f"pod{world}")
    script = work / "worker.py"
    script.write_text(_WORKER)
    plan = {
        "n": N, "v": V, "block": BLOCK[world], "specs": SPECS[world],
        "fns": FNS[world],
        "sparse": SPARSE,
        "cli": {k: CLI_FIXTURE + v for k, v in cli_runs.items()},
    }
    _run_workers(script, [work, json.dumps(plan)], n=world)
    reports = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(world)]
    return work, reports


@pytest.fixture(scope="module")
def pod2(tmp_path_factory):
    return _pod(tmp_path_factory, 2, CLI_RUNS)


@pytest.fixture(scope="module")
def pod4(tmp_path_factory):
    return _pod(tmp_path_factory, 4, {})


@pytest.fixture(scope="module")
def cohort():
    x = _cohort()
    meshless = gramian_blockwise(_blocks(x, 32), N, device="cpu").numpy()
    assert np.array_equal(meshless, x.astype(np.int64) @ x.T)
    return x, meshless


_JAX_G = {}


def _jax_g(x, spec, fn, block):
    """The JAX package's single-controller G on ``spec``'s shape over the
    8 virtual CPU devices."""
    kind = fn.split("-")[0] if not fn.startswith("sparse") else fn
    key = (spec, kind, fn.endswith("-packed"), block)
    if key not in _JAX_G:
        mesh = jax_make_mesh(spec, devices=jax.devices()[:8])
        if kind == "replicated":
            g = jax_global(_blocks(x, block), N, mesh, packed=key[2])
        elif kind == "sharded":
            g = jax_sharded_blockwise(_blocks(x, block), N, mesh,
                                      packed=key[2])
        else:
            threshold = SPARSE[fn[7:]][0]
            g = jax_sparse_sharded(iter(_windows(x, block)), N, mesh,
                                   density_threshold=threshold,
                                   block_variants=block)
        _JAX_G[key] = np.asarray(g)
    return _JAX_G[key]


def _check_case(work, reports, world, spec, fn, cohort):
    x, meshless = cohort
    got = np.load(work / f"{spec}-{fn}.npy")
    assert got.dtype == np.float32 and got.shape == (N, N)
    np.testing.assert_array_equal(got, meshless)
    np.testing.assert_array_equal(got, _jax_g(x, spec, fn, BLOCK[world]))
    if fn.startswith("sparse"):
        threshold = SPARSE[fn[7:]][0]
        port_sparse = sparse_gramian_blockwise(
            iter(_windows(x, BLOCK[world])), N, density_threshold=threshold,
            block_variants=BLOCK[world], device="cpu").numpy()
        np.testing.assert_array_equal(got, port_sparse)
    for report in reports:
        assert report["spans"][spec] is True
        if not fn.startswith("replicated"):
            # Each rank holds only its own tiles: the grid's count over
            # the world.
            rows, cols = (int(p.split(":")[1]) for p in
                          (spec + ",model:1").split(",")[:2])
            assert report["tiles"][f"{spec} {fn}"] == rows * cols // world


@pytest.mark.parametrize("fn", FNS[2])
@pytest.mark.parametrize("spec", SPECS[2])
def test_two_rank_pod_g_is_the_meshless_and_the_jax_g(spec, fn, pod2,
                                                       cohort):
    work, reports = pod2
    _check_case(work, reports, 2, spec, fn, cohort)


@pytest.mark.parametrize("fn", FNS[4])
@pytest.mark.parametrize("spec", SPECS[4])
def test_four_rank_pod_g_is_the_meshless_and_the_jax_g(spec, fn, pod4,
                                                        cohort):
    work, reports = pod4
    _check_case(work, reports, 4, spec, fn, cohort)


def _tsv_rows(out):
    return [line.split("\t") for line in out.splitlines()
            if line.count("\t") == 3]


def _one_process(argv, capsys):
    """The same run in one process: the spec's grid on the CPU device
    repeated, no process group."""
    assert cli.main(["pca", *CLI_FIXTURE, *argv]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_rank_0_prints_the_one_process_rows(name, pod2, capsys):
    _, (r0, r1) = pod2
    alone = _one_process(CLI_RUNS[name], capsys)
    got, want = _tsv_rows(r0["stdout"][name]), _tsv_rows(alone)
    assert len(got) == 24 == len(want)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    err = max(max(abs(float(a[2]) - float(b[2])),
                  abs(float(a[3]) - float(b[3]))) for a, b in zip(got, want))
    assert err <= COORD_TOL, err
    assert _tsv_rows(r1["stdout"][name]) == []
    # Both ranks print the parity line from the pod's row sums.
    nonzero = [ln for ln in alone.splitlines() if ln.startswith("Non zero")]
    for report in (r0, r1):
        assert nonzero[0] in report["stdout"][name]


@pytest.mark.parametrize(
    "spec,sharded,mode,sparse",
    [("data:2,model:2", True, "auto", True),
     ("data:2,model:2", False, "auto", False),
     ("data:2,model:4", None, "sparse", True),
     ("data:2", True, "stream", False)],
)
def test_a_pod_routes_as_the_jax_driver(spec, sharded, mode, sparse,
                                        monkeypatch):
    """On a spanning mesh ``auto`` picks sparse when G is sample-sharded
    (JAX ``models/pca.py:843-870``), a pod merges nothing, and the G
    bytes a rank holds are its share of the grid (``:872``)."""
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
        synthetic_cohort,
    )
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.parallel import Mesh, distributed
    from spark_examples_tpu_torch.utils.config import PcaConfig

    rows, cols = (int(p.split(":")[1]) for p in
                  (spec + ",model:1").split(",")[:2])
    names = tuple(p.split(":")[0] for p in spec.split(","))
    grid = np.arange(rows * cols).reshape([int(p.split(":")[1])
                                           for p in spec.split(",")])
    devices = np.empty(grid.shape, dtype=object)
    devices[...] = torch.device("cpu")
    owners = grid * 2 // grid.size  # two ranks, rank by rank
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    mesh = Mesh(devices, names, owners)
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", pca_mode=mode, sample_sharded=sharded,
                  sample_shard_threshold=8,
                  variant_set_ids=[DEFAULT_VARIANT_SET_ID]),
        synthetic_cohort(24, 96, seed=3),
        mesh=mesh,
    )
    assert driver._mesh_spans_processes()
    assert driver._sparse_selected() is sparse
    g = object()
    assert driver._merge_partials(g) is g
    n_padded = -(-24 // (rows * cols)) * rows * cols
    tile = (n_padded // rows) * (n_padded // cols) * 4
    assert driver._sparse_host_g_bytes() == tile * int((owners == 0).sum())


@pytest.mark.parametrize("grid", [2, 3])
@pytest.mark.parametrize("route", ["scatter", "dense"])
def test_the_mirror_halves_fill_to_the_whole_tiles(grid, route, cohort):
    """The mirror in one process (what each pair of ranks does across
    the group): the off-diagonal tiles compute only their slabs — the
    upper tile its top rows, the lower its right columns — and the fill's
    swap and transpose rebuilds every tile bit for bit."""
    from spark_examples_tpu_torch.ops.gramian import pack_indicator_block
    from spark_examples_tpu_torch.ops.sparse import (
        _pad_rows_for_scan,
        padded_carrier_matrix,
    )
    from spark_examples_tpu_torch.parallel import ShardedGramian, make_mesh
    from spark_examples_tpu_torch.parallel.sharded import (
        _mirror_fill,
        _tile_dense_pod,
        _tile_scatter,
    )

    x, meshless = cohort
    mesh = make_mesh(f"data:{grid},model:{grid}", device="cpu")
    g = ShardedGramian.zeros(N, mesh)
    half = g.tile_rows // 2
    xp = np.pad(x, ((0, g.n_padded - N), (0, 0)))
    if route == "scatter":
        for idx, lens in _windows(x, 32):
            _tile_scatter(g, padded_carrier_matrix(
                idx, lens, sentinel=g.n_padded,
                n_rows=_pad_rows_for_scan(lens.size)), mirror=True)
    else:
        _tile_dense_pod(g, torch.from_numpy(pack_indicator_block(xp)),
                        torch.int8, mirror=True)
    full = xp.astype(np.int64) @ xp.T.astype(np.int64)
    for (i, j), tile in g.local_tiles():
        r0, c0 = g.tile_origin(i, j)
        block = full[r0:r0 + g.tile_rows, c0:c0 + g.tile_cols].copy()
        if i < j:
            block[half:, :] = 0
        elif i > j:
            block[:, :half] = 0
        np.testing.assert_array_equal(tile.numpy(), block)
    _mirror_fill(g)
    np.testing.assert_array_equal(g.full().numpy(), meshless)
