"""Checkpoints in a process group: the port against the JAX package's.

The twins of ``tests/test_multihost.py:475, 684, 794``, on two gloo ranks
spawned once for the module (as ``tests/test_torch_pod_gramian.py``
spawns its pods). Every rank's second round (or shard) fails on purpose;
the synced pod stream raises on both ranks together, and a fresh driver
resumes from the snapshots:

- a pod with G replicated (``data:2,model:4``, ``--no-sample-sharded``):
  each rank snapshots G with a global round cursor into ``host-<p>``;
  before the resume each rank's snapshot is rewritten by the JAX
  package's ``save_snapshot`` (deflated), so the port resumes a JAX pod
  snapshot;
- a pod with G sample-sharded (``data:2,model:4``, and the mirrored
  ``data:2,model:2``, each at an n the device count divides and at one
  it does not): each rank snapshots only its tiles, in the JAX package's tile
  bounds, rewritten by the JAX package's ``save_sharded_snapshot``
  before the resume;
- a data-parallel run (no mesh): each rank snapshots its manifest slice
  under the ``|host=p/P`` digest and the partials merge at the end;
- rounds that disagree (one rank's snapshot gone): every rank discards
  with the JAX package's warning and re-ingests from round 0.

Every resumed G is bit-identical to the one-process uncheckpointed G and
to the JAX package's; the JAX package's loaders read the port's files
under the JAX digests, and a tile set is the one the JAX package's
``P(data, model)`` sharding gives each process.
"""

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
from jax.sharding import NamedSharding, PartitionSpec

from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.genomics.shards import (
    manifest_digest as jax_manifest_digest,
    shards_for_references as jax_shards_for_references,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.parallel import make_mesh as jax_make_mesh
from spark_examples_tpu.utils import checkpoint as jax_checkpoint
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.parallel import ShardedGramian, make_mesh
from spark_examples_tpu_torch.parallel.sharded import jax_tile_splits
from spark_examples_tpu_torch.utils.config import PcaConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = "17:41196311:41277499"

# name: (mesh spec or None, sample_sharded, (n, v, seed), rewrite)
CASES = {
    "replicated": ("data:2,model:4", False, (10, 80, 5), True),
    "tiled": ("data:2,model:4", True, (24, 96, 3), True),
    "tiled-mirror": ("data:2,model:2", True, (24, 96, 3), True),
    # n that each axis divides but the device count does not: the JAX
    # package's tiles are n / parts wide, the port's grid pads n to a
    # multiple of the device count, and the snapshot keeps the JAX tiles.
    "tiled-uneven": ("data:2,model:4", True, (12, 96, 3), True),
    "tiled-mirror-uneven": ("data:2,model:2", True, (10, 80, 5), True),
    "host": (None, None, (10, 80, 5), False),
}


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
    import contextlib, io, json, os, shutil, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from spark_examples_tpu.utils import checkpoint as jax_checkpoint
    from spark_examples_tpu_torch.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID, synthetic_cohort)
    from spark_examples_tpu_torch.genomics.shards import (
        shards_for_references)
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.parallel import (
        ShardedGramian, distributed, make_mesh)
    from spark_examples_tpu_torch.utils import checkpoint
    from spark_examples_tpu_torch.utils.config import PcaConfig

    out, cases = sys.argv[1], json.loads(sys.argv[2])
    assert distributed.initialize_from_env("cpu")
    pid, world = distributed.process_index(), distributed.process_count()


    class _Shard:
        # The JAX writer's view of one tile: its data and global index.
        def __init__(self, data, index):
            self.data, self.index = data, index


    class _Tiles:
        def __init__(self, n, tiles):
            self.shape = (n, n)
            self.addressable_shards = [_Shard(d, i) for i, d in tiles]


    def rewrite_with_the_jax_writer(ck_dir):
        snap = os.path.join(ck_dir, "gramian_snapshot.npz")
        tiled = os.path.join(ck_dir, "gramian_sharded_snapshot.npz")
        if os.path.exists(snap):
            with np.load(snap) as z:
                g, done = z["g"], int(z["shards_done"])
                digest = bytes(z["run_digest"]).decode()
            jax_checkpoint.save_snapshot(ck_dir, g, done, digest)
        else:
            with np.load(tiled) as z:
                n, done = int(z["n"]), int(z["shards_done"])
                digest = bytes(z["run_digest"]).decode()
                tiles, i = [], 0
                while f"data_{i}" in z:
                    index = tuple(slice(int(a), int(b))
                                  for a, b in z[f"index_{i}"])
                    tiles.append((index, z[f"data_{i}"]))
                    i += 1
            jax_checkpoint.save_sharded_snapshot(
                ck_dir, _Tiles(n, tiles), done, digest)


    def driver(name, spec, sharded, cohort, ck, source):
        kw = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                  bases_per_partition=20_000, block_variants=32,
                  checkpoint_dir=ck, checkpoint_every=1, device="cpu")
        if sharded is not None:
            kw["sample_sharded"] = sharded
        mesh = make_mesh(spec, device="cpu") if spec else None
        return VariantsPcaDriver(PcaConfig(**kw), source, mesh=mesh)


    def full(g):
        return (g.full() if isinstance(g, ShardedGramian) else g).numpy()


    report = {}
    for name, (spec, sharded, cohort, rewrite) in cases.items():
        ck = os.path.join(out, name)
        n, v, seed = cohort
        rec = report[name] = {}
        # Phase 1: every rank's second round fails (its slice's shard 1).
        source = synthetic_cohort(n, v, seed=seed)
        mine = shards_for_references(
            "17:41196311:41277499", 20_000)[pid::world]
        source._fail_once.add(mine[1])
        d = driver(name, spec, sharded, cohort, ck, source)
        try:
            d.get_similarity_matrix_checkpointed()
            rec["failed"] = None
        except (RuntimeError, IOError) as e:
            rec["failed"] = [type(e).__name__,
                             type(e.__cause__).__name__ if e.__cause__
                             else None]
        own = os.path.join(ck, f"host-{pid}")
        rec["files"] = sorted(os.listdir(own))
        if rewrite:
            rewrite_with_the_jax_writer(own)
        # Phase 2: a fresh driver resumes.
        source = synthetic_cohort(n, v, seed=seed)
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            g = driver(name, spec, sharded, cohort, ck,
                       source).get_similarity_matrix_checkpointed()
        rec["tiled"] = isinstance(g, ShardedGramian)
        if rec["tiled"]:
            rec["local_tiles"] = len(g.local_tiles())
        g = full(g)
        rec["partitions"] = source.stats.partitions
        rec["stdout"], rec["stderr"] = buf.getvalue(), err.getvalue()
        if pid == 0:
            np.save(os.path.join(out, f"{name}.npy"), g)
    # Rounds that disagree: rank 1 loses its snapshot of the finished
    # replicated run; every rank discards and re-ingests from round 0.
    spec, sharded, cohort, _ = cases["replicated"]
    ck = os.path.join(out, "replicated")
    if pid == 1:
        shutil.rmtree(os.path.join(ck, "host-1"))
    source = synthetic_cohort(*cohort[:2], seed=cohort[2])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        g = driver("disagree", spec, sharded, cohort, ck,
                   source).get_similarity_matrix_checkpointed()
    report["disagree"] = {"stderr": err.getvalue(),
                          "partitions": source.stats.partitions}
    if pid == 0:
        np.save(os.path.join(out, "disagree.npy"), full(g))
    with open(os.path.join(out, f"rank{pid}.json"), "w") as f:
        json.dump(report, f)
    # Tear the group down together before exiting, as torch asks, so no
    # rank's exit races a peer's teardown.
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    work = tmp_path_factory.mktemp("podck")
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_workers(script, [work, json.dumps(CASES)], n=2)
    reports = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(2)]
    return work, reports


_PLAIN = {}


def _plain(cohort):
    """The one-process uncheckpointed G, the same in both packages."""
    if cohort not in _PLAIN:
        n, v, seed = cohort
        kw = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                  bases_per_partition=20_000, block_variants=32)
        g = VariantsPcaDriver(PcaConfig(device="cpu", **kw),
                              synthetic_cohort(n, v, seed=seed))\
            .ingest_gramian().numpy()
        jax_g = JaxDriver(JaxConfig(**kw),
                          jax_synthetic_cohort(n, v, seed=seed))\
            .ingest_gramian()
        np.testing.assert_array_equal(g, np.asarray(jax_g))
        _PLAIN[cohort] = g
    return _PLAIN[cohort]


def _jax_digest(case, rank, world=2):
    spec, sharded, _, _ = CASES[case]
    mine = jax_shards_for_references(REFS, 20_000)[rank::world]
    base = f"{jax_manifest_digest(mine)}|{DEFAULT_VARIANT_SET_ID}|af=None"
    if spec is None:
        return f"{base}|host={rank}/{world}"
    tag = f"|mesh={spec}" if sharded else ""
    return f"{base}|pod={rank}/{world}|every=1{tag}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_resumed_g_is_the_plain_and_the_jax_g(case, pod):
    work, reports = pod
    spec, sharded, cohort, _ = CASES[case]
    np.testing.assert_array_equal(np.load(work / f"{case}.npy"),
                                  _plain(cohort))
    for rank, report in enumerate(reports):
        rec = report[case]
        # Both ranks failed in round 2 (the pod raises on every rank
        # together, chaining the ingest error where it happened).
        if spec is None:
            assert rec["failed"][0] in ("OSError", "IOError"), rec
        else:
            assert rec["failed"][0] == "RuntimeError", rec
        # Round 1 resumed from its snapshot: fewer than the slice's
        # shards (3 on rank 0, 2 on rank 1) were streamed again.
        mine = 3 - rank
        assert rec["partitions"] < mine, rec
        resume = (f"Resuming from snapshot: 1/{mine} shards done."
                  if spec is None else
                  "Resuming pod ingest from round 1/3.")
        assert resume in rec["stdout"], rec["stdout"]
        want_file = ("gramian_sharded_snapshot.npz" if sharded
                     else "gramian_snapshot.npz")
        assert rec["files"] == [want_file]
        assert rec["tiled"] is bool(sharded)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_jax_loaders_read_the_ports_snapshots(case, pod):
    work, _ = pod
    spec, sharded, (n, _, _), _ = CASES[case]
    for rank in range(2):
        directory = str(work / case / f"host-{rank}")
        digest = _jax_digest(case, rank)
        if not sharded:
            ck = jax_checkpoint.load_snapshot(directory, digest, n)
            # A pod's cursor counts rounds, a data-parallel rank's shards.
            assert ck is not None
            assert ck.shards_done == (3 if spec else 3 - rank)
            continue
        loaded = jax_checkpoint.load_sharded_snapshot(directory, digest, n)
        assert loaded is not None and loaded[0] == 3
        # The tile set is the one the JAX package's P(data, model)
        # sharding gives this process (rank r holds mesh row r of the
        # rank-by-rank device grid).
        shape = [int(p.split(":")[1]) for p in spec.split(",")]
        mesh = jax_make_mesh(spec, devices=jax.devices()[:np.prod(shape)])
        sharding = NamedSharding(mesh, PartitionSpec("data", "model"))
        per_rank = mesh.devices.size // 2
        mine = set(mesh.devices.flat[rank * per_rank:(rank + 1) * per_rank])
        want = {
            jax_checkpoint.index_key(idx, (n, n))
            for dev, idx in sharding.devices_indices_map((n, n)).items()
            if dev in mine
        }
        assert set(loaded[1]) == want
        g = _plain(CASES[case][2])
        for key, tile in loaded[1].items():
            (r0, r1), (c0, c1) = key
            np.testing.assert_array_equal(tile, g[r0:r1, c0:c1])


def test_disagreeing_rounds_are_discarded_with_the_jax_warning(pod):
    work, reports = pod
    np.testing.assert_array_equal(np.load(work / "disagree.npy"),
                                  _plain(CASES["replicated"][2]))
    for rank, report in enumerate(reports):
        rec = report["disagree"]
        assert ("WARNING: pod snapshot rounds disagree across hosts "
                "([0, 3]); discarding and re-ingesting from round 0."
                in rec["stderr"])
        assert rec["partitions"] == 3 - rank  # the whole slice again


@pytest.mark.parametrize("spec", ["data:2,model:4", "data:2,model:2",
                                  "data:4"])
@pytest.mark.parametrize("n", [5, 10, 12, 24])
def test_the_jax_tiles_are_the_jax_shardings_tiles(spec, n):
    """One process: a G laid out on the port's grid, re-tiled to the JAX
    package's ``P(data, model)`` bounds and back, bit for bit. Where an
    axis does not divide n the JAX sharding refuses the shape, and the
    split is ceil(n / parts) wide."""
    g = np.random.default_rng(n).random((n, n)).astype(np.float32)
    mesh = make_mesh(spec, device="cpu")
    grid = ShardedGramian.from_full(g, mesh)
    tiles = grid.jax_tiles()
    shape = [int(p.split(":")[1]) for p in spec.split(",")]
    jax_mesh = jax_make_mesh(spec, devices=jax.devices()[:np.prod(shape)])
    axes = ("data", "model") if "model" in spec else ("data", None)
    sharding = NamedSharding(jax_mesh, PartitionSpec(*axes))
    rows, cols = jax_tile_splits(n, mesh)
    got = set()
    for (i, j), tile in np.ndenumerate(tiles):
        got.add(((rows[i].start, rows[i].stop), (cols[j].start, cols[j].stop)))
        np.testing.assert_array_equal(tile.numpy(), g[rows[i], cols[j]])
    if all(n % parts == 0 for parts in shape):
        assert got == {
            jax_checkpoint.index_key(idx, (n, n))
            for idx in sharding.devices_indices_map((n, n)).values()}
    else:
        with pytest.raises(ValueError, match="evenly divide"):
            sharding.devices_indices_map((n, n))
        size = [-(-n // parts) for parts in shape] + [n]
        assert got == {((min(i * size[0], n), min((i + 1) * size[0], n)),
                        (min(j * size[1], n), min((j + 1) * size[1], n)))
                       for i, j in np.ndindex(*tiles.shape)}
    back = ShardedGramian.from_jax_tiles(tiles, n, mesh)
    np.testing.assert_array_equal(back.full().numpy(), g)
    for (i, j), tile in back.local_tiles():
        r0, c0 = back.tile_origin(i, j)
        # The port's pad rows and columns stay zero.
        assert not tile[max(0, n - r0):].any()
        assert not tile[:, max(0, n - c0):].any()
