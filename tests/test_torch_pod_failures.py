"""A pod's failures raise on every rank together, at the same slot.

Two gloo ranks (spawned as ``tests/test_torch_multihost.py`` spawns them,
a free port, a hard timeout) run every failure case back to back on one
process group and one socket mesh: a synchronized failure leaves the
pipes clean for the next stream, as in the JAX package's chaos suite.
Each case counts the steps each rank completed before its raise; every
rank raises the JAX package's text at the same step:

- a one-sided producer error, mid-stream and while peeking the first
  block (``tests/test_multihost.py:1018``); the failing rank chains its
  own exception, its peer none;
- block width, row-count and dtype mismatches (``_synced_block_stream``);
- in the sparse carrier stream, a producer error, a payload that fails to
  build after the header, a route divergence in the same step, and a
  payload dtype divergence (a version-skewed rank);
- the collective check, switched on by the port's own variable
  ``SPARK_EXAMPLES_TPU_TORCH_COLLECTIVE_CHECK``: a clean run counts every
  live step as agree with G unchanged, a digest divergence raises at the
  same step everywhere (``tests/test_sparse_gramian.py:1239``), and a
  pod where one rank has it off runs unchecked;
- the sync counters count each outcome under the JAX labels.
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

from spark_examples_tpu.utils import collectivecheck as jax_check
from spark_examples_tpu_torch.utils import collectivecheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 13


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


_WORKER = textwrap.dedent(
    """
    import json, os, re, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.arrays.blocks import windows_from_calls
    from spark_examples_tpu_torch.parallel import (
        distributed, make_mesh, sharded)
    from spark_examples_tpu_torch.utils import collectivecheck

    assert distributed.initialize_from_env("cpu")
    pid, world = distributed.process_index(), distributed.process_count()
    N = 13
    rng = np.random.default_rng(0)
    x = (rng.random((N, 128)) < 0.5).astype(np.int8)
    rare = np.zeros((N, 128), np.int8)
    for v in range(128):
        rare[rng.choice(N, size=2, replace=False), v] = 1

    def blocks(a, width=32):
        return [a[:, i:i + width] for i in range(0, a.shape[1], width)]

    def windows(a, width=16):
        calls = [np.nonzero(a[:, v])[0] for v in range(a.shape[1])]
        return list(windows_from_calls(iter(calls), width))

    def carrier(wins, threshold=2.0, depth=2, coalesce=0):
        return sharded._synced_carrier_stream(
            iter(wins), N, N, threshold, 16, 2, pipeline_depth=depth,
            coalesce_variants=coalesce)

    def run(make):
        done = []
        try:
            for item in make():
                done.append(item)
        except Exception as e:
            cause = e.__cause__
            return {"done": len(done), "type": type(e).__name__,
                    "msg": str(e),
                    "cause": type(cause).__name__ if cause else None}
        return {"done": len(done), "type": None, "msg": None, "cause": None}

    def fails_at(items, k, exc):
        for i, item in enumerate(items):
            if i == k:
                raise exc
            yield item

    out = {}
    mine = blocks(x)[pid::world]

    # Block streams -----------------------------------------------------
    bad = [b.copy() for b in mine]
    if pid == 0:
        bad[1][0, 0] = 2  # not a 0/1 indicator: the pack refuses it
    out["block-producer"] = run(lambda: sharded._pod_blocks(
        iter(bad), N, N, packed=True, prepacked=False)[1])

    def first_fails():
        if pid == 0:
            raise OSError("first-block ingest failure")
        yield from mine
    try:
        sharded.gramian_blockwise_global(first_fails(), N, make_mesh(
            "data:2", device="cpu"), packed=False)
        out["block-first-peek"] = {"done": 0, "type": None}
    except RuntimeError as e:
        out["block-first-peek"] = {
            "done": 0, "type": type(e).__name__, "msg": str(e),
            "cause": type(e.__cause__).__name__ if e.__cause__ else None}

    width = [b[:, :16] for b in mine] if pid == 1 else mine
    out["block-width"] = run(lambda: sharded._pod_blocks(
        iter(width), N, N, packed=False, prepacked=False)[1])
    rows = [b[:-1] for b in mine] if pid == 1 else mine
    out["block-rows"] = run(lambda: sharded._pod_blocks(
        iter(rows), N, N, packed=False, prepacked=False)[1])
    drift = list(mine)
    if pid == 1:
        drift[1] = drift[1].astype(np.float32)
    out["block-dtype-midstream"] = run(lambda: sharded._pod_blocks(
        iter(drift), N, N, packed=False, prepacked=False)[1])
    first = [b.astype(np.float32) for b in mine] if pid == 1 else mine
    out["block-dtype-first"] = run(lambda: sharded._pod_blocks(
        iter(first), N, N, packed=False, prepacked=False)[1])

    # Carrier streams ---------------------------------------------------
    wins = windows(rare)[pid::world]
    out["carrier-producer"] = run(lambda: carrier(fails_at(
        wins, 2 if pid == 0 else 99, OSError("shard read failed"))))
    real_pcm = sharded.padded_carrier_matrix
    calls = {"n": 0}

    def failing_pcm(*a, **k):
        calls["n"] += 1
        if pid == 0 and calls["n"] == 2:
            raise MemoryError("carrier matrix")
        return real_pcm(*a, **k)
    sharded.padded_carrier_matrix = failing_pcm
    try:
        out["carrier-payload"] = run(lambda: carrier(wins))
    finally:
        sharded.padded_carrier_matrix = real_pcm
    out["carrier-route"] = run(lambda: carrier(
        windows(x)[pid::world], threshold=2.0 if pid == 0 else 0.0))
    # A version-skewed rank that derives another payload dtype for the
    # same route.
    real_dtypes = dict(sharded._PAYLOAD_DTYPES)
    if pid == 1:
        sharded._PAYLOAD_DTYPES["scatter"] = np.dtype(np.int64)
    try:
        out["carrier-dtype"] = run(lambda: carrier(wins))
    finally:
        sharded._PAYLOAD_DTYPES.update(real_dtypes)

    # The collective check ----------------------------------------------
    reg = obs.get_registry()
    checks = reg.counter(
        "collective_check_steps_total",
        "Pod protocol steps cross-checked by the collective-congruence "
        "runtime backstop, by outcome")
    mesh = make_mesh("data:2,model:2", device="cpu")
    os.environ[collectivecheck.COLLECTIVE_CHECK_ENV] = "1"
    before = checks.labels(outcome="agree").value
    g = sharded.sparse_sharded_gramian_blockwise(
        iter(wins), N, mesh, density_threshold=2.0, pipeline_depth=2,
        coalesce_variants=0).full()
    out["check-clean"] = {
        "agree": checks.labels(outcome="agree").value - before,
        "g": g.numpy().tolist()}
    real_digest = collectivecheck.step_digest

    def faulty(stream, step, ops):
        if pid == 0 and step == 1:
            ops = list(ops) + [("all_gather", (9,))]
        return real_digest(stream, step, ops)
    collectivecheck.step_digest = faulty
    try:
        out["check-divergence"] = run(lambda: carrier(wins))
    finally:
        collectivecheck.step_digest = real_digest
    out["check-divergence"]["divergence"] = checks.labels(
        outcome="divergence").value
    if pid == 1:
        del os.environ[collectivecheck.COLLECTIVE_CHECK_ENV]
    before = checks.labels(outcome="agree").value
    g = sharded.sparse_sharded_gramian_blockwise(
        iter(wins), N, mesh, density_threshold=2.0).full()
    out["check-mixed"] = {
        "agree": checks.labels(outcome="agree").value - before,
        "g": g.numpy().tolist()}
    os.environ.pop(collectivecheck.COLLECTIVE_CHECK_ENV, None)

    sync = reg.counter(
        "sparse_pod_sync_total",
        "Pod-sparse per-window sync steps (header + carrier allgather) "
        "by outcome")
    out["sync"] = {k: sync.labels(outcome=k).value for k in (
        "synced", "drained", "producer-error", "route-divergence",
        "dtype-divergence")}
    gang = reg.counter(
        "sparse_pod_coalesced_windows_total",
        "Local CSR windows entering pod-sparse protocol steps, by "
        "gang/solo coalescing outcome")
    out["gang"] = {k: gang.labels(mode=k).value for k in ("gang", "solo")}
    out["windows"] = len(wins)
    with open(os.path.join(sys.argv[1], f"rank{pid}.json"), "w") as f:
        json.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    work = tmp_path_factory.mktemp("failures")
    script = work / "worker.py"
    script.write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": ROOT, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    env.pop(collectivecheck.COLLECTIVE_CHECK_ENV, None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(work)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads((work / f"rank{r}.json").read_text()) for r in (0, 1)]


# case → (steps completed before the raise, error type, message, the
# failing rank or None when every rank raises from gathered data alone).
CASES = {
    "block-producer": (
        1, "RuntimeError",
        "block stream failed on process(es) [0]; raising on every process "
        "together (a one-sided raise would strand peers in the next "
        "collective)", 0),
    "block-first-peek": (
        0, "RuntimeError",
        "block stream failed on process(es) [0] while peeking the first "
        "block; raising on every process together (a one-sided raise "
        "would strand peers in the collective)", 0),
    "block-width": (
        0, "ValueError",
        "block widths differ across processes in the same step: [16, 32]; "
        "every host must stream fixed-width blocks (blocks_from_calls "
        "pads) with the same --block-variants", None),
    "block-rows": (
        0, "ValueError",
        "block row counts [12] differ from the padded sample count 13; "
        "every host must stream blocks over the full (padded) sample axis",
        None),
    "block-dtype-midstream": (
        1, "ValueError",
        "block dtype diverged mid-stream: got ['float32'] where the stream "
        "was resolved as int8; every host must stream one dtype for the "
        "whole accumulation", None),
    "block-dtype-first": (
        0, "ValueError",
        "block dtypes differ across processes: ['int8', 'float32']; every "
        "host must stream the same block dtype", None),
    "carrier-producer": (
        2, "RuntimeError",
        "carrier stream failed on process(es) [0]; raising on every "
        "process together (a one-sided raise would strand peers in the "
        "next collective)", 0),
    "carrier-payload": (
        1, "RuntimeError",
        "carrier payload construction failed on process(es) [0]; raising "
        "on every process together (a one-sided raise would strand peers "
        "in the payload collective)", 0),
    "carrier-route": (
        0, "ValueError",
        "sparse pod streams disagree on the density route for the same "
        "step: {0: 'scatter', 1: 'dense'}; the route is a per-window "
        "GLOBAL decision (both routes are collective programs) — pin "
        "--sparse-density-threshold to one side for heterogeneous "
        "cohorts", None),
    "carrier-dtype": (
        0, "ValueError",
        "sparse pod payload dtypes diverged in the same step: ['int32', "
        "'int64']; every host must stream one payload dtype (the dtype "
        "derives from the agreed route — divergence means a "
        "version-skewed pod)", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_raises_together_at_the_same_step(case, pod):
    done, kind, msg, culprit = CASES[case]
    for rank, report in enumerate(pod):
        got = report[case]
        assert got["type"] == kind, got
        assert got["msg"] == msg
        assert got["done"] == done
        if culprit is not None:
            # The failing rank chains its own exception; its peer none.
            assert (got["cause"] is not None) == (rank == culprit), got


def _meshless_rare_g():
    rng = np.random.default_rng(0)
    rng.random((N, 128))
    rare = np.zeros((N, 128), np.int64)
    for v in range(128):
        rare[rng.choice(N, size=2, replace=False), v] = 1
    return (rare @ rare.T).astype(np.float32)


def test_a_checked_clean_run_agrees_at_every_step(pod):
    want = _meshless_rare_g()
    for report in pod:
        got = report["check-clean"]
        np.testing.assert_array_equal(np.array(got["g"], np.float32), want)
        # Solo steps of 16-variant windows: one agreed check per window.
        assert got["agree"] == report["windows"]


def test_a_digest_divergence_raises_at_the_same_step(pod):
    for report in pod:
        got = report["check-divergence"]
        assert got["type"] == "RuntimeError"
        assert got["msg"].startswith(
            "collective-congruence check failed at protocol step 1: "
            "per-process (op, geometry) digests diverged")
        assert got["done"] == 1
        assert got["divergence"] == 1


def test_a_mixed_pod_runs_unchecked(pod):
    want = _meshless_rare_g()
    for report in pod:
        got = report["check-mixed"]
        assert got["agree"] == 0
        np.testing.assert_array_equal(np.array(got["g"], np.float32), want)


def test_the_sync_counters_use_the_jax_labels(pod):
    for report in pod:
        sync = report["sync"]
        # Three failed carrier streams: two producer errors (the header's
        # −2 and the payload confirm's) and one route divergence.
        assert sync["producer-error"] == 2
        assert sync["route-divergence"] == 1
        assert sync["dtype-divergence"] == 1
        # Two clean runs of the pod's windows drained once each.
        assert sync["drained"] == 2
        assert sync["synced"] >= 2 * report["windows"]
        assert report["gang"]["solo"] > 0


@pytest.mark.parametrize(
    "ops",
    [[("header", (2, 7)), ("scatter", (256, 8, 2, 16, 5))],
     [("header", (4, 7)), ("dense", (64, 8, 4, 2504, 2))], []],
)
def test_the_digest_is_the_jax_digest(ops):
    assert collectivecheck.step_digest(3, 5, ops) == jax_check.step_digest(
        3, 5, ops)


def test_the_port_reads_its_own_variable(monkeypatch):
    assert collectivecheck.COLLECTIVE_CHECK_ENV == (
        "SPARK_EXAMPLES_TPU_TORCH_COLLECTIVE_CHECK")
    monkeypatch.setenv("SPARK_EXAMPLES_TPU_COLLECTIVE_CHECK", "1")
    monkeypatch.delenv(collectivecheck.COLLECTIVE_CHECK_ENV, raising=False)
    assert not collectivecheck.collective_check_enabled()
    monkeypatch.setenv(collectivecheck.COLLECTIVE_CHECK_ENV, "1")
    assert collectivecheck.collective_check_enabled()
    monkeypatch.setenv(collectivecheck.COLLECTIVE_CHECK_ENV, "0")
    assert not collectivecheck.collective_check_enabled()


@pytest.mark.parametrize(
    "flag,field,value",
    [("--pod-pipeline-depth", "pod_pipeline_depth", "-1"),
     ("--pod-coalesce-variants", "pod_coalesce_variants", "-3")],
)
def test_the_pod_flags_parse_and_validate_as_the_jax_cli(flag, field,
                                                         value):
    """The flags exist with the JAX CLI's names and defaults, and a
    negative value raises the JAX driver's text before any ingest."""
    import argparse

    from spark_examples_tpu.genomics.fixtures import (
        synthetic_cohort as jax_cohort,
    )
    from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
    from spark_examples_tpu.utils.config import (
        PcaConfig as JaxConfig,
        add_pca_flags as jax_flags,
    )
    from spark_examples_tpu_torch.genomics.fixtures import synthetic_cohort
    from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
    from spark_examples_tpu_torch.utils.config import (
        PcaConfig,
        add_pca_flags,
        pca_config_from_args,
    )

    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_pca_flags(ours)
    jax_flags(theirs)
    assert getattr(ours.parse_args([]), field) == getattr(
        theirs.parse_args([]), field) == getattr(PcaConfig, field)
    conf = pca_config_from_args(ours.parse_args([flag, value]))
    assert getattr(conf, field) == int(value)
    with pytest.raises(ValueError) as port:
        VariantsPcaDriver(conf, synthetic_cohort(4, 8))
    with pytest.raises(ValueError) as jax_err:
        JaxDriver(JaxConfig(**{field: int(value)}), jax_cohort(4, 8))
    assert str(port.value) == str(jax_err.value)
