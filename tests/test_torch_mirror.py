"""The port's cohort mirror and cold-stream tier against the JAX package's.

A remote cohort behind either package's HTTP or gRPC server is mirrored
into ``--cache-dir`` by the port's clients (``genomics/mirror.py``):

- durability: every mirror file commits tmp → fsync → atomic rename (the
  ``mirror.write`` torn seam proves a kill -9 mid-write never lands a torn
  file at a committed name), a restarted cold run reuses a killed run's
  staging, the populate lock spares live peers (pid@host owners) and
  reaps dead ones, a stale staging of another identity is discarded;
- the cold-stream tier: with an empty cache the source streams wire frames
  at once while the mirror downloads write-through in the background; a
  resident source flips to the mirror at the run boundary;
  ``--no-cold-stream`` is phased; G is bit-identical across cold-stream vs
  phased, worker counts and arrival orders, and over a warm full or light
  mirror, in every ``--pca-mode``, to ``--input-path``;
- one cache directory shared by both packages: a mirror written by either
  package is served warm by the other with no export request;
- the light-mirror ``FileNotFoundError`` messages, the JAX package's;
- the ``cold_stream_shards_total{stage}`` counter's name and labels, and
  the fetch/accumulate overlap on a slowed cohort.

Every background writer is joined with a timeout, every server and channel
is closed by a finalizer.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from spark_examples_tpu import obs as jax_obs
from spark_examples_tpu.genomics import grpc_transport as jax_grpc
from spark_examples_tpu.genomics import service as jax_service
from spark_examples_tpu.genomics.mirror import (
    ColdStreamMirror as JaxColdStreamMirror,
)
from spark_examples_tpu.genomics.sources import (
    JsonlSource as JaxJsonlSource,
)
from spark_examples_tpu.genomics.sources import _CsrCohort as _JaxCsrCohort
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics import grpc_transport, mirror
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
    synthetic_reads,
)
from spark_examples_tpu_torch.genomics.mirror import (
    ColdStreamMirror,
    refresh_cold_stream,
)
from spark_examples_tpu_torch.genomics.service import (
    GenomicsServiceServer,
    HttpVariantSource,
)
from spark_examples_tpu_torch.genomics.shards import shards_for_references
from spark_examples_tpu_torch.genomics.sources import (
    MIRROR_COMPLETE_MARKER,
    SIDECAR_BASENAME,
    JsonlSource,
    _CsrCohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.resilience import (
    FaultPlan,
    FaultRule,
    RetryPolicy,
    faults,
)
from spark_examples_tpu_torch.utils.config import PcaConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = "17:41196311:41277499"
VSID = DEFAULT_VARIANT_SET_ID
BASES = 15_000
FAST = dict(max_attempts=3, base_delay=0.0, jitter=0.0)
JOIN_S = 60
MODES = ("sparse", "auto", "fused", "stream", "sketch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mirrored") / "cohort")
    synthetic_cohort(50, 400, references=REFS, seed=21,
                     population_structure=3).dump(root)
    JsonlSource(root).ensure_serving_index()  # sidecar + line index warm
    return root


def _serve_http(source, request, cls=GenomicsServiceServer):
    server = cls(source).start()
    request.addfinalizer(server.stop)
    return f"http://127.0.0.1:{server.port}"


def _serve_grpc(source, request, cls=grpc_transport.GrpcGenomicsServer):
    server = cls(source, port=0).start()
    request.addfinalizer(server.stop)
    return f"grpc://127.0.0.1:{server.port}"


@pytest.fixture()
def served(cohort_dir, request):
    return cohort_dir, _serve_http(JsonlSource(cohort_dir), request)


def _http(url, **kw):
    return HttpVariantSource(url, timeout=30,
                             retry_policy=RetryPolicy(**FAST), **kw)


@contextlib.contextmanager
def _source(transport, url, **kw):
    """A port client that is closed (and whose write-through writer is
    joined) on exit."""
    if transport == "http":
        src = _http(url, **kw)
    else:
        src = grpc_transport.GrpcVariantSource(
            url, timeout=30, idle_timeout=30.0,
            retry_policy=RetryPolicy(**FAST), **kw)
    try:
        yield src
    finally:
        _join_writer(src)
        if transport == "grpc":
            src.close()


def _join_writer(src):
    resolved = getattr(src, "_mirror", None)
    if isinstance(resolved, (ColdStreamMirror, JaxColdStreamMirror)):
        assert resolved.join(timeout=JOIN_S), "the mirror writer lives on"


def _conf(**overrides):
    overrides.setdefault("ingest_workers", 2)
    return dict(references=REFS, variant_set_ids=[VSID],
                bases_per_partition=BASES, block_variants=64, **overrides)


def _gramian(source, **overrides):
    drv = VariantsPcaDriver(PcaConfig(device="cpu", **_conf(**overrides)),
                            source)
    return drv.get_similarity_matrix_csr(drv.get_csr_fused()).numpy()


def _staging_dir(cache):
    entries = [e for e in os.listdir(cache)
               if e.startswith(".staging-cohort-")]
    assert len(entries) <= 1, entries
    return os.path.join(cache, entries[0]) if entries else None


def _mirror_root(cache):
    entries = [e for e in os.listdir(cache) if e.startswith("cohort-")]
    return os.path.join(cache, entries[0]) if entries else None


def _indexes(root):
    return {c.id: i for i, c in enumerate(JsonlSource(root).list_callsets(
        VSID))}


def _ids(src):
    return [c.id for c in src.list_callsets(VSID)]


# -- durability ---------------------------------------------------------------


def test_torn_write_never_lands_and_restart_heals(served, tmp_path):
    root, url = served
    cache = str(tmp_path / "cache")
    plan = FaultPlan(seed=1, rules=[FaultRule(
        site="mirror.write", kind="torn", match="variants.jsonl")])
    with faults.active_plan(plan), pytest.raises(IOError):
        _http(url, cache_dir=cache, cold_stream=False).list_callsets(VSID)
    assert plan.fired_total == 1
    # The torn write landed nowhere a reader trusts: no completed mirror,
    # no committed variants.jsonl — only a *.tmp-* partial in staging.
    assert _mirror_root(cache) is None
    staging = _staging_dir(cache)
    assert not os.path.exists(os.path.join(staging, "variants.jsonl"))
    assert any(".tmp-" in e for e in os.listdir(staging))
    assert os.path.exists(os.path.join(staging, "callsets.json"))
    # Restart (same cache, no plan): byte-identical to a clean download.
    _http(url, cache_dir=cache, cold_stream=False).list_callsets(VSID)
    healed = _mirror_root(cache)
    assert os.path.exists(os.path.join(healed, MIRROR_COMPLETE_MARKER))
    clean_cache = str(tmp_path / "clean")
    _http(url, cache_dir=clean_cache, cold_stream=False).list_callsets(VSID)
    clean = _mirror_root(clean_cache)
    for name in ("callsets.json", "variants.jsonl", SIDECAR_BASENAME,
                 ".identity", ".sidecar-ok", MIRROR_COMPLETE_MARKER):
        with open(os.path.join(healed, name), "rb") as a, open(
                os.path.join(clean, name), "rb") as b:
            assert a.read() == b.read(), name


class _CountingExports:
    """A served source that counts its export requests."""

    def __init__(self, inner):
        self._inner = inner
        self.exports = {}
        self.sidecars = 0
        self.frames = 0
        self.reads = 0

    def export_lines(self, name):
        self.exports[name] = self.exports.get(name, 0) + 1
        return self._inner.export_lines(name)

    def ensure_sidecar(self):
        self.sidecars += 1
        return self._inner.ensure_sidecar()

    def stream_carrying_frame(self, *args, **kwargs):
        self.frames += 1
        return self._inner.stream_carrying_frame(*args, **kwargs)

    def stream_reads(self, *args, **kwargs):
        self.reads += 1
        return self._inner.stream_reads(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_restart_reuses_partial_mirror(cohort_dir, tmp_path, request):
    counting = _CountingExports(JsonlSource(cohort_dir))
    url = _serve_http(counting, request)
    cache = str(tmp_path / "cache")
    # Run 1 dies mid-download: callsets.json commits, then the
    # variants.jsonl write errors (a worker death / kill).
    plan = FaultPlan(seed=1, rules=[FaultRule(
        site="mirror.write", kind="error", match="variants.jsonl")])
    with faults.active_plan(plan), pytest.raises(IOError):
        _http(url, cache_dir=cache, cold_stream=False).list_callsets(VSID)
    assert counting.exports.get("callsets.json") == 1
    # Run 2 reuses the staged callsets.json; only the missing files are
    # fetched.
    got = _ids(_http(url, cache_dir=cache, cold_stream=False))
    assert counting.exports.get("callsets.json") == 1
    assert counting.exports.get("variants.jsonl") == 2
    assert os.path.exists(os.path.join(_mirror_root(cache),
                                       MIRROR_COMPLETE_MARKER))
    assert got == _ids(JsonlSource(cohort_dir))


def test_concurrent_populate_never_touches_live_peers_staging(
        served, tmp_path):
    root, url = served
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    ident = JsonlSource(root).cohort_identity()
    lock = os.path.join(cache, f".lock-cohort-{ident}-full")
    with open(lock, "w") as f:
        f.write(str(os.getpid()))  # a LIVE peer holds the lock
    shared = os.path.join(cache, f".staging-cohort-{ident}-full")
    os.makedirs(shared)
    peer_tmp = os.path.join(shared, f"variants.jsonl.tmp-{os.getpid()}")
    with open(peer_tmp, "w") as f:
        f.write("peer in-flight bytes")
    got = _ids(_http(url, cache_dir=cache, cold_stream=False))
    assert got == _ids(JsonlSource(root))  # via the isolated path
    assert os.path.exists(os.path.join(_mirror_root(cache),
                                       MIRROR_COMPLETE_MARKER))
    assert os.path.exists(peer_tmp) and os.path.exists(lock)


@pytest.mark.parametrize("owner", ["999999999", "999999999@some.other.host"],
                         ids=["dead-local", "foreign-host"])
def test_prune_reaps_dead_owners_and_spares_live_and_foreign_ones(
        served, tmp_path, owner):
    root, url = served
    cache = str(tmp_path / "cache")
    os.makedirs(cache)

    def staging(name, content):
        path = os.path.join(cache, f".staging-cohort-{name}-full")
        os.makedirs(path)
        with open(os.path.join(cache, f".lock-cohort-{name}-full"),
                  "w") as f:
            f.write(content)
        return path

    live = staging("otherlive", f"{os.getpid()}@{mirror._host_token()}")
    other = staging("other", owner)
    assert _ids(_http(url, cache_dir=cache, cold_stream=False))
    assert os.path.isdir(live)  # a live peer is never touched
    # A dead local owner's staging is reaped; a foreign host's pid cannot
    # be probed from here, so its staging is spared.
    assert os.path.isdir(other) == ("@" in owner)


def test_prune_spares_peer_mid_acquisition_before_pid_lands(served,
                                                            tmp_path):
    import fcntl

    _, url = served
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    staging = os.path.join(cache, ".staging-cohort-acquiring-full")
    os.makedirs(staging)
    lock = os.path.join(cache, ".lock-cohort-acquiring-full")
    fd = os.open(lock, os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    try:  # pid NOT yet written: content is empty, flock is held
        assert _ids(_http(url, cache_dir=cache, cold_stream=False))
        assert os.path.isdir(staging) and os.path.exists(lock)
    finally:
        os.close(fd)


@pytest.mark.parametrize("owner", ["999999999", "999999999@some.other.host"],
                         ids=["dead-local", "foreign-host"])
def test_own_identity_lock_is_broken_only_for_a_dead_local_owner(
        served, tmp_path, owner):
    root, url = served
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    ident = JsonlSource(root).cohort_identity()
    lock = os.path.join(cache, f".lock-cohort-{ident}-full")
    with open(lock, "w") as f:
        f.write(owner)
    shared = os.path.join(cache, f".staging-cohort-{ident}-full")
    os.makedirs(shared)
    probe = os.path.join(shared, "foreign-in-flight")
    with open(probe, "w") as f:
        f.write("peer bytes")
    assert _ids(_http(url, cache_dir=cache, cold_stream=False)) == _ids(
        JsonlSource(root))
    assert os.path.exists(os.path.join(_mirror_root(cache),
                                       MIRROR_COMPLETE_MARKER))
    foreign = "@" in owner
    # A dead local holder's lock is broken, its staging reused and
    # released; a foreign host's populate routes this one to the isolated
    # one-shot path and keeps its files.
    assert os.path.exists(lock) == foreign
    assert os.path.exists(probe) == foreign


def test_owner_tokens_are_the_jax_packages():
    from spark_examples_tpu.genomics import mirror as jax_mirror

    assert mirror._owner_token() == jax_mirror._owner_token()
    for token in ("12@h.x", "12", "", "x@y", "7@a@b"):
        assert mirror._parse_owner(token) == jax_mirror._parse_owner(token)
    for entry in (".once-12@h-abc", ".once-12-abc", ".once-x-y"):
        assert mirror._entry_owner(entry, ".once-") == (
            jax_mirror._entry_owner(entry, ".once-"))


def test_failed_upgrade_leaves_no_partials_in_mirror_root(served, tmp_path):
    root, url = served
    cache = str(tmp_path / "cache")
    assert _ids(_http(url, cache_dir=cache, mirror_mode="light",
                      cold_stream=False))
    mirror_root = _mirror_root(cache)
    plan = FaultPlan(seed=1, rules=[FaultRule(
        site="mirror.write", kind="torn", match="variants.jsonl")])
    full = _http(url, cache_dir=cache, mirror_mode="full",
                 cold_stream=False)
    shard = shards_for_references(REFS, 20_000)[0]
    with faults.active_plan(plan), pytest.raises(IOError):
        list(full.stream_variants(VSID, shard))
    assert plan.fired_total == 1
    assert [e for e in os.listdir(mirror_root)
            if e.startswith(".partial-") or ".tmp-" in e] == []
    # The upgrade gate re-fires: a fresh full-mode consumer completes it.
    full2 = _http(url, cache_dir=cache, mirror_mode="full",
                  cold_stream=False)
    assert list(full2.stream_variants(VSID, shard)) == list(
        JsonlSource(root).stream_variants(VSID, shard))
    assert os.path.exists(os.path.join(mirror_root, "variants.jsonl"))


def test_tolerated_sidecar_failure_publishes_no_tmp(served, tmp_path):
    root, url = served
    cache = str(tmp_path / "cache")
    plan = FaultPlan(seed=1, rules=[FaultRule(
        site="mirror.write", kind="torn", match=SIDECAR_BASENAME)])
    with faults.active_plan(plan):
        got = _ids(_http(url, cache_dir=cache, cold_stream=False))
    assert plan.fired_total == 1
    assert got == _ids(JsonlSource(root))
    mirror_root = _mirror_root(cache)
    assert os.path.exists(os.path.join(mirror_root, MIRROR_COMPLETE_MARKER))
    assert not os.path.exists(os.path.join(mirror_root, SIDECAR_BASENAME))
    assert [e for e in os.listdir(mirror_root) if ".tmp-" in e] == []


def test_probe_resolve_failure_defers_to_the_first_fetch():
    class _FlakySource:
        _cold_stream = True
        _mirror = None
        _mirror_lock = threading.Lock()

        def _resolve_mirror(self):
            raise IOError("transient: identity fetch failed")

    assert refresh_cold_stream(_FlakySource()) is False


def test_stale_staging_for_other_identity_discarded(served, tmp_path):
    root, url = served
    cache = str(tmp_path / "cache")
    ident = JsonlSource(root).cohort_identity()
    staging = os.path.join(cache, f".staging-cohort-{ident}-full")
    os.makedirs(staging)
    with open(os.path.join(staging, ".identity"), "w") as f:
        f.write("some-older-cohort")
    with open(os.path.join(staging, "callsets.json"), "w") as f:
        f.write("[]")  # poison: would break list_callsets if reused
    got = _ids(_http(url, cache_dir=cache, cold_stream=False))
    assert got == _ids(JsonlSource(root))


def test_corrupt_staged_sidecar_is_refetched(served, tmp_path):
    """A staged npz without its ``.sidecar-ok`` marker (a crash between
    the two commits) is never trusted: the restart fetches it again."""
    root, url = served
    cache = str(tmp_path / "cache")
    ident = JsonlSource(root).cohort_identity()
    staging = os.path.join(cache, f".staging-cohort-{ident}-light")
    os.makedirs(staging)
    with open(os.path.join(staging, ".identity"), "w") as f:
        f.write(ident)
    with open(os.path.join(staging, SIDECAR_BASENAME), "wb") as f:
        f.write(b"not an npz")
    src = _http(url, cache_dir=cache, mirror_mode="light",
                cold_stream=False)
    indexes = _indexes(root)
    shard = shards_for_references(REFS, BASES)[0]
    got = src.stream_carrying_csr(VSID, shard, indexes)
    want = JsonlSource(root).stream_carrying_csr(VSID, shard, indexes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -- the cold-stream tier -----------------------------------------------------


@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_cold_stream_serves_wire_and_writes_through(cohort_dir, tmp_path,
                                                    request, transport):
    counting = _CountingExports(JsonlSource(cohort_dir))
    serve = _serve_http if transport == "http" else _serve_grpc
    url = serve(counting, request)
    cache = str(tmp_path / "cache")
    local = JsonlSource(cohort_dir)
    indexes = _indexes(cohort_dir)
    shards = shards_for_references(REFS, BASES)
    with _source(transport, url, cache_dir=cache) as src:
        assert src.cold_stream_active() is True
        for shard in shards:
            want = local.stream_carrying_csr(VSID, shard, indexes)
            got = src.stream_carrying_csr(VSID, shard, indexes)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(want[0], got[0])
                np.testing.assert_array_equal(want[1], got[1])
        assert counting.frames == len(shards)
        resolved = src._resolve_mirror()
        assert isinstance(resolved, ColdStreamMirror) and not resolved
        assert resolved.join(timeout=JOIN_S)
    mirror_root = _mirror_root(cache)
    assert os.path.exists(os.path.join(mirror_root, MIRROR_COMPLETE_MARKER))
    # The next run is WARM: no frame, no export.
    exports = dict(counting.exports)
    with _source(transport, url, cache_dir=cache) as warm:
        assert warm.cold_stream_active() is False
        pair = warm.stream_carrying_csr(VSID, shards[0], indexes)
        want = local.stream_carrying_csr(VSID, shards[0], indexes)
        np.testing.assert_array_equal(want[0], pair[0])
        np.testing.assert_array_equal(want[1], pair[1])
    assert counting.frames == len(shards) and counting.exports == exports


def test_resident_source_upgrades_to_mirror_at_run_boundary(served,
                                                             tmp_path):
    root, url = served
    src = _http(url, cache_dir=str(tmp_path / "cache"))
    assert src.cold_stream_active() is True  # run 1: cold, wire
    resolved = src._resolve_mirror()
    assert isinstance(resolved, ColdStreamMirror)
    assert resolved.join(timeout=JOIN_S)
    # Run 2 on the SAME instance: the boundary consultation flips.
    assert src.cold_stream_active() is False
    assert isinstance(src._resolve_mirror(), JsonlSource)
    indexes = _indexes(root)
    shard = shards_for_references(REFS, BASES)[0]
    got = src.stream_carrying_csr(VSID, shard, indexes)
    want = JsonlSource(root).stream_carrying_csr(VSID, shard, indexes)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


def test_no_cold_stream_is_phased(served, tmp_path):
    _, url = served
    cache = str(tmp_path / "cache")
    src = _http(url, cache_dir=cache, cold_stream=False)
    # A pure probe with the flag off: no download here.
    assert src.cold_stream_active() is False
    assert not os.path.isdir(cache) or _mirror_root(cache) is None
    assert _ids(src)  # the first data call downloads the whole mirror
    assert os.path.exists(os.path.join(_mirror_root(cache),
                                       MIRROR_COMPLETE_MARKER))


def test_cold_stream_inactive_without_cache_dir(served):
    assert _http(served[1]).cold_stream_active() is False


def test_g_bit_identical_cold_vs_phased_across_workers(served, tmp_path):
    root, url = served
    g_local = _gramian(JsonlSource(root))
    with _source("http", url, cache_dir=str(tmp_path / "phased"),
                 cold_stream=False) as src:
        assert np.array_equal(g_local, _gramian(src))
    for workers in (1, 3):
        for order in ("manifest", "completion"):
            with _source("http", url,
                         cache_dir=str(tmp_path / f"c{workers}{order}")
                         ) as src:
                g = _gramian(src, ingest_workers=workers,
                             ingest_order=order)
            assert np.array_equal(g_local, g), (workers, order)


def _driver_g(driver):
    g = driver.g
    return (g.y, g.row_sums) if hasattr(g, "y") else (g.numpy(),)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", ["cold", "warm-full", "warm-light"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_g_over_the_mirror_is_bit_identical_to_input_path(
        cohort_dir, tmp_path, request, transport, tier, mode, capsys):
    serve = _serve_http if transport == "http" else _serve_grpc
    url = serve(JsonlSource(cohort_dir), request)
    kw = _conf(device="cpu", pca_mode=mode, sparse_density_threshold=0.6)
    if mode == "sketch":
        # The panel is a float32 sum, so its bits depend on the window
        # composition: a cold run holds it bit for bit in manifest order
        # (completion order: test_a_completion_ordered_cold_sketch_...).
        kw["ingest_order"] = "manifest"
    local = VariantsPcaDriver(PcaConfig(**kw), JsonlSource(cohort_dir))
    want = local.run()
    cache = str(tmp_path / "cache")
    mirror_mode = "light" if tier == "warm-light" else "full"
    if tier != "cold":  # one phased download first
        with _source(transport, url, cache_dir=cache,
                     mirror_mode=mirror_mode, cold_stream=False) as src:
            src.list_callsets(VSID)
    with _source(transport, url, cache_dir=cache,
                 mirror_mode=mirror_mode) as src:
        net = VariantsPcaDriver(PcaConfig(**kw), src)
        got = net.run()
        assert src.cold_stream_active() is (tier == "cold")
    err = capsys.readouterr().err
    # The line names the order auto resolved to; an explicit one prints
    # nothing.
    assert ("Cold-stream ingest" in err) == (
        tier == "cold" and "ingest_order" not in kw)
    for a, b in zip(_driver_g(net), _driver_g(local)):
        np.testing.assert_array_equal(a, b)
    assert got == want


PANEL_RTOL = 1e-5  # float32 sums of the same terms in another order


def test_a_completion_ordered_cold_sketch_panel_is_the_same_sum(
        served, tmp_path, capsys):
    """Under ``--ingest-order auto`` a cold run feeds shards in completion
    order (as the JAX driver does), so the sketch's float32 panel sums the
    same terms in another window composition: within ``PANEL_RTOL`` of the
    ``--input-path`` panel, its row sums exact."""
    root, url = served
    kw = _conf(device="cpu", pca_mode="sketch", ingest_workers=3)
    local = VariantsPcaDriver(PcaConfig(**kw), JsonlSource(root))
    local.run()
    with _source("http", url, cache_dir=str(tmp_path / "c")) as src:
        net = VariantsPcaDriver(PcaConfig(**kw), src)
        net.run()
    assert "Cold-stream ingest" in capsys.readouterr().err
    got, want = np.asarray(net.g.y), np.asarray(local.g.y)
    assert np.linalg.norm(got - want) <= PANEL_RTOL * np.linalg.norm(want)
    np.testing.assert_array_equal(net.g.row_sums, local.g.row_sums)


def test_cold_stream_counts_each_shard_fetched_and_accumulated(
        served, tmp_path):
    _, url = served
    trace = str(tmp_path / "run.trace.json")
    metrics = str(tmp_path / "run.metrics.prom")
    with obs.telemetry_session(trace_out=trace, metrics_out=metrics) as ses:
        with _source("http", url, cache_dir=str(tmp_path / "cache")) as src:
            assert _gramian(src).shape == (50, 50)
        counters = ses.registry.snapshot()["counters"]
    n_shards = len(shards_for_references(REFS, BASES))
    assert counters['cold_stream_shards_total{stage="fetched"}'] == n_shards
    assert counters[
        'cold_stream_shards_total{stage="accumulated"}'] == n_shards
    validate = _validator()
    assert validate.validate_trace(trace) == []
    assert validate.validate_metrics(metrics) == []


def _validator():
    spec = importlib.util.spec_from_file_location(
        "validate_trace", os.path.join(ROOT, "scripts", "validate_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cold_stream_counter_carries_the_jax_packages_name_and_labels(
        cohort_dir, tmp_path, request):
    def counters(pkg_obs, run):
        with pkg_obs.telemetry_session() as session, \
                contextlib.redirect_stdout(io.StringIO()):
            run()
            return {k: v for k, v in
                    session.registry.snapshot()["counters"].items()
                    if k.startswith("cold_stream")}

    url = _serve_http(JsonlSource(cohort_dir), request)

    def port_run():
        with _source("http", url, cache_dir=str(tmp_path / "p")) as src:
            _gramian(src)

    def jax_run():
        src = jax_service.HttpVariantSource(url,
                                            cache_dir=str(tmp_path / "j"))
        drv = JaxDriver(JaxConfig(**_conf()), src)
        drv.get_similarity_matrix_csr(drv.get_csr_fused())
        _join_writer(src)

    got, want = counters(obs, port_run), counters(jax_obs, jax_run)
    assert got and got == want


class _SlowFrames:
    """A served cohort whose frame requests each take 0.2 s (a fixed RTT
    per shard): the ingest pipeline then overlaps fetch and compute."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def stream_carrying_frame(self, *args, **kwargs):
        time.sleep(0.2)
        return self._inner.stream_carrying_frame(*args, **kwargs)


def test_cold_stream_overlaps_fetch_and_accumulate(cohort_dir, tmp_path,
                                                   request):
    """The first ``gramian.accumulate`` range begins before the last
    ``ingest.fetch`` range ends: the accumulator starts while later shards
    are still on the wire. (The phased/streamed wall-time ratio is
    measured on the card, not asserted here.)"""
    url = _serve_http(_SlowFrames(JsonlSource(cohort_dir)), request)
    trace = str(tmp_path / "cold.trace.json")
    with obs.telemetry_session(trace_out=trace):
        with _source("http", url, cache_dir=str(tmp_path / "c")) as src:
            _gramian(src, ingest_workers=2)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    fetch = [e for e in events
             if e.get("name") == "ingest.fetch" and e.get("ph") == "X"]
    acc = [e for e in events
           if e.get("name") == "gramian.accumulate" and e.get("ph") == "X"]
    assert fetch and acc
    assert min(e["ts"] for e in acc) < max(e["ts"] + e["dur"]
                                           for e in fetch)


# -- one cache directory, both packages --------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_a_mirror_written_by_either_package_is_warm_for_the_other(
        cohort_dir, tmp_path, request, transport, writer):
    counting = _CountingExports(JsonlSource(cohort_dir))
    if transport == "http":
        url = _serve_http(counting, request)
        clients = {
            "port": lambda cache: _http(url, cache_dir=cache,
                                        cold_stream=False),
            "jax": lambda cache: jax_service.HttpVariantSource(
                url, cache_dir=cache, cold_stream=False),
        }
    else:
        url = _serve_grpc(counting, request)
        clients = {
            "port": lambda cache: grpc_transport.GrpcVariantSource(
                url, cache_dir=cache, cold_stream=False, idle_timeout=30.0),
            "jax": lambda cache: jax_grpc.GrpcVariantSource(
                url, cache_dir=cache, cold_stream=False, idle_timeout=30.0),
        }
    reader = "jax" if writer == "port" else "port"
    cache = str(tmp_path / "shared")
    first = clients[writer](cache)
    assert _ids(first) == _ids(JsonlSource(cohort_dir))
    exports, sidecars = dict(counting.exports), counting.sidecars
    assert exports and sidecars == 1
    second = clients[reader](cache)
    indexes = _indexes(cohort_dir)
    shard = shards_for_references(REFS, BASES)[1]
    got = second.stream_carrying_csr(VSID, shard, indexes)
    want = JsonlSource(cohort_dir).stream_carrying_csr(VSID, shard, indexes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert list(second.stream_variants(VSID, shard)) == list(
        JaxJsonlSource(cohort_dir).stream_variants(VSID, shard)
        if reader == "jax" else JsonlSource(cohort_dir).stream_variants(
            VSID, shard))
    # No download and no frame: served from the other package's mirror.
    assert counting.exports == exports and counting.sidecars == sidecars
    assert counting.frames == 0
    if transport == "grpc":
        first.close()
        second.close()


@pytest.mark.parametrize("mode", ["full", "light"])
def test_mirror_files_are_byte_identical_across_packages(
        served, tmp_path, mode):
    _, url = served
    port_cache, jax_cache = str(tmp_path / "p"), str(tmp_path / "j")
    _http(url, cache_dir=port_cache, mirror_mode=mode,
          cold_stream=False).list_callsets(VSID)
    jax_service.HttpVariantSource(url, cache_dir=jax_cache,
                                  mirror_mode=mode,
                                  cold_stream=False).list_callsets(VSID)
    assert os.listdir(port_cache) == os.listdir(jax_cache)
    got, want = _mirror_root(port_cache), _mirror_root(jax_cache)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(got):
        with open(os.path.join(got, name), "rb") as a, open(
                os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name
    assert ("variants.jsonl" in os.listdir(got)) == (mode == "full")


# -- light mirrors ------------------------------------------------------------


def _light_mirror(url, tmp_path):
    cache = str(tmp_path / "light")
    _http(url, cache_dir=cache, mirror_mode="light",
          cold_stream=False).list_callsets(VSID)
    return _mirror_root(cache)


def _message(exc, root):
    return str(exc.value).replace(root, "ROOT")


def test_light_mirror_record_streams_name_the_full_mode(served, tmp_path):
    _, url = served
    root = _light_mirror(url, tmp_path)
    shard = shards_for_references(REFS, BASES)[0]
    with pytest.raises(FileNotFoundError) as port:
        list(JsonlSource(root).stream_variants(VSID, shard))
    with pytest.raises(FileNotFoundError) as ref:
        list(JaxJsonlSource(root).stream_variants(VSID, shard))
    assert _message(port, root) == _message(ref, root)
    assert "LIGHT cohort mirror" in str(port.value)
    assert "--mirror-mode full" in str(port.value)


def test_light_mirror_without_its_marker_names_sidecar_ok(served, tmp_path):
    _, url = served
    root = _light_mirror(url, tmp_path)
    os.unlink(os.path.join(root, ".sidecar-ok"))
    with pytest.raises(FileNotFoundError) as port:
        _CsrCohort.load_or_build(root, JsonlSource(root)._open)
    with pytest.raises(FileNotFoundError) as ref:
        _JaxCsrCohort.load_or_build(root, JaxJsonlSource(root)._open)
    assert _message(port, root) == _message(ref, root)
    assert re.search(r"\.sidecar-ok marker", str(port.value))


def test_a_trusted_mirror_sidecar_needs_the_jax_packages_version(
        served, tmp_path):
    _, url = served
    root = _light_mirror(url, tmp_path)
    assert _CsrCohort.VERSION == _JaxCsrCohort.VERSION
    assert _CsrCohort._mirror_sidecar_trusted(root)
    assert _JaxCsrCohort._mirror_sidecar_trusted(root)
    with open(os.path.join(root, ".sidecar-ok"), "w") as f:
        f.write("another-identity")
    assert not _CsrCohort._mirror_sidecar_trusted(root)
    assert not _JaxCsrCohort._mirror_sidecar_trusted(root)


# -- reads from the mirror ----------------------------------------------------

READ_REFS = "11:6888648:6890648"


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mirrored_reads") / "cohort")
    src = synthetic_cohort(12, 60, references=REFS, seed=4)
    src.add_reads(
        synthetic_reads(120, references=READ_REFS, seed=2).reads_records())
    src.dump(root)
    JsonlSource(root).ensure_serving_index()
    return root


def _reads(source):
    return [[vars(r) for r in source.stream_reads("", shard)]
            for shard in shards_for_references(READ_REFS, 400)]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_reads_from_a_warm_mirror_written_by_either_package(
        reads_dir, tmp_path, request, transport, writer):
    counting = _CountingExports(JsonlSource(reads_dir))
    if transport == "http":
        url = _serve_http(counting, request)
        clients = {
            "port": lambda cache: _http(url, cache_dir=cache,
                                        cold_stream=False),
            "jax": lambda cache: jax_service.HttpVariantSource(
                url, cache_dir=cache, cold_stream=False),
        }
    else:
        url = _serve_grpc(counting, request)
        clients = {
            "port": lambda cache: grpc_transport.GrpcVariantSource(
                url, cache_dir=cache, cold_stream=False, idle_timeout=30.0),
            "jax": lambda cache: jax_grpc.GrpcVariantSource(
                url, cache_dir=cache, cold_stream=False, idle_timeout=30.0),
        }
    cache = str(tmp_path / "shared")
    first = clients[writer](cache)
    first.list_callsets(VSID)
    assert counting.exports.get("reads.jsonl") == 1
    exports = dict(counting.exports)
    want = _reads(JsonlSource(reads_dir))
    assert sum(map(len, want)) == 120
    for reader in ("port", "jax"):
        second = clients[reader](cache)
        assert _reads(second) == want
        assert second.stats.reads_read == 120
        if transport == "grpc":
            second.close()
    # Served from the mirror: no /reads request and no download.
    assert counting.reads == 0 and counting.exports == exports
    if transport == "grpc":
        first.close()


def test_light_mirror_reads_fail_as_the_jax_packages(reads_dir, tmp_path,
                                                     request):
    url = _serve_http(JsonlSource(reads_dir), request)
    cache = str(tmp_path / "light")
    _http(url, cache_dir=cache, mirror_mode="light",
          cold_stream=False).list_callsets(VSID)
    root = _mirror_root(cache)
    assert "reads.jsonl" not in os.listdir(root)
    shard = shards_for_references(READ_REFS, 400)[0]
    with pytest.raises(FileNotFoundError) as port:
        list(JsonlSource(root).stream_reads("", shard))
    with pytest.raises(FileNotFoundError) as ref:
        list(JaxJsonlSource(root).stream_reads("", shard))
    assert _message(port, root) == _message(ref, root)
    # Through either package's client over the light mirror, too.
    for client in (_http(url, cache_dir=cache, mirror_mode="light",
                         cold_stream=False),
                   jax_service.HttpVariantSource(
                       url, cache_dir=cache, mirror_mode="light",
                       cold_stream=False)):
        with pytest.raises(FileNotFoundError) as err:
            list(client.stream_reads("", shard))
        assert _message(err, root) == _message(port, root)
