"""The port's HTTP genomics service against the JAX package's.

Both packages' servers serve the same on-disk cohort on 127.0.0.1 (bound to
port 0, stopped by fixture finalizers); both packages' clients read both
servers, through the binary frame tier and the gzip record tier, and must
agree with each other and with the local ``JsonlSource``: the callsets,
the records, the CSR pairs, the ``IoStats`` counters. The port's driver
over ``--api-url`` must give G bit-identical to ``--input-path`` on the
same directory in every ``--pca-mode``. No test sleeps through a backoff:
every client retries with zero delay, and every socket has a timeout.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics import auth as jax_auth
from spark_examples_tpu.genomics import service as jax_service
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.genomics.fixtures import (
    synthetic_reads as jax_synthetic_reads,
)
from spark_examples_tpu.genomics.sources import (
    JsonlSource as JaxJsonlSource,
)
from spark_examples_tpu.resilience import RetryPolicy as JaxRetryPolicy
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics import service
from spark_examples_tpu_torch.genomics.auth import Credentials
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
    synthetic_reads,
)
from spark_examples_tpu_torch.genomics.shards import shards_for_references
from spark_examples_tpu_torch.genomics.sources import (
    SIDECAR_BASENAME,
    JsonlSource,
)
from spark_examples_tpu_torch.genomics.wire import WireFormatError
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops import scatter_kernel
from spark_examples_tpu_torch.resilience import (
    BreakerSet,
    CircuitOpenError,
    FaultPlan,
    FaultRule,
    RetryPolicy,
    active_plan,
)
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.stats import COUNTER_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "tok"
VSID = DEFAULT_VARIANT_SET_ID
REFS = "17:41196311:41277499"
# The cohort of tests/test_torch_pca_pipeline.py: 4 scatter and 9 dense
# windows at 64 variants a window and a 0.6 threshold; 5 shards here.
N, V = 64, 800
BASES = 20_000
FAST = dict(max_attempts=3, base_delay=0.0, jitter=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("served"))
    synthetic_cohort(N, V, seed=3, population_structure=3).dump(root)
    JsonlSource(root).ensure_serving_index()
    return root


def _serve(server_cls, source, request):
    server = server_cls(source, port=0, token=TOKEN).start()
    request.addfinalizer(server.stop)
    return f"http://127.0.0.1:{server.port}"


@pytest.fixture(scope="module")
def servers(cohort_dir, request):
    """{"port": url, "jax": url}: each package's server, same directory."""
    return {
        "port": _serve(service.GenomicsServiceServer,
                       JsonlSource(cohort_dir), request),
        "jax": _serve(jax_service.GenomicsServiceServer,
                      JaxJsonlSource(cohort_dir), request),
    }


def _client(pkg, url, token=TOKEN, **kw):
    if pkg == "port":
        return service.HttpVariantSource(
            url, credentials=Credentials(token, "test"), timeout=30,
            retry_policy=RetryPolicy(**FAST), **kw)
    return jax_service.HttpVariantSource(
        url, credentials=jax_auth.Credentials(token, "test"), timeout=30,
        retry_policy=JaxRetryPolicy(**FAST), **kw)


def _shards():
    return shards_for_references(REFS, BASES)


def _stats(source):
    return [getattr(source.stats, f) for f in COUNTER_FIELDS]


def _indexes(root):
    ids = [c.id for c in JsonlSource(root).list_callsets(VSID)]
    return {cid: i for i, cid in enumerate(ids)}


def _pairs(source, indexes, min_af=None):
    out = []
    for shard in _shards():
        pair = source.stream_carrying_csr(VSID, shard, indexes, min_af)
        out.append(None if pair is None else tuple(np.asarray(a)
                                                   for a in pair))
    return out


def _same_pairs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "records"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_every_client_reads_every_server(servers, cohort_dir, server_pkg,
                                         client_pkg, frames):
    src = _client(client_pkg, servers[server_pkg], wire_frames=frames)
    callsets = src.list_callsets(VSID)
    local = JsonlSource(cohort_dir)
    assert [(c.id, c.name) for c in callsets] == [
        (c.id, c.name) for c in local.list_callsets(VSID)]
    indexes = _indexes(cohort_dir)
    _same_pairs(_pairs(src, indexes), _pairs(local, indexes))
    # The six parity counters read the same from every pairing.
    ref = _client("port", servers["port"], wire_frames=frames)
    ref.list_callsets(VSID)
    _pairs(ref, indexes)
    assert _stats(src) == _stats(ref)
    assert src.stats.variants_read == V


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_min_af_applied_by_the_server_matches_the_local_tier(
        servers, cohort_dir, server_pkg):
    indexes = _indexes(cohort_dir)
    for frames in (True, False):
        src = _client("port", servers[server_pkg], wire_frames=frames)
        _same_pairs(_pairs(src, indexes, 0.3),
                    _pairs(JsonlSource(cohort_dir), indexes, 0.3))


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_variants_records_equal_the_local_source(servers, cohort_dir,
                                                 server_pkg):
    src = _client("port", servers[server_pkg])
    local = JsonlSource(cohort_dir)
    for shard in _shards():
        assert list(src.stream_variants(VSID, shard)) == list(
            local.stream_variants(VSID, shard))
    indexes = _indexes(cohort_dir)
    shard = _shards()[0]
    assert list(src.stream_carrying(VSID, shard, indexes)) == list(
        local.stream_carrying(VSID, shard, indexes))
    # Keyed triples: the identity travels as its payload over the wire and
    # as its hash from the sidecar; contigs and carriers agree.
    assert [(c, calls) for c, _, calls in src.stream_carrying_keyed(
        VSID, shard, indexes)] == [
        (c, calls) for c, _, calls in local.stream_carrying_keyed(
            VSID, shard, indexes)]


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_missing_token_is_a_401_counted_once(servers, server_pkg,
                                               client_pkg):
    src = _client(client_pkg, servers[server_pkg], token="")
    with pytest.raises(IOError, match="401"):
        src.list_callsets(VSID)
    assert src.stats.unsuccessful_responses == 1
    assert src.stats.io_exceptions == 0 and src.stats.requests == 1


class _FailingMidStream:
    """A served source whose record stream dies after a few lines."""

    def __init__(self, inner):
        self._inner = inner

    def list_callsets(self, vsid):
        return self._inner.list_callsets(vsid)

    def stream_variant_lines(self, vsid, shard):
        for i, line in enumerate(self._inner.stream_variant_lines(vsid,
                                                                   shard)):
            if i == 5:
                raise RuntimeError("disk gone")
            yield line


@pytest.mark.parametrize("server_cls,source_cls", [
    (service.GenomicsServiceServer, JsonlSource),
    (jax_service.GenomicsServiceServer, JaxJsonlSource),
], ids=["port", "jax"])
def test_a_mid_stream_failure_raises_and_never_truncates(
        cohort_dir, request, server_cls, source_cls):
    url = _serve(server_cls, _FailingMidStream(source_cls(cohort_dir)),
                 request)
    src = _client("port", url)
    # The server cannot serve frames, so the CSR route takes the record
    # tier too, and must raise as loudly.
    with pytest.raises(IOError, match="mid-shard"):
        list(src.stream_variants(VSID, _shards()[0]))
    with pytest.raises(IOError, match="mid-shard"):
        src.stream_carrying_csr(VSID, _shards()[0], _indexes(cohort_dir))
    assert src.stats.io_exceptions == 2
    assert src.stats.unsuccessful_responses == 0


@pytest.mark.parametrize("kind", ["truncate", "corrupt", "error"])
def test_frame_faults_are_retried_to_the_same_pair(servers, cohort_dir,
                                                   kind):
    indexes = _indexes(cohort_dir)
    want = _pairs(JsonlSource(cohort_dir), indexes)
    plan = FaultPlan(rules=[FaultRule(
        site="transport.http.frames", kind=kind, at_line=0, times=2)])
    src = _client("port", servers["jax"])
    with active_plan(plan), obs.telemetry_session() as session:
        got = _pairs(src, indexes)
        retries = session.registry.snapshot()["counters"]
    _same_pairs(got, want)
    assert plan.fired_total == 2
    assert retries['genomics_rpc_retries_total{method="/variants-csr",'
                   'transport="http"}'] == 2
    assert src.stats.io_exceptions == src.stats.unsuccessful_responses == 0


def test_a_frame_fault_without_retries_is_loud(servers, cohort_dir):
    plan = FaultPlan(rules=[FaultRule(
        site="transport.http.frames", kind="truncate", at_line=0)])
    src = service.HttpVariantSource(
        servers["port"], credentials=Credentials(TOKEN, "test"), timeout=30,
        retry_policy=RetryPolicy(max_attempts=1))
    with active_plan(plan), pytest.raises(WireFormatError,
                                          match="truncated"):
        src.stream_carrying_csr(VSID, _shards()[0], _indexes(cohort_dir))
    assert src.stats.io_exceptions == 1


def test_an_injected_request_fault_is_retried_with_clean_stats(
        servers, cohort_dir):
    indexes = _indexes(cohort_dir)
    plan = FaultPlan.from_spec(json.dumps({"rules": [
        {"site": "transport.http.request", "match": "/variants-csr"}]}))
    src = _client("port", servers["port"])
    with active_plan(plan):
        _same_pairs(_pairs(src, indexes),
                    _pairs(JsonlSource(cohort_dir), indexes))
    assert plan.fired_total == 1
    assert src.stats.io_exceptions == src.stats.unsuccessful_responses == 0


def test_a_dead_endpoint_opens_the_breaker(cohort_dir, request):
    server = service.GenomicsServiceServer(
        JsonlSource(cohort_dir), port=0, token=TOKEN).start()
    url = f"http://127.0.0.1:{server.port}"
    server.stop()
    src = service.HttpVariantSource(
        url, credentials=Credentials(TOKEN, "test"), timeout=5,
        retry_policy=RetryPolicy(**FAST),
        breakers=BreakerSet("http:t:", failure_threshold=2,
                            cooldown_s=60.0))
    with pytest.raises(IOError):
        src.list_callsets(VSID)
    with pytest.raises(CircuitOpenError):
        src.list_callsets(VSID)
    assert src.stats.io_exceptions == 2 and src.stats.requests == 2


MODES = ("sparse", "auto", "fused", "stream", "sketch")


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "records"])
@pytest.mark.parametrize("mode", MODES)
def test_api_url_g_is_bit_identical_to_input_path(servers, cohort_dir, mode,
                                                  frames, capsys):
    kw = dict(variant_set_ids=[VSID], device="cpu", pca_mode=mode,
              block_variants=64, sparse_density_threshold=0.6)
    local = VariantsPcaDriver(PcaConfig(**kw), JsonlSource(cohort_dir))
    net = VariantsPcaDriver(
        PcaConfig(**kw), _client("port", servers["port"],
                                 wire_frames=frames))
    before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
    want, got = local.run(), net.run()
    capsys.readouterr()
    if mode == "sketch":
        np.testing.assert_array_equal(net.g.y, local.g.y)
        np.testing.assert_array_equal(net.g.row_sums, local.g.row_sums)
    else:
        np.testing.assert_array_equal(net.g.numpy(), local.g.numpy())
    assert got == want
    assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before  # the CPU


def test_a_network_run_without_cuda_raises_before_any_request(
        servers, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _client("port", servers["port"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VariantsPcaDriver(PcaConfig(variant_set_ids=[VSID]), src)
    assert src.stats.requests == 0


def _get(url, path, token=TOKEN, method="GET", data=None):
    req = urllib.request.Request(
        url + path, data=data, method=method,
        headers={"Authorization": f"Bearer {token}"} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("path", [
    "/callsets?variant_set_id=" + VSID,
    "/callset-order",
    "/identity",
    "/export/callsets.json",
    "/export/variants.jsonl",
    "/export/reads.jsonl",
    "/export/nope",
    "/export-sidecar",
    "/variants-csr?variant_set_id=" + VSID + "&contig=17&start=41196311"
    "&end=41216311",
    "/variants-csr?contig=17",
    "/no-such-endpoint",
])
def test_endpoints_answer_as_the_jax_server(servers, path):
    got, want = _get(servers["port"], path), _get(servers["jax"], path)
    assert got[0] == want[0]
    if got[0] == 200:
        assert got[1] == want[1]


def test_export_sidecar_is_the_file(servers, cohort_dir):
    status, body = _get(servers["port"], "/export-sidecar")
    assert status == 200
    with open(os.path.join(cohort_dir, SIDECAR_BASENAME), "rb") as f:
        assert body == f.read()


def test_introspection_and_unserved_endpoints(servers):
    for url in servers.values():
        status, body = _get(url, "/healthz", token="")
        assert status == 200 and json.loads(body)["checks"] == {"live": True}
        assert _get(url, "/callsets", token="")[0] == 401
        assert _get(url, "/analyze", method="POST", data=b"{}")[0] == 404
    port, ref = (json.loads(_get(servers[p], "/statusz")[1])
                 for p in ("port", "jax"))
    drop = {"compile_cache", "jit_retraces"}  # XLA-specific
    assert set(port) == set(ref) - drop
    assert set(port["server"]) == set(ref["server"])
    status, body = _get(servers["port"], "/metrics")
    assert status == 200 and b"genomics_io_requests_total" in body
    # /reads is served; over a directory without reads.jsonl both
    # packages' servers answer the same 500 (the JAX package's
    # JsonlSource has no reads file to index).
    got, want = (_get(servers[p], "/reads?contig=17&start=0&end=9")
                 for p in ("port", "jax"))
    assert got == want and got[0] == 500


def test_fixture_sources_serve_byte_identical_frames(request):
    urls = {
        "port": _serve(service.GenomicsServiceServer,
                       synthetic_cohort(N, V, seed=3), request),
        "jax": _serve(jax_service.GenomicsServiceServer,
                      jax_synthetic_cohort(N, V, seed=3), request),
    }
    for path in (
        "/identity",
        "/callset-order",
        "/callsets?variant_set_id=" + VSID,
        "/export/variants.jsonl",
        "/variants-csr?variant_set_id=" + VSID
        + "&contig=17&start=41196311&end=41277499",
        "/variants-csr?variant_set_id=" + VSID
        + "&contig=17&start=41196311&end=41277499&min_af=0.2",
    ):
        got, want = _get(urls["port"], path), _get(urls["jax"], path)
        assert got == want and got[0] == 200


def test_cli_serve_cohort_and_pca_api_url(cohort_dir, tmp_path):
    token_file = tmp_path / "adc.json"
    token_file.write_text(json.dumps({"token": TOKEN}))
    env = dict(os.environ, GENOMICS_APPLICATION_CREDENTIALS=str(token_file),
               OMP_NUM_THREADS="1")
    server = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
         "serve-cohort", "--input-path", cohort_dir, "--port", "0",
         "--token", TOKEN],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = None
        for line in server.stdout:
            if "listening on http://" in line:
                url = line.split("listening on ", 1)[1].split()[0]
                break
        assert url, "serve-cohort exited before listening"
        out = tmp_path / "net"
        cli = subprocess.run(
            [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
             "pca", "--api-url", url, "--device", "cpu",
             "--pca-mode", "sparse", "--block-variants", "64",
             "--sparse-density-threshold", "0.6",
             "--output-path", str(out),
             "--trace-out", str(tmp_path / "t.json"),
             "--metrics-out", str(tmp_path / "m.prom"),
             "--manifest-out", str(tmp_path / "man.json")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    finally:
        server.terminate()
        server.wait(timeout=30)
    assert cli.returncode == 0, cli.stderr
    driver = VariantsPcaDriver(
        PcaConfig(variant_set_ids=[VSID], device="cpu", pca_mode="sparse",
                  block_variants=64, sparse_density_threshold=0.6,
                  output_path=str(tmp_path / "local")),
        JsonlSource(cohort_dir))
    with contextlib.redirect_stdout(io.StringIO()):
        driver.run()
    got = [l.split("\t") for l in (tmp_path / "net-pca.tsv").read_text()
           .splitlines()]
    want = [l.split("\t") for l in (tmp_path / "local-pca.tsv").read_text()
            .splitlines()]
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == N
    np.testing.assert_allclose(
        np.array([r[1:3] for r in got], float),
        np.array([r[1:3] for r in want], float), atol=1e-6)
    names = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"ingest.fetch", "wire_frame_fetch"} <= names
    prom = (tmp_path / "m.prom").read_text()
    assert 'sparse_gramian_windows_total{route="scatter"} 4.0' in prom
    assert "genomics_rpc_latency_seconds_count" in prom
    assert json.loads((tmp_path / "man.json").read_text())["command"] == (
        "pca")


# -- reads --------------------------------------------------------------------

READ_REFS = "11:6888648:6890648"
READ_BASES = 500


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("served_reads"))
    src = synthetic_cohort(8, 40, seed=5)
    src.add_reads(
        synthetic_reads(150, references=READ_REFS, seed=6).reads_records())
    src.dump(root)
    return root


@pytest.fixture(scope="module")
def reads_servers(reads_dir, request):
    """Each package's server over the reads directory and over its own
    fixture of the same records: {(package, kind): url}."""
    def fixture(pkg):
        if pkg == "port":
            return synthetic_reads(150, references=READ_REFS, seed=6)
        return jax_synthetic_reads(150, references=READ_REFS, seed=6)

    return {
        ("port", "jsonl"): _serve(service.GenomicsServiceServer,
                                  JsonlSource(reads_dir), request),
        ("jax", "jsonl"): _serve(jax_service.GenomicsServiceServer,
                                 JaxJsonlSource(reads_dir), request),
        ("port", "fixture"): _serve(service.GenomicsServiceServer,
                                    fixture("port"), request),
        ("jax", "fixture"): _serve(jax_service.GenomicsServiceServer,
                                   fixture("jax"), request),
    }


def _reads(source, rgsid):
    return [[vars(r) for r in source.stream_reads(rgsid, shard)]
            for shard in shards_for_references(READ_REFS, READ_BASES)]


@pytest.mark.parametrize("kind", ["jsonl", "fixture"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_every_client_reads_reads_from_every_server(
        reads_servers, reads_dir, server_pkg, client_pkg, kind):
    local = JsonlSource(reads_dir)
    src = _client(client_pkg, reads_servers[server_pkg, kind])
    for rgsid in ("", "fixture-readset", "another-readset"):
        got = _reads(src, rgsid)
        assert got == _reads(local, rgsid)
        assert sum(map(len, got)) == (0 if rgsid == "another-readset"
                                      else 150)
    ref = _client("port", reads_servers["port", "jsonl"])
    for rgsid in ("", "fixture-readset", "another-readset"):
        _reads(ref, rgsid)
    assert _stats(src) == _stats(ref)
    assert src.stats.reads_read == 300


def test_reads_lines_are_byte_identical_across_servers(reads_servers):
    query = "/reads?contig=11&start=6888648&end=6889648"
    bodies = {key: _get(url, query) for key, url in reads_servers.items()}
    assert len(set(bodies.values())) == 1
    status, body = bodies["port", "jsonl"]
    assert status == 200 and body.count(b"\n") > 50
