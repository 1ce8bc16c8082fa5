"""The port's gRPC transport against the JAX package's.

Both packages' ``GrpcGenomicsServer`` serve the same on-disk cohort on
127.0.0.1 (port 0, a bearer token, stopped by fixture finalizers); both
packages' ``GrpcVariantSource`` read both servers, through the binary frame
tier and the record tier, and must agree with each other and with the local
``JsonlSource``: callsets, records, identity, CSR pairs, ``IoStats``. The
servers' answers are byte-identical method for method. The port's driver
over ``--api-url grpc://`` gives G bit-identical to ``--input-path`` in
every ``--pca-mode``. Every client retries with zero delay, every stream
has an idle timeout, every channel is closed in a ``finally``.
"""

import contextlib
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from spark_examples_tpu import obs as jax_obs
from spark_examples_tpu.genomics import auth as jax_auth
from spark_examples_tpu.genomics import grpc_transport as jax_grpc
from spark_examples_tpu.genomics.fixtures import (
    synthetic_reads as jax_synthetic_reads,
)
from spark_examples_tpu.genomics.sources import (
    JsonlSource as JaxJsonlSource,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.resilience import FaultPlan as JaxFaultPlan
from spark_examples_tpu.resilience import RetryPolicy as JaxRetryPolicy
from spark_examples_tpu.resilience import active_plan as jax_active_plan
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics import grpc_transport
from spark_examples_tpu_torch.genomics.auth import Credentials
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
    synthetic_reads,
)
from spark_examples_tpu_torch.genomics.shards import shards_for_references
from spark_examples_tpu_torch.genomics.sources import JsonlSource
from spark_examples_tpu_torch.genomics.wire import WireFormatError
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops import scatter_kernel
from spark_examples_tpu_torch.resilience import (
    FaultPlan,
    FaultRule,
    RetryPolicy,
    active_plan,
    classify_grpc,
)
from spark_examples_tpu_torch.utils.config import PcaConfig
from spark_examples_tpu_torch.utils.stats import COUNTER_FIELDS

TOKEN = "tok"
VSID = DEFAULT_VARIANT_SET_ID
REFS = "17:41196311:41277499"
# The cohort of tests/test_torch_service.py: 4 scatter and 9 dense windows
# at 64 variants a window and a 0.6 threshold; 5 shards here.
N, V = 64, 800
BASES = 20_000
FAST = dict(max_attempts=3, base_delay=0.0, jitter=0.0)
IDLE = 30.0
MODES = ("sparse", "auto", "fused", "stream", "sketch")
SETTINGS = dict(variant_set_ids=[VSID], block_variants=64,
                sparse_density_threshold=0.6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grpc_served"))
    synthetic_cohort(N, V, seed=3, population_structure=3).dump(root)
    JsonlSource(root).ensure_serving_index()
    return root


def _serve(server_cls, source, request, token=TOKEN):
    server = server_cls(source, port=0, token=token).start()
    request.addfinalizer(server.stop)
    return f"grpc://127.0.0.1:{server.port}"


@pytest.fixture(scope="module")
def servers(cohort_dir, request):
    """{"port": url, "jax": url}: each package's server, same directory."""
    return {
        "port": _serve(grpc_transport.GrpcGenomicsServer,
                       JsonlSource(cohort_dir), request),
        "jax": _serve(jax_grpc.GrpcGenomicsServer,
                      JaxJsonlSource(cohort_dir), request),
    }


def _client(pkg, url, token=TOKEN, **kw):
    kw.setdefault("idle_timeout", IDLE)
    kw.setdefault("timeout", 30)
    if pkg == "port":
        return grpc_transport.GrpcVariantSource(
            url, credentials=Credentials(token, "test") if token else None,
            retry_policy=RetryPolicy(**FAST), **kw)
    return jax_grpc.GrpcVariantSource(
        url,
        credentials=jax_auth.Credentials(token, "test") if token else None,
        retry_policy=JaxRetryPolicy(**FAST), **kw)


@contextlib.contextmanager
def _open(pkg, url, **kw):
    client = _client(pkg, url, **kw)
    try:
        yield client
    finally:
        client.close()


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


# -- both directions ----------------------------------------------------------


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "records"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_every_client_reads_every_server(servers, cohort_dir, server_pkg,
                                         client_pkg, frames):
    local = JsonlSource(cohort_dir)
    indexes = _indexes(cohort_dir)
    with _open(client_pkg, servers[server_pkg], wire_frames=frames) as src, \
            _open("port", servers["port"], wire_frames=frames) as ref:
        callsets = src.list_callsets(VSID)
        assert [(c.id, c.name) for c in callsets] == [
            (c.id, c.name) for c in local.list_callsets(VSID)]
        _same_pairs(_pairs(src, indexes), _pairs(local, indexes))
        # The six parity counters read the same from every pairing.
        ref.list_callsets(VSID)
        _pairs(ref, indexes)
        assert _stats(src) == _stats(ref)
        assert src.stats.variants_read == V


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_records_callsets_and_identity_match_the_local_source(
        servers, cohort_dir, server_pkg):
    local = JsonlSource(cohort_dir)
    indexes = _indexes(cohort_dir)
    with _open("port", servers[server_pkg]) as src:
        assert src.cohort_identity() == local.cohort_identity() is not None
        for shard in _shards():
            assert list(src.stream_variants(VSID, shard)) == list(
                local.stream_variants(VSID, shard))
        shard = _shards()[0]
        assert list(src.stream_carrying(VSID, shard, indexes)) == list(
            local.stream_carrying(VSID, shard, indexes))
        assert [(c, calls) for c, _, calls in src.stream_carrying_keyed(
            VSID, shard, indexes)] == [
            (c, calls) for c, _, calls in local.stream_carrying_keyed(
                VSID, shard, indexes)]
        for min_af in (None, 0.3):
            _same_pairs(_pairs(src, indexes, min_af),
                        _pairs(local, indexes, min_af))
        assert src.stats.variants_read > 0
        assert src.stats.partitions == len(_shards()) * 3 + 2


def _raw_calls(url):
    """Every method's answer from one server, as raw message bytes."""
    import grpc

    channel = grpc.insecure_channel(url[len("grpc://"):])
    meta = (("authorization", f"Bearer {TOKEN}"),)
    ident = lambda b: b  # noqa: E731

    def unary(method, req):
        fn = channel.unary_unary(f"/genomics.VariantStream/{method}",
                                 request_serializer=ident,
                                 response_deserializer=ident)
        return fn(json.dumps(req).encode(), metadata=meta, timeout=30)

    def stream(method, req):
        fn = channel.unary_stream(f"/genomics.VariantStream/{method}",
                                  request_serializer=ident,
                                  response_deserializer=ident)
        return b"".join(fn(json.dumps(req).encode(), metadata=meta,
                           timeout=30))

    try:
        out = {
            "ListCallsets": unary("ListCallsets", {"variant_set_id": VSID}),
            "CallsetOrder": unary("CallsetOrder", {}),
            "Identity": unary("Identity", {}),
            "ExportLines": stream("ExportLines",
                                  {"name": "variants.jsonl"}),
            "ExportSidecar": stream("ExportSidecar", {}),
        }
        for i, shard in enumerate(_shards()):
            req = {"variant_set_id": VSID, "contig": shard.contig,
                   "start": shard.start, "end": shard.end}
            out[f"StreamVariants {i}"] = stream("StreamVariants", req)
            out[f"StreamVariantFrames {i}"] = stream(
                "StreamVariantFrames", req)
            out[f"StreamVariantFrames {i} min_af"] = stream(
                "StreamVariantFrames", dict(req, min_af=0.3))
        return out
    finally:
        channel.close()


def test_servers_answer_byte_identically(servers):
    got, want = _raw_calls(servers["port"]), _raw_calls(servers["jax"])
    assert got.keys() == want.keys()
    for method in got:
        assert got[method] == want[method], method
    assert all(got[m] for m in got if "Frames" in m)


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "records"])
@pytest.mark.parametrize("mode", MODES)
def test_grpc_g_is_bit_identical_to_input_path(servers, cohort_dir, mode,
                                               frames, capsys):
    kw = dict(SETTINGS, device="cpu", pca_mode=mode)
    local = VariantsPcaDriver(PcaConfig(**kw), JsonlSource(cohort_dir))
    want = local.run()
    with _open("port", servers["port"], wire_frames=frames) as src:
        net = VariantsPcaDriver(PcaConfig(**kw), src)
        before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
        got = net.run()
    capsys.readouterr()
    if mode == "sketch":
        np.testing.assert_array_equal(net.g.y, local.g.y)
        np.testing.assert_array_equal(net.g.row_sums, local.g.row_sums)
    else:
        np.testing.assert_array_equal(net.g.numpy(), local.g.numpy())
    assert got == want
    assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before  # the CPU


@pytest.mark.parametrize("mode", ["sparse", "auto"])
def test_coordinates_match_the_jax_driver_over_grpc(servers, mode, capsys):
    kw = dict(SETTINGS, pca_mode=mode)
    with _open("port", servers["jax"]) as src:
        got = VariantsPcaDriver(PcaConfig(device="cpu", **kw), src).run()
    with _open("jax", servers["port"]) as src:
        want = JaxDriver(JaxConfig(**kw), src).run()
    capsys.readouterr()
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got]),
                               np.array([r[1:] for r in want]), atol=1e-4)


# -- auth and errors ----------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_missing_token_is_unauthenticated_counted_once(
        servers, server_pkg, client_pkg):
    with _open(client_pkg, servers[server_pkg], token="") as src:
        with pytest.raises(IOError, match="UNAUTHENTICATED"):
            list(src.stream_variants(VSID, _shards()[0]))
        assert src.stats.unsuccessful_responses == 1
        assert src.stats.io_exceptions == 0


class _FailsMidStream:
    """A served source whose record stream dies after a few records."""

    def __init__(self, inner):
        self._inner = inner

    def list_callsets(self, vsid):
        return self._inner.list_callsets(vsid)

    def stream_variants(self, vsid, shard):
        for i, v in enumerate(self._inner.stream_variants(vsid, shard)):
            if i == 3:
                raise IOError("disk died mid-shard")
            yield v


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_mid_stream_failure_is_a_status_not_a_truncation(
        cohort_dir, request, server_pkg):
    server_cls = {"port": grpc_transport.GrpcGenomicsServer,
                  "jax": jax_grpc.GrpcGenomicsServer}[server_pkg]
    url = _serve(server_cls, _FailsMidStream(JsonlSource(cohort_dir)),
                 request)
    with _open("port", url) as src:
        with pytest.raises(IOError, match="StreamVariants"):
            list(src.stream_variants(VSID, _shards()[0]))
        # The source serves no frames, so the CSR route takes the record
        # tier and must raise as loudly.
        with pytest.raises(IOError):
            src.stream_carrying_csr(VSID, _shards()[0], _indexes(cohort_dir))
        assert (src.stats.unsuccessful_responses
                + src.stats.io_exceptions) == 2


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_a_dead_server_counts_an_io_exception(client_pkg):
    with _open(client_pkg, "grpc://127.0.0.1:1", token="",
               timeout=3) as src:
        with pytest.raises(IOError):
            list(src.stream_variants("", _shards()[0]))
        assert src.stats.io_exceptions == 1
        assert src.stats.unsuccessful_responses == 0


def test_classify_grpc_matches_the_jax_classifier():
    import grpc

    from spark_examples_tpu.resilience import (
        classify_grpc as jax_classify_grpc,
    )

    class _Status(grpc.RpcError):
        def __init__(self, code):
            self._code = code

        def code(self):
            return self._code

    for code in grpc.StatusCode:
        err = _Status(code)
        wrapped = IOError("x")
        wrapped.__cause__ = err
        for exc in (err, wrapped):
            got, want = classify_grpc(exc), jax_classify_grpc(exc)
            assert (got.retryable, got.reason) == (want.retryable,
                                                   want.reason)
    got = classify_grpc(OSError("local"))
    assert (got.retryable, got.reason) == (True, "transport")


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "records"])
def test_an_injected_request_fault_is_retried_with_clean_stats(
        servers, cohort_dir, frames):
    indexes = _indexes(cohort_dir)
    plan = FaultPlan(rules=[FaultRule(site="transport.grpc.request",
                                      match="StreamVariant")])
    with _open("port", servers["jax"], wire_frames=frames) as src, \
            active_plan(plan), obs.telemetry_session() as session:
        got = _pairs(src, indexes)
        counters = session.registry.snapshot()["counters"]
    _same_pairs(got, _pairs(JsonlSource(cohort_dir), indexes))
    assert plan.fired_total == 1
    method = "StreamVariantFrames" if frames else "StreamVariants"
    assert counters[f'genomics_rpc_retries_total{{method="{method}",'
                    'transport="grpc"}'] == 1
    assert src.stats.io_exceptions == src.stats.unsuccessful_responses == 0


@pytest.mark.parametrize("kind", ["truncate", "corrupt", "error"])
def test_frame_stream_faults_are_retried_to_the_same_pair(
        servers, cohort_dir, kind):
    indexes = _indexes(cohort_dir)
    plan = FaultPlan(rules=[FaultRule(site="transport.grpc.stream",
                                      kind=kind, at_line=0, times=2)])
    with _open("port", servers["port"]) as src, active_plan(plan):
        got = _pairs(src, indexes)
    _same_pairs(got, _pairs(JsonlSource(cohort_dir), indexes))
    assert plan.fired_total == 2
    assert src.stats.io_exceptions == src.stats.unsuccessful_responses == 0


def test_a_frame_fault_without_retries_is_loud(servers, cohort_dir):
    plan = FaultPlan(rules=[FaultRule(site="transport.grpc.stream",
                                      kind="truncate", at_line=0)])
    src = grpc_transport.GrpcVariantSource(
        servers["port"], credentials=Credentials(TOKEN, "test"),
        retry_policy=RetryPolicy(max_attempts=1), idle_timeout=IDLE)
    try:
        with active_plan(plan), pytest.raises(WireFormatError,
                                              match="truncated"):
            src.stream_carrying_csr(VSID, _shards()[0],
                                    _indexes(cohort_dir))
    finally:
        src.close()
    assert src.stats.io_exceptions == 1


class _Wedged:
    """A served source whose record stream delivers one record, then
    blocks until released (a peer connected but delivering nothing)."""

    def __init__(self, inner):
        self._inner = inner
        self.release = threading.Event()

    def list_callsets(self, vsid):
        return self._inner.list_callsets(vsid)

    def stream_variants(self, vsid, shard):
        for i, v in enumerate(self._inner.stream_variants(vsid, shard)):
            if i == 1:
                self.release.wait(timeout=30)
                return
            yield v


def test_a_wedged_stream_hits_the_idle_timeout_and_ends_its_pump(
        cohort_dir, request):
    wedged = _Wedged(JsonlSource(cohort_dir))
    request.addfinalizer(wedged.release.set)
    url = _serve(grpc_transport.GrpcGenomicsServer, wedged, request)
    with _open("port", url, idle_timeout=0.5) as src:
        t0 = time.monotonic()
        with pytest.raises(IOError, match="no stream message"):
            list(src.stream_variants(VSID, _shards()[0]))
        assert time.monotonic() - t0 < 10
        assert src.stats.io_exceptions == 1
        wedged.release.set()
        deadline = time.monotonic() + 10
        while any(t.name.startswith("grpc-pump-")
                  for t in threading.enumerate()):
            assert time.monotonic() < deadline, "the pump thread lives on"
            time.sleep(0.02)


# -- what is refused ----------------------------------------------------------


def test_stream_reads_over_a_cohort_without_reads(servers):
    # StreamReads is served; over a directory without reads.jsonl both
    # packages' servers fail the stream the same way, and each client
    # counts one unsuccessful response.
    for server_pkg in ("port", "jax"):
        for client_pkg in ("port", "jax"):
            with _open(client_pkg, servers[server_pkg]) as src:
                with pytest.raises(IOError) as err:
                    list(src.stream_reads("", _shards()[0]))
                assert "UNIMPLEMENTED" not in str(err.value)
                assert src.stats.reads_read == 0


def test_compute_pca_names_item_8(servers, cohort_dir, request, tmp_path,
                                  capsys):
    """``ComputePca`` is served (item 8's meshless half): a server given a
    backend answers both packages' clients with the JAX backend's
    coordinates, and ``compute_pca`` works in both packages' clients; a
    server without one still registers no ``ComputePca``, as the JAX
    package's. Item 8's last part, ``--elastic-checkpoint``, runs over
    ``grpc://`` too: its G is the JAX driver's elastic G over the same
    server bit for bit, and the JAX driver resumes the port's lanes into
    it."""
    from spark_examples_tpu.bridge import TpuPcaBackend
    from spark_examples_tpu_torch.bridge import TorchPcaBackend

    rng = np.random.default_rng(4)
    calls = [sorted(rng.choice(13, size=rng.integers(1, 13),
                               replace=False).tolist()) for _ in range(90)]
    want, _ = TpuPcaBackend(block_variants=16).compute(iter(calls), 13, 2)
    backends = {
        "port": (grpc_transport.GrpcGenomicsServer,
                 TorchPcaBackend(block_variants=16, device="cpu")),
        "jax": (jax_grpc.GrpcGenomicsServer,
                TpuPcaBackend(block_variants=16)),
    }
    for server_pkg, (server_cls, backend) in backends.items():
        server = server_cls(JsonlSource(cohort_dir), port=0, token=TOKEN,
                            pca_backend=backend).start()
        request.addfinalizer(server.stop)
        url = f"grpc://127.0.0.1:{server.port}"
        for client_pkg in ("port", "jax"):
            with _open(client_pkg, url) as src:
                coords, eigvals = src.compute_pca(iter(calls), 13, 2,
                                                  batch_size=7)
                assert src.stats.requests >= 1
            assert eigvals.shape == (2,)
            np.testing.assert_allclose(coords, want, atol=1e-4,
                                       err_msg=f"{server_pkg}/{client_pkg}")
        with _open("port", url) as src:
            with pytest.raises(IOError, match="INVALID_ARGUMENT"):
                src.compute_pca(iter([[0]]), 3, 0)
    for client_pkg in ("port", "jax"):
        with _open(client_pkg, servers["port"]) as src:
            with pytest.raises(IOError, match="UNIMPLEMENTED"):
                src.compute_pca(iter([[0, 1]]), 4, 2)
    ck = dict(SETTINGS, pca_mode="auto", elastic_checkpoint=True,
              checkpoint_every=1)
    with _open("port", servers["port"]) as src:
        g = VariantsPcaDriver(
            PcaConfig(device="cpu", checkpoint_dir=str(tmp_path / "p"),
                      **ck), src,
        ).ingest_gramian().numpy()
    with _open("jax", servers["port"]) as src:
        want = JaxDriver(JaxConfig(checkpoint_dir=str(tmp_path / "j"), **ck),
                         src).ingest_gramian()
    with _open("jax", servers["jax"]) as src:
        resumed = JaxDriver(
            JaxConfig(checkpoint_dir=str(tmp_path / "p"), **ck), src
        ).ingest_gramian()
    assert "Elastic resume:" in capsys.readouterr().out
    np.testing.assert_array_equal(g, np.asarray(want))
    np.testing.assert_array_equal(g, np.asarray(resumed))


def test_a_taken_port_is_a_loud_bind_error():
    import socket

    with socket.socket() as taken:  # no SO_REUSEPORT: the port is held
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        with pytest.raises(IOError, match="cannot bind"):
            grpc_transport.GrpcGenomicsServer(
                synthetic_cohort(4, 10, seed=1), port=taken.getsockname()[1])


# -- metrics ------------------------------------------------------------------


def _grpc_counters(pkg_obs, pkg_plan, plan_cls, client, indexes):
    plan = plan_cls.from_spec(json.dumps({"rules": [
        {"site": "transport.grpc.request", "match": "StreamVariantFrames"}]}))
    with pkg_obs.telemetry_session() as session, pkg_plan(plan), \
            contextlib.redirect_stdout(io.StringIO()):
        client.list_callsets(VSID)
        for shard in _shards():
            client.stream_carrying_csr(VSID, shard, indexes)
        snap = session.registry.snapshot()
    return snap


def test_grpc_metrics_carry_the_jax_packages_names_and_labels(servers,
                                                             cohort_dir):
    indexes = _indexes(cohort_dir)
    with _open("port", servers["port"]) as port, \
            _open("jax", servers["port"]) as ref:
        got = _grpc_counters(obs, active_plan, FaultPlan, port, indexes)
        want = _grpc_counters(jax_obs, jax_active_plan, JaxFaultPlan, ref,
                              indexes)

    def series(snap):
        out = {}
        for kind in ("counters", "histograms"):
            for key, value in snap[kind].items():
                if "grpc" in key:
                    out[key] = value if kind == "counters" else None
        return out

    assert series(got) and series(got) == series(want)
    assert 'wire_frames_total{transport="grpc"}' in got["counters"]
    assert any(k.startswith("genomics_rpc_latency_seconds")
               and 'transport="grpc"' in k for k in got["histograms"])
    assert got["counters"][
        'genomics_rpc_retries_total{method="StreamVariantFrames",'
        'transport="grpc"}'] == 1


@pytest.mark.parametrize("argv", [
    ["pca", "--api-url", "grpc://127.0.0.1:1"],
    ["serve-cohort", "--fixture-samples", "4", "--grpc-port", "0"],
], ids=["api-url", "grpc-port"])
def test_without_grpcio_both_clis_exit_with_the_same_message(argv,
                                                             monkeypatch):
    from spark_examples_tpu.cli import main as jax_cli
    from spark_examples_tpu_torch.cli import main as cli

    monkeypatch.setattr(grpc_transport, "grpc_available", lambda: False)
    monkeypatch.setattr(jax_grpc, "grpc_available", lambda: False)
    monkeypatch.delenv("GENOMICS_APPLICATION_CREDENTIALS", raising=False)
    with pytest.raises(SystemExit) as port:
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(argv)
    assert str(port.value) == str(ref.value) and "grpcio" in str(
        port.value)


# -- reads --------------------------------------------------------------------

READ_REFS = "11:6888648:6890648"
READ_BASES = 500


@pytest.fixture(scope="module")
def reads_servers(tmp_path_factory, request):
    """Each package's gRPC server over one reads directory and over its
    own fixture of the same records: ({(package, kind): url}, dir)."""
    root = str(tmp_path_factory.mktemp("grpc_reads"))
    src = synthetic_cohort(8, 40, seed=5)
    src.add_reads(
        synthetic_reads(150, references=READ_REFS, seed=6).reads_records())
    src.dump(root)
    return {
        ("port", "jsonl"): _serve(grpc_transport.GrpcGenomicsServer,
                                  JsonlSource(root), request),
        ("jax", "jsonl"): _serve(jax_grpc.GrpcGenomicsServer,
                                 JaxJsonlSource(root), request),
        ("port", "fixture"): _serve(
            grpc_transport.GrpcGenomicsServer,
            synthetic_reads(150, references=READ_REFS, seed=6), request),
        ("jax", "fixture"): _serve(
            jax_grpc.GrpcGenomicsServer,
            jax_synthetic_reads(150, references=READ_REFS, seed=6), request),
    }, root


def _reads(source, rgsid):
    return [[vars(r) for r in source.stream_reads(rgsid, shard)]
            for shard in shards_for_references(READ_REFS, READ_BASES)]


@pytest.mark.parametrize("kind", ["jsonl", "fixture"])
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_every_client_streams_reads_from_every_server(
        reads_servers, server_pkg, client_pkg, kind):
    urls, root = reads_servers
    local = JsonlSource(root)
    with _open(client_pkg, urls[server_pkg, kind]) as src, \
            _open("port", urls["port", "jsonl"]) as ref:
        for rgsid in ("", "fixture-readset", "another-readset"):
            got = _reads(src, rgsid)
            assert got == _reads(local, rgsid)
            assert sum(map(len, got)) == (
                0 if rgsid == "another-readset" else 150)
            _reads(ref, rgsid)
        assert _stats(src) == _stats(ref)
        assert src.stats.reads_read == 300
