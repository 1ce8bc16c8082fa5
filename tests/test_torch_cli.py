"""The port's smaller CLI commands and refusals against the JAX package's.

``generate-fixture`` must write the JAX package's cohort directory byte for
byte and print the same line; ``search-variants-klotho`` and
``-brca1`` must print the same report from the same records (the fixture
of ``tests/test_search_variants.py`` and a served cohort). Options of later
ROADMAP.md items raise ``NotImplementedError`` naming their item, before any
request; the gRPC and mirror options run as the JAX CLI's do.
"""

import filecmp
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from spark_examples_tpu.cli import main as jax_cli
from spark_examples_tpu.genomics.sources import (
    FixtureSource as JaxFixtureSource,
)
from spark_examples_tpu.models import search_variants as jax_sv
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import synthetic_cohort
from spark_examples_tpu_torch.genomics.service import GenomicsServiceServer
from spark_examples_tpu_torch.genomics.sources import (
    FixtureSource,
    JsonlSource,
)
from spark_examples_tpu_torch.models import search_variants as sv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KLOTHO_RECORDS = [
    {"reference_name": "chr13", "start": 33628137, "end": 33628138,
     "reference_bases": "T", "alternate_bases": ["G"],
     "variant_set_id": "vs",
     "calls": [{"callset_id": "c1", "genotype": [0, 1]}]},
    {"reference_name": "chr13", "start": 33628137, "end": 33628200,
     "reference_bases": "N", "variant_set_id": "vs", "calls": []},
    {"reference_name": "chr17", "start": 41196400, "end": 41196401,
     "reference_bases": "A", "alternate_bases": ["C"],
     "variant_set_id": "vs"},
    {"reference_name": "chr17", "start": 41196500, "end": 41196600,
     "reference_bases": "N", "variant_set_id": "vs"},
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize(
    "args",
    [
        ["--fixture-samples", "12", "--fixture-variants", "40"],
        ["--fixture-samples", "9", "--fixture-variants", "30",
         "--fixture-seed", "4", "--fixture-sparse-calls",
         "--fixture-rare-af", "0.05", "--variant-set-id", "vsX",
         "--references", "13:33628000:33629000"],
    ],
    ids=["default", "options"],
)
def test_generate_fixture_writes_the_jax_packages_directory(
        tmp_path, capsys, args):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert cli.main(["generate-fixture", *args, "--out", str(port_dir)]) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(["generate-fixture", *args, "--out",
                         str(jax_dir)]) == 0
    jax_out = capsys.readouterr().out
    assert port_out.replace(str(port_dir), "D") == jax_out.replace(
        str(jax_dir), "D")
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "callsets.json", "variants.jsonl"]
    match, mismatch, errors = filecmp.cmpfiles(
        port_dir, jax_dir, ["callsets.json", "variants.jsonl"],
        shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("which", ["klotho", "brca1"])
def test_search_variants_reports_match(which, capsys):
    port = getattr(sv, f"search_variants_{which}")(
        FixtureSource(variants=KLOTHO_RECORDS), "vs")
    port_out = capsys.readouterr().out
    ref = getattr(jax_sv, f"search_variants_{which}")(
        JaxFixtureSource(variants=KLOTHO_RECORDS), "vs")
    assert port == ref and port_out == capsys.readouterr().out
    assert port[0].startswith("We have 2 records")


@pytest.mark.parametrize(
    "command", ["search-variants-klotho", "search-variants-brca1"])
def test_search_variants_cli_prints_the_jax_report(command, capsys):
    args = [command, "--fixture-samples", "16", "--fixture-variants", "300",
            "--fixture-seed", "2"]
    assert cli.main(args) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    assert port_out == capsys.readouterr().out
    assert port_out.startswith("We have ")


def test_search_variants_over_the_network(tmp_path, capsys, monkeypatch):
    FixtureSource(variants=KLOTHO_RECORDS).dump(str(tmp_path))
    server = GenomicsServiceServer(JsonlSource(str(tmp_path))).start()
    try:
        monkeypatch.delenv("GENOMICS_APPLICATION_CREDENTIALS",
                           raising=False)
        args = ["search-variants-klotho", "--variant-set-id", "vs",
                "--api-url", f"http://127.0.0.1:{server.port}",
                "--rpc-retries", "1"]
        assert cli.main(args) == 0
        port_out = capsys.readouterr().out
        assert jax_cli.main(args) == 0
        assert port_out == capsys.readouterr().out
    finally:
        server.stop()
    assert "We have 2 records that overlap Klotho." in port_out


def _served_cohort(tmp_path, request):
    """A small cohort on disk behind the port's HTTP server (no token)."""
    root = str(tmp_path / "cohort")
    synthetic_cohort(24, 120, seed=5, population_structure=3).dump(root)
    served = JsonlSource(root)
    served.ensure_serving_index()
    server = GenomicsServiceServer(served, port=0).start()
    request.addfinalizer(server.stop)
    return root, f"http://127.0.0.1:{server.port}"


def _pca_lines(argv, capsys):
    """The result lines of one port ``pca`` run (the I/O report, which
    counts requests, differs by source)."""
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return [line for line in capsys.readouterr().out.splitlines()
            if line.count("\t") == 3 or line.startswith("Non zero rows")]


def _served_grpc(tmp_path, capsys, monkeypatch, request):
    # A dead gRPC endpoint fails as it fails in the JAX CLI: the first
    # call (the callset table) surfaces UNAVAILABLE as an IOError.
    monkeypatch.delenv("GENOMICS_APPLICATION_CREDENTIALS", raising=False)
    argv = ["pca", "--api-url", "grpc://127.0.0.1:1", "--rpc-retries", "1"]
    with pytest.raises(IOError) as port:
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(IOError) as ref:
        jax_cli.main(argv)
    assert str(port.value).split(":")[:2] == str(ref.value).split(":")[:2]
    assert str(port.value).startswith("ListCallsets: UNAVAILABLE")


def _served_mirror(mode, tmp_path, capsys, monkeypatch, request):
    monkeypatch.delenv("GENOMICS_APPLICATION_CREDENTIALS", raising=False)
    root, url = _served_cohort(tmp_path, request)
    base = ["pca", "--bases-per-partition", "20000",
            "--references", "17:41196311:41277499"]
    want = _pca_lines([*base, "--input-path", root], capsys)
    cache = tmp_path / "cache"
    argv = [*base, "--api-url", url, "--cache-dir", str(cache),
            "--mirror-mode", mode]
    assert _pca_lines(argv, capsys) == want  # cold: streamed
    # The write-through mirror lands in the background; wait for it.
    deadline = time.monotonic() + 60
    while not list(cache.glob("cohort-*/.complete")):
        assert time.monotonic() < deadline, "the mirror never completed"
        time.sleep(0.05)
    assert _pca_lines(argv, capsys) == want  # warm: from the mirror
    (mirror,) = [d for d in os.listdir(cache) if d.startswith("cohort-")]
    names = set(os.listdir(cache / mirror))
    assert {".complete", ".identity", ".sidecar-ok", "callsets.json",
            ".variants.csr.npz"} <= names
    assert ("variants.jsonl" in names) == (mode == "full")


def _served_cache_dir_offline(tmp_path, capsys, monkeypatch, request):
    # Offline sources ignore --cache-dir, as the JAX CLI's do.
    base = ["pca", "--fixture-samples", "12", "--fixture-variants", "40"]
    cache = tmp_path / "c"
    assert _pca_lines([*base, "--cache-dir", str(cache)],
                      capsys) == _pca_lines(base, capsys)
    assert not cache.exists()
    args = [*base, "--cache-dir", str(cache)]
    refs = "17:41196311:41277499"
    port = cli._resolve_source(cli.build_parser().parse_args(args), refs)
    ref = jax_cli._resolve_source(jax_cli.build_parser().parse_args(args),
                                  refs)
    assert type(port).__name__ == type(ref).__name__ == "FixtureSource"
    assert not cache.exists()


def _served_grpc_port(tmp_path, capsys, monkeypatch, request):
    from spark_examples_tpu.genomics.grpc_transport import (
        GrpcVariantSource as JaxGrpcVariantSource,
    )
    from spark_examples_tpu_torch.genomics.grpc_transport import (
        GrpcVariantSource,
    )

    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
         "serve-cohort", "--fixture-samples", "12", "--fixture-variants",
         "40", "--port", "0", "--grpc-port", "0"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        urls = {}
        for line in proc.stdout:
            for scheme in ("grpc", "http"):
                if f" on {scheme}://" in line:
                    urls[scheme] = line.split(" on ", 1)[1].split()[0]
            if len(urls) == 2:
                break
        assert set(urls) == {"grpc", "http"}, "serve-cohort did not listen"
        want = [c.id for c in synthetic_cohort(12, 40).list_callsets("")]
        for client_cls in (GrpcVariantSource, JaxGrpcVariantSource):
            client = client_cls(urls["grpc"], timeout=30)
            try:
                assert [c.id for c in client.list_callsets("")] == want
            finally:
                client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0  # both servers stopped
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def _served_analyze(tmp_path, capsys, monkeypatch, request):
    """``serve-cohort --analyze`` (item 6, served now): a ``{}`` job over
    HTTP, its rows within 1e-4 of the JAX package's engine on the same
    fixture, the flight recorder beside the journal, a clean SIGINT."""
    import http.client

    import numpy as np

    from spark_examples_tpu.genomics.fixtures import (
        DEFAULT_VARIANT_SET_ID,
        synthetic_cohort as jax_synthetic_cohort,
    )
    from spark_examples_tpu.serving import AnalysisEngine as JaxEngine
    from spark_examples_tpu.utils.config import PcaConfig as JaxConfig

    journal = str(tmp_path / "journal")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
         "serve-cohort", "--fixture-samples", "12", "--fixture-variants",
         "200", "--port", "0", "--analyze", "--analyze-journal-dir",
         journal, "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url, lines = None, []
        for line in proc.stdout:
            lines.append(line)
            if " on http://" in line:
                url = line.split(" on http://", 1)[1].split()[0]
                break
        assert url, "serve-cohort did not listen: " + "".join(lines)
        assert any(l.startswith("Analysis tier up:") for l in lines)
        host, port = url.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("POST", "/analyze", body=b"{}")
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        assert resp.status == 202, doc
        deadline = time.time() + 120
        while doc["state"] not in ("done", "failed"):
            assert time.time() < deadline
            time.sleep(0.05)
            conn.request("GET", f"/jobs/{doc['id']}")
            doc = json.loads(conn.getresponse().read())
        assert doc["state"] == "done", doc
        conn.close()
        want = JaxEngine(jax_synthetic_cohort(12, 200)).run(
            JaxConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID])
        )
        got = [tuple(r) for r in doc["result"]]
        assert [r[0] for r in got] == [r[0] for r in want]
        assert np.abs(
            np.array([r[1:3] for r in got], float)
            - np.array([r[1:3] for r in want], float)
        ).max() <= 1e-4
        assert os.path.isdir(os.path.join(journal, "flightrec"))
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


_SERVED = {
    "grpc": _served_grpc,
    "cache-dir-network": lambda *a: _served_mirror("full", *a),
    "mirror-mode": lambda *a: _served_mirror("light", *a),
    "cache-dir-offline": _served_cache_dir_offline,
    "grpc-port": _served_grpc_port,
    "analyze": _served_analyze,
}


@pytest.mark.parametrize(
    "case,argv,item",
    [
        pytest.param(case, argv, item, id=case)
        for case, argv, item in [
            ("grpc", None, None),
            ("cache-dir-network", None, None),
            ("mirror-mode", None, None),
            ("cache-dir-offline", None, None),
            ("grpc-port", None, None),
            ("analyze", None, None),
            ("mesh",
             ["pca", "--fixture-samples", "4", "--mesh-shape", "data:2",
              "--pca-mode", "sketch"],
             "item 7"),
            ("checkpoint",
             ["pca", "--fixture-samples", "4", "--checkpoint-dir", "c",
              "--elastic-checkpoint"],
             "item 8"),
        ]
    ],
)
def test_unserved_options_name_their_roadmap_item(
        case, argv, item, request, tmp_path, capsys, monkeypatch):
    """Options of later items raise naming their item. The item-2 options
    (gRPC and the cohort mirror) and item 6's ``serve-cohort --analyze``
    are served now: each case runs them and holds them to the JAX CLI. Of
    item 7 the sketch under ``--mesh-shape`` is refused (the mesh itself
    runs: ``tests/test_torch_parallel_pipeline.py``); of item 8 only
    ``--elastic-checkpoint`` is refused; ``--checkpoint-dir`` runs
    (``test_checkpointed_pca_prints_the_jax_clis_rows``)."""
    if item is None:
        _SERVED[case](tmp_path, capsys, monkeypatch, request)
        return
    with pytest.raises(NotImplementedError, match=item):
        cli.main([*argv, "--device", "cpu"])


def test_flags_keep_the_jax_packages_names_and_defaults():
    port = vars(cli.build_parser().parse_args(["pca"]))
    ref = vars(jax_cli.build_parser().parse_args(["pca"]))
    for name in ("api_url", "client_secrets", "cache_dir", "mirror_mode",
                 "cold_stream", "rpc_retries", "rpc_retry_deadline",
                 "grpc_idle_timeout",
                 "breaker_threshold", "breaker_cooldown", "fault_plan",
                 "trace_out", "metrics_out", "manifest_out"):
        assert port[name] == ref[name], name
    port = vars(cli.build_parser().parse_args(["serve-cohort"]))
    ref = vars(jax_cli.build_parser().parse_args(["serve-cohort"]))
    for name in ("port", "host", "token", "grpc_port", "analyze"):
        assert port[name] == ref[name], name


def test_a_fault_plan_flag_scopes_to_the_command(tmp_path, capsys):
    from spark_examples_tpu_torch.resilience import faults

    plan = json.dumps({"rules": [{"site": "transport.http.request"}]})
    assert cli.main(["generate-fixture", "--fixture-samples", "4",
                     "--fixture-variants", "5", "--out", str(tmp_path),
                     "--fault-plan", plan]) == 0
    capsys.readouterr()
    assert faults.current_plan() is None


_CK_ARGS = ["pca", "--fixture-samples", "24", "--fixture-variants", "300",
            "--fixture-seed", "5", "--bases-per-partition", "20000",
            "--block-variants", "32"]


def _tsv_rows(out):
    return [line.split("\t") for line in out.splitlines()
            if line.count("\t") == 3]


def test_checkpointed_pca_prints_the_jax_clis_rows(tmp_path, capsys):
    """``pca --checkpoint-dir --checkpoint-every`` runs on the port: the
    rows equal the uncheckpointed run's within 1e-4 and the JAX CLI's; a
    rerun resumes from the snapshot (every shard done) and prints the JAX
    CLI's resume line."""
    ck = ["--checkpoint-dir", str(tmp_path / "p"), "--checkpoint-every", "2"]
    assert cli.main([*_CK_ARGS, *ck, "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert cli.main([*_CK_ARGS, "--device", "cpu"]) == 0
    plain_out = capsys.readouterr().out
    assert jax_cli.main([*_CK_ARGS, "--checkpoint-dir", str(tmp_path / "j"),
                         "--checkpoint-every", "2"]) == 0
    jax_out = capsys.readouterr().out
    port, plain, jax = (_tsv_rows(o) for o in (port_out, plain_out, jax_out))
    assert len(port) == 24
    for other in (plain, jax):
        assert [(r[0], r[1]) for r in port] == [(r[0], r[1]) for r in other]
        for a, b in zip(port, other):
            assert abs(float(a[2]) - float(b[2])) <= 1e-4
            assert abs(float(a[3]) - float(b[3])) <= 1e-4
    assert os.path.exists(tmp_path / "p" / "gramian_snapshot.npz")
    assert cli.main([*_CK_ARGS, *ck, "--device", "cpu"]) == 0
    again = capsys.readouterr().out
    assert "Resuming from snapshot: 5/5 shards done." in again
    assert _tsv_rows(again) == port


def test_the_new_flags_have_the_jax_clis_defaults():
    for argv in (["pca"], ["serve-cohort"], ["pca-bridge"]):
        port = cli.build_parser().parse_args(argv)
        jax = jax_cli.build_parser().parse_args(argv)
        for name in ("checkpoint_dir", "checkpoint_every",
                     "elastic_checkpoint", "trace_dir"):
            assert getattr(port, name) == getattr(jax, name), (argv, name)
    port = cli.build_parser().parse_args(["pca-bridge"]).port
    assert port == jax_cli.build_parser().parse_args(["pca-bridge"]).port
    assert port == 18717


def test_trace_dir_writes_a_profiler_trace(tmp_path, capsys):
    """``pca --trace-dir d --device cpu`` writes a ``*.pt.trace.json``
    holding the ``ingest+gramian`` stage's range and the ranges of the
    dense route's ingest spans inside it."""
    trace_dir = tmp_path / "trace"
    assert cli.main([*_CK_ARGS, "--device", "cpu", "--trace-dir",
                     str(trace_dir)]) == 0
    capsys.readouterr()
    traces = [f for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(trace_dir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ingest+gramian", "pca", "emit", "ingest.pack",
            "gramian.accumulate"} <= names
    stage = next(e for e in events if e.get("name") == "ingest+gramian")
    inside = [e for e in events if e.get("name") == "gramian.accumulate"
              and stage["ts"] <= e["ts"] <= stage["ts"] + stage["dur"]]
    assert inside


def test_pca_bridge_serves_the_c_plus_plus_client(tmp_path):
    """``pca-bridge --device cpu`` in a subprocess answers the JAX repo's
    C++ example client unchanged."""
    import shutil
    import socket

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    binary = tmp_path / "pca_bridge_client"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-o", str(binary),
         os.path.join(ROOT, "examples", "pca_bridge_client.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main",
         "pca-bridge", "--port", str(port), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert f"PcaBackend bridge listening on 127.0.0.1:{port}" in line
        out = subprocess.run([str(binary), str(port)], capture_output=True,
                             timeout=120, text=True)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "bridge ok" in out.stdout
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
