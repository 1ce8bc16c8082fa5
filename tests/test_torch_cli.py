"""The port's smaller CLI commands and refusals against the JAX package's.

``generate-fixture`` must write the JAX package's cohort directory byte for
byte and print the same line; ``search-variants-klotho`` and
``-brca1`` must print the same report from the same records (the fixture
of ``tests/test_search_variants.py`` and a served cohort). Options this
slice does not serve raise ``NotImplementedError`` naming their ROADMAP.md
item, before any request.
"""

import filecmp
import json
import os

import pytest
import torch

from spark_examples_tpu.cli import main as jax_cli
from spark_examples_tpu.genomics.sources import (
    FixtureSource as JaxFixtureSource,
)
from spark_examples_tpu.models import search_variants as jax_sv
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.service import GenomicsServiceServer
from spark_examples_tpu_torch.genomics.sources import (
    FixtureSource,
    JsonlSource,
)
from spark_examples_tpu_torch.models import search_variants as sv

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


@pytest.mark.parametrize(
    "argv,item",
    [
        (["pca", "--api-url", "grpc://127.0.0.1:1"], "item 2"),
        (["pca", "--api-url", "http://127.0.0.1:1", "--cache-dir", "c"],
         "item 2"),
        (["pca", "--fixture-samples", "4", "--mirror-mode", "light"],
         "item 2"),
        (["pca", "--fixture-samples", "4", "--cache-dir", "c"], "item 2"),
        (["serve-cohort", "--fixture-samples", "4", "--grpc-port", "0"],
         "item 2"),
        (["serve-cohort", "--fixture-samples", "4", "--analyze"], "item 6"),
        (["pca", "--fixture-samples", "4", "--mesh-shape", "data:2"],
         "item 7"),
        (["pca", "--fixture-samples", "4", "--checkpoint-dir", "c"],
         "item 8"),
    ],
    ids=["grpc", "cache-dir-network", "mirror-mode", "cache-dir-offline",
         "grpc-port", "analyze", "mesh", "checkpoint"],
)
def test_unserved_options_name_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main([*argv, "--device", "cpu"])


def test_flags_keep_the_jax_packages_names_and_defaults():
    port = vars(cli.build_parser().parse_args(["pca"]))
    ref = vars(jax_cli.build_parser().parse_args(["pca"]))
    for name in ("api_url", "client_secrets", "cache_dir", "mirror_mode",
                 "cold_stream", "rpc_retries", "rpc_retry_deadline",
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
