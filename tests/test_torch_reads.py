"""The port's reads ops and the four reads examples against the JAX package's.

The same numpy-seeded inputs go through both packages in one process:
``encode_bases``, ``per_base_depth`` and ``base_frequency_table`` must be
bit-identical (negative starts, reads past the window, quality −1, code 5),
and the four ``SearchReadsExample`` drivers must print the same bytes and
write the same ``coverage_<chr>`` and ``diff_<chr>`` files at several
``--bases-per-partition`` values, with reads longer than the 512-base row
cap. The port computes on the CPU here (``device="cpu"``).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from spark_examples_tpu.cli.main import main as jax_main
from spark_examples_tpu.genomics import fixtures as jax_fixtures
from spark_examples_tpu.genomics.sources import (
    FixtureSource as JaxFixtureSource,
)
from spark_examples_tpu.genomics.sources import JsonlSource as JaxJsonlSource
from spark_examples_tpu.models import search_reads as jax_sr
from spark_examples_tpu.ops import reads_ops as jax_ops
from spark_examples_tpu_torch.cli.main import main
from spark_examples_tpu_torch.genomics import fixtures
from spark_examples_tpu_torch.genomics.shards import shards_for_references
from spark_examples_tpu_torch.genomics.sources import (
    FixtureSource,
    JsonlSource,
)
from spark_examples_tpu_torch.models import search_reads as sr
from spark_examples_tpu_torch.ops import reads_ops
from spark_examples_tpu_torch.utils.stats import COUNTER_FIELDS

SNP = sr.Examples.CILANTRO
PILEUP_REFS = f"11:{SNP - 1000}:{SNP + 1000}"
TN_REFS = "1:100000000:100003000"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the ops ------------------------------------------------------------------


def test_encode_bases_is_the_jax_packages():
    for seq in ("ACGTNacgtnX", "", "N" * 7, "acgt" * 33 + "RYKM-*."):
        got = reads_ops.encode_bases(seq)
        want = jax_ops.encode_bases(seq)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert reads_ops.BASE_CODES == jax_ops.BASE_CODES


@pytest.mark.parametrize("seed", range(4))
def test_per_base_depth_bit_identical(seed):
    rng = np.random.default_rng(seed)
    region = int(rng.integers(64, 700))
    n = int(rng.integers(1, 300))
    # Negative starts, reads past the window's end and padding slots.
    starts = rng.integers(-150, region + 50, size=n).astype(np.int32)
    lengths = rng.integers(0, 160, size=n).astype(np.int32)
    lengths[rng.random(n) < 0.1] = 0
    got = reads_ops.per_base_depth(_t(starts), _t(lengths), region)
    want = np.asarray(jax_ops.per_base_depth(starts, lengths, region))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert want.any()


def test_per_base_depth_edges():
    starts = np.array([-10, -5, 0, 95, 100, 130, 40], np.int32)
    lengths = np.array([5, 20, 0, 10, 3, 7, 60], np.int32)
    got = reads_ops.per_base_depth(_t(starts), _t(lengths), 100).numpy()
    want = np.asarray(jax_ops.per_base_depth(starts, lengths, 100))
    assert np.array_equal(got, want)
    assert got[:15].tolist() == [1] * 15 and got[99] == 2


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_qual", [0, 30])
def test_base_frequency_table_bit_identical(seed, min_qual):
    rng = np.random.default_rng(100 + seed)
    region = int(rng.integers(50, 400))
    n, length = int(rng.integers(1, 64)), int(rng.integers(1, 80))
    starts = rng.integers(-40, region + 20, size=n).astype(np.int32)
    # Codes 0-4 are bases, 5 the beyond-sequence padding, -1 absent.
    codes = rng.integers(-1, 6, size=(n, length)).astype(np.int8)
    quals = rng.integers(-1, 60, size=(n, length)).astype(np.int32)
    quals[0, :] = -1
    got = reads_ops.base_frequency_table(
        _t(starts), _t(codes), _t(quals), min_qual, region
    )
    want = np.asarray(
        jax_ops.base_frequency_table(starts, codes, quals, min_qual, region)
    )
    assert got.shape == (region, 5) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.any()


# -- the four examples --------------------------------------------------------


def _reads_pair(n, refs, seed, **kw):
    return (
        fixtures.synthetic_reads(n, references=refs, seed=seed, **kw),
        jax_fixtures.synthetic_reads(n, references=refs, seed=seed, **kw),
    )


@pytest.mark.parametrize("bases", [300, 1000, 1_000_000])
def test_pileup_prints_the_jax_packages_lines(bases):
    port, ref = _reads_pair(200, PILEUP_REFS, 2)
    got = sr.pileup(port, "fixture-readset", snp=SNP, bases_per_shard=bases)
    want = jax_sr.pileup(ref, "fixture-readset", snp=SNP,
                         bases_per_shard=bases)
    assert got == want and len(got) > 2


@pytest.mark.parametrize("bases", [300, 1000, 1_000_000])
def test_average_coverage_prints_the_jax_packages_line(bases, capsys):
    port, ref = _reads_pair(150, "21:0:10000", 3)
    got = sr.average_coverage(port, "fixture-readset",
                              references="21:0:10000",
                              bases_per_shard=bases)
    port_out = capsys.readouterr().out
    want = jax_sr.average_coverage(ref, "fixture-readset",
                                   references="21:0:10000",
                                   bases_per_shard=bases)
    assert got == want and port_out == capsys.readouterr().out
    assert port_out.startswith("Coverage of chromosome 21 = ")


@pytest.mark.parametrize("bases", [250, 700, 1_000_000])
@pytest.mark.parametrize("read_len", [100, 700])
def test_depth_file_is_the_jax_packages(bases, read_len, tmp_path):
    refs = "11:6888648:6891648"
    port, ref = _reads_pair(120, refs, 5, read_len=read_len)
    got = sr.per_base_depth_example(
        port, "fixture-readset", references=refs,
        out_path=str(tmp_path / "port"), bases_per_shard=bases,
        device="cpu",
    )
    want = jax_sr.per_base_depth_example(
        ref, "fixture-readset", references=refs,
        out_path=str(tmp_path / "jax"), bases_per_shard=bases,
    )
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
        want, tmp_path / "jax") == os.path.join("coverage_11", "part-00000")
    data = open(got, "rb").read()
    assert data == open(want, "rb").read() and data.count(b"\n") > 1000


def _long_tumor_normal(pkg, n, seed):
    """Normal and tumor readsets of 700-base reads (past the 512-base row
    cap) with somatic alts, as one source of ``pkg``."""
    fx = fixtures if pkg == "port" else jax_fixtures
    somatic = {100000900: ("A", 0.7), 100001700: ("C", 0.7),
               100002400: ("G", 0.7)}
    normal = fx.synthetic_reads(
        n, references=TN_REFS, read_len=700, seed=seed,
        read_group_set_id=fx.NORMAL_READSET_ID)
    tumor = fx.synthetic_reads(
        n, references=TN_REFS, read_len=700, seed=seed,
        read_group_set_id=fx.TUMOR_READSET_ID, variant_positions=somatic)
    cls = FixtureSource if pkg == "port" else JaxFixtureSource
    return cls(reads=normal.reads_records() + tumor.reads_records())


@pytest.mark.parametrize("bases", [400, 1000, 1_000_000])
@pytest.mark.parametrize("long_reads", [False, True], ids=["100bp", "700bp"])
def test_diff_file_is_the_jax_packages(bases, long_reads, tmp_path):
    if long_reads:
        port = _long_tumor_normal("port", 80, 9)
        ref = _long_tumor_normal("jax", 80, 9)
    else:
        port = fixtures.synthetic_tumor_normal(300, references=TN_REFS,
                                               seed=4)
        ref = jax_fixtures.synthetic_tumor_normal(300, references=TN_REFS,
                                                  seed=4)
    kw = dict(normal_id="fixture-normal", tumor_id="fixture-tumor",
              references=TN_REFS, bases_per_shard=bases)
    got = sr.tumor_normal_diff(port, out_path=str(tmp_path / "port"),
                               device="cpu", **kw)
    want = jax_sr.tumor_normal_diff(ref, out_path=str(tmp_path / "jax"),
                                    **kw)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read() and data
    if not long_reads:
        for pos in port.somatic_positions:
            assert f"({pos},".encode() in data


def test_freq_strings_count_beyond_the_row_cap():
    refs = "1:100000000:100003000"
    port = fixtures.synthetic_reads(60, references=refs, read_len=700,
                                    seed=17)
    args = (port, "fixture-readset", refs, 1_000_000, 30, 30, 0.25,
            torch.device("cpu"))
    capped = sr._freq_strings(*args, read_len_cap=512)
    assert capped == sr._freq_strings(*args, read_len_cap=4096)
    ref = jax_fixtures.synthetic_reads(60, references=refs, read_len=700,
                                       seed=17)
    assert capped == jax_sr._freq_strings(
        ref, "fixture-readset", refs, 1_000_000, 30, 30, 0.25)


def test_windowed_arrays_carry_the_overhang_as_the_jax_package_does():
    refs = "11:6888648:6889648"
    port, ref = _reads_pair(40, refs, 8, read_len=300)

    def compute(shard, reads, pad):
        arr = np.zeros(shard.range + pad, np.int64)
        for r in reads:
            off = r.position - shard.start
            arr[off:off + len(r.aligned_sequence)] += 1
        return arr

    for bases in (97, 250, 400):
        got = [(s.contig, s.start, s.end, a.tolist()) for s, a in
               sr._windowed_arrays(port, "", refs, bases, compute)]
        want = [(s.contig, s.start, s.end, a.tolist()) for s, a in
                jax_sr._windowed_arrays(ref, "", refs, bases, compute)]
        assert got == want and len(got) > 1


def test_examples_3_and_4_need_the_card_unless_asked(tmp_path):
    src = fixtures.synthetic_reads(10, references=PILEUP_REFS)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sr.per_base_depth_example(src, "", references=PILEUP_REFS,
                                  out_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sr.tumor_normal_diff(src, references=PILEUP_REFS,
                             out_path=str(tmp_path))
    # Examples 1 and 2 do no device work.
    assert sr.pileup(src, "", snp=SNP) is not None


# -- the sources --------------------------------------------------------------


def _as_dicts(reads):
    return [vars(r) for r in reads]


def test_jsonl_reads_stream_as_the_jax_packages(tmp_path):
    port, ref = _reads_pair(120, PILEUP_REFS, 11)
    port.dump(str(tmp_path / "port"))
    ref.dump(str(tmp_path / "jax"))
    for name in ("callsets.json", "variants.jsonl", "reads.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()
    jsonl = JsonlSource(str(tmp_path / "port"))
    jax_jsonl = JaxJsonlSource(str(tmp_path / "port"))
    for rgsid in ("", "fixture-readset", "other"):
        for shard in shards_for_references(PILEUP_REFS, 500):
            got = _as_dicts(port.stream_reads(rgsid, shard))
            assert got == _as_dicts(ref.stream_reads(rgsid, shard))
            assert _as_dicts(jsonl.stream_reads(rgsid, shard)) == got
            assert _as_dicts(jax_jsonl.stream_reads(rgsid, shard)) == got
    for a, b in ((port, ref), (jsonl, jax_jsonl)):
        assert [getattr(a.stats, f) for f in COUNTER_FIELDS] == [
            getattr(b.stats, f) for f in COUNTER_FIELDS]
    assert port.stats.reads_read == 240


# -- the CLI ------------------------------------------------------------------


def _run(fn, argv, cwd):
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = fn(argv)
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("example,refs,bases", [
    (1, None, "400"),
    (2, "11:6888648:6890648", "700"),
    (3, "11:6888648:6890648", "333"),
    (4, "1:100000000:100002000", "500"),
])
def test_cli_examples_match_byte_for_byte(example, refs, bases, tmp_path):
    argv = ["reads-example", "--example", str(example), "--fixture-reads",
            "300", "--bases-per-partition", bases, "--output-path", "out"]
    if refs:
        argv += ["--references", refs]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _run(main, argv + ["--device", "cpu"], tmp_path / "port")
    want = _run(jax_main, argv, tmp_path / "jax")
    assert got[0] == want[0] == 0
    assert got[1] == want[1] and got[1]
    for sub in ("coverage_11", "diff_1"):
        p = tmp_path / "port" / "out" / sub / "part-00000"
        j = tmp_path / "jax" / "out" / sub / "part-00000"
        assert p.exists() == j.exists()
        if p.exists():
            assert p.read_bytes() == j.read_bytes()


def test_cli_warns_when_no_reads_matched(tmp_path):
    fixtures.synthetic_reads(20, references=PILEUP_REFS).dump(
        str(tmp_path / "cohort"))
    argv = ["reads-example", "--example", "2", "--input-path",
            str(tmp_path / "cohort"), "--references", "21:0:1000"]
    rc, out, err = _run(main, argv, tmp_path)
    assert rc == 0 and "Coverage of chromosome 21 = 0.0" in out
    assert "WARNING: no reads matched" in err
    assert err == _run(jax_main, argv, tmp_path)[2]


def test_cli_without_a_reads_source_exits():
    with pytest.raises(SystemExit, match="No reads source"):
        main(["reads-example", "--example", "3"])
    with pytest.raises(SystemExit, match="No reads source"):
        main(["reads-example", "--example", "4"])


@pytest.mark.parametrize("flags", [
    ["--fixture-reads", "50", "--reads-references", "11:6888648:6890648"],
    ["--fixture-tumor-normal", "40"],
])
def test_generate_fixture_writes_the_jax_packages_directory(flags, tmp_path):
    argv = ["generate-fixture", "--fixture-samples", "6",
            "--fixture-variants", "20", "--fixture-seed", "3"] + flags
    assert _run(main, argv + ["--out", str(tmp_path / "port")],
                tmp_path)[0] == 0
    assert _run(jax_main, argv + ["--out", str(tmp_path / "jax")],
                tmp_path)[0] == 0
    for name in ("callsets.json", "variants.jsonl", "reads.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "port" / "reads.jsonl").stat().st_size > 0
