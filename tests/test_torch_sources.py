"""The port's on-disk cohort tier against the JAX package's.

Both packages read one dumped JSONL directory: the CSR sidecar's arrays
(``_CsrCohort._assemble``) are equal member for member, either package maps
the other's sidecar without a rebuild, a changed, corrupt or older-format
sidecar is rebuilt, the fused streams (``carrying``, ``carrying_csr``) equal
the JAX package's, unknown callsets raise lazily, the empty variant-set id
is a wildcard, gzipped cohorts read, the byte-offset line index slices
shards identically, and the murmur3 identity digests are the JAX package's.
"""

import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics import hashing as jax_hashing
from spark_examples_tpu.genomics import sources as jax_sources
from spark_examples_tpu.genomics.fixtures import (
    dump_cohort_stream as jax_dump_cohort_stream,
)
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.native import force_fallback
from spark_examples_tpu_torch.genomics import hashing
from spark_examples_tpu_torch.genomics import sources
from spark_examples_tpu_torch.genomics.callsets import CallsetIndex
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    dump_cohort_stream,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    Shard,
    shards_for_references,
)
from spark_examples_tpu_torch.utils.stats import IoStats

N, V, SEED = 24, 300, 5
COHORT = dict(
    seed=SEED,
    population_structure=3,
    dropped_contig_every=17,
    reference_blocks_every=23,
)
SHARDS = shards_for_references(BRCA1_REFERENCES, 10_000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dump(root) -> str:
    synthetic_cohort(N, V, **COHORT).dump(str(root))
    return str(root)


@pytest.fixture
def cohort(tmp_path):
    return _dump(tmp_path / "cohort")


def _src_paths(root):
    return [
        os.path.join(root, "variants.jsonl"),
        os.path.join(root, "callsets.json"),
    ]


def _parsed_arrays(pkg, root, native=False):
    """The sidecar arrays ``pkg`` assembles for ``root`` (no file
    written); ``native`` takes the JAX package's C++ parse."""
    csr_cls = pkg._CsrCohort
    open_fn = pkg.JsonlSource(root)._open
    with open(os.path.join(root, "callsets.json")) as f:
        ids = [r["id"] for r in json.load(f)]
    parsed = (
        csr_cls._parse_native(root, ids)
        if native
        else csr_cls._parse_python(open_fn, ids)
    )
    assert parsed is not None
    return csr_cls._assemble(
        csr_cls._digest(_src_paths(root)), ids, *parsed
    )


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype, name
        assert x.shape == y.shape, name
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), name


@pytest.mark.parametrize("jax_parse", ["python", "native"])
def test_sidecar_arrays_equal_the_jax_package_member_for_member(
    cohort, jax_parse
):
    port = _parsed_arrays(sources, cohort)
    want = _parsed_arrays(
        jax_sources, cohort, native=jax_parse == "native"
    )
    _assert_same_arrays(port, want)
    assert str(port["digest"]).startswith("v2|variants.jsonl:")
    assert port["idkeys"].dtype == np.dtype("S32")


def _loaded_without_rebuild(pkg, root, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the sidecar was rebuilt")

    monkeypatch.setattr(
        pkg._CsrCohort, "_parse_python", staticmethod(refuse)
    )
    if hasattr(pkg._CsrCohort, "_parse_native"):
        monkeypatch.setattr(
            pkg._CsrCohort, "_parse_native", staticmethod(refuse)
        )
    return pkg._CsrCohort.load_or_build(root, pkg.JsonlSource(root)._open)


@pytest.mark.parametrize(
    "writer,reader",
    [("jax", "port"), ("port", "jax")],
)
def test_each_package_maps_the_others_sidecar_without_a_rebuild(
    cohort, monkeypatch, writer, reader
):
    pkgs = {"jax": jax_sources, "port": sources}
    built = pkgs[writer]._CsrCohort.load_or_build(
        cohort, pkgs[writer].JsonlSource(cohort)._open
    )
    path = os.path.join(cohort, sources.SIDECAR_BASENAME)
    assert sources.SIDECAR_BASENAME == jax_sources.SIDECAR_BASENAME
    stamp = os.stat(path).st_mtime_ns
    loaded = _loaded_without_rebuild(pkgs[reader], cohort, monkeypatch)
    assert os.stat(path).st_mtime_ns == stamp
    _assert_same_arrays(loaded._d, built._d)


def _count_parses(monkeypatch):
    """Count the sidecar's parses: one per build, native or Python (a
    native refusal hands the same build to the Python parse)."""
    calls = []
    real_python = sources._CsrCohort._parse_python
    real_native = sources._CsrCohort._parse_native

    def counted_python(open_fn, ids):
        calls.append(1)
        return real_python(open_fn, ids)

    def counted_native(root, ids, threads=0):
        parsed = real_native(root, ids, threads)
        if parsed is not None:
            calls.append(1)
        return parsed

    monkeypatch.setattr(
        sources._CsrCohort, "_parse_python", staticmethod(counted_python)
    )
    monkeypatch.setattr(
        sources._CsrCohort, "_parse_native", staticmethod(counted_native)
    )
    return calls


def _touch_variants(root):
    path = os.path.join(root, "variants.jsonl")
    with open(path, "a") as f:
        f.write(
            json.dumps(
                {
                    "reference_name": "17",
                    "start": 41196400,
                    "end": 41196401,
                    "reference_bases": "A",
                    "alternate_bases": ["C"],
                    "variant_set_id": DEFAULT_VARIANT_SET_ID,
                    "calls": [
                        {
                            "callset_id": f"{DEFAULT_VARIANT_SET_ID}-0",
                            "genotype": [0, 1],
                        }
                    ],
                }
            )
            + "\n"
        )


def _corrupt_sidecar(root):
    path = os.path.join(root, sources.SIDECAR_BASENAME)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff" * 64)


def _old_format_sidecar(root):
    path = os.path.join(root, sources.SIDECAR_BASENAME)
    data = dict(np.load(path, allow_pickle=False))
    data["digest"] = np.str_(
        "v1|" + str(data["digest"]).split("|", 1)[1]
    )
    with open(path, "wb") as f:
        np.savez(f, **data)


@pytest.mark.parametrize(
    "damage",
    [_touch_variants, _corrupt_sidecar, _old_format_sidecar],
    ids=["file-change", "corrupt", "version-mismatch"],
)
def test_sidecar_rebuilds_on_change_corruption_or_version(
    cohort, monkeypatch, damage
):
    open_fn = sources.JsonlSource(cohort)._open
    sources._CsrCohort.load_or_build(cohort, open_fn)
    damage(cohort)
    calls = _count_parses(monkeypatch)
    rebuilt = sources._CsrCohort.load_or_build(cohort, open_fn)
    assert calls == [1]
    assert str(rebuilt._d["digest"]) == sources._CsrCohort._digest(
        _src_paths(cohort)
    )
    _assert_same_arrays(rebuilt._d, _parsed_arrays(jax_sources, cohort))
    # The rebuilt file is current: the next load maps it.
    sources._CsrCohort.load_or_build(cohort, open_fn)
    assert calls == [1]


def test_read_only_directory_serves_the_sidecar_from_memory(
    cohort, monkeypatch
):
    def refuse_write(*_a, **_k):
        raise PermissionError("read-only cohort directory")

    monkeypatch.setattr(sources.np, "savez", refuse_write)
    csr = sources._CsrCohort.load_or_build(
        cohort, sources.JsonlSource(cohort)._open
    )
    assert not os.path.exists(
        os.path.join(cohort, sources.SIDECAR_BASENAME)
    )
    assert not [p for p in os.listdir(cohort) if p.endswith(".tmp")]
    _assert_same_arrays(csr._d, _parsed_arrays(jax_sources, cohort))


def _indexes(src):
    return CallsetIndex.from_source(src, [DEFAULT_VARIANT_SET_ID]).indexes


def _pair_lists(pair):
    if pair is None:
        return []
    idx, offs = pair
    return [idx[a:b].tolist() for a, b in zip(offs[:-1], offs[1:])]


@pytest.mark.parametrize("min_af", [None, 0.2])
def test_carrying_csr_equals_carrying_equals_the_jax_stream(cohort, min_af):
    port = sources.JsonlSource(cohort)
    jax = jax_sources.JsonlSource(cohort)
    indexes = _indexes(sources.JsonlSource(cohort))
    seen = 0
    for shard in SHARDS:
        lists = list(
            port.stream_carrying(
                DEFAULT_VARIANT_SET_ID, shard, indexes, min_af
            )
        )
        pair = port.stream_carrying_csr(
            DEFAULT_VARIANT_SET_ID, shard, indexes, min_af
        )
        want = jax.stream_carrying_csr(
            DEFAULT_VARIANT_SET_ID, shard, indexes, min_af
        )
        want_lists = list(
            jax.stream_carrying(
                DEFAULT_VARIANT_SET_ID, shard, indexes, min_af
            )
        )
        assert _pair_lists(pair) == lists == _pair_lists(want) == want_lists
        if pair is not None:
            assert pair[0].dtype == np.int64 and pair[1].dtype == np.int64
        seen += len(lists)
    assert seen > 0
    assert port.stats.report() == jax.stats.report()


def test_stream_carrying_keyed_equals_the_jax_stream(cohort):
    port = sources.JsonlSource(cohort)
    jax = jax_sources.JsonlSource(cohort)
    indexes = _indexes(port)
    for shard in SHARDS:
        got = list(
            port.stream_carrying_keyed(
                DEFAULT_VARIANT_SET_ID, shard, indexes, None
            )
        )
        want = list(
            jax.stream_carrying_keyed(
                DEFAULT_VARIANT_SET_ID, shard, indexes, None
            )
        )
        assert got == want


def _write_cohort(root, records, callset_ids):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "callsets.json"), "w") as f:
        json.dump(
            [
                {"id": c, "name": c, "variant_set_id": "vs"}
                for c in callset_ids
            ],
            f,
        )
    with open(os.path.join(root, "variants.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _rec(start, calls, **kw):
    rec = {
        "reference_name": "17",
        "start": start,
        "end": start + 1,
        "reference_bases": "A",
        "alternate_bases": ["G"],
        "calls": [
            {"callset_id": c, "genotype": [0, 1]} for c in calls
        ],
    }
    rec.update(kw)
    return rec


def test_unknown_callset_raises_lazily_with_its_id(tmp_path):
    root = str(tmp_path / "c")
    _write_cohort(
        root,
        [
            _rec(100, ["a", "b"], variant_set_id="vs"),
            _rec(5000, ["a", "ghost"], variant_set_id="vs"),
        ],
        ["a", "b"],
    )
    near, far = Shard("17", 0, 1000), Shard("17", 1000, 10_000)
    for pkg in (sources, jax_sources):
        src = pkg.JsonlSource(root)
        indexes = {"a": 0, "b": 1}
        # The build does not fail; the out-of-scope record is not served.
        assert _pair_lists(
            src.stream_carrying_csr("vs", near, indexes)
        ) == [[0, 1]]
        assert list(src.stream_carrying("vs", near, indexes)) == [[0, 1]]
        with pytest.raises(KeyError, match="ghost"):
            src.stream_carrying_csr("vs", far, indexes)
        with pytest.raises(KeyError, match="ghost"):
            list(src.stream_carrying("vs", far, indexes))
    csr = sources.JsonlSource(root)._ensure_csr()
    assert csr._d["callset_ids"].tolist() == ["a", "b", "ghost"]


def test_empty_variant_set_id_is_a_wildcard(tmp_path):
    root = str(tmp_path / "c")
    recs = [
        _rec(100, ["a"], variant_set_id="vs"),
        _rec(200, ["b"], variant_set_id=""),
        _rec(300, ["a", "b"]),
        _rec(400, ["b"], variant_set_id=None),
        _rec(500, ["a"], variant_set_id="other"),
    ]
    _write_cohort(root, recs, ["a", "b"])
    shard = Shard("17", 0, 1000)
    indexes = {"a": 0, "b": 1}
    for vsid, want in (
        ("vs", [[0], [1], [0, 1], [1]]),
        ("other", [[1], [0, 1], [1], [0]]),
        ("", [[0], [1], [0, 1], [1], [0]]),
    ):
        for pkg in (sources, jax_sources):
            src = pkg.JsonlSource(root)
            assert _pair_lists(
                src.stream_carrying_csr(vsid, shard, indexes)
            ) == want, (pkg.__name__, vsid)
            staged = [
                [indexes[c.callset_id] for c in v.calls]
                for v in src.stream_variants(vsid, shard)
            ]
            assert staged == want, (pkg.__name__, vsid)


def test_gzipped_cohort_reads_like_the_jax_package(cohort):
    plain = os.path.join(cohort, "variants.jsonl")
    with open(plain, "rb") as fin, gzip.open(plain + ".gz", "wb") as fout:
        shutil.copyfileobj(fin, fout)
    os.unlink(plain)
    port = sources.JsonlSource(cohort)
    jax = jax_sources.JsonlSource(cohort)
    assert port._line_index() is None
    indexes = _indexes(port)
    total = 0
    for shard in SHARDS:
        got = [v.start for v in port.stream_variants("", shard)]
        assert got == [v.start for v in jax.stream_variants("", shard)]
        total += len(got)
        assert _pair_lists(
            port.stream_carrying_csr("", shard, indexes)
        ) == _pair_lists(jax.stream_carrying_csr("", shard, indexes))
    assert total > 0
    assert str(port._ensure_csr()._d["digest"]).startswith(
        "v2|variants.jsonl.gz:"
    )


def test_line_index_slices_equal_the_jax_package(tmp_path, monkeypatch):
    a = _dump(tmp_path / "a")
    b = str(tmp_path / "b")
    shutil.copytree(a, b)
    port = sources._LineIndex.load_or_build(a)
    jax = jax_sources._LineIndex.load_or_build(b)
    assert port.total == jax.total > 0
    shards = SHARDS + [Shard("chr17", 41196311, 41277499), Shard("1", 0, 9)]
    for shard in shards:
        for x, y in zip(port.slice(shard), jax.slice(shard)):
            assert np.array_equal(x, y)
    with open(os.path.join(a, "variants.jsonl"), "rb") as f:
        offsets, lengths = port.slice(SHARDS[0])
        lines = list(sources._LineIndex.read_lines(f, offsets, lengths))
    assert [json.loads(line)["start"] for line in lines] == sorted(
        json.loads(line)["start"] for line in lines
    )
    # The port loads the persisted index the JAX package wrote (the copy
    # kept the file's size and mtime, so the digests agree) unbuilt.
    os.replace(
        os.path.join(b, sources.LINEIDX_BASENAME),
        os.path.join(a, sources.LINEIDX_BASENAME),
    )
    monkeypatch.setattr(
        sources._LineIndex,
        "_extract_fields",
        staticmethod(lambda line: pytest.fail("the index was rebuilt")),
    )
    loaded = sources._LineIndex.load_or_build(a)
    for shard in shards:
        for x, y in zip(loaded.slice(shard), jax.slice(shard)):
            assert np.array_equal(x, y)


def test_scan_helpers_equal_the_jax_package():
    lines = [
        b'{"reference_name": "17", "start": 5, "variant_set_id": "vs"}',
        b'{"start": 7, "reference_name": "chr1", "calls": []}',
        b'{"reference_name": "x\\"y", "start": 9}',
        b'{"calls": [{"variant_set_id": "a"}], "variant_set_id": "b"}',
        b'{"variant_set_id": "", "start": 1}',
    ]
    for line in lines:
        assert sources._LineIndex._extract_fields(
            line
        ) == jax_sources._LineIndex._extract_fields(line)
        for vsid in ("", "vs", "a", "b"):
            assert sources._line_vsid_matches(
                line, vsid
            ) == jax_sources._line_vsid_matches(line, vsid)
    lists = [[1, 2], [], [3], [0, 0, 5]]
    for got, want in zip(
        sources.csr_pair_from_lists(lists),
        jax_sources.csr_pair_from_lists(lists),
    ):
        assert np.array_equal(got, want) and got.dtype == want.dtype
    assert sources.csr_pair_from_lists([]) is None


def test_mmap_view_equals_the_copying_loader(cohort):
    sources._CsrCohort.load_or_build(
        cohort, sources.JsonlSource(cohort)._open
    )
    path = os.path.join(cohort, sources.SIDECAR_BASENAME)
    view = sources._load_sidecar_mmap(path)
    assert view is not None
    _assert_same_arrays(view, dict(np.load(path, allow_pickle=False)))
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\x00" * 16)
    assert sources._load_sidecar_mmap(path) is None  # CRC mismatch


def test_hashing_digests_equal_the_jax_package():
    rng = np.random.default_rng(0)
    for n in list(range(0, 40)) + [63, 64, 65, 200]:
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        for seed in (0, 7):
            want = jax_hashing._murmur3_py(data, seed)
            assert hashing.murmur3_x64_128(data, seed) == want
            assert jax_hashing.murmur3_x64_128(data, seed) == want
    fields = [
        ("17", 41196311, 41196312, "A", ["G"]),
        ("1", 0, 10, None, None),
        ("X", 5, 9, "ACGT", ["A", "TT"]),
        ("22", 2**40, 2**40 + 1, "é", ["ß"]),
    ]
    for f in fields:
        assert hashing.variant_identity(*f) == jax_hashing.variant_identity(
            *f
        )
    payloads = [hashing._identity_payload(*f) for f in fields]
    assert payloads == [jax_hashing._identity_payload(*f) for f in fields]
    assert hashing.hash_payloads(payloads) == jax_hashing.hash_payloads(
        payloads
    )
    with force_fallback():
        assert hashing.hash_payloads(payloads) == jax_hashing.hash_payloads(
            payloads
        )


def test_fixture_dump_is_the_jax_packages_byte_for_byte(tmp_path):
    synthetic_cohort(N, V, **COHORT).dump(str(tmp_path / "port"))
    jax_synthetic_cohort(N, V, **COHORT).dump(str(tmp_path / "jax"))
    for name in ("callsets.json", "variants.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name
        ).read_bytes(), name


@pytest.mark.parametrize("append", [False, True])
def test_dump_cohort_stream_is_the_jax_packages(tmp_path, append):
    for pkg_dump, name in (
        (dump_cohort_stream, "port"),
        (jax_dump_cohort_stream, "jax"),
    ):
        root = str(tmp_path / name)
        pkg_dump(root, 8, 40, variant_set_id="setA", seed=1)
        if append:
            pkg_dump(
                root, 8, 40, variant_set_id="setB", seed=2, append=True
            )
    for name in ("callsets.json", "variants.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name
        ).read_bytes(), name
    (tmp_path / "port" / "callsets.json.gz").write_bytes(b"")
    with pytest.raises(ValueError, match="gzipped"):
        dump_cohort_stream(str(tmp_path / "port"), 2, 2, append=True)


def test_fixture_keyed_stream_equals_the_jax_fixture():
    port = synthetic_cohort(N, V, **COHORT)
    jax = jax_synthetic_cohort(N, V, **COHORT)
    indexes = _indexes(synthetic_cohort(N, V, **COHORT))
    for shard in SHARDS:
        for min_af in (None, 0.2):
            got = list(
                port.stream_carrying_keyed(
                    DEFAULT_VARIANT_SET_ID, shard, indexes, min_af
                )
            )
            want = list(
                jax.stream_carrying_keyed(
                    DEFAULT_VARIANT_SET_ID, shard, indexes, min_af
                )
            )
            assert got == want
    assert port.stats.report() == jax.stats.report()


def test_jsonl_list_callsets_and_stats(cohort):
    port = sources.JsonlSource(cohort, stats=IoStats())
    jax = jax_sources.JsonlSource(cohort)
    for vsid in ("", DEFAULT_VARIANT_SET_ID, "nope"):
        got = port.list_callsets(vsid)
        want = jax.list_callsets(vsid)
        assert [(c.id, c.name, c.variant_set_id) for c in got] == [
            (c.id, c.name, c.variant_set_id) for c in want
        ]
    assert port.stats.requests == 3


def test_concurrent_shard_queries_build_the_sidecar_once(
    cohort, monkeypatch
):
    import sys
    import threading

    calls = _count_parses(monkeypatch)
    src = sources.JsonlSource(cohort)
    indexes = _indexes(sources.JsonlSource(cohort))
    got, errors = [], []
    start = threading.Barrier(4 * len(SHARDS))

    def query(shard):
        try:
            start.wait(10)
            pair = src.stream_carrying_csr(
                DEFAULT_VARIANT_SET_ID, shard, indexes
            )
            got.append((shard.start, _pair_lists(pair)))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=query, args=(s,))
            for s in SHARDS * 4
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert calls == [1]
    want = {
        s.start: _pair_lists(
            jax_sources.JsonlSource(cohort).stream_carrying_csr(
                DEFAULT_VARIANT_SET_ID, s, indexes
            )
        )
        for s in SHARDS
    }
    assert len(got) == 4 * len(SHARDS)
    assert all(lists == want[start] for start, lists in got)
    assert src.stats.partitions == 4 * len(SHARDS)
