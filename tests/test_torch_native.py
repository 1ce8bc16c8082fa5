"""The port's native host core against its numpy/Python versions and the
JAX package.

``csrc/genomics_native.cpp`` is host C++ built with ``g++`` at first use,
so these run on the CPU. On seeded numpy inputs each case holds three
things equal: the port's native path, the port's numpy/Python path
(``native=False``) and the JAX package's function:

- ``pack_calls`` (``densify_calls``) and ``csr_to_packed_blocks``
  (``packed_block_from_csr``) byte for byte, with column-padded widths,
  empty windows and N not a multiple of 8; an out-of-range index raises on
  both paths;
- ``murmur3_x64_128`` single and batch (``hash_payloads``,
  ``variant_identities``);
- ``parse_cohort_jsonl`` (``_CsrCohort._parse_native``) against
  ``_parse_python``, on 1 and 4 threads, with the anomaly and ``.gz``
  fallbacks to the Python parse, and a sidecar written by either package
  mapped by the other without a rebuild; a small ``hypothesis``
  differential of the parser over the interchange schema.

The build itself: the library lands under ``_build/`` with a hash of its
source in its name, and a failed build raises with the compiler's output.
"""

import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from spark_examples_tpu.arrays.blocks import densify_calls as jax_densify
from spark_examples_tpu.arrays.blocks import (
    packed_block_from_csr as jax_packed_block,
)
from spark_examples_tpu.genomics.hashing import (
    murmur3_x64_128 as jax_murmur3,
)
from spark_examples_tpu.genomics.hashing import (
    variant_identities as jax_variant_identities,
)
from spark_examples_tpu.genomics.sources import JsonlSource as JaxJsonl
from spark_examples_tpu.genomics.sources import _CsrCohort as JaxCsr
from spark_examples_tpu.genomics.types import Variant as JaxVariant
from spark_examples_tpu_torch import cuda_build, native
from spark_examples_tpu_torch.arrays.blocks import (
    densify_calls,
    packed_block_from_csr,
)
from spark_examples_tpu_torch.genomics.fixtures import synthetic_cohort
from spark_examples_tpu_torch.genomics.hashing import (
    hash_payloads,
    murmur3_x64_128,
    variant_identities,
)
from spark_examples_tpu_torch.genomics.sources import (
    SIDECAR_BASENAME,
    JsonlSource,
    _CsrCohort,
)
from spark_examples_tpu_torch.genomics.types import Variant

PARSED = (
    "contig_table", "rec_contig", "starts", "vsid_table", "rec_vsid",
    "afs", "offsets", "ords", "extra_ids", "ends", "refs", "alts",
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_calls(rng, n_samples, n_variants):
    """Per-variant carrier lists, some empty, some with duplicates."""
    calls = []
    for _ in range(n_variants):
        k = int(rng.integers(0, n_samples + 1))
        calls.append(rng.integers(0, n_samples, k).tolist())
    return calls


# -- the builder ---------------------------------------------------------------


def test_the_library_is_built_into_build_dir_keyed_by_source_hash():
    lib = native.load()
    path = cuda_build.build([native.SOURCE])[native.SOURCE]
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("libgenomics_native-")
    assert os.path.exists(path)
    assert lib.cohort_csr_abi_version() == native.COHORT_CSR_ABI


def test_a_failed_build_raises_with_the_compiler_output(
    tmp_path, monkeypatch
):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("int f() { return not_declared; }\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="not_declared"):
        cuda_build.build(["broken"])
    assert not [
        f for f in os.listdir(tmp_path / "_build") if f.endswith(".so")
    ]


# -- pack_calls ----------------------------------------------------------------


@pytest.mark.parametrize(
    "n_samples, n_variants, width",
    [(1, 1, 1), (7, 5, 8), (13, 9, 9), (13, 9, 24), (64, 40, 64),
     (29, 0, 16), (100, 33, 40)],
)
def test_pack_calls_is_byte_identical_to_numpy_and_jax(
    n_samples, n_variants, width
):
    rng = np.random.default_rng(n_samples * 100 + n_variants)
    calls = _random_calls(rng, n_samples, n_variants)
    got = densify_calls(calls, n_samples, width)
    plain = densify_calls(calls, n_samples, width, native=False)
    want = jax_densify(calls, n_samples, width)
    assert got.dtype == np.int8 and got.shape == (n_samples, width)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert not got[:, n_variants:].any()  # pad columns stay zero


# -- csr_to_packed_blocks -------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_packed_block_is_byte_identical_to_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    n_samples = int(rng.integers(1, 80))
    block_variants = int(rng.integers(1, 70))
    rows = int(rng.integers(0, block_variants + 1))
    lens = rng.integers(0, n_samples + 1, rows).astype(np.int64)
    idx = rng.integers(0, n_samples, int(lens.sum())).astype(np.int64)
    got = packed_block_from_csr(idx, lens, n_samples, block_variants)
    plain = packed_block_from_csr(
        idx, lens, n_samples, block_variants, native=False
    )
    want = jax_packed_block(idx, lens, n_samples, block_variants)
    assert got.dtype == np.uint8
    assert got.shape == (n_samples, (block_variants + 7) // 8)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "n_samples, block_variants, lens, idx",
    [
        (11, 16, [], []),                      # empty window
        (5, 21, [2, 0, 1], [0, 4, 3]),         # 5 pad bits in the last byte
        (9, 24, [9] * 24, list(range(9)) * 24),  # every bit set
        (13, 8, [3, 3], [12, 0, 12, 5, 5, 5]),  # N not a multiple of 8, dups
    ],
    ids=["empty", "pad-bits", "full", "odd-n-duplicates"],
)
def test_packed_block_edge_windows(n_samples, block_variants, lens, idx):
    lens = np.asarray(lens, np.int64)
    idx = np.asarray(idx, np.int64)
    got = packed_block_from_csr(idx, lens, n_samples, block_variants)
    np.testing.assert_array_equal(
        got,
        packed_block_from_csr(
            idx, lens, n_samples, block_variants, native=False
        ),
    )
    np.testing.assert_array_equal(
        got, jax_packed_block(idx, lens, n_samples, block_variants)
    )
    bits = np.unpackbits(got, axis=1)
    assert not bits[:, lens.size:].any()  # pad bits are zero


@pytest.mark.parametrize("bad", [-1, 7, 99])
def test_an_out_of_range_index_raises_on_both_paths(bad):
    lens = np.array([1], np.int64)
    idx = np.array([bad], np.int64)
    for use_native in (True, False):
        with pytest.raises(ValueError, match="out of range"):
            packed_block_from_csr(idx, lens, 7, 8, native=use_native)
        with pytest.raises(ValueError, match="out of range"):
            densify_calls([[bad]], 7, 8, native=use_native)


def test_the_c_scatter_guards_its_own_indices():
    """The native routine's own guard, behind the wrapper's check: a
    corrupt window can never silently drop a carrier."""
    idx = np.array([5], np.int64)
    offs = np.array([0, 1], np.int64)
    out = np.zeros((4, 1), np.uint8)
    rc = native.load().csr_to_packed_blocks(
        idx.ctypes.data, offs.ctypes.data, 1, 4, 1, out.ctypes.data
    )
    assert rc == 1


# -- murmur3 -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**64 - 1])
def test_murmur3_single_and_batch_equal_python_and_jax(seed):
    rng = np.random.default_rng(5)
    payloads = [rng.bytes(n) for n in range(0, 70)]
    for p in payloads:
        got = murmur3_x64_128(p, seed)
        assert got == murmur3_x64_128(p, seed, native=False)
        assert got == jax_murmur3(p, seed)
    batch = hash_payloads(payloads)
    assert batch == hash_payloads(payloads, native=False)
    assert batch == [jax_murmur3(p).hex() for p in payloads]
    assert hash_payloads([]) == []


def test_variant_identities_equal_jax():
    rng = np.random.default_rng(9)
    rows = []
    for i in range(50):
        ref = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 4))))
        alts = [
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 3))))
            for _ in range(int(rng.integers(0, 3)))
        ] or None
        rows.append(("17", int(rng.integers(0, 1 << 40)), i, ref, alts))
    ours = [
        Variant(contig=c, id=str(e), start=s, end=s + e,
                reference_bases=r, alternate_bases=a)
        for c, s, e, r, a in rows
    ]
    theirs = [
        JaxVariant(contig=c, id=str(e), start=s, end=s + e,
                   reference_bases=r, alternate_bases=a)
        for c, s, e, r, a in rows
    ]
    got = variant_identities(ours)
    assert got == variant_identities(ours, native=False)
    assert got == jax_variant_identities(theirs)


# -- the parse -----------------------------------------------------------------


def _ids(root):
    with open(os.path.join(root, "callsets.json")) as f:
        return [r["id"] for r in json.load(f)]


def _assert_parsed_equal(a, b):
    for name, x, y in zip(PARSED, a, b):
        if isinstance(x, list):
            assert x == y, name
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native") / "c")
    synthetic_cohort(
        40, 600, seed=4, population_structure=3, rare_variant_af=0.05,
        sparse_calls=True,
    ).dump(root)
    return root


def test_native_parse_equals_python_on_one_and_four_threads(cohort_dir):
    ids = _ids(cohort_dir)
    one = _CsrCohort._parse_native(cohort_dir, ids, threads=1)
    four = _CsrCohort._parse_native(cohort_dir, ids, threads=4)
    auto = _CsrCohort._parse_native(cohort_dir, ids)
    python = _CsrCohort._parse_python(JsonlSource(cohort_dir)._open, ids)
    jax_python = JaxCsr._parse_python(JaxJsonl(cohort_dir)._open, ids)
    assert one is not None and four is not None and auto is not None
    assert len(one[2]) == 600
    for other in (four, auto, python, jax_python):
        _assert_parsed_equal(one, other)


def _copy_cohort(src, dst):
    os.makedirs(dst)
    for name in ("callsets.json", "variants.jsonl"):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))


def _sidecar(root, **kw):
    return _CsrCohort.load_or_build(root, JsonlSource(root)._open, **kw)._d


def _assert_sidecars_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_an_anomalous_line_goes_to_the_python_parse(cohort_dir, tmp_path):
    root = str(tmp_path / "anomaly")
    _copy_cohort(cohort_dir, root)
    with open(os.path.join(root, "variants.jsonl"), "a") as f:
        # An escape inside an extracted string is valid JSON the native
        # parser refuses.
        f.write('{"reference_name": "17", "start": 41196400, "end": '
                '41196401, "variant_set_id": "a\\"b", "calls": []}\n')
    assert _CsrCohort._parse_native(root, _ids(root)) is None
    got = _sidecar(root)
    os.unlink(os.path.join(root, SIDECAR_BASENAME))
    _assert_sidecars_equal(got, _sidecar(root, native=False))
    assert "a\"b" in got["vsids"].tolist()


def test_a_gz_cohort_goes_to_the_python_parse(cohort_dir, tmp_path):
    root = str(tmp_path / "gz")
    _copy_cohort(cohort_dir, root)
    src = os.path.join(root, "variants.jsonl")
    with open(src, "rb") as f, gzip.open(src + ".gz", "wb") as g:
        g.write(f.read())
    os.unlink(src)
    assert _CsrCohort._parse_native(root, _ids(root)) is None
    got = _sidecar(root)
    jax = JaxCsr.load_or_build(root, JaxJsonl(root)._open)._d
    for key in ("starts", "offsets", "ords", "afs", "idkeys"):
        np.testing.assert_array_equal(got[key], jax[key], err_msg=key)


def _forbid_parse(monkeypatch, cls):
    def refuse(*_a, **_k):
        raise AssertionError("the sidecar was rebuilt")

    for name in ("_parse_native", "_parse_python"):
        monkeypatch.setattr(cls, name, staticmethod(refuse))


def test_each_package_maps_the_others_native_sidecar(
    cohort_dir, tmp_path, monkeypatch
):
    port_root = str(tmp_path / "port")
    jax_root = str(tmp_path / "jax")
    _copy_cohort(cohort_dir, port_root)
    _copy_cohort(cohort_dir, jax_root)
    port = _sidecar(port_root)  # the port's native parse writes it
    jax = JaxCsr.load_or_build(jax_root, JaxJsonl(jax_root)._open)._d
    _assert_sidecars_equal(
        {k: v for k, v in port.items() if k != "digest"},
        {k: v for k, v in jax.items() if k != "digest"},
    )
    port_file = os.path.join(port_root, SIDECAR_BASENAME)
    jax_file = os.path.join(jax_root, SIDECAR_BASENAME)
    with open(port_file, "rb") as f:
        port_bytes = f.read()
    with open(jax_file, "rb") as f:
        jax_bytes = f.read()
    _forbid_parse(monkeypatch, JaxCsr)
    _forbid_parse(monkeypatch, _CsrCohort)
    mapped_by_jax = JaxCsr.load_or_build(
        port_root, JaxJsonl(port_root)._open
    )._d
    mapped_by_port = _sidecar(jax_root)
    _assert_sidecars_equal(port, dict(mapped_by_jax))
    _assert_sidecars_equal(jax, dict(mapped_by_port))
    with open(port_file, "rb") as f:
        assert f.read() == port_bytes
    with open(jax_file, "rb") as f:
        assert f.read() == jax_bytes


# -- a differential of the parser over the interchange schema -----------------

CALLSETS = [f"cs-{i}" for i in range(6)]
_records = st.fixed_dictionaries(
    {
        "reference_name": st.sampled_from(
            ["17", "chr17", "chrX", "chr", "17x", "HLA-A", "ünicode"]
        ),
        "start": st.integers(0, 10_000_000),
        "end": st.integers(0, 10_000_000),
        "calls": st.lists(
            st.fixed_dictionaries(
                {
                    "callset_id": st.sampled_from(CALLSETS + ["ghost"]),
                    "genotype": st.lists(st.integers(-1, 2), max_size=3),
                }
            ),
            max_size=5,
        ),
    },
    optional={
        "variant_set_id": st.sampled_from(["vs1", "vs2", "", None]),
        "reference_bases": st.sampled_from(["A", "ACGT", "", None]),
        "alternate_bases": st.sampled_from([["G"], ["G", "T"], [], None]),
        "info": st.fixed_dictionaries(
            {},
            optional={
                "AF": st.sampled_from(
                    [["0.25"], ["."], [""], [0.5], [1], ["1e-3"], [None],
                     [], ["0.1", "0.9"]]
                ),
                "DP": st.just([7]),
            },
        ),
    },
)


@settings(
    max_examples=25,
    deadline=None,
    suppress_health_check=[HealthCheck.function_scoped_fixture],
)
@given(records=st.lists(_records, min_size=1, max_size=25),
       ascii_only=st.booleans())
def test_native_parse_matches_or_refuses_python(
    tmp_path_factory, records, ascii_only
):
    root = str(tmp_path_factory.mktemp("fuzz"))
    with open(os.path.join(root, "callsets.json"), "w") as f:
        json.dump([{"id": c, "name": c, "variant_set_id": "vs1"}
                   for c in CALLSETS], f)
    with open(os.path.join(root, "variants.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec, ensure_ascii=ascii_only) + "\n")
    got = _CsrCohort._parse_native(root, CALLSETS, threads=2)
    python = _CsrCohort._parse_python(JsonlSource(root)._open, CALLSETS)
    jax = JaxCsr._parse_python(JaxJsonl(root)._open, CALLSETS)
    _assert_parsed_equal(python, jax)
    carries_ghost = any(
        c["callset_id"] == "ghost" and any(g > 0 for g in c["genotype"])
        for rec in records
        for c in rec["calls"]
    )
    escaped = ascii_only and any(
        rec["reference_name"] == "ünicode" for rec in records
    )
    if got is None:
        # A refusal is allowed only where the Python parse needs its
        # extra-id table (an unknown callset carrying a variant) or an
        # extracted string holds an escape.
        assert carries_ghost or escaped
        return
    _assert_parsed_equal(got, python)


def test_the_builder_thread_table_holds_g_across_builds(cohort_dir, capsys):
    """``tools/ingest_workers.py``'s builder table at a small size on the
    CPU: every thread count, native and numpy, gives the same G (the
    table raises otherwise) and a build time for each."""
    from spark_examples_tpu_torch.tools.ingest_workers import (
        builder_thread_table,
    )

    table = builder_thread_table(
        cohort_dir, reps=1, threads=(1, 2), device="cpu"
    )
    assert sorted(table) == [(False, 1), (False, 2), (True, 1), (True, 2)]
    for row in table.values():
        assert row["s"] > 0 and row["ms_per_block"] > 0
    assert "builders native x2" in capsys.readouterr().out


@pytest.mark.parametrize(
    "lens, idx, block_variants",
    [([3], [0, 1], 8), ([1, -1], [0, 1], 8), ([1] * 9, list(range(9)), 8)],
    ids=["lens-exceed-indices", "negative-len", "window-wider-than-block"],
)
def test_a_malformed_window_raises_before_the_native_scatter(
    lens, idx, block_variants
):
    lens = np.asarray(lens, np.int64)
    idx = np.asarray(idx, np.int64)
    for use_native in (True, False):
        with pytest.raises(ValueError, match="window"):
            packed_block_from_csr(idx, lens, 16, block_variants, use_native)
