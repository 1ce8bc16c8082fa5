"""The port's PairHMM forward pass and driver against the JAX package's.

The same numpy-seeded pairs go through the JAX package's
``pairhmm_forward_batch`` (XLA on the CPU), the port's (torch ops,
``device="cpu"``) and the float64 golden ``pairhmm_forward_ref``: the port
must be within ``PAIRHMM_FORWARD_RTOL/ATOL`` of both over the bucket mix of
``tests_tpu/test_pairhmm_tpu.py``, masked pads and N bases, and a pair's
value must not depend on the tile it rides in or its place there. The
driver's rows must carry the JAX driver's names and buckets exactly and its
log-likelihoods within the bars, and be bit-identical under any
``--ingest-workers`` and ``--pairhmm-batch``.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import scripts.validate_trace as validate
from spark_examples_tpu.genomics import fixtures as jax_fixtures
from spark_examples_tpu.models.pairhmm import PairHmmDriver as JaxDriver
from spark_examples_tpu.models.pairhmm import (
    consensus_haplotype as jax_consensus,
)
from spark_examples_tpu.ops import pairhmm as jax_phmm
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch.cli.main import main
from spark_examples_tpu_torch.genomics import fixtures
from spark_examples_tpu_torch.genomics.shards import Shard
from spark_examples_tpu_torch.models.pairhmm import (
    PairHmmDriver,
    consensus_haplotype,
)
from spark_examples_tpu_torch.ops import pairhmm
from spark_examples_tpu_torch.ops.pairhmm import (
    PAIRHMM_FORWARD_ATOL,
    PAIRHMM_FORWARD_RTOL,
    PAIRHMM_NEG_INF,
    pairhmm_bucket,
    pairhmm_forward_batch,
    pairhmm_forward_ref,
)
from spark_examples_tpu_torch.utils.config import PcaConfig

READS_REFS = "11:6888648:6890648"
# tests_tpu/test_pairhmm_tpu.py's bucket mix.
SHAPES = [(1, 8), (7, 16), (37, 64), (100, 116), (100, 200)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pairs(rng, shapes, n_rate=0.0):
    out = []
    for rl, hl in shapes:
        hap = rng.integers(0, 4, hl).astype(np.int8)
        off = int(rng.integers(0, max(1, hl - rl)))
        read = hap[off:off + rl].copy()
        errs = rng.random(read.size) < 0.05
        read[errs] = rng.integers(0, 4, int(errs.sum()))
        read[rng.random(read.size) < n_rate] = 4
        hap[rng.random(hap.size) < n_rate] = 4
        out.append((read, rng.integers(5, 55, read.size).astype(np.int32),
                    hap))
    return out


def _batch(pairs, r_b=None, h_b=None, b_pad=None):
    r_b = r_b or pairhmm_bucket(max(p[0].size for p in pairs))
    h_b = h_b or pairhmm_bucket(max(p[2].size for p in pairs))
    b = b_pad or len(pairs)
    rc = np.zeros((b, r_b), np.int8)
    rq = np.zeros((b, r_b), np.int32)
    hc = np.full((b, h_b), 4, np.int8)
    rl = np.zeros(b, np.int32)
    hl = np.zeros(b, np.int32)
    for k, (read, quals, hap) in enumerate(pairs):
        rc[k, :read.size] = read
        rq[k, :quals.size] = quals
        hc[k, :hap.size] = hap
        rl[k] = read.size
        hl[k] = hap.size
    return rc, rq, rl, hc, hl


def _port(args, go=45.0, ge=10.0):
    out = pairhmm_forward_batch(*args, np.float32(go), np.float32(ge),
                                device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    return out.numpy()


def _jax(args, go=45.0, ge=10.0):
    return np.asarray(
        jax_phmm.pairhmm_forward_batch(*args, np.float32(go), np.float32(ge))
    )


def test_constants_and_buckets_are_the_jax_packages():
    for name in ("PAIRHMM_NEG_INF", "PAIRHMM_FORWARD_RTOL",
                 "PAIRHMM_FORWARD_ATOL", "MIN_GAP_OPEN_PHRED",
                 "DEFAULT_GAP_OPEN_PHRED", "DEFAULT_GAP_EXT_PHRED"):
        assert getattr(pairhmm, name) == getattr(jax_phmm, name)
    for n in (0, 1, 7, 8, 9, 100, 128, 129, 5000):
        for floor in (1, 8):
            assert pairhmm_bucket(n, floor) == jax_phmm.pairhmm_bucket(
                n, floor)


@pytest.mark.parametrize("go,ge", [(45.0, 10.0), (20.0, 5.0), (3.5, 1.0)])
@pytest.mark.parametrize("n_rate", [0.0, 0.1], ids=["acgt", "n-bases"])
def test_forward_within_the_bars_of_jax_and_the_golden(go, ge, n_rate):
    rng = np.random.default_rng(0)
    pairs = _pairs(rng, SHAPES + [(3, 3), (16, 20)], n_rate)
    # Masked pads: three padded batch slots, a read and a haplotype of
    # length 0.
    pairs.append((np.zeros(0, np.int8), np.zeros(0, np.int32),
                  rng.integers(0, 4, 30).astype(np.int8)))
    pairs.append((rng.integers(0, 5, 20).astype(np.int8),
                  rng.integers(5, 55, 20).astype(np.int32),
                  np.zeros(0, np.int8)))
    args = _batch(pairs, b_pad=len(pairs) + 3)
    got, want = _port(args, go, ge), _jax(args, go, ge)
    gold = np.array([pairhmm_forward_ref(r, q, h, go, ge)
                     for r, q, h in pairs[:-2]])
    assert np.array_equal(gold, [jax_phmm.pairhmm_forward_ref(
        r, q, h, go, ge) for r, q, h in pairs[:-2]])
    live = len(pairs) - 2
    np.testing.assert_allclose(got[:live], want[:live],
                               rtol=PAIRHMM_FORWARD_RTOL,
                               atol=PAIRHMM_FORWARD_ATOL)
    np.testing.assert_allclose(got[:live], gold, rtol=PAIRHMM_FORWARD_RTOL,
                               atol=PAIRHMM_FORWARD_ATOL)
    assert (got[live:] == np.float32(PAIRHMM_NEG_INF)).all()
    assert (want[live:] == got[live:]).all()
    print(f"go={go} ge={ge} n_rate={n_rate}: max |port - jax| "
          f"{np.abs(got[:live] - want[:live]).max():.3e}, max |port - f64| "
          f"{np.abs(got[:live] - gold).max():.3e}")


@pytest.mark.parametrize("b", [16, 13, 37])
def test_shuffled_batch_is_bit_identical(b):
    rng = np.random.default_rng(b)
    pairs = _pairs(rng, [(int(rng.integers(20, 50)), 70) for _ in range(b)])
    base = _port(_batch(pairs, 64, 128))
    perm = rng.permutation(b)
    shuffled = _port(_batch([pairs[i] for i in perm], 64, 128))
    assert np.array_equal(base[perm], shuffled)


def test_a_pair_is_bit_identical_in_any_tile():
    rng = np.random.default_rng(5)
    pairs = _pairs(rng, [(50, 80)] * 24)
    whole = _port(_batch(pairs, 64, 128))
    for lo, hi, pad in ((0, 1, None), (3, 11, 16), (11, 24, None)):
        part = _port(_batch(pairs[lo:hi], 64, 128, b_pad=pad))
        assert np.array_equal(part[:hi - lo], whole[lo:hi])


def test_n_bases_never_match():
    rng = np.random.default_rng(2)
    read = rng.integers(0, 4, 12).astype(np.int8)
    quals = np.full(12, 30, np.int32)
    all_n = [(read, quals, np.full(20, 4, np.int8)),
             (np.full(12, 4, np.int8), quals, rng.integers(
                 0, 4, 20).astype(np.int8))]
    got = _port(_batch(all_n))
    gold = [pairhmm_forward_ref(r, q, h) for r, q, h in all_n]
    np.testing.assert_allclose(got, gold, rtol=PAIRHMM_FORWARD_RTOL,
                               atol=PAIRHMM_FORWARD_ATOL)


def test_the_forward_pass_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    args = _batch(_pairs(np.random.default_rng(0), [(4, 8)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pairhmm_forward_batch(*args, 45.0, 10.0)


# -- the hand-computable pairs ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_read_pairs_are_the_jax_packages(seed):
    got = fixtures.synthetic_read_pairs(12, seed=seed)
    want = jax_fixtures.synthetic_read_pairs(12, seed=seed)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]) and (
                not isinstance(g[k], np.ndarray) or g[k].dtype == w[k].dtype)
    with pytest.raises(ValueError, match="must exceed"):
        fixtures.synthetic_read_pairs(2, read_len=8, hap_len=8)


def test_match_pairs_hold_the_hand_formula():
    pairs = [p for p in fixtures.synthetic_read_pairs(
        12, read_len=6, hap_len=10, quality=20, seed=0)
        if p["kind"] == "match"]
    assert pairs
    eps = 10.0 ** (-20 / 10.0)
    eps_go = 10.0 ** (-45.0 / 10.0)
    eps_ge = 10.0 ** (-10.0 / 10.0)
    got = _port(_batch([(p["read"], p["quals"], p["hap"]) for p in pairs]))
    for p, value in zip(pairs, got):
        r, h = p["read"].size, p["hap"].size
        n_off = sum(1 for off in range(h - r + 1)
                    if (p["hap"][off:off + r] == p["read"]).all())
        hand = (np.log(n_off) - np.log(h) + np.log1p(-eps_ge)
                + (r - 1) * np.log1p(-2 * eps_go) + r * np.log1p(-eps))
        full = pairhmm_forward_ref(p["read"], p["quals"], p["hap"])
        assert hand <= full + 1e-12
        assert abs(full - hand) < 0.01 * abs(hand) + 0.02
        assert abs(value - full) <= (PAIRHMM_FORWARD_ATOL
                                     + PAIRHMM_FORWARD_RTOL * abs(full))


# -- the driver ---------------------------------------------------------------


def _conf(cls, **kw):
    base = dict(references=READS_REFS, bases_per_partition=500,
                read_group_set_id="fixture-readset")
    if cls is PcaConfig:
        base["device"] = "cpu"
    base.update(kw)
    return cls(**base)


def test_consensus_haplotype_is_the_jax_packages():
    port = fixtures.synthetic_reads(80, references=READS_REFS, seed=3)
    reads = list(port.stream_reads("", Shard("11", 6888648, 6890648)))
    assert len(reads) == 80
    for start, length in ((6888648 - 8, 2100), (6889000, 300), (0, 16)):
        got = consensus_haplotype(reads, start, length)
        want = jax_consensus(reads, start, length)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_driver_rows_match_the_jax_drivers():
    port = fixtures.synthetic_reads(90, references=READS_REFS, seed=4)
    ref = jax_fixtures.synthetic_reads(90, references=READS_REFS, seed=4)
    got = PairHmmDriver(_conf(PcaConfig), port).run_rows()
    want = JaxDriver(_conf(JaxConfig), ref).run_rows()
    assert len(got) == 90
    assert [(n, b) for n, _, b in got] == [(n, b) for n, _, b in want]
    np.testing.assert_allclose([v for _, v, _ in got],
                               [v for _, v, _ in want],
                               rtol=PAIRHMM_FORWARD_RTOL,
                               atol=PAIRHMM_FORWARD_ATOL)
    assert got == sorted(got)


@pytest.mark.parametrize("workers,batch", [(4, 128), (3, 9), (2, 1),
                                           (1, 7)])
def test_driver_rows_are_bit_identical_across_feeds(workers, batch):
    src = fixtures.synthetic_reads(90, references=READS_REFS, seed=4)
    base = PairHmmDriver(_conf(PcaConfig, ingest_workers=1), src).run_rows()
    rows = PairHmmDriver(
        _conf(PcaConfig, ingest_workers=workers, pairhmm_batch=batch), src
    ).run_rows()
    assert rows == base


def test_empty_readset_warns_as_the_jax_driver_does(capsys):
    src = fixtures.synthetic_reads(0, references=READS_REFS)
    assert PairHmmDriver(_conf(PcaConfig), src).run(out_path=None) == []
    err = capsys.readouterr().err
    JaxDriver(_conf(JaxConfig), jax_fixtures.synthetic_reads(
        0, references=READS_REFS)).run(out_path=None)
    assert "no read x haplotype pairs" in err
    assert err == capsys.readouterr().err


@pytest.mark.parametrize("kw", [
    {"pairhmm_batch": 0},
    {"pairhmm_context": -1},
    {"pairhmm_gap_open_phred": 0.0},
    {"pairhmm_gap_open_phred": 3.0},
    {"pairhmm_gap_ext_phred": -3.0},
], ids=["batch", "context", "gap-open", "gap-open-nan", "gap-ext"])
def test_validation_messages_are_the_jax_packages(kw):
    src = fixtures.synthetic_reads(1, references=READS_REFS)
    with pytest.raises(ValueError) as got:
        PairHmmDriver(_conf(PcaConfig, **kw), src)
    with pytest.raises(ValueError) as want:
        JaxDriver(_conf(JaxConfig, **kw), src)
    assert str(got.value) == str(want.value)


def test_the_driver_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    src = fixtures.synthetic_reads(1, references=READS_REFS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PairHmmDriver(_conf(PcaConfig, device="cuda"), src)


def test_cli_run_writes_scores_and_a_schema_valid_trace(tmp_path):
    trace = str(tmp_path / "p.trace.json")
    metrics = str(tmp_path / "p.metrics.prom")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["pairhmm", "--fixture-reads", "40",
                   "--bases-per-partition", "1000", "--output-path",
                   str(tmp_path), "--trace-out", trace, "--metrics-out",
                   metrics, "--device", "cpu"])
    assert rc == 0
    assert out.getvalue().startswith("Scored 40 read x haplotype pair(s)")
    assert validate.validate_trace(trace) == []
    assert validate.validate_metrics(metrics) == []
    names = {e["name"] for e in json.loads(open(trace).read())["traceEvents"]}
    assert {"pairhmm.bucket", "pairhmm.forward"} <= names
    assert 'pairhmm_pairs_total{bucket="r128xh128"}' in open(metrics).read()
    lines = (tmp_path / "pairhmm_scores" / "part-00000").read_text()
    assert len(lines.strip().splitlines()) == 40
