"""The port's binary CSR frames against the JAX package's.

``spark_examples_tpu_torch/genomics/wire.py`` must produce the JAX
package's frames byte for byte (magic ``SXCF``, ``WIRE_VERSION``, the
header JSON, the zlib codec choice, the CRC32), so either package's client
decodes the other's server. Each case builds the same numpy-seeded CSR
shard and runs it through both packages' encoders and decoders.
"""

import numpy as np
import pytest
import torch

from spark_examples_tpu.genomics import wire as jax_wire
from spark_examples_tpu.genomics.shards import Shard as JaxShard
from spark_examples_tpu_torch.genomics import wire
from spark_examples_tpu_torch.genomics.shards import Shard

IDS = [f"cs{i}" for i in range(64)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _csr(seed, rows, n_ids=len(IDS), max_len=12, big=False):
    """A seeded ordinal CSR pair: ``rows`` variants, ragged carriers."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len, size=rows)
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    indices = rng.integers(0, n_ids, size=int(offsets[-1])).astype(np.int64)
    if big:
        indices[:1] = 2**31 + 5  # forces the int64 dtype
    return indices, offsets


# (seed, rows, big): an empty shard stays raw; larger ones deflate; values
# past 2^31 widen to int64.
CASES = {
    "tiny": (0, 1, False),
    "empty": (1, 0, False),
    "zlib": (2, 400, False),
    "int64": (3, 50, True),
}


def _encode_both(case):
    seed, rows, big = CASES[case]
    idx, off = _csr(seed, rows, big=big)
    digest = wire.callsets_digest(IDS)
    port = wire.encode_shard_frames(
        Shard("17", 100, 200), (idx, off, rows + 3), digest, "abc123"
    )
    ref = jax_wire.encode_shard_frames(
        JaxShard("17", 100, 200), (idx, off, rows + 3), digest, "abc123"
    )
    return port, ref, idx, off


def _decode(decoder_cls, body, chunk, digest=None):
    dec = decoder_cls(expect_digest=digest)
    frames = []
    for i in range(0, len(body), chunk):
        frames.extend(dec.feed(body[i : i + chunk]))
    end = dec.finish()
    return frames, end


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_are_byte_identical(case):
    port, ref, _, _ = _encode_both(case)
    assert port == ref
    assert port[:4] == b"SXCF" and port[4] == jax_wire.WIRE_VERSION


def test_codec_choice_and_constants_match():
    assert wire.WIRE_MAGIC == jax_wire.WIRE_MAGIC
    assert wire.WIRE_VERSION == jax_wire.WIRE_VERSION
    assert (wire.FRAME_DATA, wire.FRAME_END) == (
        jax_wire.FRAME_DATA,
        jax_wire.FRAME_END,
    )
    for case, codec in (("empty", "raw"), ("zlib", "zlib")):
        port, _, _, _ = _encode_both(case)
        (header, _, _), = _decode(wire.FrameDecoder, port, len(port))[0]
        assert header["codec"] == codec
    assert wire.encode_end_frame(3) == jax_wire.encode_end_frame(3)
    empty = wire.encode_shard_frames(Shard("1", 0, 10), None, "d")
    assert empty == jax_wire.encode_shard_frames(
        JaxShard("1", 0, 10), None, "d"
    )


@pytest.mark.parametrize("chunk", [1, 7, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_decoder_reads_the_other_packages_frames(case, chunk):
    port, ref, idx, off = _encode_both(case)
    digest = wire.callsets_digest(IDS)
    for decoder_cls, body in (
        (wire.FrameDecoder, ref),
        (jax_wire.FrameDecoder, port),
    ):
        frames, end = _decode(decoder_cls, body, chunk, digest)
        assert end == {"frames": 1}
        (header, got_idx, got_off), = frames
        np.testing.assert_array_equal(got_idx, idx)
        np.testing.assert_array_equal(got_off, off)
        assert got_idx.dtype == got_off.dtype == np.int64
        assert header["variants_read"] == CASES[case][1] + 3
        assert header["identity"] == "abc123"


@pytest.mark.parametrize("cut", [3, 11, 40, -5, -1])
def test_truncation_raises_wire_format_error(cut):
    port, _, _, _ = _encode_both("zlib")
    for decoder_cls, error in (
        (wire.FrameDecoder, wire.WireFormatError),
        (jax_wire.FrameDecoder, jax_wire.WireFormatError),
    ):
        dec = decoder_cls()
        with pytest.raises(error, match="truncated"):
            dec.feed(port[:cut])
            dec.finish()


@pytest.mark.parametrize("offset", [12, 60, -20, -2])
def test_crc_corruption_raises_wire_format_error(offset):
    port, _, _, _ = _encode_both("zlib")
    bad = bytearray(port)
    bad[offset] ^= 0x40
    for decoder_cls, error in (
        (wire.FrameDecoder, wire.WireFormatError),
        (jax_wire.FrameDecoder, jax_wire.WireFormatError),
    ):
        with pytest.raises(error):
            dec = decoder_cls()
            dec.feed(bytes(bad))
            dec.finish()


@pytest.mark.parametrize(
    "mutate,match",
    [
        (lambda b: b"XXXX" + b[4:], "magic"),
        (lambda b: b[:4] + bytes([9]) + b[5:], "version"),
        (lambda b: b + b"\x00", "after the end frame"),
    ],
    ids=["magic", "version", "trailing"],
)
def test_protocol_violations_raise_in_both(mutate, match):
    port, _, _, _ = _encode_both("tiny")
    for decoder_cls, error in (
        (wire.FrameDecoder, wire.WireFormatError),
        (jax_wire.FrameDecoder, jax_wire.WireFormatError),
    ):
        with pytest.raises(error, match=match):
            dec = decoder_cls()
            dec.feed(mutate(port))
            dec.finish()


def test_digest_mismatch_raises_in_both():
    port, _, _, _ = _encode_both("zlib")
    for decoder_cls, error in (
        (wire.FrameDecoder, wire.WireFormatError),
        (jax_wire.FrameDecoder, jax_wire.WireFormatError),
    ):
        with pytest.raises(error, match="digest"):
            decoder_cls(expect_digest="0" * 16).feed(port)


@pytest.mark.parametrize(
    "ids", [IDS, ["a"], [], ["xé", "y", "z"]], ids=["64", "1", "0", "utf8"]
)
def test_callsets_digest_is_equal(ids):
    assert wire.callsets_digest(ids) == jax_wire.callsets_digest(ids)


def test_remap_frames_matches_the_jax_package():
    frames_port, frames_ref = [], []
    for seed in (4, 5):
        idx, off = _csr(seed, 30)
        body = wire.encode_shard_frames(
            Shard("17", 0, 9), (idx, off, 30), "d"
        )
        frames_port.extend(_decode(wire.FrameDecoder, body, 64)[0])
        frames_ref.extend(_decode(jax_wire.FrameDecoder, body, 64)[0])
    indexes = {cid: 63 - i for i, cid in enumerate(IDS)}
    lookup = wire.OrdinalLookupCache().get(IDS, indexes)
    np.testing.assert_array_equal(
        lookup, jax_wire.build_ordinal_lookup(IDS, indexes)
    )
    got = wire.remap_frames(frames_port, lookup, IDS, Shard("17", 0, 9))
    want = jax_wire.remap_frames(
        frames_ref, lookup, IDS, JaxShard("17", 0, 9)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # An ordinal unknown to the run raises the callset's own id.
    partial = {cid: i for i, cid in enumerate(IDS[:-1])}
    lookup = wire.OrdinalLookupCache().get(IDS, partial)
    (_, idx, off), = frames_port[:1]
    idx = idx.copy()
    idx[0] = 63
    with pytest.raises(KeyError, match="cs63"):
        wire.remap_frames([({}, idx, off)], lookup, IDS)
    with pytest.raises(wire.WireFormatError, match="answers shard"):
        wire.remap_frames(frames_port, lookup, IDS, Shard("17", 1, 9))
    assert wire.remap_frames([], lookup, IDS) is None


def test_lookup_cache_keys_on_the_dict_identity():
    cache = wire.OrdinalLookupCache()
    a = {cid: i for i, cid in enumerate(IDS)}
    first = cache.get(IDS, a)
    assert cache.get(IDS, a) is first
    b = dict(a)
    assert cache.get(IDS, b) is not first
