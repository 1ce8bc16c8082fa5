"""Binary columnar wire tier: CSR shard frames (the protobuf analog).

The JAX package's ``genomics/wire.py``: frames are BYTE-IDENTICAL between
the packages, so either package's client decodes the other's server. The
reference's bulk channel ships compact serialized protobuf bytes over gRPC
(``VariantsRDD.scala:242-252``); here the binary representation is the
CSR sidecar's: one versioned, length-prefixed, checksummed binary frame per
shard carrying the shard's ``(indices, offsets)`` CSR pair in CALLSET
ORDINALS (position in the server's callset order), remapped to the run's
dense sample indexes client-side exactly as the local sidecar tier remaps
(the dense index is config-dependent, the file order is not).

Frame layout (all integers little-endian)::

    magic      4 bytes   b"SXCF"
    version    1 byte    (WIRE_VERSION)
    ftype      1 byte    (1 = data, 2 = end)
    header_len u32
    header     JSON (utf-8), header_len bytes
    payload    indices bytes ++ offsets bytes   (data frames only;
               dtypes + counts in the header, so payload length is
               derivable before it arrives)
    crc32      u32 over every byte above (magic through payload)

Data header keys: ``contig``/``start``/``end`` (the shard echo, so a
misrouted response is loud), ``rows``/``nnz``, ``idx_dtype``/
``off_dtype`` (``"<i4"`` when values fit in int32 — the compactness
win — else ``"<i8"``), ``codec`` (``"zlib"`` when deflating the
payload shrank it — ordinal arrays are mostly-zero high bytes, ~4-5×
— else ``"raw"``), ``payload_len`` (payload bytes ON THE WIRE, so the
splitter needs no guesswork under compression), ``variants_read`` (the
post-variant-set-filter, pre-AF count, so client IoStats stay
parity-identical to the JSON tier), ``callsets_digest`` (digest of the
server's callset-ordinal id list: a client holding a different order
must fail loudly, never remap silently wrong), and optional
``identity`` (the cohort content digest). End header:
``{"frames": n}`` — a stream that ends any other way is truncated and
raises; corruption anywhere fails the CRC. No per-record JSON exists
anywhere on this path.

Versioning/compat rules (docs/WIRE_FORMAT.md): the version byte is the
whole negotiation — a decoder refuses frames of a version it does not
speak, and servers never mix versions within a stream. Unknown header
keys are ignored (additive evolution); any layout change bumps
``WIRE_VERSION``. Transports carry frames opaquely (HTTP: the response
body is concatenated frames; gRPC: each stream message is an arbitrary
byte chunk of the same concatenation), so the codec — and its checksum
guarantee — is identical on every wire.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "WIRE_MAGIC",
    "WIRE_VERSION",
    "FRAME_DATA",
    "FRAME_END",
    "WireFormatError",
    "FrameDecoder",
    "callsets_digest",
    "encode_data_frame",
    "encode_end_frame",
    "encode_shard_frames",
    "iter_frame_chunks",
    "note_frame_metrics",
]

WIRE_MAGIC = b"SXCF"
WIRE_VERSION = 1
FRAME_DATA = 1
FRAME_END = 2

_PREFIX = struct.Struct("<4sBBI")  # magic, version, ftype, header_len
_CRC = struct.Struct("<I")

# Sanity bound on the JSON header (a corrupt length prefix must not
# provoke a multi-GB allocation before the CRC gets a chance to fail).
_MAX_HEADER = 1 << 20


class WireFormatError(IOError):
    """A frame failed to decode: bad magic/version, checksum mismatch,
    truncation (missing end frame / partial trailing bytes), or header
    values that contradict the payload. An IOError on purpose — the
    retry classifiers treat it as transport weather, so a corrupted
    frame is retried per policy and NEVER silently dropped."""


def callsets_digest(ids: Sequence[str]) -> str:
    """Digest of a callset-ordinal id list (the frame header pin)."""
    h = hashlib.sha256()
    for cid in ids:
        h.update(cid.encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _compact_dtype(max_value: int) -> np.dtype:
    """int32 when every value fits (the 2x wire saving), else int64."""
    return np.dtype("<i4") if max_value < 2**31 else np.dtype("<i8")


def _frame(ftype: int, header: dict, payload: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    body = _PREFIX.pack(WIRE_MAGIC, WIRE_VERSION, ftype, len(hdr)) + hdr
    body += payload
    return body + _CRC.pack(zlib.crc32(body))


def encode_data_frame(
    shard,
    indices: np.ndarray,
    offsets: np.ndarray,
    variants_read: int,
    callsets_digest: str,
    identity: Optional[str] = None,
) -> bytes:
    """One shard's ordinal CSR pair → one wire frame. ``indices`` holds
    callset ORDINALS; ``offsets`` is rows+1 long with ``offsets[-1] ==
    len(indices)`` (the ``csr_pair_from_lists`` shape)."""
    indices = np.asarray(indices, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    idx_dt = _compact_dtype(int(indices.max()) if indices.size else 0)
    off_dt = _compact_dtype(int(offsets[-1]) if offsets.size else 0)
    payload = (
        indices.astype(idx_dt, copy=False).tobytes()
        + offsets.astype(off_dt, copy=False).tobytes()
    )
    # Ordinal arrays are mostly-zero high bytes; deflate wins ~4-5× on
    # real cohorts. Kept only when it actually shrinks (tiny payloads
    # can grow), recorded in the header either way.
    codec = "raw"
    deflated = zlib.compress(payload, 6)
    if len(deflated) < len(payload):
        payload, codec = deflated, "zlib"
    header = {
        "contig": shard.contig,
        "start": shard.start,
        "end": shard.end,
        "rows": int(offsets.size) - 1 if offsets.size else 0,
        "nnz": int(indices.size),
        "idx_dtype": idx_dt.str,
        "off_dtype": off_dt.str,
        "codec": codec,
        "payload_len": len(payload),
        "variants_read": int(variants_read),
        "callsets_digest": callsets_digest,
    }
    if identity:
        header["identity"] = identity
    return _frame(FRAME_DATA, header, payload)


def encode_end_frame(frames: int) -> bytes:
    """The end-of-stream sentinel: a stream without one is truncated."""
    return _frame(FRAME_END, {"frames": int(frames)})


def encode_shard_frames(
    shard,
    payload: Optional[Tuple[np.ndarray, np.ndarray, int]],
    callsets_digest: str,
    identity: Optional[str] = None,
) -> bytes:
    """The full response body for one shard request: one data frame
    (rows may be 0 — the count still travels) + the end frame."""
    if payload is None:
        indices = np.zeros(0, dtype=np.int64)
        offsets = np.zeros(1, dtype=np.int64)
        variants_read = 0
    else:
        indices, offsets, variants_read = payload
    return encode_data_frame(
        shard, indices, offsets, variants_read, callsets_digest, identity
    ) + encode_end_frame(1)


class FrameDecoder:
    """Incremental frame splitter/validator over arbitrary byte chunks.

    Both transports feed it: HTTP response reads and gRPC stream
    messages are just chunkings of the same concatenated-frame byte
    stream. ``feed`` returns fully decoded data frames as
    ``(header, indices, offsets)`` with arrays widened to int64;
    ``finish`` must be called at stream end and raises unless exactly
    one end frame arrived last with no trailing or missing bytes — so
    truncation anywhere (mid-prefix, mid-header, mid-payload, a lost
    end frame) is a loud :class:`WireFormatError`, never silent record
    loss.
    """

    def __init__(self, expect_digest: Optional[str] = None):
        self._buf = bytearray()
        self._expect_digest = expect_digest
        self._end: Optional[dict] = None
        self.frames = 0
        self.bytes = 0

    def feed(self, chunk: bytes) -> List[Tuple[dict, np.ndarray, np.ndarray]]:
        if self._end is not None and chunk:
            raise WireFormatError(
                "bytes after the end frame (protocol violation)"
            )
        self._buf += chunk
        self.bytes += len(chunk)
        out = []
        while True:
            frame = self._try_take_frame()
            if frame is None:
                return out
            ftype, header, payload = frame
            if ftype == FRAME_END:
                if self._buf:
                    raise WireFormatError(
                        "bytes after the end frame (protocol violation)"
                    )
                self._end = header
                return out
            out.append(self._decode_data(header, payload))
            self.frames += 1

    def _try_take_frame(self) -> Optional[Tuple[int, dict, bytes]]:
        """One complete frame off the buffer, or None (need more)."""
        buf = self._buf
        if len(buf) < _PREFIX.size:
            return None
        magic, version, ftype, header_len = _PREFIX.unpack_from(buf)
        if magic != WIRE_MAGIC:
            raise WireFormatError(
                f"bad frame magic {bytes(magic)!r} (not a CSR frame "
                "stream — server speaks a different protocol?)"
            )
        if version != WIRE_VERSION:
            raise WireFormatError(
                f"unsupported wire version {version} (this client "
                f"speaks v{WIRE_VERSION})"
            )
        if ftype not in (FRAME_DATA, FRAME_END):
            raise WireFormatError(f"unknown frame type {ftype}")
        if header_len > _MAX_HEADER:
            raise WireFormatError(
                f"frame header length {header_len} exceeds the "
                f"{_MAX_HEADER}-byte bound (corrupt length prefix?)"
            )
        body_end = _PREFIX.size + header_len
        if len(buf) < body_end:
            return None
        try:
            header = json.loads(bytes(buf[_PREFIX.size : body_end]))
        except ValueError as e:
            raise WireFormatError(f"unparseable frame header: {e}") from e
        payload_len = 0
        if ftype == FRAME_DATA:
            try:
                payload_len = int(header["payload_len"])
                if (
                    int(header["nnz"]) < 0
                    or int(header["rows"]) < 0
                    or payload_len < 0
                ):
                    raise ValueError("negative counts")
                if header.get("codec", "raw") not in ("raw", "zlib"):
                    raise ValueError(
                        f"unknown payload codec {header.get('codec')!r}"
                    )
            except (KeyError, TypeError, ValueError) as e:
                raise WireFormatError(f"invalid frame header: {e}") from e
        total = body_end + payload_len + _CRC.size
        if len(buf) < total:
            return None
        (crc_stored,) = _CRC.unpack_from(buf, total - _CRC.size)
        crc = zlib.crc32(bytes(buf[: total - _CRC.size]))
        if crc != crc_stored:
            raise WireFormatError(
                f"frame checksum mismatch (crc32 {crc:#010x} != stored "
                f"{crc_stored:#010x}): corrupt frame on the wire"
            )
        payload = bytes(buf[body_end : total - _CRC.size])
        del self._buf[:total]
        return ftype, header, payload

    def _decode_data(self, header: dict, payload: bytes):
        idx_dt = np.dtype(header["idx_dtype"])
        off_dt = np.dtype(header["off_dtype"])
        nnz, rows = int(header["nnz"]), int(header["rows"])
        if header.get("codec", "raw") == "zlib":
            try:
                payload = zlib.decompress(payload)
            except zlib.error as e:
                # CRC passed but deflate is broken: encoder bug or
                # version skew — refuse, never guess.
                raise WireFormatError(
                    f"frame payload fails to inflate: {e}"
                ) from e
        want = nnz * idx_dt.itemsize + (rows + 1) * off_dt.itemsize
        if len(payload) != want:
            raise WireFormatError(
                f"frame payload is {len(payload)} bytes, header "
                f"promises {want} (rows={rows}, nnz={nnz})"
            )
        split = nnz * idx_dt.itemsize
        indices = np.frombuffer(payload, dtype=idx_dt, count=nnz).astype(
            np.int64
        )
        offsets = np.frombuffer(
            payload[split:], dtype=off_dt, count=rows + 1
        ).astype(np.int64)
        if offsets[0] != 0 or offsets[-1] != nnz or (
            np.diff(offsets) < 0
        ).any():
            # The CRC says the bytes arrived intact, so this is an
            # encoder bug or a version skew the header check missed —
            # still refuse rather than build wrong blocks.
            raise WireFormatError(
                "frame offsets are not a valid CSR ramp "
                f"(rows={rows}, nnz={nnz})"
            )
        if self._expect_digest is not None and header.get(
            "callsets_digest"
        ) != self._expect_digest:
            raise WireFormatError(
                "frame callset-order digest "
                f"{header.get('callsets_digest')!r} does not match the "
                f"client's fetched order {self._expect_digest!r} "
                "(server callsets changed mid-run?)"
            )
        return header, indices, offsets

    def finish(self) -> dict:
        """Validate stream completeness; → the end-frame header."""
        if self._end is None:
            detail = (
                f" ({len(self._buf)} trailing partial bytes)"
                if self._buf
                else ""
            )
            raise WireFormatError(
                "frame stream truncated: no end frame" + detail
            )
        want = self._end.get("frames")
        if want is not None and int(want) != self.frames:
            raise WireFormatError(
                f"frame stream truncated: end frame promises {want} "
                f"data frame(s), received {self.frames}"
            )
        return self._end


def build_ordinal_lookup(ids: Sequence[str], indexes: dict) -> np.ndarray:
    """Server callset order → the run's dense sample indexes (-1 =
    unknown to this run; served frames referencing one raise KeyError,
    the unknown-callset contract every ingest tier shares)."""
    lookup = np.full(len(ids), -1, dtype=np.int64)
    for i, cid in enumerate(ids):
        if cid in indexes:
            lookup[i] = indexes[cid]
    return lookup


class OrdinalLookupCache:
    """Single-slot ordinal→dense-index cache keyed on the run's shared
    indexes dict IDENTITY (every dataset of a run shares one dict), the
    same shape as ``_CsrCohort``'s. Shared by both transports' frame
    clients so the subtle part — return the LOCALLY built/matched
    array, never re-read the slot after publication (a racing thread
    with a different dict could have overwritten it) — lives once."""

    def __init__(self) -> None:
        # ONE slot attribute holding the (indexes, lookup) pair: the
        # pair is read and written atomically (a single reference), so
        # a racing writer with a different dict can never tear a
        # matched key away from its value.
        self._slot: Optional[Tuple[dict, np.ndarray]] = None

    def get(self, ids: Sequence[str], indexes: dict) -> np.ndarray:
        slot = self._slot
        if slot is not None and slot[0] is indexes:
            return slot[1]
        lookup = build_ordinal_lookup(ids, indexes)
        self._slot = (indexes, lookup)
        return lookup


def remap_frames(
    frames,
    lookup: np.ndarray,
    ids: Sequence[str],
    shard=None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decoded data frames → ONE dense-index ``(indices, offsets)``
    pair (None for an empty shard window, the ``stream_carrying_csr``
    contract). Raises KeyError with the true callset id for ordinals
    outside the run's index — identical to the dict/sidecar tiers'
    ``mapping(callsetId)`` throw — and :class:`WireFormatError` when a
    frame answers a different shard than was asked (a misrouted or
    cache-skewed response must never feed the accumulator)."""
    if shard is not None:
        for header, _, _ in frames:
            got = (header.get("contig"), header.get("start"), header.get("end"))
            want = (shard.contig, shard.start, shard.end)
            if got != want:
                raise WireFormatError(
                    f"frame answers shard {got}, requested {want}"
                )
    if len(frames) == 1:
        ords, offsets = frames[0][1], frames[0][2]
    else:
        ords = np.concatenate([f[1] for f in frames]) if frames else (
            np.zeros(0, dtype=np.int64)
        )
        offsets = np.zeros(
            sum(f[2].size - 1 for f in frames) + 1, dtype=np.int64
        )
        pos, base = 1, 0
        for _, fi, fo in frames:
            n = fo.size - 1
            offsets[pos : pos + n] = fo[1:] + base
            base += fi.size
            pos += n
    if offsets.size <= 1 or ords.size == 0:
        return None
    if int(ords.min()) < 0 or int(ords.max()) >= lookup.size:
        raise WireFormatError(
            f"frame ordinal {int(ords.max())} outside the callset "
            f"order (len {lookup.size}) — server/client order skew"
        )
    mapped = lookup[ords]
    if (mapped < 0).any():
        bad = int(ords[mapped < 0][0])
        raise KeyError(str(ids[bad]))
    return mapped, offsets


def iter_frame_chunks(body: bytes, chunk: int = 1 << 20) -> Iterator[bytes]:
    """Slice an encoded frame stream into bounded wire chunks (the gRPC
    message framing; HTTP just writes the body whole)."""
    for i in range(0, len(body), chunk):
        yield body[i : i + chunk]


def note_frame_metrics(
    transport: str, frames: int, nbytes: int, decode_seconds: float
) -> None:
    """Frame-tier observability: count/bytes/decode-latency metrics
    (zero-cost when no telemetry session is active, like every obs
    surface)."""
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    if not collection_active():
        return
    reg = obs.get_registry()
    reg.counter(
        "wire_frames_total",
        "Binary CSR shard frames decoded, by transport",
    ).labels(transport=transport).inc(frames)
    reg.counter(
        "wire_frame_bytes_total",
        "Binary CSR frame bytes received, by transport",
    ).labels(transport=transport).inc(nbytes)
    reg.histogram(
        "wire_frame_decode_seconds",
        "Per-shard frame fetch+decode latency, by transport",
    ).labels(transport=transport).observe(decode_seconds)
