"""Cross-dataset variant identity: MurmurHash3 x64-128.

The reference keys variants for join/merge by a Guava
``murmur3_128`` over (contig, start, end, referenceBases,
concat(alternateBases)) — ``VariantsPca.scala:62-78``. This module
implements the same MurmurHash3 x64-128 function (Austin Appleby's public
algorithm, as Guava does) over the same byte stream Guava's hasher
produces: UTF-8 bytes for ``putString``, 8-byte little-endian for
``putLong``; the hex digest matches Guava's ``HashCode.toString()``
(little-endian byte order of h1 then h2).

The digests come from the native core (``csrc/genomics_native.cpp``: one
call per digest, or one call per batch in :func:`hash_payloads`); the
pure-Python body below is the reference implementation, byte-identical,
reached with ``native=False``.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Optional

from spark_examples_tpu_torch import native as native_core

__all__ = ["murmur3_x64_128", "variant_identity", "variant_identities"]

_MASK64 = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK64
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0, native: bool = True) -> bytes:
    """16-byte MurmurHash3 x64-128 digest (h1 then h2, little-endian):
    the native core's, or with ``native=False`` the pure-Python one."""
    if not native:
        return _murmur3_py(data, seed)
    out = ctypes.create_string_buffer(16)
    native_core.load().murmur3_x64_128(data, len(data), seed, out)
    return out.raw


def _murmur3_py(data: bytes, seed: int = 0) -> bytes:
    h1 = seed & _MASK64
    h2 = seed & _MASK64
    length = len(data)
    n_blocks = length // 16

    for i in range(n_blocks):
        off = i * 16
        k1 = int.from_bytes(data[off : off + 8], "little")
        k2 = int.from_bytes(data[off + 8 : off + 16], "little")

        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK64
        h1 = (h1 * 5 + 0x52DCE729) & _MASK64

        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK64
        h2 = (h2 * 5 + 0x38495AB5) & _MASK64

    tail = data[n_blocks * 16 :]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:], "little")
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8], "little")
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64

    return h1.to_bytes(8, "little") + h2.to_bytes(8, "little")


def _identity_payload(
    contig: str,
    start: int,
    end: int,
    reference_bases: Optional[str],
    alternate_bases,
) -> bytes:
    alt = "".join(alternate_bases) if alternate_bases else ""
    ref = reference_bases or ""
    return (
        contig.encode("utf-8")
        + int(start).to_bytes(8, "little", signed=True)
        + int(end).to_bytes(8, "little", signed=True)
        + ref.encode("utf-8")
        + alt.encode("utf-8")
    )


def hash_payloads(payloads, native: bool = True) -> list:
    """Hex identity keys of identity payload byte strings — the join/merge
    hot path: one native call over the concatenated payloads, or with
    ``native=False`` one pure-Python murmur3 per payload."""
    payloads = list(payloads)
    if not native or not payloads:
        return [_murmur3_py(p).hex() for p in payloads]
    offsets = (ctypes.c_int64 * (len(payloads) + 1))(
        *itertools.accumulate(map(len, payloads), initial=0)
    )
    out = ctypes.create_string_buffer(16 * len(payloads))
    native_core.load().murmur3_x64_128_batch(
        b"".join(payloads), offsets, len(payloads), 0, out
    )
    raw = out.raw
    return [raw[i * 16 : (i + 1) * 16].hex() for i in range(len(payloads))]


def variant_identities(variants, native: bool = True) -> list:
    """Batch identity hashing of built Variant objects."""
    return hash_payloads(
        (
            _identity_payload(
                v.contig, v.start, v.end, v.reference_bases,
                v.alternate_bases,
            )
            for v in variants
        ),
        native,
    )


def variant_identity(
    contig: str,
    start: int,
    end: int,
    reference_bases: Optional[str],
    alternate_bases,
) -> str:
    """Hex identity key for a variant, byte-compatible with the reference.

    Guava hasher stream (``VariantsPca.scala:69-77``): UTF-8 contig,
    little-endian int64 start, int64 end, UTF-8 referenceBases (null → ""),
    UTF-8 concatenated alternateBases (absent → "").
    """
    return murmur3_x64_128(
        _identity_payload(contig, start, end, reference_bases, alternate_bases)
    ).hex()
