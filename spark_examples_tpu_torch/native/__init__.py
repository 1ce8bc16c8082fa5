"""ctypes loader of the native host core (``csrc/genomics_native.cpp``).

:func:`load` builds the source with ``g++`` at first use
(:mod:`spark_examples_tpu_torch.cuda_build`: a hash of the source and the
flags names the library, so an edited source is rebuilt and a stale
library is never loaded), binds its ``extern "C"`` signatures and returns
the library. A failed build raises with the compiler's output: there is no
silent fallback. Callers reach the numpy/Python versions of these loops by
an argument (``native=False``), never by an environment variable.

``ctypes.CDLL`` releases the GIL for the length of each call, which is what
lets the builder threads of the packed-block stage run the scatter in
parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from spark_examples_tpu_torch import cuda_build

__all__ = ["COHORT_CSR_ABI", "CohortCsr", "SOURCE", "load"]

SOURCE = "genomics_native"
# Version of the CohortCsr layout below; the library reports its own.
COHORT_CSR_ABI = 2


class CohortCsr(ctypes.Structure):
    """Mirror of the C ``CohortCsr`` result struct (genomics_native.cpp)."""

    _fields_ = [
        ("n_variants", ctypes.c_int64),
        ("n_calls", ctypes.c_int64),
        ("n_contigs", ctypes.c_int64),
        ("n_vsids", ctypes.c_int64),
        ("error", ctypes.c_int64),
        ("error_line", ctypes.c_int64),
        ("starts", ctypes.POINTER(ctypes.c_int64)),
        ("ends", ctypes.POINTER(ctypes.c_int64)),
        ("contig_code", ctypes.POINTER(ctypes.c_int32)),
        ("vsid_code", ctypes.POINTER(ctypes.c_int32)),
        ("afs", ctypes.POINTER(ctypes.c_double)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("ords", ctypes.POINTER(ctypes.c_int32)),
        ("contig_blob", ctypes.POINTER(ctypes.c_char)),
        ("contig_offs", ctypes.POINTER(ctypes.c_int64)),
        ("vsid_blob", ctypes.POINTER(ctypes.c_char)),
        ("vsid_offs", ctypes.POINTER(ctypes.c_int64)),
        ("ref_blob", ctypes.POINTER(ctypes.c_char)),
        ("ref_offs", ctypes.POINTER(ctypes.c_int64)),
        ("alt_blob", ctypes.POINTER(ctypes.c_char)),
        ("alt_offs", ctypes.POINTER(ctypes.c_int64)),
    ]


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The bound native library, built first if needed (raises if the
    build fails or the library's struct layout is not this module's)."""
    global _lib
    if _lib is not None:  # lock-free once resolved (hot-loop callers)
        return _lib
    with _lock:
        if _lib is None:
            _lib = _bind(cuda_build.load(SOURCE))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the ctypes signatures on the freshly loaded library."""
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.pack_calls.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.pack_calls.restype = None
    lib.csr_to_packed_blocks.argtypes = [ptr, ptr, i64, i64, i64, ptr]
    lib.csr_to_packed_blocks.restype = i64
    lib.murmur3_x64_128.argtypes = [ptr, i64, ctypes.c_uint64, ptr]
    lib.murmur3_x64_128.restype = None
    lib.murmur3_x64_128_batch.argtypes = [
        ptr, ptr, i64, ctypes.c_uint64, ptr,
    ]
    lib.murmur3_x64_128_batch.restype = None
    lib.cohort_csr_abi_version.argtypes = []
    lib.cohort_csr_abi_version.restype = i64
    abi = lib.cohort_csr_abi_version()
    if abi != COHORT_CSR_ABI:
        raise RuntimeError(
            f"{SOURCE}: CohortCsr layout {abi}, the loader mirrors "
            f"{COHORT_CSR_ABI}"
        )
    lib.parse_cohort_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ptr, i64, i64,
    ]
    lib.parse_cohort_jsonl.restype = ctypes.POINTER(CohortCsr)
    lib.cohort_csr_free.argtypes = [ctypes.POINTER(CohortCsr)]
    lib.cohort_csr_free.restype = None
    lib.emit_order.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr]
    lib.emit_order.restype = i64
    lib.emit_rows.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr, i64,
    ]
    lib.emit_rows.restype = i64
    return lib
