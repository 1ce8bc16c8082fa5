"""Delta index over the cohort-hash cache: nearest-ancestor Gramians.

The serving tier's result cache (``serving/tier.py``) is keyed on the
murmur3 cohort hash of the fully-resolved analysis parameters — exact
matches only. This module adds the INCREMENTAL layer underneath it: a
per-server index of finished Gramians keyed by the **base key** (the
resolved parameters that determine G's VALUES — variant sets,
references, AF filter — excluding the sample set, which determines G's
FRAME, and ``num_pc``, which only shapes the finish), each entry
carrying the cohort's sample frame and an integrity checksum. A new
submission resolves to its nearest cached ancestor — same base key,
sample set differing by at most ``delta_max_samples`` — and the engine
updates that G with exact rank-k corrections (:mod:`ops.delta`) instead
of re-accumulating from scratch.

Safety posture: deltas are an OPTIMIZATION and must never be able to
change results. Every cached G carries a murmur3 checksum taken at
insert; resolution re-verifies it, and any mismatch (or any error while
applying a correction) falls back to the cold path — counted as
``serving_delta_jobs_total{outcome="fallback"}`` so operators see decay
instead of silently losing the win. The delta math itself is
integer-exact, so a served delta is bit-identical to from-scratch
(pinned by tests); the checksum guards the CACHE, not the math.

The index also caches the base key's full-frame CSR **windows** (the
ingest stream's ``(indices, lens)`` pairs) when a cold run captured
them, so corrections are built from in-memory arrays — the O(k·N)
touch-up never re-pays the host ingest. Both stores are LRU-bounded by
bytes; torch-free at import time like the rest of ``serving/``.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

import numpy as np

__all__ = [
    "DEFAULT_DELTA_MAX_SAMPLES",
    "DEFAULT_GANG_MAX_SAMPLES",
    "DeltaEntry",
    "DeltaIndex",
    "gramian_base_key",
    "gramian_checksum",
    "note_delta",
]

# Largest sample-set symmetric difference the ancestor resolution will
# bridge (|added| + |removed|): beyond it a from-scratch run is cheaper
# than the correction. 0 disables the delta tier entirely.
DEFAULT_DELTA_MAX_SAMPLES = 16

# Cohorts at or below this many samples are gang-batching candidates
# (serving/tier.py): small-N jobs are dispatch-bound, exactly where
# stacking them along a batch axis amortizes device round-trips.
DEFAULT_GANG_MAX_SAMPLES = 256

# LRU byte budgets for the cached Gramians and the per-base-key window
# sets. Internal constants, not flags: they bound SERVER memory, and the
# correct values follow from host RAM, not workload tuning.
_GRAMIAN_CACHE_BYTES = 256 << 20
_WINDOW_CACHE_BYTES = 128 << 20
# A single G bigger than this fraction of the budget is not worth
# caching (it would evict everything else for one unlikely ancestor).
_MAX_ENTRY_FRACTION = 4


def gramian_base_key(conf: Any) -> str:
    """Hex murmur3 key over the resolved parameters that determine G's
    values — variant sets, references window, AF filter. The sample
    restriction (``samples``/``exclude_samples``) is EXCLUDED on
    purpose: cohorts differing only in samples share a base key, which
    is what makes one cohort's G another cohort's ancestor. ``num_pc``
    is excluded too — it shapes the eigensolve, never G."""
    from spark_examples_tpu_torch.genomics.hashing import murmur3_x64_128

    payload = json.dumps(
        {
            "variant_set_ids": list(conf.variant_set_ids),
            "references": conf.references,
            "all_references": bool(conf.all_references),
            "min_allele_frequency": conf.min_allele_frequency,
        },
        sort_keys=True,
        separators=(",", ":"),
    ).encode("utf-8")
    return murmur3_x64_128(payload).hex()


def _host(g: Any) -> Any:
    """A Gramian as a host array: a torch tensor (on any device) comes
    back through ``.cpu().numpy()``; anything else passes through."""
    if hasattr(g, "detach") and hasattr(g, "cpu"):
        return g.detach().cpu().numpy()
    return g


def gramian_checksum(g: np.ndarray) -> str:
    """Integrity digest of a cached Gramian (murmur3 over the f32
    bytes) — taken at insert, re-verified at resolve. The JAX package's
    digest over the same bytes, so a delta file either package persisted
    verifies in the other."""
    from spark_examples_tpu_torch.genomics.hashing import murmur3_x64_128

    return murmur3_x64_128(
        np.ascontiguousarray(_host(g), dtype=np.float32).tobytes()
    ).hex()


def note_delta(outcome: str) -> None:
    """Count one delta resolution outcome: ``hit`` (ancestor found and
    applied), ``fallback`` (checksum mismatch or correction error →
    cold), ``miss`` (no ancestor within range → cold)."""
    from spark_examples_tpu_torch import obs

    obs.get_registry().counter(
        "serving_delta_jobs_total",
        "Delta-index resolutions for analysis jobs (hit = served by "
        "rank-k correction; fallback = guard tripped, ran cold; miss = "
        "no cached ancestor)",
    ).labels(outcome=outcome).inc()


class DeltaEntry:
    """One cached Gramian: base key + sample frame + f32 G + checksum.

    ``g`` is treated as IMMUTABLE once inserted — resolution hands the
    same array to every delta job, and the correction math never writes
    into it (``ops.delta`` gathers from it into a fresh target array).
    """

    __slots__ = ("base_key", "samples", "g", "checksum")

    def __init__(
        self, base_key: str, samples: Tuple[str, ...], g: np.ndarray
    ) -> None:
        self.base_key = base_key
        self.samples = samples
        # A PRIVATE copy, never a view: ``.numpy()`` of a CPU tensor is a
        # zero-copy view of the tensor's storage, which a later in-place
        # accumulation could overwrite — the checksum guard would catch
        # the corruption, but the cache entry would be lost. A card
        # tensor comes to the host first; the copy then makes the entry
        # self-owned either way.
        self.g = np.array(_host(g), dtype=np.float32, order="C", copy=True)
        self.checksum = gramian_checksum(self.g)

    def verify(self) -> bool:
        """True when the cached bytes still match the insert-time
        checksum — the fall-back-to-cold guard."""
        return gramian_checksum(self.g) == self.checksum


class DeltaIndex:
    """Thread-safe nearest-ancestor index of cached Gramians + the
    per-base-key full-frame window cache (both byte-bounded LRU).

    ``persist_dir`` arms WRITE-THROUGH persistence: every inserted
    Gramian entry also lands as an ``.npz`` beside the job journal
    (atomic tmp→fsync→rename, the mirror-staging discipline), and a
    restarted index re-loads the directory — so a ``kill -9``'d server
    answers ±k delta queries warm instead of re-running every ancestor
    cold. The insert-time checksum rides the file and is RE-VERIFIED at
    load: a torn, truncated, or stale entry is dropped LOUDLY (warning
    + file unlink) and that cohort simply runs cold — persistence is an
    optimization and can never change results (the same posture as the
    in-memory checksum guard). The window cache is NOT persisted: the
    first delta against a re-loaded ancestor re-streams host ingest
    once and re-captures.

    In replicated serving the persist dir lives on the shared store, so
    the write-through is cross-replica: a warm delta computed on one
    replica answers on all. Two extra pieces make that safe and useful:
    ``fence`` (a zero-arg callable raising ``FencedWriteError`` when
    this process lost its lease) gates every persisted write — a
    zombie's Gramian never lands in the shared tier — and a resolve
    MISS rescans the directory for entries peers persisted since our
    last look before answering cold.
    """

    def __init__(
        self,
        max_delta_samples: int = DEFAULT_DELTA_MAX_SAMPLES,
        max_bytes: int = _GRAMIAN_CACHE_BYTES,
        max_window_bytes: int = _WINDOW_CACHE_BYTES,
        persist_dir: Optional[str] = None,
        fence: Optional[Callable[[], None]] = None,
    ) -> None:
        self.max_delta_samples = max(0, max_delta_samples)
        self.max_bytes = max(1, max_bytes)
        self.max_window_bytes = max(1, max_window_bytes)
        self._lock = threading.Lock()
        # (base_key, samples) -> entry, LRU over total G bytes.
        self._entries: "collections.OrderedDict[Tuple[str, Tuple[str, ...]], DeltaEntry]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        # base_key -> list of (indices, lens) full-frame windows.
        self._windows: "collections.OrderedDict[str, List[Tuple[np.ndarray, np.ndarray]]]" = (
            collections.OrderedDict()
        )
        self._window_bytes: Dict[str, int] = {}
        self._persist_dir = persist_dir
        self._fence = fence
        # Persisted filenames already loaded (or written) by THIS
        # process — the rescan-on-miss skips them, so a rescan costs
        # one listdir plus only the files peers added since.
        self._seen_files: Set[str] = set()
        if persist_dir is not None:
            os.makedirs(persist_dir, exist_ok=True)
            loaded = self._load_persisted(sweep_partials=True)
            if loaded:
                print(
                    f"Delta cache re-loaded: {loaded} persisted Gramian "
                    f"entr{'y' if loaded == 1 else 'ies'} "
                    f"(warm ±k answers survive the restart)."
                )

    # -- persistence ----------------------------------------------------------

    @staticmethod
    def _entry_filename(base_key: str, samples: Tuple[str, ...]) -> str:
        """Deterministic per-(base key, frame) filename — recomputable,
        so eviction/drop can unlink without tracking state."""
        from spark_examples_tpu_torch.genomics.hashing import murmur3_x64_128

        frame = murmur3_x64_128(
            "\x00".join(samples).encode("utf-8")
        ).hex()[:16]
        return f"delta-{base_key[:16]}-{frame}.npz"

    def _entry_path(self, entry: DeltaEntry) -> Optional[str]:
        if self._persist_dir is None:
            return None
        return os.path.join(
            self._persist_dir,
            self._entry_filename(entry.base_key, entry.samples),
        )

    def _persist_entry(self, entry: DeltaEntry) -> None:
        """Write one entry through to disk (atomic: a kill mid-write
        leaves only a ``.tmp-`` partial the next load sweeps).

        The fence runs FIRST and outside the OSError handler on
        purpose: ``FencedWriteError`` is RuntimeError-shaped, so the
        disk-weather catch below can never degrade a zombie's rejected
        write into a warning."""
        from spark_examples_tpu_torch.resilience import faults

        path = self._entry_path(entry)
        if path is None:
            return
        if self._fence is not None:
            self._fence()
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    g=entry.g,
                    samples=np.asarray(entry.samples, dtype=np.str_),
                    base_key=np.asarray(entry.base_key),
                    checksum=np.asarray(entry.checksum),
                )
                f.flush()
                os.fsync(f.fileno())
                # Torn-write seam (InjectedFault is IOError-shaped, so
                # the disk-weather catch below handles it like any
                # mid-write crash: warn, sweep the tmp, stay in memory).
                faults.inject_write("serving.delta.write", tmp)
            os.replace(tmp, path)
            # Our own write needs no rescan pickup.
            self._seen_files.add(os.path.basename(path))
        except OSError as e:
            # Disk weather costs only restart warmth, never a result.
            print(
                f"WARNING: delta-cache persist failed for {path} "
                f"({type(e).__name__}: {e}); entry stays memory-only.",
                file=sys.stderr,
            )
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _unlink_entry(self, entry: DeltaEntry) -> None:
        path = self._entry_path(entry)
        if path is None:
            return
        try:
            os.unlink(path)
        except OSError:
            pass

    def _load_persisted(self, sweep_partials: bool = False) -> int:
        """Load persisted entries this process has not seen yet,
        loudest-possible skepticism: any unreadable/torn/checksum-
        mismatched file is warned about and unlinked — the affected
        cohort runs cold, exactly as if the entry had never been
        written. Returns the number of entries loaded.

        ``sweep_partials`` is startup-only: on a SHARED persist dir a
        ``.tmp-`` file seen mid-run may be a live peer's in-progress
        write, so rescans leave partials alone (the writer's rename
        makes them visible atomically)."""
        assert self._persist_dir is not None
        loaded = 0
        try:
            names = sorted(os.listdir(self._persist_dir))
        except OSError:
            return 0
        for name in names:
            path = os.path.join(self._persist_dir, name)
            if ".tmp-" in name:
                if sweep_partials:
                    # A kill mid-persist's partial: never parse, sweep.
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                continue
            if not name.endswith(".npz") or name in self._seen_files:
                continue
            try:
                with np.load(path, allow_pickle=False) as doc:
                    g = np.asarray(doc["g"], dtype=np.float32)
                    samples = tuple(str(s) for s in doc["samples"])
                    base_key = str(doc["base_key"])
                    checksum = str(doc["checksum"])
                if gramian_checksum(g) != checksum:
                    raise ValueError(
                        "stored checksum does not match the G bytes"
                    )
            except Exception as e:  # noqa: BLE001 — torn/stale cache file
                print(
                    f"WARNING: dropping torn/stale delta-cache entry "
                    f"{path} ({type(e).__name__}: {e}); that cohort "
                    "runs cold and re-warms.",
                    file=sys.stderr,
                )
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            # In-memory insert WITHOUT re-persisting (the file is the
            # source we just read); oversized entries obey the same
            # budget rule as live puts.
            entry = DeltaEntry(base_key, samples, g)
            if entry.g.nbytes > self.max_bytes // _MAX_ENTRY_FRACTION:
                # Over the per-entry budget share (a shrunken budget
                # since it was written): drop the file too, or every
                # restart re-reads and re-verifies the same dead entry.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            with self._lock:
                self._entries[(base_key, samples)] = entry
                self._bytes += entry.g.nbytes
                evicted = self._evict_over_budget_locked()
            for gone in evicted:
                # A persisted set over the byte budget sheds its
                # oldest files here, or every restart would re-read,
                # re-verify, and re-evict the same dead entries.
                if gone is not entry:
                    self._unlink_entry(gone)
            self._seen_files.add(name)
            loaded += 1
        return loaded

    def _evict_over_budget_locked(self) -> List[DeltaEntry]:
        """Pop LRU entries past the byte budget; the caller unlinks the
        returned entries' files outside the lock."""
        from spark_examples_tpu_torch.utils.lockcheck import assert_lock_held

        assert_lock_held(
            self._lock, "DeltaIndex._evict_over_budget_locked"
        )
        evicted: List[DeltaEntry] = []
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            _, entry = self._entries.popitem(last=False)
            self._bytes -= entry.g.nbytes
            evicted.append(entry)
        return evicted

    # -- Gramian entries ------------------------------------------------------

    def resolve(
        self, base_key: str, samples: Sequence[str]
    ) -> Optional[DeltaEntry]:
        """Nearest cached ancestor: same base key, sample-set symmetric
        difference ≤ ``max_delta_samples`` (0 = exact frame, the
        num_pc-tweak case). Ties prefer the smallest difference, then
        the most recently used. Returns None when nothing qualifies.

        On a MISS with shared persistence armed, the directory is
        rescanned first — a peer replica may have persisted exactly
        this ancestor since our last look (one listdir; already-seen
        files are skipped) — and resolution retried once."""
        best = self._resolve_once(base_key, samples)
        if best is None and self._persist_dir is not None:
            try:
                fresh = self._load_persisted()
            except Exception:  # noqa: BLE001 — rescan is best-effort
                fresh = 0
            if fresh:
                print(
                    f"Delta cache rescanned: {fresh} entr"
                    f"{'y' if fresh == 1 else 'ies'} persisted by peer "
                    "replica(s) picked up."
                )
                best = self._resolve_once(base_key, samples)
        return best

    def _resolve_once(
        self, base_key: str, samples: Sequence[str]
    ) -> Optional[DeltaEntry]:
        want = set(samples)
        with self._lock:
            best: Optional[DeltaEntry] = None
            best_d = self.max_delta_samples + 1
            # Most-recently-used last; iterate reversed so recency
            # breaks ties at equal distance.
            for (key, _), entry in reversed(self._entries.items()):
                if key != base_key:
                    continue
                d = len(want.symmetric_difference(entry.samples))
                if d < best_d:
                    best, best_d = entry, d
                    if d == 0:
                        break
            if best is not None:
                self._entries.move_to_end((base_key, best.samples))
            return best

    def put(
        self, base_key: str, samples: Sequence[str], g: np.ndarray
    ) -> None:
        """Insert/refresh one finished Gramian (no-op when a single G
        would consume more than its budget share). With persistence
        armed the entry writes through to disk — file I/O OUTSIDE the
        index lock (the journal-append discipline: concurrent resolves
        must never stall on a slow disk)."""
        entry = DeltaEntry(base_key, tuple(samples), g)
        if entry.g.nbytes > self.max_bytes // _MAX_ENTRY_FRACTION:
            return
        key = (base_key, entry.samples)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.g.nbytes
            self._entries[key] = entry
            self._bytes += entry.g.nbytes
            evicted = self._evict_over_budget_locked()
        self._persist_entry(entry)
        for gone in evicted:
            if gone is not entry:
                self._unlink_entry(gone)
        # Re-check membership AFTER persisting: a concurrent put() may
        # have evicted this entry (and unlinked its file) between the
        # insert and the write above — the re-written file would then
        # orphan an entry no longer in memory. Every interleaving
        # converges: whichever of the evictor's unlink and this one
        # runs last removes the file.
        with self._lock:
            still_in = self._entries.get(key) is entry
        if not still_in:
            self._unlink_entry(entry)

    def drop(self, entry: DeltaEntry) -> None:
        """Remove a corrupt entry (checksum guard tripped) — from the
        persisted tier too, so a restart can never resurrect it."""
        key = (entry.base_key, entry.samples)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.g.nbytes
        self._unlink_entry(entry)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        """Occupancy snapshot for ``/statusz`` (hit-ratio lives in the
        metrics registry: ``serving_delta_jobs_total{outcome=...}``)."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": int(self._bytes),
                "max_bytes": int(self.max_bytes),
                "window_sets": len(self._windows),
                "window_bytes": int(sum(self._window_bytes.values())),
                "max_window_bytes": int(self.max_window_bytes),
            }

    # -- full-frame window cache ----------------------------------------------

    def windows(
        self, base_key: str
    ) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
        """The base key's captured full-frame CSR windows (None when no
        cold run captured them yet). The returned list and its arrays
        are shared and must be treated as read-only."""
        with self._lock:
            wins = self._windows.get(base_key)
            if wins is not None:
                self._windows.move_to_end(base_key)
            return wins

    def put_windows(
        self,
        base_key: str,
        windows: Sequence[Tuple[np.ndarray, np.ndarray]],
    ) -> None:
        nbytes = int(
            sum(int(i.nbytes) + int(l.nbytes) for i, l in windows)
        )
        if nbytes > self.max_window_bytes // _MAX_ENTRY_FRACTION:
            return
        with self._lock:
            if base_key in self._windows:
                self._windows.move_to_end(base_key)
                return  # same base key => same stream; keep the first
            self._windows[base_key] = list(windows)
            self._window_bytes[base_key] = nbytes
            while (
                sum(self._window_bytes.values()) > self.max_window_bytes
                and len(self._windows) > 1
            ):
                evicted_key, _ = self._windows.popitem(last=False)
                self._window_bytes.pop(evicted_key, None)
