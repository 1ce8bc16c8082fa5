"""Re-entrant, session-safe PCA execution engine.

The JAX package's ``serving/engine.py`` on PyTorch. The batch driver's run
loop is callable per job (``ingest_gramian`` + ``compute_pca`` +
``collect_result``) with NO mutable state shared between runs — each job
gets a fresh :class:`VariantsPcaDriver` (per-driver cursors and
speculation counters stay per-job), while everything immutable and
expensive is shared across jobs:

- **built kernels** — the scatter kernel's library is built once per
  process (``cuda_build.py``) and loaded on first launch;
- **the callset index** — one immutable :class:`CallsetIndex` per
  variantset tuple, built once and handed to every driver;
- **the source** — the resident CSR sidecar / fixture the server
  fronts; its read paths are already driven concurrently by the
  shard-parallel ingest workers.

Device execution is serialized by one engine lock: ingest feeds the
device accumulator and the eigensolve owns the card, so two jobs
interleaving their work would destroy both. The lock makes concurrent
submissions safe (they queue on the device in job order); host-side
work before the lock (spec resolution, index lookup) stays concurrent.

The engine computes on ``device`` — the card unless the caller asks for
the CPU (CLI ``--device cpu``); constructing it without a card raises.
The JAX package's ``jit_retraces`` listener (``jax.monitoring``) has no
counterpart: the port compiles no per-shape programs, so ``/statusz``
carries neither ``jit_retraces`` nor ``compile_cache``.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_examples_tpu_torch.device import DEFAULT_DEVICE
from spark_examples_tpu_torch.serving.deltas import (
    DeltaIndex,
    gramian_base_key,
    note_delta,
)

__all__ = ["AnalysisEngine"]

# Distinct variantset tuples whose CallsetIndex stays resident. Bounded
# because the tuple is CLIENT-SUPPLIED on a multi-tenant surface: an
# unbounded dict keyed by request content is attacker-growable memory.
# Real servers front one or two variantsets; 8 is generous.
_INDEX_CACHE_SIZE = 8


class AnalysisEngine:
    """Runs PCA jobs against one resident source (one per server).

    ``delta_max_samples > 0`` arms the INCREMENTAL tier
    (``serving/deltas.py``): finished Gramians are cached per base key
    (resolved variant params) + sample frame, and a job whose cohort
    differs from a cached ancestor's by at most that many samples is
    answered by exact rank-k corrections — bit-identical to
    from-scratch, with a checksum guard falling back to cold on any
    cache doubt. Default 0 runs every job cold.

    ``mesh`` (a :class:`~spark_examples_tpu_torch.parallel.mesh.Mesh`)
    runs every job's driver on that mesh, with G as a tile grid (a
    sketch job's panel through ``sharded_sketch_panel`` and its TSQR
    finish); the delta tier is off under a mesh, and the tier runs no
    gangs there (it probes ``mesh``).
    """

    def __init__(
        self,
        source: Any,
        mesh: Any = None,
        delta_max_samples: int = 0,
        delta_persist_dir: Optional[str] = None,
        delta_fence: Optional[Callable[[], None]] = None,
        device: Any = DEFAULT_DEVICE,
    ) -> None:
        from spark_examples_tpu_torch.device import resolve_device

        self.source = source
        self.mesh = mesh
        # Resolved here, so an engine asked for the card raises at
        # construction on a host without one.
        self.device = resolve_device(device)
        # One device owner at a time — see the module docstring.
        self._device_lock = threading.Lock()
        self._index_lock = threading.Lock()
        self._indexes: "collections.OrderedDict[Tuple[str, ...], object]" = (
            collections.OrderedDict()
        )
        # delta_persist_dir (normally <journal dir>/deltas; in
        # replicated serving <store root>/deltas, shared by every
        # replica) arms the write-through tier: finished Gramians
        # survive a kill -9 and re-load checksum-verified on restart
        # (serving/deltas.py). delta_fence gates those shared writes in
        # replicated mode — a zombie's Gramian is rejected loudly.
        self._deltas: Optional[DeltaIndex] = (
            DeltaIndex(
                delta_max_samples,
                persist_dir=delta_persist_dir,
                fence=delta_fence,
            )
            if delta_max_samples > 0 and mesh is None
            else None
        )

    def index_for(self, variant_set_ids: Tuple[str, ...]) -> Any:
        """The shared immutable CallsetIndex for a variantset tuple
        (LRU-bounded; callset listings don't change under a resident
        cohort — a swapped cohort is a server restart). Order matters
        and is part of the key on purpose: the dense sample numbering
        follows variantset order."""
        from spark_examples_tpu_torch.genomics.callsets import CallsetIndex

        with self._index_lock:
            index = self._indexes.get(variant_set_ids)
            if index is None:
                index = self._indexes[variant_set_ids] = (
                    CallsetIndex.from_source(
                        self.source, list(variant_set_ids)
                    )
                )
            self._indexes.move_to_end(variant_set_ids)
            while len(self._indexes) > _INDEX_CACHE_SIZE:
                self._indexes.popitem(last=False)
            return index

    def _driver(self, conf: Any) -> Any:
        from spark_examples_tpu_torch.models.pca import VariantsPcaDriver

        return VariantsPcaDriver(
            conf,
            self.source,
            mesh=self.mesh,
            index=self.index_for(tuple(conf.variant_set_ids)),
        )

    # -- introspection (the /healthz and /statusz sources) --------------------

    def device_lock_available(self, timeout_s: float = 0.5) -> bool:
        """Probe the device lock with a BOUNDED wait (the exit-77
        discipline: a health probe must never hang on the very wedge it
        exists to detect). False means "held for longer than the
        probe's patience" — the caller disambiguates busy-with-work
        from wedged via the tier's running-job count."""
        if not self._device_lock.acquire(timeout=max(0.0, timeout_s)):
            return False
        try:
            return True
        finally:
            self._device_lock.release()

    def delta_stats(self) -> Optional[Dict[str, int]]:
        """Delta-cache occupancy (None when the tier is unarmed)."""
        return self._deltas.stats() if self._deltas is not None else None

    # -- gang/delta compatibility probes (host-side, no device work) ----------

    def gang_key(self, conf: Any) -> str:
        """The base key gang members must share — same resolved variant
        params means same full-frame window stream."""
        return gramian_base_key(conf)

    def cohort_size(self, conf: Any, index: Any = None) -> int:
        """Restricted-cohort sample count for a job config (the N the
        gang-max bound compares against). O(|samples| + |exclude|) set
        arithmetic — NEVER builds the frame: the gang selector calls
        this under the admission-queue lock per queued job, where an
        O(N) remap build would stall every concurrent submit/pop. For
        the same reason callers already holding the job's CallsetIndex
        pass it via ``index`` — an LRU miss in :meth:`index_for` runs
        source I/O, which must never happen under the queue lock
        (the gang selector resolves the lead's index up front; members
        share it because equal base keys mean equal variantset
        tuples). Raises ValueError for the restrictions the driver
        itself would reject (unknown ids, empty cohort), so the
        selector excludes doomed jobs and they fail solo with the loud
        error."""
        if index is None:
            index = self.index_for(tuple(conf.variant_set_ids))
        samples = getattr(conf, "samples", None)
        exclude = getattr(conf, "exclude_samples", None) or ()
        if samples is None and not exclude:
            return int(index.size)
        known = index.indexes
        unknown = [s for s in (samples or ()) if s not in known] + [
            s for s in exclude if s not in known
        ]
        if unknown:
            raise ValueError(
                f"unknown sample callset id(s) in cohort restriction: "
                f"{unknown[:8]}"
            )
        if samples is None:
            size = int(index.size) - len(set(exclude))
        else:
            size = len(set(samples) - set(exclude))
        if size <= 0:
            raise ValueError(
                "cohort restriction leaves no samples"
            )
        return size

    def delta_resolvable(self, conf: Any) -> bool:
        """True when the delta index holds an ancestor for this job —
        the tier runs such jobs solo (the rank-k touch-up beats riding
        a cold gang)."""
        if self._deltas is None:
            return False
        try:
            driver = self._driver(conf)
        except ValueError:
            return False
        samples = tuple(driver.cohort.callset_of_index())
        return (
            self._deltas.resolve(gramian_base_key(conf), samples)
            is not None
        )

    # -- execution ------------------------------------------------------------

    def run(
        self, conf: Any, kind: str = "pca"
    ) -> List[Tuple[Any, ...]]:
        """Execute one job: fresh driver, shared index, serialized
        device phases → ``(name, pc1, pc2, dataset)`` rows for the
        default PCA kind, ``(name, loglik, bucket)`` rows for a
        ``pairhmm`` job (the read-side kernel pipeline against the same
        resident source). With the delta tier armed, a PCA Gramian
        resolves through the nearest cached ancestor when one is close
        enough (bit-identical either way)."""
        if kind == "pairhmm":
            from spark_examples_tpu_torch.models.pairhmm import (
                PairHmmDriver,
            )

            phmm = PairHmmDriver(conf, self.source)
            with self._device_lock:
                return [tuple(row) for row in phmm.run_rows()]
        driver = self._driver(conf)
        with self._device_lock:
            if driver.sketch_selected():
                # Gramian-free: ingest returns an O(N·(k+p))
                # SketchPanel, not a G — it must never enter the
                # delta/window caches (the delta algebra corrects N×N
                # arrays, and sketch results are seed-specific), so the
                # job runs the plain tier routing end to end.
                g = driver.ingest_gramian()
            elif self._deltas is None:
                g = driver.ingest_gramian()
            else:
                g = self._on_device(
                    self._gramian_delta_aware(driver, conf)
                )
            result = driver.compute_pca(g)
        return driver.collect_result(result)

    def _on_device(self, g: Any) -> Any:
        """A finished G as a float32 tensor on the engine's device. A
        host array is COPIED first: a cached delta entry's G must never
        be shared with a finish that may work in place."""
        import torch

        if isinstance(g, torch.Tensor):
            return g.to(self.device, torch.float32)
        return torch.from_numpy(
            np.array(g, dtype=np.float32, copy=True)
        ).to(self.device)

    def _gramian_delta_aware(self, driver: Any, conf: Any) -> Any:
        """Gramian via the delta index: ancestor hit → rank-k touch-up;
        checksum mismatch or any correction error → loud fallback to
        cold; miss → cold. Every cold result (and every delta result)
        is cached for the next neighbor. Caller holds the device lock.
        """
        from spark_examples_tpu_torch import obs

        assert self._deltas is not None
        key = gramian_base_key(conf)
        samples = tuple(driver.cohort.callset_of_index())
        entry = self._deltas.resolve(key, samples)
        if entry is not None:
            if not entry.verify():
                # The cached bytes no longer match their insert-time
                # checksum: never correct on top of a corrupt G.
                self._deltas.drop(entry)
                note_delta("fallback")
                print(
                    "WARNING: delta-cache checksum mismatch for base "
                    f"key {key[:12]}…; running cold.",
                    file=sys.stderr,
                )
                return self._gramian_cold(driver, key, samples)
            added = len(set(samples) - set(entry.samples))
            removed = len(set(entry.samples) - set(samples))
            try:
                with obs.span(
                    "job.delta",
                    added=added,
                    removed=removed,
                    ancestor=entry.checksum[:12],
                ):
                    if entry.samples == samples:
                        g = entry.g
                    else:
                        windows = self._deltas.windows(key)
                        sink: Optional[list] = (
                            [] if windows is None else None
                        )
                        g = driver.ingest_gramian_delta(
                            entry.g,
                            entry.samples,
                            windows=windows,
                            window_sink=sink,
                        )
                        if sink:
                            self._deltas.put_windows(key, sink)
            except Exception as e:  # noqa: BLE001 — optimization guard
                # A correction that cannot be applied (frame drift, a
                # source that lost a callset, ...) must degrade to the
                # cold path, never fail a job the cold path would serve.
                note_delta("fallback")
                print(
                    f"WARNING: delta correction failed "
                    f"({type(e).__name__}: {e}); running cold.",
                    file=sys.stderr,
                )
                return self._gramian_cold(driver, key, samples)
            note_delta("hit")
            if entry.samples != samples:
                # An exact-frame hit IS the cache entry — re-putting it
                # would copy + re-checksum an identical O(N²) array on
                # the very path whose purpose is to skip work (resolve
                # already refreshed its LRU position).
                self._deltas.put(key, samples, g)
            return g
        note_delta("miss")
        return self._gramian_cold(driver, key, samples)

    def _gramian_cold(
        self,
        driver: Any,
        key: str,
        samples: Tuple[str, ...],
    ) -> Any:
        """From-scratch Gramian + cache warm-up: uncheckpointed runs ride
        the window route so the full-frame windows are captured for
        future corrections; checkpointed runs keep their snapshot/resume
        semantics (no capture — the first delta against them re-streams
        once and captures then)."""
        assert self._deltas is not None
        if driver.conf.checkpoint_dir:
            g = driver.ingest_gramian()
        else:
            sink: list = []
            g = driver.ingest_gramian_windows(window_sink=sink)
            self._deltas.put_windows(key, sink)
        self._deltas.put(key, samples, g)
        return g

    def run_gang(
        self, confs: List[Any]
    ) -> List[List[Tuple[str, float, float, str]]]:
        """Execute compatible jobs as ONE batched Gramian dispatch:
        one full-frame window stream, cohorts stacked on a leading
        batch axis, one copy to the device a window
        (:func:`spark_examples_tpu_torch.ops.gramian.gang_gramian_blockwise`),
        per-job finishes unstacked and run in submission order —
        results bit-identical to serial per-job execution (pinned by
        tests). All configs must share a base key (the tier's
        compatibility predicate guarantees it; violated = loud error).
        """
        from spark_examples_tpu_torch.ops.gramian import (
            gang_gramian_blockwise,
        )

        if not confs:
            return []
        if len(confs) == 1:
            return [self.run(confs[0])]
        keys = {gramian_base_key(c) for c in confs}
        if len(keys) != 1:
            raise ValueError(
                f"gang members disagree on the Gramian base key: "
                f"{sorted(keys)}"
            )
        key = keys.pop()
        # Gang members never checkpoint (small cohorts; replay re-runs
        # them bit-identically).
        confs = [
            dataclasses.replace(c, checkpoint_dir=None) for c in confs
        ]
        drivers = [self._driver(c) for c in confs]
        sizes = [int(d.cohort.size) for d in drivers]
        n_max = max(sizes)
        remaps = []
        for d in drivers:
            if d._sample_remap is not None:
                remaps.append(np.asarray(d._sample_remap, dtype=np.int64))
            else:
                remaps.append(
                    np.arange(d.index.size, dtype=np.int64)
                )
        out: List[List[Tuple[str, float, float, str]]] = []
        with self._device_lock:
            windows = (
                self._deltas.windows(key)
                if self._deltas is not None
                else None
            )
            # Capture only when a delta index exists to consume it:
            # with deltas off, buffering every full-frame window for
            # the whole dispatch would hold GBs at biobank V for no
            # reader.
            sink: Optional[list] = (
                []
                if windows is None and self._deltas is not None
                else None
            )

            def stream() -> Any:
                for window in drivers[0]._cohort_windows(restrict=False):
                    if sink is not None:
                        sink.append(window)
                    yield window

            g = gang_gramian_blockwise(
                windows if windows is not None else stream(),
                remaps,
                n_max,
                device=self.device,
            )
            if self._deltas is not None and sink is not None:
                self._deltas.put_windows(key, sink)
            for b, driver in enumerate(drivers):
                n_b = sizes[b]
                g_b = np.ascontiguousarray(g[b, :n_b, :n_b])
                if self._deltas is not None:
                    self._deltas.put(
                        key,
                        tuple(driver.cohort.callset_of_index()),
                        g_b,
                    )
                result = driver.compute_pca(self._on_device(g_b))
                out.append(driver.collect_result(result))
        return out
