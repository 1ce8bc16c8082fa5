"""The PCoA pipeline driver on PyTorch: ``--pca-mode
auto|fused|stream|sparse|sketch``, meshless, on a single-controller mesh or
on a pod, in one process or data-parallel across a process group.

The port of the JAX package's ``VariantsPcaDriver`` (the reference's
``VariantsPca.scala:36-246``) with the same stage surface — get_data /
filter_dataset / get_calls / ingest_gramian / compute_pca / emit_result /
report_io_stats:

- ingest, routed as the JAX driver routes it: per-shard ``(indices,
  offsets)`` CSR pairs straight off an on-disk cohort's sidecar (the
  CSR-direct tier of ``--input-path``, in ``--ingest-order``), per-variant
  carrier lists from the source (the fused fast path, shards extracted on
  ``--ingest-workers`` threads in manifest order, stragglers re-executed
  under ``--speculative-ingest``), keyed identity triples joined or
  merged across two or more ``--variant-set-id`` datasets, or the staged
  Variant path under ``--debug-datasets``; every shard extraction and
  block build retried up to ``--shard-retries`` attempts within
  ``--shard-retry-deadline`` (the ``ingest.shard``, ``ingest.build`` and
  ``ingest.stream`` fault sites sit inside that loop);
- checkpointed ingest (``--checkpoint-dir``, ``--checkpoint-every``): the
  manifest in groups of shards, in manifest order, each group's blocks
  added onto the G of the groups before it and a ``(G, shards_done)``
  snapshot committed after it, so a killed or soft-cancelled run resumes
  from its last group (:mod:`spark_examples_tpu_torch.utils.checkpoint`,
  the JAX package's snapshot file); single dataset, full cohort, not
  ``sparse`` nor ``sketch``. In a process group each rank snapshots its
  own manifest slice (``host-<p>``, a ``|host=p/P`` digest); on a pod the
  ranks snapshot synced rounds (the replicated G, or each rank's tiles);
  ``--elastic-checkpoint`` writes world-size-independent lanes
  (:mod:`~spark_examples_tpu_torch.utils.elastic`, single or
  multi-dataset) that resume at any world size;
- soft cancel: past the ``SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE``
  deadline the run exits with code 75 at the next block, window or group
  boundary (:mod:`spark_examples_tpu_torch.utils.softcancel`);
- cohort restriction (``--samples``/``--exclude-samples``): ingest
  extracts in the full callset frame and carriers are remapped or dropped
  at the window boundary, so G, the finish and the emission are sized by
  the restricted cohort;
- Gramian, dense-blockwise (``auto``, ``fused``, ``stream``): the lists
  densified into 0/1 blocks of ``--block-variants`` variants, bit-packed
  (on the CSR tier by ``--ingest-workers`` builder threads) and copied
  through the double-buffered pinned feed
  (``--prefetch-depth``), accumulated as int8 products
  (:func:`~spark_examples_tpu_torch.ops.gramian.gramian_blockwise`);
- Gramian, sparse (``sparse``): CSR windows through
  :func:`~spark_examples_tpu_torch.ops.sparse.sparse_gramian_blockwise` —
  rare windows through the hand-written CUDA scatter kernel, dense ones
  through the int8 product;
- no Gramian (``sketch``, and ``auto`` where the float32 G would exceed
  4 GiB, N > 32768): the same CSR windows accumulate an (N, k+p)
  randomized panel
  (:func:`~spark_examples_tpu_torch.ops.sketch.sketch_panel_blockwise`),
  finished on the host in float64 (:func:`~spark_examples_tpu_torch.ops.
  sketch.sketch_eig`);
- finish: the fused centering + CholeskyQR subspace eig (``fused``; under
  ``auto`` and ``sparse`` for N ≤ ``--dense-eigh-limit``, with dense
  ``eigh`` when it collapses on a degenerate G), dense ``eigh``
  (``stream``, or above the limit), or host float64 with ``--precise``;
- a mesh (``--mesh-shape``, :mod:`spark_examples_tpu_torch.parallel`): G
  as a tile grid laid out ``P(data, model)`` over one process's devices,
  dense blocks through :func:`~spark_examples_tpu_torch.parallel.sharded.
  sharded_gramian_blockwise`, CSR windows through the tile scatter of
  :func:`~spark_examples_tpu_torch.parallel.sharded.
  sparse_sharded_gramian_blockwise` (``sparse``, and ``auto`` on a
  sample-sharded mesh), finished by :func:`~spark_examples_tpu_torch.
  parallel.sharded.sharded_pcoa`; the sketch through
  :func:`~spark_examples_tpu_torch.parallel.sharded.sharded_sketch_panel`
  and its TSQR finish; a mesh in a process group spans its ranks (the
  pod);
- data-parallel (a ``torch.distributed`` group from the launcher's
  variables): rank r ingests ``shards[r::P]`` of the manifest, the partial
  G (or sketch panel) is summed over the group, and rank 0 alone emits
  and reports the merged IoStats;
- serving entry points for the analysis engine
  (:mod:`spark_examples_tpu_torch.serving`): ``ingest_gramian_windows``
  (the sparse engine's window route whatever the mode, capturing the
  full-frame windows) and ``ingest_gramian_delta`` (an exact rank-k
  correction of a cached G, :mod:`~spark_examples_tpu_torch.ops.delta`);
- emission byte-format compatible with ``emitResult``
  (``VariantsPca.scala:233-246``): stdout ``name\\tdataset\\tpc1\\tpc2``
  sorted by name; ``--output-path`` writes ``<path>-pca.tsv`` lines
  ``name\\tpc1\\tpc2\\tdataset``; ``--trace-dir`` writes a
  ``torch.profiler`` trace of the run.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch import obs, resilience
from spark_examples_tpu_torch.arrays.blocks import (
    blocks_from_calls,
    csr_windows,
    packed_blocks_from_csr,
    round_up_multiple,
    windows_from_calls,
)
from spark_examples_tpu_torch.device import resolve_device
from spark_examples_tpu_torch.genomics.callsets import CallsetIndex
from spark_examples_tpu_torch.genomics.datasets import (
    af_filter,
    calls_stream,
    calls_stream_keyed,
)
from spark_examples_tpu_torch.genomics.mirror import tick_cold_stream_shard
from spark_examples_tpu_torch.genomics.shards import SexChromosomeFilter
from spark_examples_tpu_torch.genomics.types import Variant
from spark_examples_tpu_torch.models.emission import (
    FILE_LAYOUT,
    STDOUT_LAYOUT,
    RowColumns,
    note_rows,
)
from spark_examples_tpu_torch.ops.fused import fused_finish
from spark_examples_tpu_torch.ops.gramian import gramian_blockwise
from spark_examples_tpu_torch.ops.pcoa import (
    mllib_principal_components_reference,
    pcoa,
    topk_with_gap_check,
)
from spark_examples_tpu_torch.ops.sketch import (
    SketchPanel,
    sketch_eig,
    sketch_panel_blockwise,
)
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
    sparse_gramian_blockwise,
)
from spark_examples_tpu_torch.parallel import distributed
from spark_examples_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_spans_processes,
)
from spark_examples_tpu_torch.parallel.sharded import (
    ShardedGramian,
    _axis_product,
    _grid_device,
    _grid_index,
    _grid_shape,
    _mesh_axes,
    gramian_blockwise_global,
    jax_tile_splits,
    sharded_gramian_blockwise,
    sharded_gramian_blockwise_global,
    sharded_pcoa,
    sharded_sketch_panel,
    sparse_sharded_gramian_blockwise,
)
from spark_examples_tpu_torch.resilience import faults
from spark_examples_tpu_torch.utils import softcancel
from spark_examples_tpu_torch.utils.config import (
    INGEST_ORDERS,
    PCA_MODES,
    PcaConfig,
)
from spark_examples_tpu_torch.utils.concurrency import (
    completion_parallel_map,
    ordered_parallel_map,
)
from spark_examples_tpu_torch.utils.stats import COUNTER_FIELDS
from spark_examples_tpu_torch.utils.tracing import (
    INGEST_FETCH,
    INGEST_STREAM,
    PCOA_TILES_SUMS,
    ROWS_SORT,
    ROWS_TUPLES,
    ROWS_WRITE,
    SHARD_WAIT,
    StageTimer,
    profiler_trace,
)
from spark_examples_tpu_torch.utils.watchdog import CollectiveWatchdog

__all__ = ["VariantsPcaDriver"]


def _contig_runs_unique(shards) -> bool:
    """True when the manifest presents each contig as one contiguous run —
    the precondition for contig-partitioned (bounded-memory) joins."""
    seen = set()
    last = None
    for s in shards:
        if s.contig != last:
            if s.contig in seen:
                return False
            seen.add(s.contig)
            last = s.contig
    return True


class VariantsPcaDriver:
    def __init__(self, conf: PcaConfig, source, mesh=None, index=None):
        if conf.num_pc < 1:
            raise ValueError(f"--num-pc must be >= 1, got {conf.num_pc}")
        if conf.elastic_checkpoint and not conf.checkpoint_dir:
            # A checkpoint flag that silently does nothing loses the user
            # hours of presumed-checkpointed work: refuse up front. (The
            # multi-dataset preconditions are checked in
            # _checkpointed_elastic, still before any ingest.)
            raise ValueError(
                "--elastic-checkpoint requires --checkpoint-dir"
            )
        if conf.ingest_order not in INGEST_ORDERS:
            # argparse choices only guard the CLI.
            raise ValueError(
                f"ingest_order must be 'auto', 'manifest', or "
                f"'completion'; got {conf.ingest_order!r}"
            )
        if conf.prefetch_depth < 1:
            # A zero/negative staging depth would deadlock the bounded
            # feed queue — refuse before any ingest work.
            raise ValueError(
                f"--prefetch-depth must be >= 1, got {conf.prefetch_depth}"
            )
        if conf.ingest_workers < 0:
            raise ValueError(
                f"--ingest-workers must be >= 1 (or 0 = auto), got "
                f"{conf.ingest_workers}"
            )
        if conf.pca_mode not in PCA_MODES:
            allowed = ", ".join(repr(m) for m in PCA_MODES)
            raise ValueError(
                f"pca_mode must be one of {allowed}; got "
                f"{conf.pca_mode!r}"
            )
        if conf.pca_mode == "sparse" and conf.checkpoint_dir:
            # Snapshot digests cut at manifest positions; the sparse
            # accumulator's window stream has no checkpoint grid yet.
            # Refuse before ingest, not after hours of it.
            raise ValueError(
                "--pca-mode sparse does not compose with checkpointed "
                "ingest yet; drop --checkpoint-dir or use --pca-mode "
                "auto/stream"
            )
        if conf.pca_mode == "sketch" and conf.checkpoint_dir:
            # The sketch panel has no snapshot grid (and a resumed partial
            # panel would silently double-count windows).
            raise ValueError(
                "--pca-mode sketch does not compose with checkpointed "
                "ingest; drop --checkpoint-dir or use --pca-mode auto"
            )
        if conf.pca_mode == "sketch" and conf.precise:
            # --precise is the host-f64 exact route; the sketch engine is
            # approximate by contract.
            raise ValueError(
                "--pca-mode sketch is the randomized approximate "
                "engine and cannot honor --precise; drop one"
            )
        if conf.sketch_oversample < 1:
            raise ValueError(
                "--sketch-oversample must be >= 1 (the panel needs a "
                "value past k for the spectral-gap check), got "
                f"{conf.sketch_oversample}"
            )
        if conf.sketch_power_iters < 0:
            raise ValueError(
                "--sketch-power-iters must be >= 0, got "
                f"{conf.sketch_power_iters}"
            )
        if conf.sparse_density_threshold < 0:
            raise ValueError(
                "--sparse-density-threshold must be >= 0, got "
                f"{conf.sparse_density_threshold}"
            )
        if conf.pod_pipeline_depth < 0:
            raise ValueError(
                "--pod-pipeline-depth must be >= 0 (0 = inline "
                f"lockstep), got {conf.pod_pipeline_depth}"
            )
        if conf.pod_coalesce_variants < 0:
            raise ValueError(
                "--pod-coalesce-variants must be >= 0 (0 disables "
                f"coalescing), got {conf.pod_coalesce_variants}"
            )
        meshed = mesh is not None or bool(conf.mesh_shape)
        if conf.pca_mode == "fused" and (
            conf.precise or meshed or distributed.process_count() > 1
        ):
            # Fail before ingest, not after the Gramian: the fused finish
            # is a one-device program and --precise is definitionally the
            # host-f64 route.
            raise ValueError(
                "--pca-mode fused requires a single-process, meshless, "
                "non---precise run (use --pca-mode auto to fall back "
                "automatically)"
            )
        # `samples is not None` rather than truthiness: an EXPLICITLY
        # empty include list is a contradictory cohort and must hit the
        # loud "leaves no samples" error, never silently run the full
        # cohort. (An empty exclude list excludes nothing — that IS the
        # unrestricted cohort.)
        restricted = conf.samples is not None or bool(conf.exclude_samples)
        if restricted and conf.checkpoint_dir:
            raise ValueError(
                "--samples/--exclude-samples do not compose with "
                "checkpointed ingest; drop --checkpoint-dir"
            )
        if restricted and meshed:
            raise ValueError(
                "--samples/--exclude-samples require a meshless run "
                "(drop --mesh-shape)"
            )
        self.conf = conf
        self.source = source
        self.device = resolve_device(conf.device)
        # The CLI builds the mesh (JAX cli/main.py:170-187); a config
        # that names one and no mesh passed builds it here.
        if mesh is None and conf.mesh_shape:
            mesh = make_mesh(conf.mesh_shape, device=conf.device)
        self.mesh = mesh
        self.index = (
            index
            if index is not None
            else CallsetIndex.from_source(source, conf.variant_set_ids)
        )
        # The COHORT frame: ingest always extracts in the full index
        # frame (unknown callsets stay a hard error there), and a sample
        # restriction remaps/filters carriers at the window boundary —
        # `self.cohort` is what the Gramian, the finish and emission are
        # sized by; `_sample_remap` (full dense index → cohort index, -1
        # drops) is the one filter array.
        if restricted:
            self.cohort, self._sample_remap = self.index.restricted(
                conf.samples, conf.exclude_samples
            )
        else:
            self.cohort, self._sample_remap = self.index, None
        # Set by run(): the finished Gramian (or the sketch panel) and the
        # stage timings.
        self.g = None
        self.timer = None
        self._speculated_shards = 0  # straggler duplicates launched

    def _watchdog(self) -> CollectiveWatchdog:
        """Collective fail-stop guard, armed only in a multi-process run
        with ``--collective-timeout``: a lone process has no peer to lose
        and must never be shot by a timer."""
        timeout = self.conf.collective_timeout
        return CollectiveWatchdog(
            timeout if distributed.process_count() > 1 else None
        )

    # -- stage 1: ingest -----------------------------------------------------

    @staticmethod
    def _host_shards(shards):
        """Round-robin manifest slice for this process (data-parallel
        ingest across a process group)."""
        count = distributed.process_count()
        if count > 1:
            return shards[distributed.process_index() :: count]
        return shards

    def _global_manifest(self):
        """The full, unsliced shard manifest — the one place the
        partitioner parameters live."""
        return self.conf.shards(
            all_references=self.conf.all_references,
            sex_filter=SexChromosomeFilter.EXCLUDE_XY,
        )

    def _manifest(self):
        """This process's shard manifest slice."""
        return self._host_shards(self._global_manifest())

    def get_data(self) -> List[Iterator[Variant]]:
        """One lazy variant stream per configured variantset (the analog
        of ``VariantsCommon.data``, VariantsCommon.scala:52-66)."""
        shards = self._manifest()
        # When the manifest visits each contig exactly once, multi-dataset
        # joins may partition their state by contig instead of holding the
        # whole cohort's identities.
        self._contig_runs_unique = _contig_runs_unique(shards)

        def stream(vsid: str) -> Iterator[Variant]:
            for shard in shards:
                yield from self.source.stream_variants(vsid, shard)

        return [stream(vsid) for vsid in self.conf.variant_set_ids]

    # -- stage 2: filters ----------------------------------------------------

    def filter_dataset(self, data: Iterable[Variant]) -> Iterator[Variant]:
        if self.conf.min_allele_frequency is not None:
            print(f"Min allele frequency {self.conf.min_allele_frequency}.")
        return af_filter(data, self.conf.min_allele_frequency)

    # -- stage 3: calls ------------------------------------------------------

    def get_calls(
        self, streams: Sequence[Iterable[Variant]]
    ) -> Iterator[List[int]]:
        """Per-variant carrying-sample index lists (the RDD[Seq[Int]]
        interface at VariantsPca.scala:153-168): one dataset's lists, or
        the identity join (two) or merge (three or more) of several."""
        if self.conf.debug_datasets:
            streams = [self._debug_wrap(s) for s in streams]
        return calls_stream(
            list(streams),
            self.index.indexes,
            contig_runs_unique=getattr(self, "_contig_runs_unique", False),
        )

    @staticmethod
    def _debug_wrap(stream):
        for v in stream:
            alt = "".join(v.alternate_bases or ())
            print(
                f"{v.contig}: ({v.start}, {v.end}) "
                f"ref={v.reference_bases or ''} alt={alt}"
            )
            yield v

    def _fused_ingest_possible(self) -> bool:
        """The fast path fuses ingest → AF filter → call extraction when
        nothing needs full Variant/Call records: single dataset (no
        identity join), no --debug-datasets printing, and a source that
        implements stream_carrying."""
        return (
            len(self.conf.variant_set_ids) == 1
            and not self.conf.debug_datasets
            and hasattr(self.source, "stream_carrying")
        )

    def get_calls_fused(self) -> Iterator[List[int]]:
        """Fused ingest: shards → carrying index lists in manifest order.
        Same observable behavior as get_data → filter_dataset → get_calls
        minus the per-call object materialization."""
        vsid = self.conf.variant_set_ids[0]
        if self.conf.min_allele_frequency is not None:
            print(
                f"Min allele frequency {self.conf.min_allele_frequency}."
            )
        yield from self._parallel_shard_calls(vsid, self._manifest())

    def _ingest_workers(self) -> int:
        """--ingest-workers; auto = core count capped at 16 (1 → serial).

        The cap bounds peak host memory: each in-flight worker holds one
        shard's call lists (ordered_parallel_map keeps workers+2 results
        buffered). Users with the RAM opt into more explicitly.
        """
        if self.conf.ingest_workers:
            return self.conf.ingest_workers
        return min(os.cpu_count() or 1, 16)

    def _block_builder_workers(self) -> int:
        """Builder threads for the packed-block production stage of the
        CSR tier (``--ingest-workers``; auto = min(4, cores), 1 → serial).

        A separate, smaller auto cap than shard extraction: each builder
        holds exactly one packed block (N × ⌈Vb/8⌉ bytes) but the stage is
        memory bandwidth, not cores. On a single-core host auto = 1, the
        serial in-order path.
        """
        if self.conf.ingest_workers:
            return self.conf.ingest_workers
        return min(os.cpu_count() or 1, 4)

    def _retrying(self, site: str, key: str, method: str, fn):
        """Run one idempotent unit of ingest under the resilience layer:
        the ``site`` fault seam, then up to ``--shard-retries`` attempts,
        each drawing down the ``--shard-retry-deadline`` budget. Default
        (1 attempt, no fault plan): ``fn()`` with no overhead."""
        retries = max(1, self.conf.shard_retries)
        if retries <= 1 and faults.current_plan() is None:
            return fn()

        def attempt():
            faults.inject(site, key=key)
            return fn()

        return resilience.call_with_retry(
            attempt,
            resilience.RetryPolicy(
                max_attempts=retries,
                base_delay=0.05,
                deadline=self.conf.shard_retry_deadline,
            ),
            resilience.classify_ingest,
            transport="ingest",
            method=method,
        )

    def _build_attempt(self, thunk, key: str):
        """One packed-block build (keyed by its window's index) behind the
        ``ingest.build`` seam (a builder worker dying mid-block). Sound
        because the build is a pure function of its already-sliced
        window: a retry yields a byte-identical block, so a builder death
        changes wall-clock, never G — and a block is either built or the
        run fails loudly."""
        return self._retrying("ingest.build", key, "build", thunk)

    def _shard_attempt(self, shard, fn):
        """One shard extraction behind the ``ingest.shard`` seam (worker
        death = an injected error, a slow lane = an injected stall).
        Re-execution is sound because the manifest is deterministic and
        per-shard ingest idempotent (STRICT boundaries): a retried shard
        yields the same records, so results never change."""
        return self._retrying("ingest.shard", str(shard), "shard", fn)

    def _parallel_shard_calls(
        self, vsid: str, shards, stream_method=None, workers=None
    ):
        """Per-shard extraction lists in EXACT manifest order: block
        composition and accumulation order — and so G — never change with
        the worker count. With one extraction thread (``--ingest-workers
        1``, or a manifest of one shard) and no retry layer, each shard
        streams straight into the block builder; otherwise each shard is
        extracted whole by :meth:`_shard_attempt` (a retried shard must
        not have yielded part of itself), on ``ordered_parallel_map``'s
        worker threads with more than one, speculated under
        ``--speculative-ingest``. ``stream_method`` defaults to the
        single-dataset fused stream; the keyed multi-dataset path passes
        its own."""
        shards = list(shards)
        method = stream_method or self.source.stream_carrying

        def stream(shard):
            return method(
                vsid,
                shard,
                self.index.indexes,
                self.conf.min_allele_frequency,
            )

        def extract(shard):
            return self._shard_attempt(shard, lambda: list(stream(shard)))

        def note_speculation(shard):
            self._speculated_shards += 1
            print(
                f"Speculating straggler shard {shard} "
                "(duplicate attempt launched).",
                file=sys.stderr,
            )
            obs.instant(
                "speculative_shard_attempt", scope="p", shard=str(shard)
            )

        workers = min(workers or self._ingest_workers(), len(shards))
        if workers <= 1:
            plain = (
                self.conf.shard_retries <= 1
                and faults.current_plan() is None
            )
            for shard in shards:
                yield from stream(shard) if plain else extract(shard)
            return
        for calls in ordered_parallel_map(
            extract,
            shards,
            workers,
            speculate=self.conf.speculative_ingest,
            on_speculate=note_speculation,
        ):
            yield from calls

    def _fused_csr_possible(self) -> bool:
        """CSR-direct ingest: the fused single-dataset preconditions plus
        a source that can serve whole shards as (indices, offsets) pairs
        (the JSONL sidecar tier). Skipped when speculation is on — the
        straggler race re-executes extractions, which the fused lists
        (:meth:`_parallel_shard_calls`) do and this tier does not."""
        return (
            self._fused_ingest_possible()
            and hasattr(self.source, "stream_carrying_csr")
            and not self.conf.speculative_ingest
        )

    def _cold_stream_active(self) -> bool:
        """Is the source streaming a COLD remote cohort from the wire
        while its mirror downloads? (Sources without the concept — local
        sidecars, fixtures — answer False.)"""
        probe = getattr(self.source, "cold_stream_active", None)
        return bool(probe()) if probe is not None else False

    def get_csr_fused(self):
        """Fused single-dataset ingest as per-shard CSR pairs — the
        vectorized twin of :meth:`get_calls_fused` (same filters and
        stats, no per-variant Python lists).

        ``--ingest-order completion`` feeds pairs in SHARD-COMPLETION
        order instead of manifest order, so one slow shard never
        head-of-line-blocks the stream. Safe because the Gramian
        accumulates exact integer co-occurrence counts (every count sits
        far below 2^24, the f32 exact-integer bound), so G is
        bit-identical under any arrival order; only block COMPOSITION
        differs. ``auto`` resolves to completion on a cold-stream run and
        to manifest otherwise. Each shard's extraction is an
        ``ingest.fetch`` range, each pull from the fetch pool a
        ``shard.wait`` range (the consuming thread's wait for the next
        shard) and the whole stream an ``ingest.stream`` range; the
        ``ingest.stream`` fault seam sits inside each shard's
        retry loop (:meth:`_shard_attempt`), so a mid-pipeline
        stall/error/truncate retries per ``--shard-retries`` and G stays
        bit-identical.

        COLD-STREAM runs (``--cold-stream`` on a cold remote cohort)
        default to completion order: fetch → decode → build → put runs as
        one completion-ordered pipeline per shard with no inter-phase
        barrier, so the device accumulator starts before the last shard
        is off the wire; each shard that reaches the window slicer ticks
        ``cold_stream_shards_total{stage="accumulated"}``.
        """
        vsid = self.conf.variant_set_ids[0]
        shards = self._manifest()
        if self.conf.min_allele_frequency is not None:
            print(
                f"Min allele frequency {self.conf.min_allele_frequency}."
            )
        cold = self._cold_stream_active()
        order = self.conf.ingest_order
        if order == "auto":
            # An EXPLICIT --ingest-order is always honored; only the
            # default resolves by run shape.
            order = "completion" if cold else "manifest"
            if cold:
                print(
                    "Cold-stream ingest: completion-ordered "
                    "fetch-decode-build-put pipeline (mirror writes "
                    "through in the background).",
                    file=sys.stderr,
                )

        def extract(shard):
            def fetch():
                faults.inject("ingest.stream", key=str(shard))
                with obs.span(INGEST_FETCH, shard=str(shard)):
                    return self.source.stream_carrying_csr(
                        vsid,
                        shard,
                        self.index.indexes,
                        self.conf.min_allele_frequency,
                    )

            return self._shard_attempt(shard, fetch)

        pmap = (
            completion_parallel_map
            if order == "completion"
            else ordered_parallel_map
        )
        with obs.span(
            INGEST_STREAM, shards=len(shards), order=order, cold=cold
        ):
            for pair in obs.waited(
                pmap(extract, shards, self._ingest_workers()),
                SHARD_WAIT,
            ):
                if cold:
                    tick_cold_stream_shard("accumulated")
                yield pair

    def _fused_multi_possible(self) -> bool:
        """Keyed fused ingest for multi-dataset join/merge: identity
        payloads + carrying indices straight from records (no
        --debug-datasets, source implements stream_carrying_keyed)."""
        return (
            len(self.conf.variant_set_ids) > 1
            and not self.conf.debug_datasets
            and hasattr(self.source, "stream_carrying_keyed")
        )

    def get_calls_fused_multi(self) -> Iterator[List[int]]:
        """Fused multi-dataset ingest: keyed triples per dataset →
        identity join/merge, same observable behavior as the staged path,
        without Call/Variant materialization."""
        shards = self._manifest()
        if self.conf.min_allele_frequency is not None:
            for _ in self.conf.variant_set_ids:
                # One parity print per dataset (filter_dataset prints per
                # stream in the staged path).
                print(
                    f"Min allele frequency "
                    f"{self.conf.min_allele_frequency}."
                )
        return self._keyed_calls(shards, _contig_runs_unique(shards))

    def _keyed_calls(self, shards, contig_runs_unique: bool):
        """The keyed multi-dataset ingest recipe: the worker budget split
        across the datasets' streams, keyed streams, identity
        join/merge."""
        # One worker pool per dataset stream runs concurrently under
        # calls_stream_keyed — split the budget so K datasets never
        # oversubscribe the host K-fold.
        per_stream = max(
            1,
            self._ingest_workers() // len(self.conf.variant_set_ids),
        )

        def keyed(vsid: str):
            yield from self._parallel_shard_calls(
                vsid,
                shards,
                stream_method=self.source.stream_carrying_keyed,
                workers=per_stream,
            )

        return calls_stream_keyed(
            [keyed(v) for v in self.conf.variant_set_ids],
            contig_runs_unique=contig_runs_unique,
        )

    # -- cohort sample restriction (the window-boundary filter) -------------

    def _restrict_calls(self, calls_iter):
        """Full-frame per-variant carrier lists → cohort frame (lists
        with no cohort carrier drop, matching calls_stream's no-carrier
        drop; G is unaffected either way — empty columns are inert)."""
        remap = self._sample_remap
        if remap is None:
            yield from calls_iter
            return
        for calls in calls_iter:
            mapped = [int(remap[i]) for i in calls if remap[i] >= 0]
            if mapped:
                yield mapped

    def _restrict_csr(self, pairs):
        """Full-frame per-shard ``(indices, offsets)`` CSR pairs →
        cohort frame, vectorized (drop + renumber carriers; empty rows
        kept so window composition stays arrival-order-only)."""
        remap = self._sample_remap
        if remap is None:
            yield from pairs
            return
        for pair in pairs:
            if pair is None:
                continue
            indices, offsets = pair
            offsets = np.asarray(offsets, dtype=np.int64)
            if offsets.size <= 1:
                continue
            mapped = remap[np.asarray(indices, dtype=np.int64)]
            keep = mapped >= 0
            kept = np.zeros(mapped.size + 1, dtype=np.int64)
            np.cumsum(keep, out=kept[1:])
            yield mapped[keep], kept[offsets]

    def _restrict_window(self, window):
        """One full-frame ``(indices, lens)`` CSR window → cohort frame
        (the per-window twin of :meth:`_restrict_csr`, for callers that
        share one full-frame window stream)."""
        remap = self._sample_remap
        if remap is None:
            return window
        window_idx, lens = window
        window_idx = np.asarray(window_idx, dtype=np.int64)
        lens = np.asarray(lens, dtype=np.int64)
        mapped = remap[window_idx]
        keep = mapped >= 0
        row_of = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
        new_lens = np.bincount(
            row_of[keep], minlength=lens.size
        ).astype(np.int64)
        return mapped[keep], new_lens

    # -- stage 4: the Gramian ------------------------------------------------

    def _mesh_spans_processes(self) -> bool:
        return self.mesh is not None and mesh_spans_processes(self.mesh)

    def _sample_sharded(self) -> bool:
        """Shard the N×N Gramian over the mesh instead of replicating it:
        explicit via ``--sample-sharded``, auto when N exceeds
        ``--sample-shard-threshold``."""
        if self.conf.sample_sharded is not None:
            return self.conf.sample_sharded
        return self.cohort.size > self.conf.sample_shard_threshold

    def _blocks_to_gramian(self, blocks, g_init=None, prepacked=False):
        """Dense 0/1 blocks (or, with ``prepacked``, their bit-packed
        bytes) → (N, N) G: bit-packed (8× fewer host→device bytes,
        bit-identical) through the double-buffered feed at
        ``--prefetch-depth`` — into one tensor on the device meshless, into
        a :class:`~spark_examples_tpu_torch.parallel.sharded.
        ShardedGramian` tile grid on a mesh. ``g_init`` (a snapshot's or an
        earlier group's G) is added on the device: exact, since every
        count stays below 2^24 in float32."""
        if self._mesh_spans_processes():
            # The pod: each rank feeds its manifest slice into the synced
            # stream, and the result is already the global G (a replica
            # on every rank, or this rank's share of the tile grid).
            accumulate = (
                sharded_gramian_blockwise_global
                if self._sample_sharded()
                else gramian_blockwise_global
            )
            g = accumulate(
                blocks,
                self.cohort.size,
                self.mesh,
                packed=True,
                prepacked=prepacked,
            )
            if g_init is None:
                return g
            if isinstance(g, ShardedGramian):
                return g.add_(g_init)
            return g + torch.as_tensor(g_init).to(g.device, g.dtype)
        if self.mesh is not None:
            g = sharded_gramian_blockwise(
                blocks,
                self.cohort.size,
                self.mesh,
                packed=True,
                prepacked=prepacked,
                prefetch_depth=self.conf.prefetch_depth,
            )
            return g if g_init is None else g.add_(g_init)
        g = gramian_blockwise(
            blocks,
            self.cohort.size,
            packed=True,
            prepacked=prepacked,
            prefetch_depth=self.conf.prefetch_depth,
            device=self.device,
        )
        if g_init is not None:
            g = g + torch.as_tensor(g_init).to(g.device, g.dtype)
        return g

    def _merge_partials(self, g):
        """Data-parallel merge: each rank holds the partial G of its
        manifest slice; sum them over the process group (identity on one
        process, and on a pod, whose G is already global). A host-local
        tile grid is gathered first."""
        if distributed.process_count() == 1 or self._mesh_spans_processes():
            return g
        if isinstance(g, ShardedGramian):
            g = g.full()
        return distributed.allreduce_gramian(g)

    @staticmethod
    def _cancellable_blocks(blocks):
        """Soft-deadline seam (:mod:`~spark_examples_tpu_torch.utils.
        softcancel`): the check sits at BLOCK boundaries — between one
        accumulation step and the next — so a deadline cancels with no
        device dispatch in flight."""
        for block in blocks:
            softcancel.check("gramian block boundary")
            yield block

    def _gramian_from_block_stream(self, blocks, prepacked=False):
        """An uncheckpointed block stream → G, cancellable at every block
        boundary; in a process group, the partials merged."""
        with self._watchdog().armed("ingest+gramian collectives"):
            g = self._blocks_to_gramian(
                self._cancellable_blocks(blocks), prepacked=prepacked
            )
            return self._merge_partials(g)

    def get_similarity_matrix(self, calls: Iterable[List[int]]):
        """Stream carrier lists as fixed-width blocks through the device
        accumulator → (N, N) G. The densify and pack run in the feed's
        producer thread, overlapping the product."""
        blocks = blocks_from_calls(
            self._restrict_calls(calls),
            self.cohort.size,
            self.conf.block_variants,
        )
        return self._gramian_from_block_stream(blocks)

    def get_similarity_matrix_csr(self, csr_pairs):
        """CSR-direct twin of :meth:`get_similarity_matrix` — the same
        blocks bit for bit, built by vectorized scatter instead of
        per-variant Python lists: ``--ingest-workers`` builder threads
        densify and bit-pack the sidecar ``(indices, offsets)`` windows
        (``ingest.build`` ranges), feeding the double-buffered device feed
        in completion order — G is bit-identical under any block arrival
        order (integer-exact accumulation)."""
        blocks = packed_blocks_from_csr(
            self._restrict_csr(csr_pairs),
            self.cohort.size,
            self.conf.block_variants,
            workers=self._block_builder_workers(),
            attempt=self._build_attempt,
        )
        return self._gramian_from_block_stream(blocks, prepacked=True)

    def get_similarity_matrix_checkpointed(self):
        """Shard-group ingest with incremental (G, cursor) snapshots.

        Resume semantics (done better than the reference's all-or-nothing
        objectFile): the deterministic manifest + idempotent per-shard
        ingest make skipping completed shards exact. Groups of
        ``--checkpoint-every`` shards are ingested in manifest order,
        whatever ``--ingest-order`` says. Four routes, as in the JAX
        package: ``--elastic-checkpoint`` (world-size-independent lanes,
        :meth:`_checkpointed_elastic`, single or multi-dataset); a pod
        (synced rounds, :meth:`_checkpointed_pod`); else one dataset, each
        rank of a process group snapshotting its own manifest slice into
        ``host-<p>`` under a ``|host=p/P`` digest, the partials summed
        over the group at the end.
        """
        from spark_examples_tpu_torch.genomics.shards import manifest_digest
        from spark_examples_tpu_torch.utils.checkpoint import (
            load_snapshot,
            save_snapshot,
        )

        if self.conf.elastic_checkpoint:
            # Elastic takes multi-dataset joins through contig-aligned
            # units; the grid-keyed routes below stay single-set.
            return self._checkpointed_elastic()
        assert len(self.conf.variant_set_ids) == 1, (
            "checkpointed ingest supports a single variantset"
        )
        if self._mesh_spans_processes():
            return self._checkpointed_pod()
        vsid = self.conf.variant_set_ids[0]
        shards = self._manifest()
        checkpoint_dir = self.conf.checkpoint_dir
        # In a process group each rank checkpoints ITS manifest slice into
        # its own subdirectory (no cross-rank file races); the partials
        # merge after every rank completes, as uncheckpointed. The slice
        # depends on the process grid, so the digest pins it.
        host_tag = ""
        world = distributed.process_count()
        if world > 1:
            rank = distributed.process_index()
            host_tag = f"|host={rank}/{world}"
            checkpoint_dir = os.path.join(checkpoint_dir, f"host-{rank}")
        # The snapshot key covers everything that determines this rank's
        # partial G: the manifest slice, the dataset, the AF filter and
        # the process grid.
        digest = (
            f"{manifest_digest(shards)}|{vsid}"
            f"|af={self.conf.min_allele_frequency}{host_tag}"
        )
        n = self.index.size
        ck = load_snapshot(checkpoint_dir, digest, n)
        done = ck.shards_done if ck else 0
        if ck:
            print(f"Resuming from snapshot: {done}/{len(shards)} shards done.")
        g = ck.g if ck else None

        every = max(1, self.conf.checkpoint_every)
        while done < len(shards):
            # Between groups a snapshot is already on disk — the ideal
            # soft-cancel point: exit here loses zero completed work.
            softcancel.check("checkpoint group boundary")
            group = shards[done : done + every]
            g = self._ingest_shard_group(vsid, group, g)
            done += len(group)
            save_snapshot(checkpoint_dir, g, done, digest)
        return self._merge_partials(self._gramian_on_device(g))

    def _gramian_on_device(self, g):
        """A checkpointed route's G where the run computes: a host array
        (a snapshot's or a lane's, every shard done before this run)
        copied to the device, or laid out over the mesh; None is the
        empty Gramian."""
        if g is None:
            return self._blocks_to_gramian(iter(()))
        if isinstance(g, (torch.Tensor, ShardedGramian)):
            return g
        g = torch.from_numpy(np.array(g, copy=True)).to(self.device)
        if self.mesh is not None:
            g = ShardedGramian.from_full(g, self.mesh)
        return g

    def _elastic_shared_dir_probe(self, directory, p, world):
        """Verify every rank sees ONE checkpoint directory, before any
        work.

        A write probe rather than lane fingerprints: on a first run every
        rank sees zero lanes, so fingerprints cannot tell a shared
        directory from per-host local disks, and finding that out only
        after a crash strands each host's lanes. Every rank drops a token,
        all-gathers (the barrier), then must see every peer's token. Miss
        counts are exchanged BEFORE the tokens are deleted (an all-gather
        syncs entry, not exit), and EVERY rank fails when ANY rank missed:
        a one-sided raise would strand the others in the next collective.
        """
        os.makedirs(directory, exist_ok=True)
        token = os.path.join(directory, f".probe-{p}")
        with open(token, "w") as f:
            f.write(str(p))
        with self._watchdog().armed("elastic shared-dir probe"):
            distributed.allgather_ints([p])
        missing = [
            i
            for i in range(world)
            if not os.path.exists(os.path.join(directory, f".probe-{i}"))
        ]
        with self._watchdog().armed("elastic shared-dir probe (exit)"):
            misses = distributed.allgather_ints([len(missing)]).ravel()
        try:
            os.remove(token)
        except OSError:
            pass
        if int(misses.max()) > 0:
            detail = (
                f"this host cannot see the probe file(s) of "
                f"process(es) {missing}; "
                if missing
                else ""
            )
            raise RuntimeError(
                "elastic multi-host checkpointing requires "
                "--checkpoint-dir on a filesystem every host shares; "
                f"{detail}probe miss counts per process: "
                f"{misses.tolist()}"
            )

    def _checkpointed_elastic(self):
        """Elastic ingest: Spark-task-style work units, resumable at any
        world size (:mod:`~spark_examples_tpu_torch.utils.elastic`).

        The GLOBAL manifest is cut into fixed units of
        ``--checkpoint-every`` shards (whole contigs a unit for a
        multi-dataset join); each rank accumulates its units into a
        self-describing lane file; a resume at ANY process count claims the
        surviving lanes and deals the uncovered units over the ranks
        alive, so a lost rank's share is re-executed by the others. Lanes
        are written in the JAX package's format, so either package resumes
        the other's. The host-local (data-parallel) regime only: a pod's
        collectives need every rank in lockstep, so a process-spanning
        mesh raises (use the synced-round pod checkpoints). A multi-rank
        run needs the directory on a filesystem every rank shares (probed
        before any work).
        """
        from spark_examples_tpu_torch.genomics.shards import manifest_digest
        from spark_examples_tpu_torch.utils import elastic

        if self._mesh_spans_processes():
            raise ValueError(
                "--elastic-checkpoint applies to the host-local (DP) "
                "accumulation regime; a process-spanning mesh needs the "
                "fixed-grid pod checkpointing (omit --elastic-checkpoint)"
            )
        vsids = self.conf.variant_set_ids
        multi = len(vsids) > 1
        shards_all = self._global_manifest()
        every = max(1, self.conf.checkpoint_every)
        if multi:
            # Multi-dataset joins checkpoint exactly when no work unit
            # splits a contig: the identity join keeps per-contig state,
            # so whole-contig units reproduce the uninterrupted join row
            # for row.
            if not self._fused_multi_possible():
                raise ValueError(
                    "elastic multi-dataset checkpointing needs the fused "
                    "keyed ingest (a source with stream_carrying_keyed, "
                    "no --debug-datasets)"
                )
            if not _contig_runs_unique(shards_all):
                raise ValueError(
                    "elastic multi-dataset checkpointing requires each "
                    "contig to appear as one contiguous manifest run "
                    "(join state is per-contig; units cut at contig "
                    "boundaries)"
                )
        # One dataset keeps the bare id; several use a length-prefixed
        # encoding, so distinct id lists never collide.
        vs_key = (
            vsids[0]
            if not multi
            else ",".join(f"{len(v)}:{v}" for v in vsids)
        )
        digest = (
            f"{manifest_digest(shards_all)}|{vs_key}"
            f"|af={self.conf.min_allele_frequency}|every={every}|elastic"
            + ("|contig-units" if multi else "")
        )
        n = self.index.size
        directory = os.path.join(self.conf.checkpoint_dir, "elastic")
        p, world = distributed.process_index(), distributed.process_count()
        if world > 1:
            self._elastic_shared_dir_probe(directory, p, world)
        lanes = elastic.load_lanes(directory, digest, n)
        if world > 1:
            fp = np.frombuffer(
                bytes.fromhex(elastic.lane_view_fingerprint(lanes)),
                dtype=np.uint8,
            )
            with self._watchdog().armed("elastic lane-view agreement"):
                views = distributed.allgather_ints(fp).reshape(world, -1)
            if not (views == views[0]).all():
                raise RuntimeError(
                    "elastic checkpoint lanes differ across hosts — "
                    "--checkpoint-dir must be on a filesystem every host "
                    "shares for elastic multi-host resume"
                )
        if p == 0:
            # One rank prunes digest-orphaned and superseded lane files
            # (safe: every rank finished reading lanes at the agreement
            # above; a single process has no reader to race).
            elastic.prune_stale_lanes(directory, digest, lanes)
        if multi:
            units = elastic.unit_ranges_contig_aligned(shards_all, every)
        else:
            units = elastic.unit_ranges(len(shards_all), every)
        done = set()
        for lane in lanes:
            done |= lane.units
        remaining = [u for u in range(len(units)) if u not in done]
        # A deterministic claim: the sorted lanes and the uncovered units
        # round-robin over the CURRENT world size, the same rule at any
        # world size, so a relaunch with fewer or more ranks re-deals.
        my_lanes = lanes[p::world]
        my_units = remaining[p::world]
        if done:
            print(
                f"Elastic resume: {len(done)}/{len(units)} units already "
                f"covered by {len(lanes)} lane(s); this process claims "
                f"{len(my_lanes)} lane(s) + {len(my_units)} new unit(s)."
            )
        g = None
        covered = set()
        own_paths = []
        for lane in my_lanes:
            # Payloads load lazily: only CLAIMED lanes' Gramians reach this
            # host's memory. A claimed payload that fails to read is
            # re-executed, and the file is superseded at the next merge.
            try:
                lane_g = lane.load_g()
            except Exception as e:  # noqa: BLE001 — any corruption shape
                print(
                    f"WARNING: claimed lane {lane.path} payload is "
                    f"unreadable ({type(e).__name__}: {e}); re-executing "
                    f"its {len(lane.units)} unit(s).",
                    file=sys.stderr,
                )
                my_units = my_units + sorted(lane.units)
                own_paths.append(lane.path)
                continue
            covered |= lane.units
            own_paths.append(lane.path)
            if g is None:
                g = lane_g  # a private array from np.load: add in place
            else:
                g += lane_g
        if multi and my_units and self.conf.min_allele_frequency is not None:
            for _ in vsids:  # one parity print per dataset stream
                print(
                    f"Min allele frequency "
                    f"{self.conf.min_allele_frequency}."
                )
        for u in my_units:
            # Between units the lane covers everything done: a soft
            # cancel here loses zero completed work.
            softcancel.check("elastic unit boundary")
            lo, hi = units[u]
            if multi:
                g = self._ingest_unit_multi(shards_all[lo:hi], g)
            else:
                g = self._ingest_shard_group(vsids[0], shards_all[lo:hi], g)
            covered.add(u)
            own_paths = [
                elastic.merge_and_supersede(
                    directory, g, covered, digest, own_paths
                )
            ]
        g = self._gramian_on_device(g)
        if world > 1:
            # Elastic ranks ingest with no sync until this one merge: the
            # first rank done waits here for the slowest, so
            # --collective-timeout must budget the whole run's ingest skew.
            with self._watchdog().armed(
                "elastic final allreduce (deadline must cover ingest "
                "skew across hosts — slowest minus fastest host)"
            ):
                g = self._merge_partials(g)
        return g

    def _checkpointed_pod(self):
        """Pod checkpoints: a globally synced round cursor.

        Pod block steps are collective, so a per-rank cursor cannot
        resume ranks independently. Every rank runs the same number of
        ROUNDS (``--checkpoint-every`` shards of its own manifest slice a
        round, a zero fill where its slice runs short), and after each
        round every rank snapshots into its own ``host-<p>`` directory
        with the same round cursor: the replicated G whole, a
        sample-sharded G as this rank's tiles only (no gather). A resume
        needs every rank to agree on the round (all-gathered); a
        disagreement (a crash between two ranks' saves) discards the
        snapshots with a warning and re-ingests from round 0.
        """
        from spark_examples_tpu_torch.genomics.shards import manifest_digest
        from spark_examples_tpu_torch.utils.checkpoint import (
            load_snapshot,
            save_snapshot,
        )

        # A lost peer stalls the others in the next collective; with
        # --collective-timeout each phase is armed fail-stop.
        wd = self._watchdog()
        sharded_g = self._sample_sharded()
        vsid = self.conf.variant_set_ids[0]
        mine = self._manifest()
        every = max(1, self.conf.checkpoint_every)
        rank, world = distributed.process_index(), distributed.process_count()
        with wd.armed("manifest-length allgather"):
            lens = distributed.allgather_ints([len(mine)]).ravel()
        total_rounds = int(-(-int(lens.max()) // every))  # ceil
        checkpoint_dir = os.path.join(
            self.conf.checkpoint_dir, f"host-{rank}"
        )
        # The digest pins THIS rank's manifest slice, its pod coordinates,
        # the round width and, for a tiled G, the mesh layout the tiles
        # are keyed to; the rounds all-gather below checks the ranks agree.
        mesh_tag = ""
        if sharded_g:
            mesh_tag = "|mesh=" + ",".join(
                f"{name}:{size}" for name, size in self.mesh.shape.items()
            )
        digest = (
            f"{manifest_digest(mine)}|{vsid}"
            f"|af={self.conf.min_allele_frequency}"
            f"|pod={rank}/{world}|every={every}"
            f"{mesh_tag}"
        )
        n = self.index.size
        if sharded_g:
            local_round, g = self._load_sharded_pod_snapshot(
                checkpoint_dir, digest, n
            )
        else:
            ck = load_snapshot(checkpoint_dir, digest, n)
            local_round = ck.shards_done if ck else 0  # counts ROUNDS
            g = ck.g if ck else None
        with wd.armed("resume-round allgather"):
            rounds = distributed.allgather_ints([local_round]).ravel()
        start = int(rounds.min())
        if int(rounds.max()) != start:
            print(
                "WARNING: pod snapshot rounds disagree across hosts "
                f"({sorted(int(r) for r in rounds)}); discarding and "
                "re-ingesting from round 0.",
                file=sys.stderr,
            )
            start, g = 0, None
        if start and sharded_g:
            # Every rank holds its snapshot's tiles: lay them out on the
            # port's grid together.
            g = ShardedGramian.from_jax_tiles(g, n, self.mesh)
        if start:
            print(
                f"Resuming pod ingest from round {start}/{total_rounds}."
            )
        for r in range(start, total_rounds):
            # A collective round: a rank whose slice ran short feeds zero
            # steps through the synced stream, so every rank runs the same
            # collectives. The watchdog budget covers the whole round.
            with wd.armed(f"pod round {r + 1}/{total_rounds}"):
                g = self._ingest_shard_group(
                    vsid, mine[r * every : (r + 1) * every], g
                )
                if sharded_g:
                    self._save_sharded_pod_snapshot(
                        checkpoint_dir, g, r + 1, digest
                    )
                else:
                    save_snapshot(checkpoint_dir, g, r + 1, digest)
        if g is None:
            g = self._blocks_to_gramian(iter(()))
        elif not isinstance(g, (torch.Tensor, ShardedGramian)):
            # Every round was done before this run: the snapshot's G.
            g = torch.from_numpy(np.array(g, copy=True)).to(
                self.mesh.local_devices()[0]
            )
        return g

    def _g_sharding(self):
        """This rank's tiles of the pod's sample-sharded G, as ``{(i, j):
        (rows, cols)}`` slices of the (n, n) matrix in the JAX package's
        ``P(data, model)`` split (:func:`jax_tile_splits`), which its
        snapshots are keyed to."""
        rows, cols = jax_tile_splits(self.index.size, self.mesh)
        return {
            (i, j): (rows[i], cols[j])
            for i, j in np.ndindex(len(rows), len(cols))
            if self.mesh.is_local(_grid_index(self.mesh, i, j))
        }

    def _save_sharded_pod_snapshot(self, directory, g, round_, digest):
        """Snapshot this rank's tiles of the sharded G (no gather), in the
        JAX package's split, each tagged with its global [start, stop)
        indices in the (n, n) matrix. Re-tiling G from the port's grid is
        a collective that every rank runs at the same round, as the JAX
        package's pin to ``P(data, model)`` is."""
        from spark_examples_tpu_torch.utils.checkpoint import (
            save_sharded_snapshot,
        )

        tiles = g.jax_tiles()
        save_sharded_snapshot(
            directory,
            [(idx, tiles[ij]) for ij, idx in self._g_sharding().items()],
            g.n,
            round_,
            digest,
        )

    def _load_sharded_pod_snapshot(self, directory, digest, n):
        """→ ``(rounds_done, tiles | None)`` from this rank's tile set:
        ``tiles`` an object array of its tiles in the JAX package's split,
        for :meth:`ShardedGramian.from_jax_tiles` once every rank agrees
        on the round. The stored tiles must be exactly this rank's tiles
        of the current layout; any mismatch discards the snapshot with a
        warning. The rounds value feeds the cross-rank agreement either
        way."""
        from spark_examples_tpu_torch.utils.checkpoint import (
            index_key,
            load_sharded_snapshot,
        )

        loaded = load_sharded_snapshot(directory, digest, n)
        if loaded is None:
            return 0, None
        rounds_done, tiles = loaded
        layout = {
            ij: index_key(idx, (n, n))
            for ij, idx in self._g_sharding().items()
        }
        if set(layout.values()) != set(tiles):
            print(
                "WARNING: sharded snapshot tile set does not match this "
                "mesh placement; discarding.",
                file=sys.stderr,
            )
            return 0, None
        grid = np.empty(_grid_shape(self.mesh), dtype=object)
        for ij, key in layout.items():
            grid[ij] = torch.from_numpy(np.array(tiles[key], copy=True)).to(
                _grid_device(self.mesh, *ij)
            )
        return rounds_done, grid

    def _ingest_unit_multi(self, group, g):
        """One contig-aligned unit through the fused keyed join → blocks
        accumulated onto g (elastic multi-dataset checkpoints). The group
        holds whole contigs, so the join state is complete within the
        unit and its rows equal the same contigs' rows of an
        uninterrupted run."""
        blocks = blocks_from_calls(
            self._keyed_calls(group, contig_runs_unique=True),
            self.index.size,
            self.conf.block_variants,
        )
        return self._blocks_to_gramian(blocks, g_init=g)

    def _ingest_shard_group(self, vsid: str, group, g):
        """Stream one shard group through filter → calls → Gramian blocks,
        accumulating onto g. Prefers the CSR-direct tier (bit-identical
        blocks, so snapshots and resume digests are unaffected): the same
        builder threads as the uncheckpointed route, each shard under
        :meth:`_shard_attempt`; else the fused carrier lists; else the
        staged Variant path, materialized per shard so a retry re-runs
        only the failed shard."""
        if self._fused_csr_possible():
            pairs = (
                self._shard_attempt(
                    shard,
                    lambda shard=shard: self.source.stream_carrying_csr(
                        vsid,
                        shard,
                        self.index.indexes,
                        self.conf.min_allele_frequency,
                    ),
                )
                for shard in group
            )
            # Snapshots cut at GROUP boundaries, and within a group G is
            # bit-identical under any block completion order.
            blocks = packed_blocks_from_csr(
                pairs,
                self.index.size,
                self.conf.block_variants,
                workers=self._block_builder_workers(),
                attempt=self._build_attempt,
            )
            return self._blocks_to_gramian(blocks, g_init=g, prepacked=True)
        fused = self._fused_ingest_possible()

        def group_calls():
            if fused:
                yield from self._parallel_shard_calls(vsid, group)
                return
            for shard in group:
                yield from self._shard_attempt(
                    shard,
                    lambda shard=shard: list(
                        calls_stream(
                            [
                                self.filter_dataset(
                                    self.source.stream_variants(
                                        vsid, shard
                                    )
                                )
                            ],
                            self.index.indexes,
                        )
                    ),
                )

        blocks = blocks_from_calls(
            group_calls(), self.index.size, self.conf.block_variants
        )
        return self._blocks_to_gramian(blocks, g_init=g)

    def _sparse_selected(self) -> bool:
        """Route the Gramian through the sparse-aware engine?

        ``--pca-mode sparse`` forces it; ``auto`` selects it for the
        biobank shape — a sample-sharded mesh (G tiled) on an
        uncheckpointed single-controller run. Everything else keeps the
        dense-blockwise route; a host-local mesh on a multi-process
        data-parallel run stays dense (each rank would tile the whole G).
        """
        mode = self.conf.pca_mode
        if mode == "sparse":
            return True
        if mode != "auto":
            return False
        return (
            self.mesh is not None
            and (
                self._mesh_spans_processes()
                or distributed.process_count() == 1
            )
            and not self.conf.checkpoint_dir
            and self._sample_sharded()
        )

    def _cohort_windows(self, restrict: bool = True):
        """Route the best available tier's output as CSR carrier windows
        of ``--block-variants`` variants (never densified blocks). The
        CSR sidecar tier feeds windows straight from ``(indices,
        offsets)`` pairs; call-list tiers go through
        ``windows_from_calls`` — the same window composition as the dense
        path's block composition. ``restrict=False`` yields FULL-frame
        windows regardless of any cohort sample restriction."""
        if self._fused_csr_possible():
            pairs = self.get_csr_fused()
            if restrict:
                pairs = self._restrict_csr(pairs)
            return csr_windows(pairs, self.conf.block_variants)
        if self._fused_ingest_possible():
            calls = self.get_calls_fused()
        elif self._fused_multi_possible():
            calls = self.get_calls_fused_multi()
        else:
            data = self.get_data()
            filtered = [self.filter_dataset(d) for d in data]
            calls = self.get_calls(filtered)
        if restrict:
            calls = self._restrict_calls(calls)
        return windows_from_calls(calls, self.conf.block_variants)

    def _windows_to_gramian(self, windows):
        """CSR carrier windows → finished (N, N) G on the device, each
        window routed by density inside the sparse engine, cancellable at
        every window boundary."""

        def cancellable():
            for window in windows:
                softcancel.check("sparse gramian window boundary")
                yield window

        with self._watchdog().armed("sparse ingest+gramian"):
            if self.mesh is not None:
                g = sparse_sharded_gramian_blockwise(
                    cancellable(),
                    self.cohort.size,
                    self.mesh,
                    density_threshold=self.conf.sparse_density_threshold,
                    block_variants=self.conf.block_variants,
                    pipeline_depth=self.conf.pod_pipeline_depth,
                    coalesce_variants=self.conf.pod_coalesce_variants,
                )
            else:
                g = sparse_gramian_blockwise(
                    cancellable(),
                    self.cohort.size,
                    density_threshold=self.conf.sparse_density_threshold,
                    block_variants=self.conf.block_variants,
                    device=self.device,
                )
            return self._merge_partials(g)

    def _gramian_sparse(self):
        return self._windows_to_gramian(self._cohort_windows())

    # -- serving entry points: window capture, deltas ------------------------

    def ingest_gramian_windows(self, window_sink=None):
        """Window-route ingest for the delta-aware serving engine: the
        same finished G as :meth:`ingest_gramian` (integer-exact
        accumulation — bit-identical across routes), but fed through the
        sparse engine's window stream, whatever ``--pca-mode`` says, so the
        FULL-frame windows can be captured into ``window_sink`` on the way
        (the delta index's per-base-key window cache) while the
        cohort-restricted view of each window accumulates. Rare windows
        launch the scatter kernel. Meshless runs only."""
        if self.mesh is not None:
            raise ValueError(
                "ingest_gramian_windows serves meshless runs; use "
                "ingest_gramian"
            )

        def stream():
            for window in self._cohort_windows(restrict=False):
                if window_sink is not None:
                    window_sink.append(window)
                yield self._restrict_window(window)

        return self._windows_to_gramian(stream())

    def ingest_gramian_delta(
        self, cached_g, cached_samples, windows=None, window_sink=None,
        density_threshold=DEFAULT_SPARSE_DENSITY_THRESHOLD,
    ):
        """Target-cohort G from a cached ancestor G by exact rank-k
        sample correction (:mod:`spark_examples_tpu_torch.ops.delta`) —
        bit-identical to from-scratch, O(k·N) device work instead of a
        full re-accumulation.

        ``cached_samples`` is the ancestor's callset-id frame (row i of
        ``cached_g`` is that callset). ``windows`` is the base key's
        cached full-frame window list; None re-streams the source (and
        captures into ``window_sink`` so the next delta is ingest-free).
        ``density_threshold`` routes the correction (the JAX package's
        fixed threshold unless a caller forces a route). Returns a host
        float32 array in this driver's cohort frame.
        """
        from spark_examples_tpu_torch.ops.delta import delta_gramian

        full = self.index.indexes
        ancestor = np.asarray(
            [full[cid] for cid in cached_samples], dtype=np.int64
        )
        target = np.asarray(
            [full[cid] for cid in self.cohort.callset_of_index()],
            dtype=np.int64,
        )
        if windows is None:

            def stream():
                for window in self._cohort_windows(restrict=False):
                    if window_sink is not None:
                        window_sink.append(window)
                    yield window

            windows = stream()
        return delta_gramian(
            cached_g, ancestor, target, self.index.size, windows,
            density_threshold=density_threshold,
            device=self.device,
        )

    # The auto-sketch trigger, the JAX package's: above 4 GiB of float32 G
    # (N > 32768) its exact engines refuse, and only there does auto trade
    # exactness for the approximate engine.
    SKETCH_AUTO_G_BYTES = 4 << 30

    def _sparse_host_g_bytes(self) -> int:
        """Bytes of float32 G this process holds: N² meshless; on a mesh,
        the tile of every device of this process (``(N/rows)·(N/cols)``
        each, padded N), replicas included — on a pod only this rank's
        share of the grid."""
        n = self.cohort.size
        if self.mesh is None:
            return n * n * 4
        d_axis, m_axis = _mesh_axes(self.mesh)
        n_padded = round_up_multiple(
            n, _axis_product(self.mesh, (d_axis, m_axis))
        )
        rows = n_padded // self.mesh.shape[d_axis]
        cols = n_padded // (self.mesh.shape[m_axis] if m_axis else 1)
        return len(self.mesh.local_devices()) * rows * cols * 4

    def sketch_selected(self) -> bool:
        """Will :meth:`ingest_gramian` return a Gramian-free
        :class:`~spark_examples_tpu_torch.ops.sketch.SketchPanel` instead of
        an (N, N) G?"""
        return self._sketch_selected()

    def _sketch_selected(self) -> bool:
        """Route ingest through the sketch engine?

        ``--pca-mode sketch`` forces it; ``auto`` selects it only on an
        uncheckpointed run whose float32 G would exceed
        :attr:`SKETCH_AUTO_G_BYTES`.
        """
        mode = self.conf.pca_mode
        if mode == "sketch":
            return True
        if mode != "auto":
            return False
        return (
            not self.conf.checkpoint_dir
            and self._sparse_host_g_bytes() > self.SKETCH_AUTO_G_BYTES
        )

    def _sketch_panel(self) -> SketchPanel:
        """Sketch-engine ingest: the cohort's CSR windows into an
        (N, k+p) randomized panel. The factory returns fresh windows on
        each call, because each power iteration re-streams the source;
        each window boundary is a soft-cancel check. A data-parallel run
        sums the ranks' partial panels after each pass. On a mesh the panel
        is :func:`~spark_examples_tpu_torch.parallel.sharded.
        sharded_sketch_panel`'s (a pod's through the synced carrier
        stream), finished by the TSQR."""

        def windows_factory():
            for window in self._cohort_windows():
                softcancel.check("sketch panel window boundary")
                yield window

        with self._watchdog().armed("sketch ingest+panel"):
            if self.mesh is not None:
                return sharded_sketch_panel(
                    windows_factory,
                    self.cohort.size,
                    self.conf.num_pc,
                    self.mesh,
                    oversample=self.conf.sketch_oversample,
                    power_iters=self.conf.sketch_power_iters,
                    seed=self.conf.sketch_seed,
                    density_threshold=self.conf.sparse_density_threshold,
                    block_variants=self.conf.block_variants,
                    pipeline_depth=self.conf.pod_pipeline_depth,
                    coalesce_variants=self.conf.pod_coalesce_variants,
                )
            return sketch_panel_blockwise(
                windows_factory,
                self.cohort.size,
                self.conf.num_pc,
                oversample=self.conf.sketch_oversample,
                power_iters=self.conf.sketch_power_iters,
                seed=self.conf.sketch_seed,
                density_threshold=self.conf.sparse_density_threshold,
                block_variants=self.conf.block_variants,
                device=self.device,
            )

    def ingest_gramian(self):
        """Stages 1-4 as one call: route the configured ingest tier, in
        the JAX driver's order, and return the finished (N, N) float32 G
        tensor: checkpointed ingest first (``--checkpoint-dir`` on a single
        dataset); else, under the sketch engine, a host
        :class:`~spark_examples_tpu_torch.ops.sketch.SketchPanel` and no G
        at all; else the sparse engine; else the CSR-direct sidecar tier,
        the fused carrier lists, the keyed multi-dataset join/merge or the
        staged Variant path, all through the dense-blockwise
        accumulator."""
        if self.conf.checkpoint_dir and (
            len(self.conf.variant_set_ids) == 1
            or self.conf.elastic_checkpoint
        ):
            return self.get_similarity_matrix_checkpointed()
        if self._sketch_selected():
            return self._sketch_panel()
        if self._sparse_selected():
            return self._gramian_sparse()
        if self._fused_csr_possible():
            return self.get_similarity_matrix_csr(self.get_csr_fused())
        if self._fused_ingest_possible():
            return self.get_similarity_matrix(self.get_calls_fused())
        if self._fused_multi_possible():
            return self.get_similarity_matrix(self.get_calls_fused_multi())
        data = self.get_data()
        filtered = [self.filter_dataset(d) for d in data]
        return self.get_similarity_matrix(self.get_calls(filtered))

    # -- stage 5: eigendecomposition ----------------------------------------

    def _pca_fused_eligible(self) -> bool:
        """Route the PCA stage through the fused finish?

        ``stream`` never; ``--precise``, a mesh or a process group never
        (the fused finish is a one-device program; host float64 is its
        own route); ``fused`` always (its config was checked in __init__,
        before ingest); ``auto`` and ``sparse`` for N ≤
        ``--dense-eigh-limit``.
        """
        mode = self.conf.pca_mode
        if (
            mode == "stream"
            or self.conf.precise
            or self.mesh is not None
            or distributed.process_count() > 1
        ):
            return False
        if mode == "fused":
            return True
        return self.cohort.size <= self.conf.dense_eigh_limit

    def compute_pca(self, g, timer=None) -> List[Tuple[str, float, float]]:
        with self._watchdog().armed("pca collectives"):
            return self._compute_pca(g, timer)

    def _compute_pca(self, g, timer=None) -> List[Tuple[str, float, float]]:
        if isinstance(g, SketchPanel):
            # Gramian-free finish: the row sums rode the panel's companion
            # column, so the parity print survives without G.
            self._print_nonzero_rows(g.row_sums)
            coords, _ = sketch_eig(g, self.conf.num_pc, timer=timer)
            return self._emit_tuples(coords)
        if self._pca_fused_eligible():
            kwargs = (
                {"resid_warn": self.conf.eig_tol}
                if self.conf.eig_tol is not None
                else {}
            )
            try:
                coords, _, row_sums = fused_finish(
                    g, self.conf.num_pc, timer=timer, device=self.device,
                    **kwargs,
                )
            except FloatingPointError as e:
                # The CholeskyQR panel collapses on numerically degenerate
                # centered Gramians. A forced --pca-mode fused keeps the
                # hard error (the user asked for exactly that program);
                # otherwise dense eigh handles rank deficiency exactly,
                # and N is ≤ --dense-eigh-limit here.
                if self.conf.pca_mode == "fused":
                    raise
                warnings.warn(
                    "fused finish collapsed on a numerically "
                    f"degenerate centered Gramian ({e}); falling back "
                    "to the dense-eigh finish (exact on rank-deficient "
                    "spectra)"
                )
                if timer is not None:
                    timer.note(
                        "fused finish degenerate -> dense-eigh fallback"
                    )
            else:
                self._print_nonzero_rows(row_sums)
                return self._emit_tuples(coords)
        sharded = isinstance(g, ShardedGramian)
        if sharded:
            # Read once a job, for the report and the centring; the copy
            # to the host ends the span when the cards' sums are there.
            with obs.span(PCOA_TILES_SUMS, n=g.n):
                row_sums = g.row_sums()
                host_sums = row_sums.cpu().numpy()
        else:
            row_sums = g.sum(dim=1)
            host_sums = row_sums.cpu().numpy()
        self._print_nonzero_rows(host_sums)
        if self.conf.precise:
            gh = (g.full() if sharded else g).cpu().numpy()
            coords, _ = topk_with_gap_check(
                lambda kk: mllib_principal_components_reference(gh, kk),
                self.conf.num_pc,
                self.cohort.size,
                timer=timer,
                vals_are_squared=True,  # covariance eigenvalues = λ(C)²/(n−1)
            )
        elif self.mesh is not None:
            coords, _ = sharded_pcoa(
                g,
                self.conf.num_pc,
                self.mesh,
                dense_eigh_limit=self.conf.dense_eigh_limit,
                timer=timer,
                eig_tol=self.conf.eig_tol,
                row_sums=row_sums,
            )
        else:

            def dense(kk):
                coords, vals = pcoa(g, kk)
                return coords.cpu().numpy(), vals.cpu().numpy()

            coords, _ = topk_with_gap_check(
                dense, self.conf.num_pc, self.cohort.size, timer=timer
            )
        return self._emit_tuples(coords)

    def _print_nonzero_rows(self, row_sums) -> None:
        nonzero = int((np.asarray(row_sums) > 0).sum())
        print(
            f"Non zero rows in matrix: {nonzero} / {self.cohort.size}."
        )  # VariantsPca.scala:207-208

    def _emit_tuples(self, coords) -> List[Tuple[str, float, float]]:
        with obs.span(ROWS_TUPLES):
            coords = np.asarray(coords)
            n = self.cohort.size
            # The reference emits exactly two components regardless of
            # --num-pc (VariantsPca.scala:228-230: array(i),
            # array(i + numRows)).
            pc2 = (
                coords[:n, 1].tolist() if coords.shape[1] > 1
                else [0.0] * n
            )
            return list(zip(
                self.cohort.callset_of_index(), coords[:n, 0].tolist(), pc2,
                strict=True,
            ))

    # -- stage 6: emission ---------------------------------------------------

    def collect_result(
        self, result: Sequence[Tuple[str, float, float]], native: bool = True
    ) -> List[Tuple[str, float, float, str]]:
        """``emitResult``'s row shape — ``(name, pc1, pc2, dataset)``
        sorted by name — without the emission side effects. ``native=False``
        sorts the tuples themselves (the tests' reference)."""
        with obs.span(ROWS_SORT):
            if not native:
                return sorted(
                    (
                        self.cohort.names[cid],
                        pc1,
                        pc2,
                        cid.split("-")[0],  # dataset label, VariantsPca.scala:235
                    )
                    for cid, pc1, pc2 in result
                )
            rows = RowColumns(result, self.cohort.names)
            return rows.tuples(rows.order())

    def emit_result(
        self, result: Sequence[Tuple[str, float, float]], native: bool = True
    ) -> None:
        """Print the rows in ``collect_result``'s order and write them to
        ``--output-path``'s ``-pca.tsv``: from columns, each text in one
        write, or (``native=False``, the tests' reference) row by row."""
        if not distributed.is_coordinator():
            return  # rank 0 alone emits (the driver role)
        if native:
            with obs.span(ROWS_SORT):
                rows = RowColumns(result, self.cohort.names)
                order = rows.order()
            with obs.span(ROWS_WRITE):
                sys.stdout.write(rows.render(order, STDOUT_LAYOUT))
                path = self._tsv_path()
                if path:
                    with open(path, "w") as f:
                        f.write(rows.render(order, FILE_LAYOUT))
        else:
            with_names = self.collect_result(result, native=False)
            with obs.span(ROWS_WRITE):
                for name, pc1, pc2, dataset in with_names:
                    print(f"{name}\t{dataset}\t{pc1}\t{pc2}")
                path = self._tsv_path()
                if path:
                    with open(path, "w") as f:
                        for name, pc1, pc2, dataset in with_names:
                            f.write(f"{name}\t{pc1}\t{pc2}\t{dataset}\n")
        note_rows("native" if native else "python", len(result))

    def _tsv_path(self) -> Optional[str]:
        """``--output-path``'s ``-pca.tsv`` file, its directory made."""
        if not self.conf.output_path:
            return None
        path = self.conf.output_path + "-pca.tsv"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return path

    # -- observability -------------------------------------------------------

    def report_io_stats(self) -> None:
        if self._speculated_shards:
            print(
                f"Speculative shard attempts on this host: "
                f"{self._speculated_shards}.",
                file=sys.stderr,
            )
        stats = getattr(self.source, "stats", None)
        if stats is None:
            return
        if distributed.process_count() > 1:
            stats = distributed.allreduce_host_stats(stats)
            if not distributed.is_coordinator():
                return
        # The job-end merged totals, as registry gauges, so the run
        # manifest carries them apart from the per-instance sums.
        reg = obs.get_registry()
        for name, value in zip(COUNTER_FIELDS, stats.as_vector()):
            reg.gauge(
                f"genomics_io_merged_{name}",
                "Driver-merged job-end IoStats totals "
                "(allreduce_host_stats across hosts)",
            ).set(float(value))
        print(stats.report())

    # -- orchestration -------------------------------------------------------

    def _sync(self) -> None:
        """Wait for the device, so a stage's wall-clock includes its
        device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> List[Tuple[str, float, float]]:
        """main() stage order — VariantsPca.scala:38-50. Keeps the
        finished Gramian (``self.g``: a tensor, a ``ShardedGramian`` on a
        mesh, or a host ``SketchPanel`` under the sketch engine) and the stage timer (``self.timer``) for
        callers that verify the run. With ``--trace-dir`` the stages run
        under a ``torch.profiler`` trace written there."""
        self.timer = timer = StageTimer()
        with profiler_trace(self.conf.trace_dir, self.device):
            with timer.stage("ingest+gramian"):
                self.g = self.ingest_gramian()
                self._sync()
            with timer.stage("pca"):
                result = self.compute_pca(self.g, timer=timer)
            with timer.stage("emit"):
                self.emit_result(result)
        self.report_io_stats()
        print(timer.report())
        return result
