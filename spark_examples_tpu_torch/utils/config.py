"""Flag system: the configuration of ``pca`` and the other subcommands.

The JAX package's ``PcaConfig`` / ``add_pca_flags`` cut to what the port
serves (GenomicsConf/PcaConf parity, ``GenomicsConf.scala:31-101``):
every field and flag here keeps the JAX package's name and default, and
:func:`add_analyze_flags` is the analysis tier's surface. ``--device`` is
the port's own: ``cuda`` by default, ``cpu`` only when asked.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import List, Optional

from spark_examples_tpu_torch.arrays.blocks import DEFAULT_BLOCK_VARIANTS
from spark_examples_tpu_torch.device import DEFAULT_DEVICE
from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    DEFAULT_BASES_PER_SHARD,
    SexChromosomeFilter,
    Shard,
    shards_for_all_references,
    shards_for_references,
)
from spark_examples_tpu_torch.ops.pcoa import (
    DEFAULT_RANDOMIZED_OVERSAMPLE,
    DEFAULT_SKETCH_POWER_ITERS,
)
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_POD_COALESCE_VARIANTS,
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
)
from spark_examples_tpu_torch.resilience.breaker import (
    DEFAULT_COOLDOWN_S,
    DEFAULT_FAILURE_THRESHOLD,
)
from spark_examples_tpu_torch.resilience.policy import (
    RetryPolicy as _RetryPolicy,
)

__all__ = [
    "INGEST_ORDERS",
    "PCA_MODES",
    "PcaConfig",
    "add_analyze_flags",
    "add_pca_flags",
    "pca_config_from_args",
]

# The JAX package's --pca-mode registry.
PCA_MODES = ("auto", "fused", "stream", "sparse", "sketch")
# The JAX package's --ingest-order choices.
INGEST_ORDERS = ("auto", "manifest", "completion")

# Per-read idle deadline (seconds) on gRPC shard streams (the JAX
# package's GenomicsConfig.grpc_idle_timeout).
DEFAULT_GRPC_IDLE_TIMEOUT = 120.0

# Reference well-known variantset id (SearchVariantsExample.scala:27-31).
PLATINUM_GENOMES = "3049512673186936334"


def _csv_list(value: str) -> List[str]:
    """argparse type for comma-separated id lists (empty items dropped,
    so a trailing comma is not a silent empty id)."""
    return [item for item in value.split(",") if item]


@dataclass
class PcaConfig:
    bases_per_partition: int = DEFAULT_BASES_PER_SHARD
    output_path: Optional[str] = None
    references: str = BRCA1_REFERENCES
    variant_set_ids: List[str] = field(
        default_factory=lambda: [PLATINUM_GENOMES]
    )
    # Device mesh, e.g. "data:4,model:2" (parallel/mesh.py::make_mesh):
    # this process's devices, or in a process group every rank's.
    mesh_shape: Optional[str] = None
    # Accepted for CLI parity (the Spark shuffle knob); unused.
    num_reduce_partitions: int = 10
    block_variants: int = DEFAULT_BLOCK_VARIANTS
    all_references: bool = False
    debug_datasets: bool = False
    min_allele_frequency: Optional[float] = None
    num_pc: int = 2
    # Cohort sample restriction: `samples` keeps only the named callset
    # ids (None = all), `exclude_samples` then drops ids. Ingest still
    # extracts in the full callset frame; carriers are remapped/dropped
    # at the window boundary, so the Gramian, finish, and emission are
    # sized by the restricted cohort. Meshless uncheckpointed runs only.
    samples: Optional[List[str]] = None
    exclude_samples: Optional[List[str]] = None
    precise: bool = False  # host-f64 eigendecomposition
    pca_mode: str = "auto"
    # The sketch engine's knobs (--pca-mode sketch, or auto past the 4 GiB
    # G bound): panel oversampling p (the panel has randomized_panel_width
    # = k+p columns), the seed of the Gaussian test matrix Ω (a run is
    # reproducible bit for bit from it), and the extra streamed passes with
    # Ω ← orth(Y) between them.
    sketch_oversample: int = DEFAULT_RANDOMIZED_OVERSAMPLE
    sketch_seed: int = 0
    sketch_power_iters: int = DEFAULT_SKETCH_POWER_ITERS
    # Dense/sparse switch of the sparse Gramian: a window whose carrier
    # density is strictly below this scatters, at or above it goes dense.
    sparse_density_threshold: float = DEFAULT_SPARSE_DENSITY_THRESHOLD
    # Pod-sparse protocol pipeline depth (process-spanning meshes with the
    # sparse engine): how many window slots the sync thread's
    # header/confirm/carrier exchange runs AHEAD of the card's scatter, so
    # exchange latency and payload construction hide behind compute.
    # 0 = inline lockstep (the ablation mode); 2 (double buffering).
    pod_pipeline_depth: int = 2
    # Pod-sparse gang coalescing: consecutive scatter-route windows merge
    # into one protocol step until their variant-row total reaches this,
    # so tiny windows share one exchange. 0 disables; G is bit-identical
    # at any setting (integer-exact accumulation).
    pod_coalesce_variants: int = DEFAULT_POD_COALESCE_VARIANTS
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 64  # shards per Gramian snapshot
    # World-size-independent checkpointing (utils/elastic.py): work units
    # over the GLOBAL manifest and self-describing lane files, so a resume
    # runs on any number of ranks.
    elastic_checkpoint: bool = False
    # Shard the N×N Gramian over the mesh as a tile grid. None = auto
    # (shard when N exceeds sample_shard_threshold); on a sample-sharded
    # single-controller mesh `auto` routes through the sparse engine.
    sample_sharded: Optional[bool] = None
    sample_shard_threshold: int = 16384
    # Fail-stop deadline (seconds) per collective phase of a
    # multi-process run (utils/watchdog.py). None = disabled.
    collective_timeout: Optional[float] = None
    trace_dir: Optional[str] = None  # torch.profiler trace output
    # N above which the finish uses dense eigh instead of the fused
    # subspace iteration.
    dense_eigh_limit: int = 8192
    # Convergence target of the fused finish (None = its default 1e-3).
    eig_tol: Optional[float] = None
    # Shard-extraction (and, on the CSR tier, block-building) threads of
    # the fused ingest (0 = auto).
    ingest_workers: int = 0
    # Shard arrival order into the accumulator on the CSR-direct ingest
    # tier: "manifest" keeps exact manifest order; "completion" feeds
    # shards as their extraction completes. G is bit-identical either way
    # (integer-exact accumulation); only block composition and wall-clock
    # change. "auto" resolves to completion on a cold-stream run (a cold
    # remote cohort behind --cache-dir) and to manifest everywhere else.
    ingest_order: str = "auto"
    # Spark-style speculative execution for straggler shards: when the
    # head-of-line extraction runs far past the median, a duplicate
    # attempt races it and the winner's (identical) result is used.
    speculative_ingest: bool = False
    # Per-shard ingest retry (the driver-side resilience tier): each
    # shard extraction (and, on the CSR tier, each block build) is
    # idempotent, so a failed one re-executes up to this many total
    # attempts, every attempt drawing down the per-shard wall-clock budget
    # below. 1 = fail fast.
    shard_retries: int = 1
    shard_retry_deadline: Optional[float] = None
    # Blocks the host→device feed stages ahead of the product.
    prefetch_depth: int = 2
    # Reads-pipeline surface (models/pairhmm.py + the reads examples):
    # readset filter for streamed reads (None/"" = every readset the
    # cohort holds) and the PairHMM scoring knobs. Pairs per batched
    # forward dispatch (partial flush tiles pad to a pow2 bucket);
    # consensus-haplotype context bases scored on each side of a read's
    # alignment; phred-scaled gap-open/gap-extend penalties (GATK
    # defaults Q45/Q10). Per-pair results are independent of batching,
    # so pairhmm_batch changes wall-clock only.
    read_group_set_id: Optional[str] = None
    pairhmm_batch: int = 128
    pairhmm_context: int = 8
    pairhmm_gap_open_phred: float = 45.0
    pairhmm_gap_ext_phred: float = 10.0
    device: str = DEFAULT_DEVICE

    def shards(
        self,
        all_references: bool = False,
        sex_filter: SexChromosomeFilter = SexChromosomeFilter.EXCLUDE_XY,
    ) -> List[Shard]:
        """Partitioner selection — PcaConf.getPartitioner
        (GenomicsConf.scala:92-100)."""
        if all_references:
            return shards_for_all_references(
                sex_filter, self.bases_per_partition
            )
        return shards_for_references(
            self.references, self.bases_per_partition
        )


def add_pca_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--bases-per-partition",
        type=int,
        default=DEFAULT_BASES_PER_SHARD,
        help="Partition each reference using a fixed number of bases",
    )
    p.add_argument(
        "--client-secrets",
        default=None,
        help="Credential JSON for network-source auth (interactive "
        "confirmation required, Client.scala:32-41 semantics): either a "
        "pre-exchanged {'token': ...} or a stored OAuth user credential "
        "(client_id + client_secret + refresh_token, exchanged at "
        "startup via the refresh-token grant); offline sources ignore it",
    )
    p.add_argument(
        "--api-url",
        default=None,
        help="Base URL of a Genomics-compatible HTTP service to ingest "
        "from (see the serve-cohort subcommand)",
    )
    p.add_argument(
        "--cache-dir",
        default=None,
        help="Local directory for mirrored remote cohorts (keyed by the "
        "server's /identity digest): repeat runs against the same served "
        "cohort skip the network and hit the warm sidecar tier",
    )
    p.add_argument(
        "--mirror-mode",
        choices=("full", "light"),
        default="full",
        help="With --cache-dir: 'full' mirrors the whole interchange "
        "cohort (every consumer works offline); 'light' downloads only "
        "callsets + the binary CSR sidecar — at all-autosomes scale a "
        "~2.7 GB npz instead of a ~58 GB JSONL, serving the default "
        "fused pca ingest tiers (record-streaming consumers like "
        "--debug-datasets need 'full')",
    )
    p.add_argument(
        "--cold-stream",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="With --cache-dir on a COLD cohort (no completed mirror): "
        "stream wire frames straight into the fetch->decode->build->put "
        "ingest pipeline — the first Gramian step dispatches while later "
        "shards are still on the wire — and write the mirror through in "
        "the background (atomic per-file; a killed run's partial mirror "
        "is reused by the next cold run). --no-cold-stream restores the "
        "phased cold path (download the whole mirror, then ingest). "
        "Warm runs and checkpointed/mesh contracts are unaffected; G is "
        "bit-identical either way",
    )
    p.add_argument(
        "--input-path",
        default=None,
        help="JSONL cohort directory (callsets.json + variants.jsonl[.gz]); "
        "the fused ingest reads it through a CSR sidecar built next to "
        "the files on first use",
    )
    p.add_argument("--output-path", default=None)
    p.add_argument(
        "--references",
        default=BRCA1_REFERENCES,
        help="Comma separated tuples of reference:start:end",
    )
    p.add_argument(
        "--variant-set-id",
        action="append",
        dest="variant_set_ids",
        default=None,
        help="VariantSet id (repeat to join/merge datasets)",
    )
    p.add_argument(
        "--mesh-shape",
        default=None,
        help="Device mesh, e.g. 'data:4,model:2' (replaces --spark-master)",
    )
    p.add_argument(
        "--num-reduce-partitions",
        type=int,
        default=10,
        help="Accepted for CLI parity (Spark shuffle knob); unused",
    )
    p.add_argument(
        "--sample-sharded",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="Shard the N×N Gramian over the mesh (default: auto above "
        "--sample-shard-threshold; --no-sample-sharded forces the "
        "replicated-G path); the 100k-sample stress regime",
    )
    p.add_argument(
        "--sample-shard-threshold", type=int, default=16384
    )
    p.add_argument(
        "--collective-timeout",
        type=float,
        default=None,
        help="Fail-stop deadline (seconds) per collective phase of a "
        "multi-process run: a lost peer stalls survivors in a collective "
        "forever; with this set the process exits 77 instead",
    )
    p.add_argument(
        "--block-variants", type=int, default=DEFAULT_BLOCK_VARIANTS
    )
    p.add_argument(
        "--all-references",
        action="store_true",
        help="Use all the autosomes (overrides --references)",
    )
    p.add_argument("--debug-datasets", action="store_true")
    p.add_argument("--min-allele-frequency", type=float, default=None)
    p.add_argument("--num-pc", type=int, default=2)
    p.add_argument(
        "--samples",
        type=_csv_list,
        default=None,
        help="Comma-separated callset ids restricting the cohort to "
        "exactly these samples (default: every callset of the "
        "variantsets). Ingest stays full-frame; carriers outside the "
        "cohort drop at the window boundary, so results are identical "
        "to a cohort containing only these samples. Meshless "
        "uncheckpointed runs only",
    )
    p.add_argument(
        "--exclude-samples",
        type=_csv_list,
        default=None,
        help="Comma-separated callset ids dropped from the cohort "
        "(applied after --samples)",
    )
    p.add_argument(
        "--precise",
        action="store_true",
        help="Eigendecompose on host in float64 (Breeze/LAPACK analog)",
    )
    p.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Directory for incremental Gramian snapshots (resume support)",
    )
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument(
        "--elastic-checkpoint",
        action="store_true",
        help="World-size-independent checkpointing: fixed work units over "
        "the GLOBAL manifest with self-describing lane files, so a crashed "
        "or shrunken process group resumes on ANY number of ranks and the "
        "survivors re-execute a lost rank's remaining units. Multi-rank "
        "runs need --checkpoint-dir on a shared filesystem; host-local "
        "(data-parallel) accumulation only",
    )
    p.add_argument(
        "--dense-eigh-limit",
        type=int,
        default=8192,
        help="N above which the finish uses dense eigh instead of the "
        "fused subspace iteration",
    )
    p.add_argument(
        "--pca-mode",
        choices=PCA_MODES,
        default="auto",
        help="PCA pipeline route: 'auto' (default) accumulates the "
        "Gramian from bit-packed dense blocks through the double-buffered "
        "feed and runs the fused finish (centering + subspace eig + row "
        "sums on the device) up to --dense-eigh-limit samples, dense eigh "
        "above; 'fused' forces the fused finish; 'stream' forces the "
        "dense-eigh finish; 'sparse' accumulates straight from CSR carrier "
        "windows (a hand-written CUDA scatter for rare windows, an int8 "
        "product for dense ones); 'sketch' forces the Gramian-free "
        "randomized sketch engine: the same CSR windows accumulate an "
        "(N, k+p) panel, no N x N matrix anywhere, O(N*(k+p)) memory, "
        "then a host float64 Nystrom finish, held to the reference's "
        "spectrum tolerance (see --sketch-seed); auto selects it only "
        "where the float32 G would exceed 4 GiB (N > 32768)",
    )
    p.add_argument(
        "--sketch-oversample",
        type=int,
        default=PcaConfig.sketch_oversample,
        help="Sketch-engine panel oversampling p: the streamed panel "
        "carries k+p columns (floor p >= 1, so the spectral-gap check "
        "always has a value past k). Larger p tightens the approximation "
        "at O(N*p) memory and per-window cost; p >= N-k makes the "
        "Nystrom reconstruction exact to roundoff",
    )
    p.add_argument(
        "--sketch-seed",
        type=int,
        default=PcaConfig.sketch_seed,
        help="Seed of the sketch engine's Gaussian test matrix: a fixed "
        "seed reproduces coordinates bit for bit; different seeds agree "
        "within the documented spectrum tolerance (ops/sketch.py), not "
        "bit for bit",
    )
    p.add_argument(
        "--sketch-power-iters",
        type=int,
        default=PcaConfig.sketch_power_iters,
        help="Extra full streamed passes of the sketch engine with "
        "Omega <- orth(Y) between them: 0 (default) streams the windows "
        "once; >= 2 sharpens coordinates to the top-k tolerance bars on "
        "gapped spectra. Each pass re-streams every CSR window once",
    )
    p.add_argument(
        "--sparse-density-threshold",
        type=float,
        default=PcaConfig.sparse_density_threshold,
        help="Windows with carrier density strictly below this scatter, "
        "at or above it they densify onto the int8 product; results are "
        "bit-identical either way. On a process-spanning mesh the route is "
        "a per-window GLOBAL decision synced by the carrier exchange's "
        "header — ranks whose same-step windows land on opposite sides of "
        "the threshold fail together (pin the threshold to 0 or large to "
        "force one route on heterogeneous cohorts)",
    )
    p.add_argument(
        "--pod-pipeline-depth",
        type=int,
        default=PcaConfig.pod_pipeline_depth,
        help="Pod-sparse protocol pipeline depth (process-spanning "
        "meshes, --pca-mode sparse): window slots the host-side "
        "header/confirm/carrier exchange runs ahead of the device "
        "scatter, hiding exchange latency and payload construction "
        "behind compute. 0 = inline lockstep (ablation mode); default "
        "2 (double buffering). G is bit-identical at any depth",
    )
    p.add_argument(
        "--pod-coalesce-variants",
        type=int,
        default=PcaConfig.pod_coalesce_variants,
        help="Pod-sparse gang coalescing target: consecutive "
        "scatter-route windows merge into one protocol step until "
        "their variant-row total reaches this, amortizing one "
        "exchange over many tiny windows (tail windows, small "
        "shards). 0 disables coalescing; G is bit-identical at any "
        "setting",
    )
    p.add_argument(
        "--read-group-set-id",
        default=None,
        help="Readset id filter for reads pipelines (pairhmm, "
        "reads-example): only reads of this read group set stream from "
        "the source; default = every readset in the cohort",
    )
    p.add_argument(
        "--pairhmm-batch",
        type=int,
        default=PcaConfig.pairhmm_batch,
        help="Read x haplotype pairs per batched PairHMM forward "
        "dispatch (pow2-bucketed partial tiles; must be >= 1). Per-pair "
        "log-likelihoods are bit-identical at any setting — batching "
        "changes wall-clock only",
    )
    p.add_argument(
        "--pairhmm-context",
        type=int,
        default=PcaConfig.pairhmm_context,
        help="Consensus-haplotype context bases included on each side "
        "of a read's alignment when scoring it (>= 0); the haplotype "
        "window a read is evaluated against is its span plus this "
        "margin",
    )
    p.add_argument(
        "--pairhmm-gap-open-phred",
        type=float,
        default=PcaConfig.pairhmm_gap_open_phred,
        help="Phred-scaled gap-open penalty of the PairHMM transition "
        "model (GATK default 45, i.e. P(open) ~ 3.2e-5); must be > "
        "10*log10(2) ~= 3.01 — at or below it the match "
        "self-transition 1 - 2*10^(-go/10) is non-positive and every "
        "likelihood would be NaN",
    )
    p.add_argument(
        "--pairhmm-gap-ext-phred",
        type=float,
        default=PcaConfig.pairhmm_gap_ext_phred,
        help="Phred-scaled gap-extension penalty of the PairHMM "
        "transition model (GATK default 10, i.e. P(extend) = 0.1); "
        "must be > 0",
    )
    p.add_argument(
        "--eig-tol",
        type=float,
        default=None,
        help="Fused-finish convergence target |Cv - lv|/|l| per top-k "
        "pair (default 1e-3): above it the sweep retries with doubled "
        "iterations, then warns",
    )
    p.add_argument(
        "--ingest-workers",
        type=int,
        default=0,
        help="Threads extracting shards AND building packed genotype "
        "blocks concurrently on the host (fused ingest; 0 = auto — one "
        "per core capped at 16 for extraction, min(4, cores) for the "
        "block builders; 1 = serial; < 0 rejected). Results are "
        "bit-identical at any setting; only wall-clock changes",
    )
    p.add_argument(
        "--prefetch-depth",
        type=int,
        default=PcaConfig.prefetch_depth,
        help="Blocks the double-buffered host→device feed stages ahead "
        "of the accumulating product (default 2; must be >= 1). Applies "
        "to the replicated and host-local-mesh feeds alike; the "
        "process-spanning pod stream is collective lockstep and "
        "ignores it",
    )
    p.add_argument(
        "--ingest-order",
        choices=INGEST_ORDERS,
        default=PcaConfig.ingest_order,
        help="Shard arrival order into the Gramian accumulator on the "
        "CSR-direct ingest tier: 'manifest' preserves exact manifest "
        "order; 'completion' feeds shards as their extraction completes; "
        "'auto' (default) picks completion on cold-stream runs and "
        "manifest otherwise. G is bit-identical either way "
        "(integer-exact accumulation)",
    )
    p.add_argument(
        "--speculative-ingest",
        action="store_true",
        help="Speculatively re-execute straggler shard extractions "
        "(Spark speculation analog): when the head-of-line shard runs "
        "far past the median completed duration, a duplicate attempt "
        "races it on a spare thread and the first identical result "
        "wins; a failed attempt defers to the survivor. Needs "
        "--ingest-workers > 1 (or auto)",
    )
    p.add_argument(
        "--shard-retries",
        type=int,
        default=PcaConfig.shard_retries,
        help="Total attempts per ingested shard (fused/checkpointed "
        "ingest tiers): extraction is idempotent, so a failed shard "
        "re-executes with backoff instead of killing the run — results "
        "are identical, only wall-clock changes. 1 = fail fast "
        "(historical behavior)",
    )
    p.add_argument(
        "--shard-retry-deadline",
        type=float,
        default=None,
        help="Per-shard wall-clock budget (seconds) its retry attempts "
        "draw down",
    )
    p.add_argument(
        "--rpc-retries",
        type=int,
        default=_RetryPolicy.max_attempts,
        help="Total attempts per network request: transport errors and "
        "infrastructural statuses (429/502/503/504, Retry-After honored) "
        "retry with jittered exponential backoff; served application "
        "errors never do. 1 disables retries",
    )
    p.add_argument(
        "--rpc-retry-deadline",
        type=float,
        default=None,
        help="Wall-clock budget (seconds) per network request that its "
        "attempts draw down; when it runs dry the last error surfaces "
        "even if attempts remain",
    )
    p.add_argument(
        "--breaker-threshold",
        type=int,
        default=DEFAULT_FAILURE_THRESHOLD,
        help="Per-endpoint circuit breaker: consecutive retryable "
        "failures before the circuit OPENS and requests shed instantly "
        "instead of burning their attempt budget against a down tier",
    )
    p.add_argument(
        "--breaker-cooldown",
        type=float,
        default=DEFAULT_COOLDOWN_S,
        help="Seconds an open circuit sheds before admitting a "
        "half-open probe; the probe's success closes it, failure "
        "re-opens and re-arms the cooldown",
    )
    p.add_argument(
        "--grpc-idle-timeout",
        type=float,
        default=DEFAULT_GRPC_IDLE_TIMEOUT,
        help="Per-read idle deadline (seconds) on gRPC shard streams: "
        "cancels a stream whose peer is connected but delivering "
        "nothing (the wedged-peer case keepalive cannot catch); an "
        "actively-delivering stream never trips it. 0 disables",
    )
    p.add_argument(
        "--fault-plan",
        default=None,
        help="Activate the deterministic fault-injection plane: a JSON "
        "fault plan, inline ('{\"seed\":1,\"rules\":[...]}') or a path "
        "to a file holding one",
    )
    p.add_argument(
        "--trace-dir",
        default=None,
        help="Write a torch.profiler trace of the run here (host and, on "
        "the card, CUDA activity; open the *.pt.trace.json in Perfetto "
        "or chrome://tracing)",
    )
    p.add_argument(
        "--trace-out",
        default=None,
        help="Write a Chrome-trace-event JSON span timeline here "
        "(open in Perfetto: ui.perfetto.dev; host-side stages, RPC "
        "spans, retry instant events)",
    )
    p.add_argument(
        "--metrics-out",
        default=None,
        help="Write a Prometheus text-format metrics dump here "
        "(counters/gauges/latency histograms; a .jsonl machine-readable "
        "snapshot is written alongside)",
    )
    p.add_argument(
        "--manifest-out",
        default=None,
        help="Write the machine-readable run manifest JSON here "
        "(config, devices, stage timings, counters, histogram summaries)",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default=DEFAULT_DEVICE,
        help="Device the run computes on: 'cuda' (default; fails without "
        "a card) or 'cpu'",
    )


def add_analyze_flags(p: argparse.ArgumentParser) -> None:
    """The serve-cohort analysis-tier surface (serving/): flag defaults
    derive from the serving layer's own constants — one source of
    truth, like the breaker/retry flags above."""
    from spark_examples_tpu_torch.serving.queue import (
        DEFAULT_QUEUE_DEPTH,
        DEFAULT_TENANT_QUOTA,
    )
    from spark_examples_tpu_torch.serving.tier import DEFAULT_RESULT_CACHE

    p.add_argument(
        "--analyze",
        action="store_true",
        help="Serve the multi-tenant analysis job tier: POST /analyze "
        "submits a cohort spec (dataset, references, AF filter, num_pc) "
        "and GET /jobs/<id> polls it; jobs run PCA against the served "
        "cohort on this host's card (--device) with admission control, "
        "per-tenant quotas, result caching, and crash-safe replay",
    )
    p.add_argument(
        "--analyze-workers",
        type=int,
        default=1,
        help="Analysis worker threads executing queued jobs (device "
        "phases serialize on one engine lock regardless; extra workers "
        "only overlap host-side work)",
    )
    p.add_argument(
        "--analyze-queue-depth",
        type=int,
        default=DEFAULT_QUEUE_DEPTH,
        help="Bounded analysis queue depth: submissions beyond it shed "
        "with 429 + Retry-After (derived from the retry policy's "
        "backoff over the consecutive-shed streak) instead of queuing "
        "unboundedly",
    )
    p.add_argument(
        "--analyze-tenant-quota",
        type=int,
        default=DEFAULT_TENANT_QUOTA,
        help="Per-tenant in-flight job quota (queued + running): a "
        "tenant at quota sheds with 429 + Retry-After so one greedy "
        "client cannot starve the others",
    )
    p.add_argument(
        "--analyze-journal-dir",
        default=None,
        help="Directory for the crash-safe analysis job journal (plus "
        "the persisted delta Gramians and the flight recorder): a killed "
        "server restarted with the same directory replays finished jobs "
        "into the result cache and re-queues in-flight ones "
        "deterministically; unset = in-memory only (a crash forgets "
        "every job)",
    )
    p.add_argument(
        "--analyze-cache-size",
        type=int,
        default=DEFAULT_RESULT_CACHE,
        help="Result-cache entries kept (LRU), keyed on the cohort "
        "hash + analysis flags: identical submissions are served "
        "without recomputation, across tenants",
    )
    from spark_examples_tpu_torch.serving.deltas import (
        DEFAULT_DELTA_MAX_SAMPLES,
        DEFAULT_GANG_MAX_SAMPLES,
    )

    p.add_argument(
        "--delta-max-samples",
        type=int,
        default=DEFAULT_DELTA_MAX_SAMPLES,
        help="Incremental serving: a submitted cohort whose sample set "
        "differs from a cached ancestor's by at most this many samples "
        "(same variantsets/references/AF filter) is answered by exact "
        "rank-k corrections to the cached Gramian instead of a "
        "from-scratch re-accumulation — bit-identical results, O(k*N) "
        "touch-up instead of O(N*V) ingest; a checksum guard falls "
        "back to cold on any cache doubt. 0 disables the delta tier",
    )
    from spark_examples_tpu_torch.serving.replica import (
        DEFAULT_HEARTBEAT_S,
        DEFAULT_LEASE_TTL_S,
    )

    p.add_argument(
        "--store-dir",
        default=None,
        help="Shared durable-store directory for replicated serving: "
        "N serve-cohort replicas pointed at the same directory "
        "coordinate through lease-owned jobs (per-replica journals, a "
        "fenced shared job index and delta write-through), so killing "
        "any replica mid-job lets a survivor re-run it bit-identically. "
        "Unset = single-replica local mode; an unreachable store "
        "degrades to the same, never crashes",
    )
    p.add_argument(
        "--replica-id",
        default=None,
        help="Stable identity of this replica in the shared store "
        "(its lease name and journal subdirectory); default is a "
        "generated host-pid-suffix id. Reusing a dead replica's id "
        "resumes its journal; two LIVE replicas must never share one",
    )
    p.add_argument(
        "--replica-lease-ttl",
        type=float,
        default=DEFAULT_LEASE_TTL_S,
        help="Replica lease time-to-live in seconds (> 0): how stale a "
        "peer's heartbeat must be before survivors declare it dead and "
        "adopt its in-flight jobs. Lower = faster failover, higher = "
        "more tolerance for GC/IO pauses before a live replica is "
        "zombied (its late writes are then fenced, not merged)",
    )
    p.add_argument(
        "--replica-heartbeat",
        type=float,
        default=DEFAULT_HEARTBEAT_S,
        help="Replica lease renewal interval in seconds (0 < value < "
        "ttl; ttl/5 to ttl/3 is a sane band): each renewal re-proves "
        "ownership under the fencing token and recovers the store "
        "after degraded spells",
    )
    p.add_argument(
        "--gang-max-samples",
        type=int,
        default=DEFAULT_GANG_MAX_SAMPLES,
        help="Gang batching: queued compatible jobs (same resolved "
        "variantsets/references/AF filter, cohort size at most this) "
        "coalesce into ONE batched Gramian dispatch — cohorts stacked "
        "on a leading batch axis, one host-to-device copy a window, "
        "per-job results unstacked and journaled individually "
        "(crash-safe replay semantics unchanged; results bit-identical "
        "to serial execution). 0 disables gang batching",
    )


def pca_config_from_args(args: argparse.Namespace) -> PcaConfig:
    kwargs = {
        f: getattr(args, f)
        for f in PcaConfig.__dataclass_fields__
        if hasattr(args, f)
    }
    if kwargs.get("variant_set_ids") is None:
        kwargs.pop("variant_set_ids", None)
    return PcaConfig(**kwargs)
