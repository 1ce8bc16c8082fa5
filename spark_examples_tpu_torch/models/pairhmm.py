"""PairHMM read-scoring driver: the reads-side pipeline.

The JAX package's ``models/pairhmm.py``. Feeds the batched forward pass
(:mod:`spark_examples_tpu_torch.ops.pairhmm`, on ``conf.device``) from the
existing reads source/wire tier: shards come from the same
manifest every reads example walks, reads stream through
``source.stream_reads`` (fixture, JSONL, HTTP, or gRPC — the whole
source matrix), and per-shard host prep runs on the completion-order
ingest machinery (:func:`utils.concurrency.completion_parallel_map`) so
a slow shard never stalls the device behind it.

Pair production: each shard's covering reads vote a CONSENSUS haplotype
(pure-numpy scatter counts — the same difference-array/table idiom as
``ops/reads_ops`` but host-side, so worker threads never touch the
device), and every read scores against the consensus segment spanning
its alignment ± ``pairhmm_context`` bases. On fixture cohorts the
consensus reconstructs ``synthetic_reads``' latent haplotype (the reads
are 1%-error copies of it), so the pipeline is the hermetic analog of
scoring against assembled haplotypes.

Tiling: pairs bucket by (pow2 read length, pow2 haplotype length) via
:func:`ops.pairhmm.pairhmm_bucket` and dispatch in tiles of
``pairhmm_batch`` (partial flush tiles pad to a pow2 batch bucket), so
the tile shapes stay O(log R · log H · log B) however ragged the cohort. Every per-pair result is independent of tile composition and
arrival order (elementwise along the batch axis — pinned by test), so
completion-order feeding is free and the emitted rows are deterministic:
sorted by fragment name.

Telemetry: ``pairhmm.bucket`` spans one shard's host prep,
``pairhmm.forward`` one batched dispatch, and
``pairhmm_pairs_total{bucket=...}`` counts pairs per geometry — all in
``scripts/validate_trace.py``'s closed sets.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.device import resolve_device
from spark_examples_tpu_torch.genomics.shards import shards_for_references
from spark_examples_tpu_torch.ops.pairhmm import (
    MIN_GAP_OPEN_PHRED,
    PAIRHMM_NEG_INF,
    pairhmm_bucket,
    pairhmm_forward_batch,
)
from spark_examples_tpu_torch.ops.reads_ops import encode_bases
from spark_examples_tpu_torch.utils.concurrency import completion_parallel_map

__all__ = ["PairHmmDriver", "consensus_haplotype"]

# Quality assigned to read positions past the aligned_quality array
# (the reference skips such bases in counting pipelines; scoring needs
# a defined emission, so they contribute at maximum uncertainty).
_MISSING_QUAL = 2

# One scored pair staged for dispatch: name, read codes, quals, hap codes.
_Pair = Tuple[str, np.ndarray, np.ndarray, np.ndarray]


def consensus_haplotype(reads, window_start: int, window_len: int) -> np.ndarray:
    """Majority-vote haplotype over a window from its covering reads.

    Pure numpy (host-thread safe — shard prep workers call this
    concurrently): scatter-add per-base votes into a (window, 4) count
    table, argmax per position; positions with zero coverage hold code
    4 (N), which the forward pass treats as never-matching.
    """
    counts = np.zeros((window_len, 4), dtype=np.int64)
    for r in reads:
        codes = encode_bases(r.aligned_sequence)
        off = r.position - window_start
        lo, hi = max(0, -off), min(len(codes), window_len - off)
        if hi <= lo:
            continue
        seg = codes[lo:hi]
        pos = np.arange(off + lo, off + hi)
        keep = seg < 4
        np.add.at(counts, (pos[keep], seg[keep].astype(np.int64)), 1)
    hap = counts.argmax(axis=1).astype(np.int8)
    hap[counts.sum(axis=1) == 0] = 4
    return hap


class PairHmmDriver:
    """Scores every read of a readset against its consensus haplotype.

    ``conf`` is a :class:`~spark_examples_tpu_torch.utils.config.PcaConfig`
    (the reads fields: ``references``, ``bases_per_partition``,
    ``read_group_set_id``, the four ``pairhmm_*`` knobs, and ``device``,
    where the tiles are scored); ``source`` any reads-bearing source.
    Re-entrant like the PCA driver.
    """

    def __init__(self, conf, source) -> None:
        if conf.pairhmm_batch < 1:
            raise ValueError(
                f"pairhmm_batch must be >= 1, got {conf.pairhmm_batch}"
            )
        if conf.pairhmm_context < 0:
            raise ValueError(
                f"pairhmm_context must be >= 0, got {conf.pairhmm_context}"
            )
        if conf.pairhmm_gap_open_phred <= MIN_GAP_OPEN_PHRED:
            raise ValueError(
                "pairhmm_gap_open_phred must be > 10*log10(2) ~= "
                f"{MIN_GAP_OPEN_PHRED:.3f} (below it the match "
                "self-transition 1 - 2*10^(-go/10) is non-positive and "
                f"every likelihood is NaN), got "
                f"{conf.pairhmm_gap_open_phred}"
            )
        if conf.pairhmm_gap_ext_phred <= 0:
            raise ValueError(
                "pairhmm_gap_ext_phred must be > 0, got "
                f"{conf.pairhmm_gap_ext_phred}"
            )
        self.conf = conf
        self.source = source
        self.device = resolve_device(conf.device)
        self.read_group_set_id = conf.read_group_set_id or ""
        self._batch = int(conf.pairhmm_batch)
        self._context = int(conf.pairhmm_context)

    # -- host prep ------------------------------------------------------------

    def _shard_pairs(self, shard) -> List[_Pair]:
        """One shard's read×haplotype pairs (runs on a prep worker)."""
        # The span opens BEFORE streaming: against a remote reads
        # source the wire time dominates host prep, and it must land
        # inside the span the schema attributes prep to.
        with obs.span(
            "pairhmm.bucket", shard=f"{shard.contig}:{shard.start}"
        ):
            reads = list(
                self.source.stream_reads(self.read_group_set_id, shard)
            )
            if not reads:
                return []
            # Window covers the shard plus any read overhang (reads are
            # sharded by start position; their bases may extend past the
            # end) plus the scoring context on both sides.
            overhang = max(len(r.aligned_sequence) for r in reads)
            window_start = shard.start - self._context
            window_len = shard.range + overhang + 2 * self._context
            hap = consensus_haplotype(reads, window_start, window_len)
            pairs: List[_Pair] = []
            for r in reads:
                codes = encode_bases(r.aligned_sequence)
                quals = np.asarray(r.aligned_quality, dtype=np.int32)
                if quals.size < codes.size:
                    quals = np.concatenate(
                        [
                            quals,
                            np.full(
                                codes.size - quals.size,
                                _MISSING_QUAL,
                                np.int32,
                            ),
                        ]
                    )
                lo = r.position - window_start - self._context
                hi = (
                    r.position
                    - window_start
                    + len(codes)
                    + self._context
                )
                seg = hap[max(0, lo) : min(window_len, hi)]
                if codes.size == 0 or seg.size == 0:
                    continue
                pairs.append(
                    (
                        r.fragment_name or r.id,
                        codes,
                        quals[: codes.size],
                        seg,
                    )
                )
            return pairs

    # -- device dispatch ------------------------------------------------------

    def _score_tile(
        self, r_bucket: int, h_bucket: int, tile: List[_Pair]
    ) -> List[Tuple[str, float, str]]:
        """One batched forward dispatch → (name, loglik, bucket) rows."""
        bucket = f"r{r_bucket}xh{h_bucket}"
        # Flush tiles pad to a pow2 bucket capped at the batch size, so
        # the distinct dispatch shapes per (r, h) bucket stay O(log B)
        # even under a non-pow2 --pairhmm-batch (full tiles are always
        # exactly the batch size).
        b_pad = min(pairhmm_bucket(len(tile), floor=1), self._batch)
        read_codes = np.zeros((b_pad, r_bucket), np.int8)
        read_quals = np.zeros((b_pad, r_bucket), np.int32)
        hap_codes = np.full((b_pad, h_bucket), 4, np.int8)
        read_lens = np.zeros(b_pad, np.int32)
        hap_lens = np.zeros(b_pad, np.int32)
        for k, (_, codes, quals, seg) in enumerate(tile):
            read_codes[k, : codes.size] = codes
            read_quals[k, : quals.size] = quals
            hap_codes[k, : seg.size] = seg
            read_lens[k] = codes.size
            hap_lens[k] = seg.size
        with obs.span("pairhmm.forward", bucket=bucket, pairs=len(tile)):
            # One copy back per tile, inside the span: it covers the
            # tile's device work.
            out = pairhmm_forward_batch(
                read_codes,
                read_quals,
                read_lens,
                hap_codes,
                hap_lens,
                np.float32(self.conf.pairhmm_gap_open_phred),
                np.float32(self.conf.pairhmm_gap_ext_phred),
                device=self.device,
            ).cpu().numpy()
        if obs.collection_active():
            obs.get_registry().counter(
                "pairhmm_pairs_total",
                "Read x haplotype pairs scored by the PairHMM forward "
                "kernel, per (read, haplotype) length bucket",
            ).labels(bucket=bucket).inc(len(tile))
        return [
            (tile[k][0], float(out[k]), bucket) for k in range(len(tile))
        ]

    # -- run loop -------------------------------------------------------------

    def _prep_workers(self) -> int:
        if self.conf.ingest_workers == 1:
            return 1
        if self.conf.ingest_workers > 1:
            return self.conf.ingest_workers
        return min(4, os.cpu_count() or 1)

    def run_rows(self) -> List[Tuple[str, float, str]]:
        """Score the whole readset → ``(name, loglik, bucket)`` rows,
        sorted by read name (deterministic under any worker count or
        arrival order — per-pair results are tile-independent)."""
        shards = shards_for_references(
            self.conf.references, self.conf.bases_per_partition
        )
        staged: Dict[Tuple[int, int], List[_Pair]] = {}
        rows: List[Tuple[str, float, str]] = []
        # Shard prep (read streaming + consensus + pair building) rides
        # the completion-order pipeline; the device tile dispatches stay
        # on this thread, like every other driver's accumulation loop.
        for pairs in completion_parallel_map(
            self._shard_pairs, shards, self._prep_workers()
        ):
            for pair in pairs:
                key = (
                    pairhmm_bucket(pair[1].size),
                    pairhmm_bucket(pair[3].size),
                )
                tile = staged.setdefault(key, [])
                tile.append(pair)
                if len(tile) >= self._batch:
                    rows.extend(self._score_tile(*key, tile))
                    staged[key] = []
        for key, tile in sorted(staged.items()):
            if tile:
                rows.extend(self._score_tile(*key, tile))
        # Whole-row sort, not name-only: paired-end mates share a
        # fragment name, and a name-keyed sort would tie-break them by
        # completion order — nondeterministic across worker schedules,
        # which would break the serving replay/bit-identity contract.
        rows.sort()
        return rows

    def run(self, out_path: Optional[str] = None) -> List[Tuple[str, float, str]]:
        """CLI entry: score, report, optionally dump ``(name,loglik)``
        lines (ascending by name, the reads-example output idiom)."""
        rows = self.run_rows()
        scored = [row for row in rows if row[1] > PAIRHMM_NEG_INF / 2]
        if not scored:
            print(
                "WARNING: no read x haplotype pairs scored — check that "
                "the cohort covers --references and the readset id "
                "(--read-group-set-id)",
                file=sys.stderr,
            )
        else:
            mean = sum(row[1] for row in scored) / len(scored)
            print(
                f"Scored {len(scored)} read x haplotype pair(s); "
                f"mean log-likelihood {mean:.4f}"
            )
        if out_path:
            out_dir = os.path.join(out_path, "pairhmm_scores")
            os.makedirs(out_dir, exist_ok=True)
            out_file = os.path.join(out_dir, "part-00000")
            with open(out_file, "w") as f:
                for name, loglik, _bucket in rows:
                    f.write(f"({name},{loglik!r})\n")
            print(f"Wrote {out_file}")
        return rows
