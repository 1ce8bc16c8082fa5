"""Job model + crash-safe journal for the analysis service.

A submission is a :class:`JobSpec` — the cohort spec a client POSTs to
``/analyze`` (dataset, references window, AF filter, k) plus tenant and
priority. Its :func:`cohort_key` is a MurmurHash3 x64-128 digest
(:mod:`spark_examples_tpu_torch.genomics.hashing` — the same hash the
variant-identity join uses) over the RESOLVED analysis parameters, and
is the unit of result caching and single-flight dedup: two submissions
that would compute the same coordinates share one key, whoever their
tenants are (arxiv 1909.00954's observation that cohorts share most of
G is what makes the cache the common case, not a luxury).

The :class:`JobJournal` is the crash-safety spine: an append-only JSONL
event log (submit/start/done/fail), flushed per append and fsynced
through the watchdog's pre-exit flush hook, written under the same
torn-write discipline ``utils/checkpoint.py`` drills — the loader
tolerates a torn tail (the bytes a SIGKILL mid-append leaves) by
skipping unparseable lines with a warning, never by dying on its own
safety net. Replaying the journal reconstructs every job
deterministically: finished jobs re-populate the result cache, and
jobs that were queued or running when the process died re-queue in
original submission order.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Job",
    "JobJournal",
    "JobSpec",
    "JOB_KINDS",
    "cohort_key",
    "JOB_QUEUED",
    "JOB_RUNNING",
    "JOB_DONE",
    "JOB_FAILED",
]

JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_DONE = "done"
JOB_FAILED = "failed"

_JOURNAL_NAME = "jobs.journal.jsonl"

# Spec fields a client may set; anything else in the POST body is a
# loud 400, not a silent ignore — a typo'd "min_allele_freq" that
# silently ran unfiltered would be a correctness bug shipped as data.
_SPEC_FIELDS = frozenset(
    {
        "kind",
        "tenant",
        "variant_set_id",
        "variant_set_ids",
        "references",
        "all_references",
        "min_allele_frequency",
        "num_pc",
        "priority",
        "samples",
        "exclude_samples",
        "read_group_set_id",
        "pca_mode",
    }
)

# Analysis job kinds the tier executes. "pca" (the default, and the
# implied kind of every pre-kind journal record) runs the variant-side
# PCoA; "pairhmm" runs the read-side batched PairHMM scoring pipeline
# (models/pairhmm.py) against the served cohort's reads.
JOB_KINDS = ("pca", "pairhmm")

# Spec fields that only parameterize the variant-side analysis: a
# pairhmm submission carrying one is a loud 400, not a silent ignore
# (the same posture as unknown fields — a client that sets num_pc on a
# read-scoring job misunderstands what it asked for).
_PCA_ONLY_FIELDS = (
    "variant_set_id",
    "variant_set_ids",
    "all_references",
    "min_allele_frequency",
    "num_pc",
    "samples",
    "exclude_samples",
    "pca_mode",
)


def _sample_list(
    rec: Dict[str, Any], field: str
) -> Optional[Tuple[str, ...]]:
    """Validate + canonicalize a cohort sample-restriction field: a
    list of callset-id strings, sorted and deduplicated so permuted
    submissions are ONE cohort (one cache key, one frame — the frame
    itself orders by full-index position, driver-side)."""
    val = rec.get(field)
    if val is None:
        return None
    if not isinstance(val, (list, tuple)) or not all(
        isinstance(s, str) and s for s in val
    ):
        raise ValueError(
            f"{field} must be a list of non-empty callset-id strings"
        )
    return tuple(sorted(set(val)))


@dataclass(frozen=True)
class JobSpec:
    """One client-submitted analysis: cohort spec + tenant + priority."""

    # None (or an empty tuple) = inherit the server's configured
    # default for that field — a client submitting {} analyzes exactly
    # the cohort the server's own batch run would.
    tenant: str = "anonymous"
    variant_set_ids: Tuple[str, ...] = ()
    references: Optional[str] = None
    all_references: Optional[bool] = None
    min_allele_frequency: Optional[float] = None
    num_pc: Optional[int] = None
    priority: int = 0
    # Cohort sample restriction: `samples` keeps only the named
    # callset ids (None = all), `exclude_samples` then drops ids —
    # the spec surface the delta tier's ±k cohort queries ride.
    samples: Optional[Tuple[str, ...]] = None
    exclude_samples: Optional[Tuple[str, ...]] = None
    # Per-job PCA engine override (None = the server's configured
    # --pca-mode). The servable surface for the Gramian-free sketch
    # engine: a huge-N cohort submits {"pca_mode": "sketch"} and rides
    # the O(N·(k+p)) panel instead of 413-ing on the tile-footprint
    # bound. Validated against utils.config.PCA_MODES.
    pca_mode: Optional[str] = None
    # Job kind: "pca" (default) or "pairhmm" (read-side scoring).
    kind: str = "pca"
    # Readset filter for pairhmm jobs (None = the server's configured
    # default readset, or every readset when that too is unset).
    read_group_set_id: Optional[str] = None

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "JobSpec":
        """Parse + validate a client JSON body (ValueError = HTTP 400)."""
        if not isinstance(rec, dict):
            raise ValueError("analysis spec must be a JSON object")
        unknown = set(rec) - _SPEC_FIELDS
        if unknown:
            raise ValueError(
                f"unknown spec field(s): {sorted(unknown)} "
                f"(expected a subset of {sorted(_SPEC_FIELDS)})"
            )
        kind = str(rec.get("kind", "pca") or "pca")
        if kind not in JOB_KINDS:
            raise ValueError(
                f"unknown job kind {kind!r} (expected one of "
                f"{list(JOB_KINDS)})"
            )
        if kind == "pairhmm":
            misapplied = [f for f in _PCA_ONLY_FIELDS if f in rec]
            if misapplied:
                raise ValueError(
                    f"spec field(s) {misapplied} do not apply to a "
                    "pairhmm job (reads are selected by references + "
                    "read_group_set_id)"
                )
        rgsid = rec.get("read_group_set_id")
        if rgsid is not None:
            if kind != "pairhmm":
                raise ValueError(
                    "read_group_set_id applies only to pairhmm jobs"
                )
            if not isinstance(rgsid, str) or not rgsid:
                raise ValueError(
                    "read_group_set_id must be a non-empty string"
                )
        vsids = rec.get("variant_set_ids")
        if vsids is None:
            one = rec.get("variant_set_id")
            vsids = [one] if one else []
        if not isinstance(vsids, (list, tuple)) or not all(
            isinstance(v, str) and v for v in vsids
        ):
            raise ValueError("variant_set_ids must be non-empty strings")
        af = rec.get("min_allele_frequency")
        if af is not None:
            af = float(af)
            if not (0.0 <= af <= 1.0):
                raise ValueError("min_allele_frequency must be in [0, 1]")
        num_pc = rec.get("num_pc")
        if num_pc is not None:
            num_pc = int(num_pc)
            if num_pc < 1:
                raise ValueError(f"num_pc must be >= 1, got {num_pc}")
        priority = int(rec.get("priority", 0))
        if not (-10 <= priority <= 10):
            # Priority is a cooperative nudge between trusted clients,
            # not a bidding war: an unbounded value would let one
            # tenant park above everyone else forever (the per-tenant
            # quota bounds volume, not position).
            raise ValueError(
                f"priority must be in [-10, 10], got {priority}"
            )
        refs = rec.get("references")
        if refs is not None and not isinstance(refs, str):
            raise ValueError("references must be a string")
        pca_mode = rec.get("pca_mode")
        if pca_mode is not None:
            from spark_examples_tpu_torch.utils.config import PCA_MODES

            if pca_mode not in PCA_MODES:
                raise ValueError(
                    f"unknown pca_mode {pca_mode!r} (expected one of "
                    f"{list(PCA_MODES)})"
                )
        all_refs = rec.get("all_references")
        return cls(
            tenant=str(rec.get("tenant", "anonymous")) or "anonymous",
            variant_set_ids=tuple(vsids),
            references=refs,
            all_references=(
                None if all_refs is None else bool(all_refs)
            ),
            min_allele_frequency=af,
            num_pc=num_pc,
            priority=priority,
            samples=_sample_list(rec, "samples"),
            exclude_samples=_sample_list(rec, "exclude_samples"),
            pca_mode=pca_mode,
            kind=kind,
            read_group_set_id=rgsid,
        )

    def to_record(self) -> Dict[str, Any]:
        if self.kind == "pairhmm":
            # Only the read-side fields: a record carrying the (inert)
            # variant-side keys would be rejected by from_record's own
            # misapplied-field validation on journal replay.
            slim: Dict[str, Any] = {
                "kind": self.kind,
                "tenant": self.tenant,
                "references": self.references,
                "priority": self.priority,
            }
            if self.read_group_set_id is not None:
                slim["read_group_set_id"] = self.read_group_set_id
            return slim
        rec: Dict[str, Any] = {
            "tenant": self.tenant,
            "variant_set_ids": list(self.variant_set_ids),
            "references": self.references,
            "all_references": self.all_references,
            "min_allele_frequency": self.min_allele_frequency,
            "num_pc": self.num_pc,
            "priority": self.priority,
        }
        # Omitted when unset: journals written before the sample-
        # restriction fields existed replay unchanged, and unrestricted
        # specs keep their historical record shape.
        if self.samples is not None:
            rec["samples"] = list(self.samples)
        if self.exclude_samples is not None:
            rec["exclude_samples"] = list(self.exclude_samples)
        # Omitted when unset, like the restriction fields: pre-sketch
        # journals replay unchanged.
        if self.pca_mode is not None:
            rec["pca_mode"] = self.pca_mode
        # No "kind" key on the default kind: pre-kind journals and
        # their replayed record shapes stay byte-for-byte what round 12
        # wrote (and their cohort keys stay identical).
        return rec


def resolve_spec(spec: JobSpec, base: Any) -> Dict[str, Any]:
    """The spec with server defaults applied — the EXACT parameter set a
    job will run with, which is therefore what the cohort key must
    cover (``base`` is the server's PcaConfig template).

    A pairhmm job resolves to the read-side parameter set: the region,
    the readset filter, and every server knob that changes a score
    (consensus context, gap penalties, and the shard size — consensus
    haplotypes are voted per shard window, so partitioning is part of
    the result's identity). PCA jobs keep their historical record shape
    exactly (no ``kind`` key), so pre-kind journals and caches resolve
    to the same keys they always did.
    """
    if spec.kind == "pairhmm":
        return {
            "kind": "pairhmm",
            "references": (
                spec.references
                if spec.references is not None
                else base.references
            ),
            "read_group_set_id": (
                spec.read_group_set_id
                if spec.read_group_set_id is not None
                else getattr(base, "read_group_set_id", None)
            ),
            "bases_per_partition": int(base.bases_per_partition),
            "pairhmm_context": int(base.pairhmm_context),
            "pairhmm_gap_open_phred": float(
                base.pairhmm_gap_open_phred
            ),
            "pairhmm_gap_ext_phred": float(base.pairhmm_gap_ext_phred),
        }
    resolved_mode = (
        spec.pca_mode
        if spec.pca_mode is not None
        else getattr(base, "pca_mode", "auto")
    )
    out = {
        "variant_set_ids": list(
            spec.variant_set_ids or base.variant_set_ids
        ),
        "references": (
            spec.references
            if spec.references is not None
            else base.references
        ),
        "all_references": (
            spec.all_references
            if spec.all_references is not None
            else bool(base.all_references)
        ),
        "min_allele_frequency": (
            spec.min_allele_frequency
            if spec.min_allele_frequency is not None
            else base.min_allele_frequency
        ),
        "num_pc": (
            spec.num_pc if spec.num_pc is not None else base.num_pc
        ),
        "samples": _resolved_samples(spec.samples, base, "samples"),
        "exclude_samples": _resolved_samples(
            spec.exclude_samples, base, "exclude_samples"
        ),
    }
    if resolved_mode == "sketch":
        # Every EXACT engine is bit-identical on the same cohort, so
        # pca_mode has never been part of the resolved identity (and
        # pre-sketch journals/caches keep their keys). The sketch
        # engine is approximate and seeded — a sketch job's result is
        # a different artifact from the exact result AND from other
        # sketch parameterizations, so all of its knobs join the key.
        out["pca_mode"] = "sketch"
        out["sketch_oversample"] = int(
            getattr(base, "sketch_oversample", 8)
        )
        out["sketch_seed"] = int(getattr(base, "sketch_seed", 0))
        out["sketch_power_iters"] = int(
            getattr(base, "sketch_power_iters", 0)
        )
    return out


def _resolved_samples(
    spec_val: Optional[Tuple[str, ...]], base: Any, field: str
) -> Optional[List[str]]:
    """Spec value wins; otherwise the server default, canonicalized the
    same way (sorted, deduplicated) so key equality is frame equality."""
    if spec_val is not None:
        return list(spec_val)
    base_val = getattr(base, field, None)
    if not base_val:
        return None
    return sorted(set(base_val))


def cohort_key(spec: JobSpec, base: Any) -> str:
    """Hex result-cache key: murmur3_x64_128 over the canonical JSON of
    the resolved analysis parameters. Tenant and priority are excluded
    ON PURPOSE — identical analyses share results across tenants (the
    whole point of the cache)."""
    from spark_examples_tpu_torch.genomics.hashing import murmur3_x64_128

    payload = json.dumps(
        resolve_spec(spec, base), sort_keys=True, separators=(",", ":")
    ).encode("utf-8")
    return murmur3_x64_128(payload).hex()


def job_config(
    spec: JobSpec, base: Any, checkpoint_dir: Optional[str] = None
) -> Any:
    """Per-job PcaConfig: the server template with the spec's analysis
    parameters applied and every emission output stripped (jobs return
    rows; they never write the operator's artifacts). The port's
    PcaConfig carries no telemetry paths (the CLI holds them), so
    ``output_path`` and ``trace_dir`` are stripped here. ``checkpoint_dir``
    is the job's snapshot directory (the tier's ``_ckpt_dir``); sketch
    and pairhmm jobs never get one."""
    import dataclasses

    resolved = resolve_spec(spec, base)
    if spec.kind == "pairhmm":
        return dataclasses.replace(
            base,
            references=resolved["references"],
            read_group_set_id=resolved["read_group_set_id"],
            checkpoint_dir=None,
            elastic_checkpoint=False,
            output_path=None,
            trace_dir=None,
        )
    pca_mode = (
        spec.pca_mode
        if spec.pca_mode is not None
        else getattr(base, "pca_mode", "auto")
    )
    if pca_mode == "sketch":
        # The sketch driver refuses checkpointed ingest (no snapshot
        # grid for a partial panel) — never hand it one.
        checkpoint_dir = None
    return dataclasses.replace(
        base,
        variant_set_ids=resolved["variant_set_ids"],
        references=resolved["references"],
        all_references=resolved["all_references"],
        min_allele_frequency=resolved["min_allele_frequency"],
        num_pc=resolved["num_pc"],
        samples=resolved["samples"],
        exclude_samples=resolved["exclude_samples"],
        pca_mode=pca_mode,
        checkpoint_dir=checkpoint_dir,
        elastic_checkpoint=False,
        output_path=None,
        trace_dir=None,
    )


@dataclass
class Job:
    """One admitted submission's lifecycle (in-memory view; the journal
    is the durable truth)."""

    id: str
    spec: JobSpec
    key: str
    seq: int
    state: str = JOB_QUEUED
    cached: bool = False
    error: Optional[str] = None
    # Row shape is per-kind: (name, pc1, pc2, dataset) for pca,
    # (name, loglik, bucket) for pairhmm.
    result: Optional[List[Tuple[Any, ...]]] = None
    submitted_unix: float = field(default_factory=time.time)
    # Minted at admission, carried through journal -> replay -> every
    # span the job's execution emits (a tracer context field). None on
    # synthetic cache-hit views (no execution, no timeline).
    trace_id: Optional[str] = None

    def to_record(self, include_result: bool = True) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "id": self.id,
            "state": self.state,
            "tenant": self.spec.tenant,
            "cached": self.cached,
            "submitted_unix": self.submitted_unix,
            "spec": self.spec.to_record(),
        }
        if self.trace_id is not None:
            rec["trace_id"] = self.trace_id
        if self.error is not None:
            rec["error"] = self.error
        if include_result and self.result is not None:
            rec["result"] = [list(row) for row in self.result]
        return rec


class JobJournal:
    """Append-only JSONL event log — the tier's crash-safe state.

    Every append is flushed to the OS immediately; the watchdog's
    pre-exit flush hook (``utils/watchdog.py``) additionally fsyncs it
    on the exit-77 fail-stop path, so a collective-timeout kill leaves
    the journal as durable as a clean shutdown. The ``serving.journal.
    append`` fault seam injects torn/error writes for the chaos suite.
    """

    def __init__(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.path = os.path.join(directory, _JOURNAL_NAME)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        # Heal a crash-torn tail BEFORE the first append: a kill mid-
        # write leaves a partial line with no newline, and appending
        # straight after it would merge the next (acknowledged!) event
        # into one unparseable line — silently destroying it on every
        # later replay. Terminating the torn bytes keeps them an
        # isolated skip-with-warning line, exactly what replay expects.
        if self._f.tell() > 0:
            with open(self.path, "rb") as probe:
                probe.seek(-1, os.SEEK_END)
                if probe.read(1) != b"\n":
                    self._f.write(b"\n")
                    self._f.flush()
        from spark_examples_tpu_torch.utils.watchdog import register_flush_hook

        self._hook_name = f"job-journal:{self.path}"
        register_flush_hook(self._hook_name, self.flush)

    def append(self, event: Dict[str, Any]) -> None:
        from spark_examples_tpu_torch.resilience import faults

        line = (
            json.dumps(event, separators=(",", ":")) + "\n"
        ).encode("utf-8")
        with self._lock:
            rule = faults.take(
                "serving.journal.append", key=str(event.get("e", ""))
            )
            if rule is not None and rule.kind == "torn":
                # A torn append: half the bytes, no newline — exactly
                # what a SIGKILL mid-write leaves. The replay loader
                # must skip it; the NEXT append would corrupt it
                # further, so a torn rule models the crash-final write.
                self._f.write(line[: max(1, len(line) // 2)])
                self._f.flush()
                return
            if rule is not None:
                raise faults.InjectedFault(
                    "serving.journal.append", rule.kind, self.path,
                    rule.message,
                )
            self._f.write(line)
            self._f.flush()

    def flush(self) -> None:
        """Flush + fsync (the watchdog pre-exit hook target).

        Bounded lock wait: this runs on the fail-stop path, where a
        writer wedged inside an append (hung NFS — exactly the kind of
        stall that fired the watchdog) may hold the lock forever. The
        exit-77 guarantee outranks the fsync: give up after 2 s rather
        than convert fail-stop into a permanent hang. (The fsync itself
        can also wedge on hung storage; the watchdog bounds the whole
        hook pass with a daemon-thread deadline for that case.)
        """
        if not self._lock.acquire(timeout=2.0):
            return
        try:
            if self._f.closed:
                return
            self._f.flush()
            os.fsync(self._f.fileno())
        finally:
            self._lock.release()

    def probe(self, timeout_s: float = 0.5) -> bool:
        """Bounded writability probe (the ``/healthz`` journal check):
        True when the journal file is open and flushable. Same bounded-
        wait discipline as :meth:`flush` — a probe that hangs on the
        wedged writer it exists to detect is worse than useless."""
        if not self._lock.acquire(timeout=max(0.0, timeout_s)):
            return False
        try:
            if self._f.closed:
                return False
            self._f.flush()
            return True
        except OSError:
            return False
        finally:
            self._lock.release()

    def close(self) -> None:
        from spark_examples_tpu_torch.utils.watchdog import unregister_flush_hook

        unregister_flush_hook(self._hook_name)
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    @staticmethod
    def replay_events(directory: str) -> Iterator[Dict[str, Any]]:
        """Parsed journal events in append order; unparseable lines (a
        torn tail) are warned about and skipped — resume must degrade
        to re-running, never die on its own safety net."""
        path = os.path.join(directory, _JOURNAL_NAME)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            for lineno, raw in enumerate(f, 1):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    doc = json.loads(raw)
                except ValueError:
                    print(
                        f"WARNING: skipping torn/corrupt journal line "
                        f"{path}:{lineno} ({len(raw)} bytes) — jobs it "
                        "described re-run from their last durable event.",
                        file=sys.stderr,
                    )
                    continue
                if isinstance(doc, dict):
                    yield doc
