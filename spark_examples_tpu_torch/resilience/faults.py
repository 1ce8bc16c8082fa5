"""Deterministic, seedable fault-injection plane.

The JAX package's ``resilience/faults.py``, with the injection points the
port has so far:

- a :class:`FaultPlan` is a SEEDED list of declarative
  :class:`FaultRule`\\ s, activated per process by the CLI's
  ``--fault-plan`` or per scope (:func:`active_plan`). The port reads no
  environment variable for it: a plan set in the environment for a JAX
  package run never injects faults into a port run;
- production code carries *injection points* — :func:`inject` calls,
  :func:`inject_write` at tmp-then-rename commits and :func:`wrap_lines`
  stream wrappers — that are a single ``None``-check
  when no plan is installed;
- every injected fault is recorded on the plan (test introspection),
  the obs timeline (``fault_injected`` instants), and the metrics
  registry (``resilience_faults_injected_total{site,kind}``), so a
  chaos run's artifacts SHOW what was injected.

Determinism: rule matching is by site/key and a per-rule eligible-hit
counter; probabilistic rules draw from ``hash((seed, rule, hit))`` so
the SAME plan over the same request sequence injects the same faults.

Sites wired in the port (glob-matched, so ``transport.*`` works):

===========================  ===============================================
``transport.http.request``   before each HTTP attempt (error/stall)
``transport.http.stream``    HTTP record-stream body (error/stall/truncate/
                             corrupt — detected by the framing layer)
``transport.http.frames``    HTTP binary-frame body (the same four kinds —
                             detected by the frame CRC and end frame)
``transport.grpc.request``   before each gRPC unary/stream attempt
``transport.grpc.stream``    gRPC stream body (error/stall/truncate/corrupt;
                             truncate raises: gRPC has no end sentinel)
``transport.oauth.request``  before each token-exchange attempt
``ingest.shard``             driver-side shard extraction (error = worker
                             death mid-stream, stall = slow lane), keyed
                             by the shard string
``ingest.build``             packed-block build of the CSR tier (error = a
                             builder dying mid-block), keyed by the
                             window's index
``ingest.stream``            fused-CSR streaming ingest, per shard inside
                             the retry loop (error/stall/truncate = a
                             fetch-decode-build-put pipeline fault
                             mid-stream; retried per --shard-retries)
``fixture.stream``           FixtureSource per-shard streams (its own
                             per-source plan: the ``fail_shards`` hook)
``mirror.write``             cohort-mirror file commit (torn = kill -9
                             mid-write: the tmp truncates to half and
                             never renames; error/stall as usual)
``store.read``               durable-store object reads (error/stall)
``store.write``              durable-store object puts (torn = kill -9
                             mid-write: the framed blob truncates under its
                             ``.tmp-`` name and never renames)
``store.lease``              lease CAS operations, keyed ``<op>:<name>``
                             (error/stall; ``corrupt`` = a STALE FENCING
                             TOKEN: the op raises ``FencedWriteError``)
``store.lease.write``        lease-doc file commit (torn = kill -9 between
                             fsync and rename: reads back as "no lease"
                             with the token floor intact)
``serving.job.run``          analysis job execution (error/stall)
``serving.job.kill``         a simulated process death between the
                             journaled start and execution
``serving.journal.append``   job-journal appends (torn/error)
``serving.delta.write``      delta-cache persist-dir commit (torn = the
                             ``.tmp-`` partial the next load sweeps)
``flightrec.write``          flight-recorder dump commit (torn = kill
                             mid-dump; the previous dump survives)
``checkpoint.snapshot_write`` Gramian snapshot commit, keyed by its path
                             (torn = the committed file truncated to half,
                             a filesystem without atomic rename: the
                             loader discards it with a warning)
===========================  ===============================================
"""

from __future__ import annotations

import contextlib
import fnmatch
import json
import os
import random
import threading
import time
from dataclasses import asdict, dataclass
from typing import Iterator, List, Optional, Sequence

__all__ = [
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "active_plan",
    "clear_plan",
    "current_plan",
    "inject",
    "inject_write",
    "install_plan",
    "take",
    "wrap_lines",
]

KINDS = ("error", "stall", "truncate", "corrupt", "torn")


class InjectedFault(IOError):
    """A fault the plan injected (an IOError: transports and the shard
    retry layer already classify it as IO weather)."""

    def __init__(self, site: str, kind: str, key: str = "", message: str = ""):
        text = message or f"injected {kind} fault at {site}"
        if key:
            text += f" (key={key})"
        super().__init__(text)
        self.site = site
        self.kind = kind
        self.key = key


@dataclass
class FaultRule:
    """One declarative fault.

    ``site`` glob-matches the injection point; ``match`` (substring of
    the site key, e.g. a shard string) narrows it. ``times`` caps how
    often the rule fires (None = unbounded), ``after`` skips the first
    N eligible hits, ``probability`` gates each remaining hit through a
    seeded draw. Stream-shaped kinds (truncate/corrupt, applied by
    :func:`wrap_lines`) act at line index ``at_line``.
    """

    site: str
    kind: str = "error"
    probability: float = 1.0
    times: Optional[int] = 1
    after: int = 0
    match: str = ""
    stall_s: float = 0.05
    at_line: int = 0
    message: str = ""

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {KINDS}"
            )
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")


@dataclass
class _Fired:
    """One injected fault, kept on the plan for introspection."""

    site: str
    kind: str
    key: str = ""


class FaultPlan:
    """A seeded set of rules plus their runtime counters (thread-safe)."""

    MAX_LOG = 10_000  # bound the introspection log on long soaks

    def __init__(self, seed: int = 0, rules: Sequence[FaultRule] = ()):
        self.seed = int(seed)
        self._rules: List[FaultRule] = list(rules)
        self._lock = threading.Lock()
        self._hits: List[int] = [0] * len(self._rules)
        self._count: List[int] = [0] * len(self._rules)
        self.injected: List[_Fired] = []

    # -- construction ---------------------------------------------------------

    def add_rule(self, rule: FaultRule) -> None:
        with self._lock:
            self._rules.append(rule)
            self._hits.append(0)
            self._count.append(0)

    @classmethod
    def from_dict(cls, spec: dict) -> "FaultPlan":
        rules = [FaultRule(**r) for r in spec.get("rules", ())]
        return cls(seed=int(spec.get("seed", 0)), rules=rules)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """CLI value → plan: a JSON object inline, or a path to a
        JSON file holding one."""
        text = spec.strip()
        if not text.startswith("{"):
            with open(text) as f:
                text = f.read()
        try:
            doc = json.loads(text)
        except ValueError as e:
            raise ValueError(f"unparseable fault plan {spec!r}: {e}") from e
        if not isinstance(doc, dict):
            raise ValueError("fault plan must be a JSON object")
        return cls.from_dict(doc)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [asdict(r) for r in self._rules],
            }

    # -- runtime --------------------------------------------------------------

    @property
    def fired_total(self) -> int:
        with self._lock:
            return sum(self._count)

    def fired_by_site(self) -> dict:
        with self._lock:
            out: dict = {}
            for f in self.injected:
                out[f.site] = out.get(f.site, 0) + 1
            return out

    def inject(self, site: str, key: str = "") -> None:
        """Per-instance injection point (the ambient plan untouched):
        same action semantics as the module-level :func:`inject`."""
        inject(site, key, plan=self)

    def decide(self, site: str, key: str = "") -> Optional[FaultRule]:
        """First matching rule that fires for this hit, with counters
        advanced and the injection recorded; None = no fault here."""
        with self._lock:
            for i, rule in enumerate(self._rules):
                if not fnmatch.fnmatchcase(site, rule.site):
                    continue
                if rule.match and rule.match not in key:
                    continue
                hit = self._hits[i]
                self._hits[i] += 1
                if hit < rule.after:
                    continue
                if rule.times is not None and self._count[i] >= rule.times:
                    continue
                if rule.probability < 1.0:
                    # Deterministic per-(seed, rule, hit) draw: tuple-of-
                    # int hashing is stable across processes.
                    draw = random.Random(
                        hash((self.seed, i, hit))
                    ).random()
                    if draw >= rule.probability:
                        continue
                self._count[i] += 1
                if len(self.injected) < self.MAX_LOG:
                    self.injected.append(_Fired(site, rule.kind, key))
                return rule
        return None


# -- ambient plan -------------------------------------------------------------

_active: Optional[FaultPlan] = None
_active_lock = threading.Lock()


def install_plan(plan: Optional[FaultPlan]) -> None:
    global _active
    with _active_lock:
        _active = plan


def clear_plan() -> None:
    install_plan(None)


def current_plan() -> Optional[FaultPlan]:
    return _active


@contextlib.contextmanager
def active_plan(plan: Optional[FaultPlan]) -> Iterator[Optional[FaultPlan]]:
    """Scope a plan: install on entry, restore the previous on exit."""
    global _active
    with _active_lock:
        previous = _active
        _active = plan
    try:
        yield plan
    finally:
        with _active_lock:
            _active = previous


# -- injection points ---------------------------------------------------------


def _record(site: str, kind: str, key: str) -> None:
    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.obs.tracer import collection_active

    obs.instant("fault_injected", scope="p", site=site, kind=kind, key=key)
    if collection_active():
        obs.get_registry().counter(
            "resilience_faults_injected_total",
            "Faults injected by the active fault plan",
        ).labels(site=site, kind=kind).inc()


def take(
    site: str, key: str = "", plan: Optional[FaultPlan] = None
) -> Optional[FaultRule]:
    """Decide-and-record without acting — for sites whose kinds need
    local handling (torn writes). Returns the fired rule or None."""
    plan = plan if plan is not None else _active
    if plan is None:
        return None
    rule = plan.decide(site, key)
    if rule is not None:
        _record(site, rule.kind, key)
    return rule


def inject(site: str, key: str = "", plan: Optional[FaultPlan] = None) -> None:
    """The standard injection point: no-op without a plan; a fired
    ``stall`` sleeps, anything else raises :class:`InjectedFault`."""
    rule = take(site, key, plan)
    if rule is None:
        return
    if rule.kind == "stall":
        time.sleep(rule.stall_s)
        return
    raise InjectedFault(site, rule.kind, key, rule.message)


def inject_write(
    site: str, path: str, plan: Optional[FaultPlan] = None
) -> None:
    """Write-seam injection point for tmp-then-atomic-rename protocols
    (the mirror's ``mirror.write``): ``torn`` truncates the half-written
    tmp file to half its bytes AND raises — the kill -9-mid-write shape,
    where the commit rename must never run and the partial can only
    ever exist under a ``*.tmp-*`` name; ``stall`` sleeps; anything
    else raises. No-op without a plan."""
    rule = take(site, key=os.path.basename(path), plan=plan)
    if rule is None:
        return
    if rule.kind == "torn":
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
        except OSError:
            pass
        raise InjectedFault(
            site, "torn", os.path.basename(path), rule.message
        )
    if rule.kind == "stall":
        time.sleep(rule.stall_s)
        return
    raise InjectedFault(site, rule.kind, os.path.basename(path), rule.message)


def wrap_lines(
    site: str,
    lines: Iterator[bytes],
    key: str = "",
    plan: Optional[FaultPlan] = None,
    truncate_silently: bool = True,
) -> Iterator[bytes]:
    """Apply stream-shaped faults to an iterator of wire lines.

    The decision is taken once, at stream start; the fault acts at the
    rule's ``at_line``: ``truncate`` ends the stream early (the framing
    layer sees no end frame), ``corrupt`` garbles that line (unframed /
    unparseable downstream), ``error`` raises mid-stream, ``stall``
    sleeps once and continues. Streams shorter than ``at_line`` escape
    the fault — keep ``at_line`` small.

    ``truncate_silently`` must reflect what the wrapped transport can
    DETECT: the HTTP tier's end-frame protocol turns a silent early end
    into a loud missing-frame error, so silence is the faithful
    injection there — but a transport with no end sentinel (gRPC, whose
    own framing turns real truncation into a status) must receive the
    fault as a raised error, or the injection would silently drop
    records and corrupt results, which no REAL failure of that
    transport can do.
    """
    plan = plan if plan is not None else _active
    rule = None
    if plan is not None:
        rule = plan.decide(site, key)
        if rule is not None:
            _record(site, rule.kind, key)
    if rule is None:
        yield from lines
        return
    n = 0
    for line in lines:
        if n == rule.at_line:
            if rule.kind == "truncate":
                if truncate_silently:
                    return
                raise InjectedFault(site, "truncate", key, rule.message)
            if rule.kind == "error":
                raise InjectedFault(site, "error", key, rule.message)
            if rule.kind == "stall":
                time.sleep(rule.stall_s)
            elif rule.kind == "corrupt":
                yield b"\x00\xffcorrupt\xff\x00" + line[:8]
                n += 1
                continue
        yield line
        n += 1
