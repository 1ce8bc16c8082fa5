"""Elastic checkpointing: world-size-independent work units and lanes.

The port of the JAX package's ``utils/elastic.py``. A lane file is the
JAX package's, key for key and dtype for dtype (``g`` float32,
``g_shape``, ``units`` int64, ``run_digest`` bytes, ``lane-<hex>.npz``),
so either package resumes the other's lanes. The port stores its members
(``np.savez``) where the JAX package deflates them, as its snapshots do
(:mod:`~spark_examples_tpu_torch.utils.checkpoint`): ``np.load`` reads
either file.

The Spark-task-re-execution analog. Spark reschedules a lost executor's
tasks onto survivors for free; the reference leans on that entirely and
itself only *counts* failures (``VariantsRDD.scala:163-165``, SURVEY.md
§2.10 elasticity row). The non-elastic checkpoint modes here key their
snapshots to the process grid (``host=p/P`` digests over per-host manifest
slices), so recovery demands a relaunch with the SAME world size — a dead
host freezes its share of the work. Elastic mode removes the coupling:

- The **global** manifest is cut into fixed work units of
  ``checkpoint_every`` shards — the analog of a Spark task. Unit
  boundaries depend only on the manifest and the round width, never on
  how many processes exist.
- Each process accumulates its units into a **lane**: one ``.npz``
  holding a partial Gramian plus the exact unit-id set it covers. A lane
  is self-describing — any reader knows precisely what work it holds.
- Resume (at ANY world size): list the shared checkpoint dir, drop lanes
  whose unit set is contained in another lane's (the merge protocol's
  only crash residue — see below), deterministically claim surviving
  lanes round-robin, and re-slice the units no lane covers over the
  CURRENT processes. A dead host's unfinished share is thereby
  re-executed by survivors: Spark's elasticity without a cluster manager.

Crash-safety protocol: a process merges its claimed lanes plus each newly
finished unit into a NEW lane file (atomic tmp+rename), and only then
deletes the lanes the new file supersedes. A crash at any instant leaves
either the old lanes intact, or the merged lane alongside stale subset
lanes — never a torn file, never a unit counted twice after the
subset-discard pass. Lanes never partially overlap under this protocol;
if one ever does (external corruption), it is discarded loudly.

Multi-host elastic mode requires the checkpoint dir to be on a filesystem
all hosts share (the driver verifies the view cross-host before work
begins). This mirrors Spark, whose recovery also runs through shared
state (the driver's lineage + a shared shuffle/storage layer).
"""

from __future__ import annotations

import os
import sys
import tempfile
import uuid
from dataclasses import dataclass
from typing import FrozenSet, List, Optional, Sequence, Tuple
from zipfile import BadZipFile

import numpy as np

__all__ = [
    "Lane",
    "lane_view_fingerprint",
    "load_lanes",
    "merge_and_supersede",
    "prune_stale_lanes",
    "save_lane",
    "unit_ranges",
    "unit_ranges_contig_aligned",
]

_LANE_PREFIX = "lane-"
_LANE_SUFFIX = ".npz"


@dataclass(frozen=True)
class Lane:
    """One lane's metadata. The Gramian payload is NOT held here: at the
    stress scale (100k samples) one lane's float32 G is ~40 GB, and every
    host lists ALL lanes but needs the payload of only its claimed ones —
    so listing loads unit sets and payloads load on demand."""

    path: str
    units: FrozenSet[int]

    def load_g(self) -> np.ndarray:
        with np.load(self.path) as z:
            return z["g"]


def unit_ranges(n_shards: int, every: int) -> List[Tuple[int, int]]:
    """Global manifest → work-unit shard ranges ``[start, stop)``.

    Pure function of (manifest length, round width): the same units exist
    no matter how many processes compute them — the property that makes
    resume world-size independent.
    """
    every = max(1, every)
    return [
        (lo, min(lo + every, n_shards)) for lo in range(0, n_shards, every)
    ]


def unit_ranges_contig_aligned(shards, every: int) -> List[Tuple[int, int]]:
    """Work units that never split a contig's manifest run.

    Multi-dataset identity joins keep per-contig state (the variant
    identity hashes contig+position+alleles, so matches can only occur
    within one contig): cutting work units at contig boundaries makes an
    incrementally-checkpointed join EXACT — each unit's joined rows equal
    the same contigs' rows in an uninterrupted run. Consecutive whole
    runs pack into units of at most ``every`` shards; a single contig
    longer than ``every`` becomes one oversized unit (it cannot be split
    without breaking join-state locality).

    Precondition (caller-verified): each contig appears as ONE contiguous
    run in the manifest.
    """
    every = max(1, every)
    runs: List[Tuple[int, int]] = []
    lo = 0
    for i in range(1, len(shards) + 1):
        if i == len(shards) or shards[i].contig != shards[lo].contig:
            runs.append((lo, i))
            lo = i
    units: List[Tuple[int, int]] = []
    cur: Optional[List[int]] = None
    for lo, hi in runs:
        if cur is None:
            cur = [lo, hi]
        elif hi - cur[0] <= every:
            cur[1] = hi
        else:
            units.append((cur[0], cur[1]))
            cur = [lo, hi]
    if cur is not None:
        units.append((cur[0], cur[1]))
    return units


def save_lane(
    directory: str,
    g,
    units: Sequence[int],
    run_digest: str,
) -> str:
    """Write one lane atomically (tmp + rename); returns its path. ``g``
    is a host array, a tensor (copied off its device) or a tile grid
    (gathered)."""
    from spark_examples_tpu_torch.utils.checkpoint import (
        _apply_write_fault,
        _host_array,
    )

    os.makedirs(directory, exist_ok=True)
    g = _host_array(g)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:
        # g_shape is stored separately so readers can validate a lane
        # without reading the (N, N) payload member.
        np.savez(
            f,
            g=g,
            g_shape=np.asarray(g.shape, np.int64),
            units=np.asarray(sorted(units), np.int64),
            run_digest=np.bytes_(run_digest.encode()),
        )
    path = os.path.join(
        directory, f"{_LANE_PREFIX}{uuid.uuid4().hex}{_LANE_SUFFIX}"
    )
    os.replace(tmp, path)
    # Chaos seam: a "torn" rule truncates the committed lane (the
    # non-atomic-filesystem failure load_lanes discards with a warning
    # and whose units resume re-executes) — see utils/checkpoint.py.
    _apply_write_fault("checkpoint.lane_write", path)
    return path


def _read_lane(path: str, run_digest: str, n: int) -> Optional[Lane]:
    try:
        # npz members load individually — digest/units/shape checks
        # never pull the (N, N) payload into memory. Lanes written before
        # g_shape existed lack the member; fall back to reading the
        # payload once rather than discarding a prior run's progress.
        with np.load(path) as z:
            if bytes(z["run_digest"]).decode() != run_digest:
                return None
            shape = (
                tuple(z["g_shape"]) if "g_shape" in z else z["g"].shape
            )
            if shape != (n, n):
                return None
            return Lane(
                path=path,
                units=frozenset(int(u) for u in z["units"]),
            )
    except (OSError, KeyError, ValueError, BadZipFile):
        # A torn write cannot exist (atomic rename), but an unreadable
        # file from any other source must not kill resume — its work is
        # simply re-executed.
        print(
            f"WARNING: unreadable elastic lane {path}; ignoring.",
            file=sys.stderr,
        )
        from spark_examples_tpu_torch import obs

        obs.instant("elastic_unreadable_lane", scope="p", path=path)
        return None


def load_lanes(directory: str, run_digest: str, n: int) -> List[Lane]:
    """All usable lanes, deterministically de-overlapped.

    Candidates sort by descending unit-count then name, so a merged
    superset lane always wins over the stale subsets it replaced; a lane
    overlapping the kept set in any *partial* way cannot arise from the
    merge protocol and is discarded with a warning. The result is a list
    of pairwise-disjoint lanes, identical on every host that sees the
    same directory.
    """
    if not os.path.isdir(directory):
        return []
    candidates = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith(_LANE_PREFIX) and name.endswith(_LANE_SUFFIX)):
            continue
        lane = _read_lane(os.path.join(directory, name), run_digest, n)
        if lane is not None:
            candidates.append(lane)
    candidates.sort(key=lambda l: (-len(l.units), os.path.basename(l.path)))
    kept: List[Lane] = []
    covered: set = set()
    for lane in candidates:
        if lane.units.isdisjoint(covered):
            kept.append(lane)
            covered |= lane.units
        elif lane.units <= covered:
            continue  # stale subset left by a crash inside a merge
        else:
            print(
                f"WARNING: elastic lane {lane.path} partially overlaps "
                "other lanes (corruption?); discarding it — its units "
                "will be re-executed.",
                file=sys.stderr,
            )
            from spark_examples_tpu_torch import obs

            obs.instant(
                "elastic_lane_discarded",
                scope="p",
                path=lane.path,
                reason="partial_overlap",
                units_reexecuted=len(lane.units),
            )
    return kept


def merge_and_supersede(
    directory: str,
    g,
    units: Sequence[int],
    run_digest: str,
    supersedes: Sequence[str],
) -> str:
    """Atomically publish a merged lane, then delete the lanes it replaces.

    Write-new-then-delete-old ordering is the crash-safety invariant: the
    merged lane's unit set is a superset of every superseded lane's, so a
    crash between the two steps leaves only subset lanes for
    :func:`load_lanes` to discard.
    """
    path = save_lane(directory, g, units, run_digest)
    from spark_examples_tpu_torch.resilience import faults

    if faults.take("checkpoint.lane_supersede", key=path) is not None:
        # Injected crash in the window between write-new and delete-old:
        # the stale subset lanes stay behind, exactly the residue the
        # load_lanes subset-discard pass exists to clean up.
        return path
    for old in supersedes:
        if os.path.abspath(old) == os.path.abspath(path):
            continue
        try:
            os.remove(old)
        except OSError:
            pass  # already gone — deletion is best-effort cleanup
    return path


def prune_stale_lanes(
    directory: str,
    run_digest: str,
    kept: Sequence[Lane],
    tmp_ttl_seconds: float = 3600.0,
) -> int:
    """Delete lane files that are provably worthless for this run.

    Every parameter change (AF filter, round width, manifest) mints a new
    digest and orphans the previous run's lanes — one (N, N)
    Gramian each, so an un-pruned checkpoint dir grows without bound.
    Removed: lanes that read cleanly but carry a different digest, lanes
    whose unit set the kept lanes already cover (merge-crash residue),
    and ``.npz.tmp`` orphans from a save that was killed mid-write —
    age-gated by ``tmp_ttl_seconds`` so a peer's save actively in flight
    on the shared dir is never yanked out from under it. Unreadable
    ``lane-*.npz`` files are deliberately LEFT in place — they are
    evidence of corruption, and deleting them would hide it. Returns the
    number of files removed.
    """
    import time

    kept_paths = {os.path.abspath(lane.path) for lane in kept}
    covered: set = set()
    for lane in kept:
        covered |= lane.units
    removed = 0
    if not os.path.isdir(directory):
        return 0
    now = time.time()
    for name in sorted(os.listdir(directory)):
        if name.endswith(".npz.tmp"):
            path = os.path.join(directory, name)
            try:
                if now - os.path.getmtime(path) > tmp_ttl_seconds:
                    os.remove(path)
                    removed += 1
            except OSError:
                pass
            continue
        if not (name.startswith(_LANE_PREFIX) and name.endswith(_LANE_SUFFIX)):
            continue
        path = os.path.join(directory, name)
        if os.path.abspath(path) in kept_paths:
            continue
        try:
            with np.load(path) as z:
                digest = bytes(z["run_digest"]).decode()
                units = frozenset(int(u) for u in z["units"])
        except (OSError, KeyError, ValueError, BadZipFile):
            continue  # unreadable: keep as corruption evidence
        if digest != run_digest or units <= covered:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed


def lane_view_fingerprint(lanes: Sequence[Lane]) -> str:
    """Order-independent digest of (lane name, unit set) pairs.

    Multi-host elastic resume requires every process to see the SAME
    lanes (shared checkpoint dir); the driver allgathers this fingerprint
    and refuses to proceed on divergence, turning a mis-mounted
    checkpoint dir into a loud error instead of a wrong Gramian.
    """
    import hashlib

    h = hashlib.sha256()
    for lane in sorted(lanes, key=lambda l: os.path.basename(l.path)):
        h.update(os.path.basename(lane.path).encode())
        h.update(b":")
        h.update(",".join(map(str, sorted(lane.units))).encode())
        h.update(b";")
    return h.hexdigest()
