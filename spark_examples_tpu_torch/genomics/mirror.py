"""Transport-agnostic remote-cohort mirror cache.

The JAX package's ``genomics/mirror.py``. A remote cohort is downloaded
once, keyed by the server's ``/identity`` content digest (the ETag
analog), and every later call is served from a local
:class:`~spark_examples_tpu_torch.genomics.sources.JsonlSource` over the
mirror, which brings the CSR-sidecar warm tier to remote cohorts.

The whole protocol — atomic per-file downloads, light mirrors (callsets +
binary CSR sidecar only), in-place light→full upgrades, the TOCTOU
identity re-verification window, the populate-race rename rule, and
stale-sibling pruning — sits behind one small transport seam
(:class:`MirrorFeed`), so HTTP and gRPC share ONE mirror implementation
and can share one cache directory (the identity digest, not the
transport, keys the mirror). The marker files, directory names and lock
owner tokens are the JAX package's byte for byte, so either package
serves the other's cache warm.

The mirror is not a prerequisite phase of a cold run:
:func:`resolve_mirror` with ``cold_stream=True`` returns a falsy
:class:`ColdStreamMirror` sentinel on a cold cohort — the caller streams
straight from the wire while the mirror downloads WRITE-THROUGH on a
background thread — and every mirror file is committed ``tmp → fsync →
atomic rename``, into a staging directory whose name is DETERMINISTIC
per (identity, mode), so a run killed mid-download (kill -9 included)
leaves only whole, fsynced files that the next cold run REUSES instead of
re-downloading.

Invariants:

- a mirror directory is trusted only when the ``.complete`` marker
  exists; crashes leave staging dirs that can never be mistaken for
  one, and ``*.tmp-*`` partials that can never be mistaken for a
  committed file (they are swept on staging reuse);
- downloads re-verify the identity BEFORE committing: a server cohort
  swap mid-download must discard the download — staging included, since
  its files are an unknown mix — never mix old and new files;
- a light mirror without the sidecar is a husk that can serve nothing
  — it fails the mirror rather than renaming into place;
- losing a populate race is success (identical content by identity);
  an existing complete root is never touched;
- sibling ``cohort-*`` dirs (and orphaned staging dirs) are pruned only
  after a successful download, so cache_dir does not grow without
  bound.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading
from typing import Iterator, Optional

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics.sources import (
    MIRROR_COMPLETE_MARKER,
    MIRROR_IDENTITY_FILE,
    MIRROR_SIDECAR_OK,
    SIDECAR_BASENAME,
    JsonlSource,
)
from spark_examples_tpu_torch.resilience import faults

__all__ = [
    "ColdStreamMirror",
    "ExportUnavailable",
    "MirrorFeed",
    "cold_stream_finished",
    "is_cold_stream",
    "note_cold_shard_fetched",
    "refresh_cold_stream",
    "resolve_mirror",
    "start_background_mirror",
    "tick_cold_stream_shard",
]


def is_cold_stream(mirror) -> bool:
    """Is this resolved mirror the cold-stream sentinel (the run is
    streaming from the wire while the mirror writes through)? One
    predicate shared by both transports' ``cold_stream_active``."""
    return isinstance(mirror, ColdStreamMirror)


def cold_stream_finished(mirror) -> bool:
    """Has this cold-stream sentinel's write-through download finished
    (successfully or not)? The RUN-BOUNDARY signal for a long-lived
    source to re-resolve its mirror: a resident source (the serving
    engine runs every job against one source instance) must not stay
    pinned to the wire tier for its whole lifetime after one cold
    resolve — but the flip happens only between runs, in
    ``cold_stream_active``, never mid-stream (the tier decision inside
    a run is taken once; see :class:`ColdStreamMirror`)."""
    return is_cold_stream(mirror) and not mirror.writing


def refresh_cold_stream(source) -> bool:
    """The shared body of both transports' ``cold_stream_active``: is
    this run streaming a COLD cohort from the wire while the mirror
    downloads write-through in the background?

    This is also the RUN-BOUNDARY tier upgrade for a long-lived source:
    when an earlier run's write-through has finished, the cached
    sentinel is dropped and the mirror re-resolved — the next run reads
    the completed mirror from disk (or restarts the write-through after
    a failed download) instead of riding the wire for this source's
    whole lifetime. Mid-stream resolves still return the cached
    sentinel: one run never flips tiers.

    ``source`` is duck-typed on the shared mirror-cache contract both
    transports already implement (``_resolve_mirror()`` with once-only
    locking, the ``_mirror`` cache guarded by ``_mirror_lock``, the
    ``_cold_stream`` constructor flag) — one implementation here so the
    flip logic cannot diverge between them.
    """
    if not getattr(source, "_cold_stream", False):
        # --no-cold-stream: never False-start the PHASED download here.
        # The driver consults this predicate before ingest begins, and
        # resolving would run the whole synchronous mirror download in
        # the driver thread — OUTSIDE the per-shard retry seam that has
        # always covered the phased path's lazy first-fetch resolve
        # (--shard-retries). No sentinel can exist with the flag off,
        # so there is nothing to refresh.
        return False
    try:
        mirror = source._resolve_mirror()
        if cold_stream_finished(mirror):
            with source._mirror_lock:
                if source._mirror is mirror:
                    source._mirror = None
            mirror = source._resolve_mirror()
    except (IOError, OSError):
        # The probe's resolve can still do real synchronous work — the
        # /identity round-trip, or a light→full mirror UPGRADE (a full
        # variants.jsonl download when a prior --mirror-mode light cache
        # meets a full-mode run). A transient failure here must not
        # kill the run from the driver thread: report "not cold-
        # streaming" and leave the resolve to the first shard fetch,
        # where the per-shard retry seam (--shard-retries) has always
        # covered it — a persistent failure still surfaces there.
        return False
    return is_cold_stream(mirror)


def note_cold_shard_fetched(mirror) -> None:
    """One 'fetched' tick per shard served over the wire while the
    mirror is cold; no-op otherwise. Shared by both transports (the
    driver ticks 'accumulated' when the pair reaches the window
    slicer)."""
    if is_cold_stream(mirror):
        tick_cold_stream_shard("fetched")


def tick_cold_stream_shard(stage: str) -> None:
    """One ``cold_stream_shards_total`` increment — the SINGLE
    registration site for the counter's name/help/label contract
    (``validate_trace._LABELED_COUNTERS`` pins the ``stage`` label;
    both transports' 'fetched' ticks and the driver's 'accumulated'
    tick share this helper so the registrations can never diverge)."""
    obs.get_registry().counter(
        "cold_stream_shards_total",
        "Shards through the cold-stream ingest pipeline, by stage",
    ).labels(stage=stage).inc()


class ExportUnavailable(IOError):
    """The server answered that this export does not exist (the served
    404 / NOT_FOUND class) — distinct from transport trouble, which
    must surface rather than silently degrade a multi-thousand-shard
    run's cache."""


class MirrorFeed:
    """The transport seam a mirror download rides (duck-typed; this
    base documents the contract).

    - ``identity()`` → the cohort content digest, or None when the
      server cannot identify itself (caching is then impossible and the
      client streams directly).
    - ``export_lines(name)`` → iterator of raw interchange lines;
      raises :class:`ExportUnavailable` when the server has no such
      export, any other IOError on transport trouble.
    - ``export_sidecar()`` → iterator of raw byte chunks of the binary
      CSR sidecar; same error contract.
    """

    def identity(self) -> Optional[str]:  # pragma: no cover - contract
        raise NotImplementedError

    def export_lines(self, name: str) -> Iterator[bytes]:  # pragma: no cover
        raise NotImplementedError

    def export_sidecar(self) -> Iterator[bytes]:  # pragma: no cover
        raise NotImplementedError


class ColdStreamMirror:
    """FALSY sentinel for a cold cohort being mirrored write-through.

    Sources treat it exactly like "no mirror" (``if mirror:`` routes to
    the wire tier), so a cold run streams frames straight into the
    ingest pipeline; the handle exposes the background downloader so
    callers/tests can observe or await completion. One run never flips
    to the mirror mid-stream — the tier decision is taken once, which
    is what keeps cold-stream results trivially order-comparable with
    the phased path (G is bit-identical regardless; pinned by test).
    """

    def __init__(self, thread: threading.Thread):
        self._thread = thread

    def __bool__(self) -> bool:
        return False

    @property
    def writing(self) -> bool:
        """Is the write-through download still in flight?"""
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Await the write-through download; True when it finished."""
        self._thread.join(timeout)
        return not self._thread.is_alive()


def resolve_mirror(
    feed: MirrorFeed,
    cache_dir: str,
    mirror_mode: str,
    stats,
    cold_stream: bool = False,
):
    """JsonlSource over the local mirror, downloading it first if this
    identity has never been mirrored; False = caching unavailable
    (server without an identity). With ``cold_stream=True`` a COLD
    cohort is not downloaded in-line: the download starts on a
    background thread (write-through, atomic per-file) and a falsy
    :class:`ColdStreamMirror` is returned so the caller streams from
    the wire immediately. The caller holds its own lock — this
    function is the single-threaded critical section."""
    ident = feed.identity()
    if ident is None:
        return False
    root = os.path.join(cache_dir, f"cohort-{ident}")
    if not os.path.exists(os.path.join(root, MIRROR_COMPLETE_MARKER)):
        if cold_stream:
            return start_background_mirror(
                feed, cache_dir, root, ident, mirror_mode
            )
        _download_mirror(feed, cache_dir, root, ident, mirror_mode)
    elif mirror_mode == "full" and not (
        os.path.exists(os.path.join(root, "variants.jsonl"))
        or os.path.exists(os.path.join(root, "variants.jsonl.gz"))
    ):
        # A LIGHT mirror from an earlier run, asked to serve full:
        # upgrade in place by fetching the missing interchange files
        # (atomic per file) instead of crashing the first
        # record-streaming consumer on cache internals.
        _upgrade_light_mirror(feed, root)
    return JsonlSource(root, stats=stats)


def start_background_mirror(
    feed: MirrorFeed, cache_dir: str, root: str, ident: str, mirror_mode: str
) -> ColdStreamMirror:
    """Write-through mirror download as a SIDE EFFECT of a cold-stream
    run: the same ``_download_mirror`` protocol (atomic per-file
    commits into the deterministic staging dir), on a daemon thread the
    ingest never waits on. Failure is a warning, not a run failure —
    the run's data rides the wire tier, and whatever staging committed
    is reused by the next cold run."""
    def run() -> None:
        try:
            _download_mirror(feed, cache_dir, root, ident, mirror_mode)
            obs.instant("mirror_writethrough_complete", scope="p", root=root)
        except BaseException as e:  # noqa: BLE001 — side effect, never fatal
            obs.instant(
                "mirror_writethrough_failed",
                scope="p",
                error=f"{type(e).__name__}: {e}",
            )
            print(
                f"WARNING: write-through mirror download failed ({e}); "
                "the cold-stream run continues over the wire, and the "
                "partially-staged mirror is reused by the next cold run.",
                file=sys.stderr,
            )

    t = threading.Thread(target=run, name="mirror-writethrough", daemon=True)
    t.start()
    return ColdStreamMirror(t)


def _fsync_dir(path: str) -> None:
    """Durability for the rename itself (best effort — some filesystems
    refuse directory fds; the rename is still atomic there)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _commit_tmp(tmp: str, path: str) -> None:
    """tmp → final, atomically and durably: the tmp is already written;
    fault-check it (the ``mirror.write`` seam — a torn rule truncates
    the tmp and raises, simulating kill -9 mid-write, so the rename
    below never runs), fsync its bytes, rename, fsync the directory. A
    crash anywhere leaves either the whole committed file or only a
    ``*.tmp-*`` partial no reader ever trusts."""
    faults.inject_write("mirror.write", tmp)
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _atomic_write_text(path: str, text: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    _commit_tmp(tmp, path)


def _fetch_to(feed: MirrorFeed, name: str, path: str) -> bool:
    """Download one interchange file tmp-then-atomic-rename with fsync;
    False when the export is absent AND optional (reads are optional in
    the layout). A file already committed at ``path`` is trusted and
    skipped — the atomic commit protocol means it is whole, which is
    what lets a restarted cold run reuse a killed run's partial
    staging instead of re-downloading it. The whole fetch is inside
    the handler because lazily-erroring transports (gRPC stream
    generators) surface the absence only on first iteration."""
    if os.path.exists(path):
        return True
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        lines = feed.export_lines(name)
        with open(tmp, "wb") as out:
            for line in lines:
                out.write(line)
                out.write(b"\n")
    except ExportUnavailable:
        try:
            os.unlink(tmp)  # the just-created empty tmp, if any
        except OSError:
            pass
        if name == "reads.jsonl":
            return False
        raise
    _commit_tmp(tmp, path)
    return True


def _upgrade_light_mirror(feed: MirrorFeed, root: str) -> None:
    # reads BEFORE variants: the upgrade gate in resolve_mirror keys on
    # variants.jsonl's presence, and replacing it LAST makes the gate
    # re-fire after any interrupted upgrade — fetching variants first
    # would mark the mirror "full" with reads.jsonl permanently missing.
    staged = []  # (tmp path, final name), commit-ordered
    try:
        for name in ("reads.jsonl", "variants.jsonl"):
            if os.path.exists(os.path.join(root, name)):
                continue
            tmp = os.path.join(root, f".partial-{name}-{os.getpid()}")
            try:
                # A stale partial from a previous crashed upgrade must
                # never be reused: its identity re-verify never passed,
                # so its bytes could be another cohort's.
                os.unlink(tmp)
            except OSError:
                pass
            # Staged BEFORE the fetch so the finally below cleans up a
            # partially-written tmp on any failure path.
            staged.append((tmp, name))
            if not _fetch_to(feed, name, tmp):
                staged.pop()
                continue
        if not staged:
            return
        # The upgrade downloaded over a window in which the server
        # cohort may have CHANGED — the same TOCTOU window
        # _download_mirror re-verifies. A mid-upgrade cohort swap would
        # leave the OLD sidecar (vouched forever by .sidecar-ok) next
        # to NEW JSONL. Verify BEFORE committing anything: files land
        # in the mirror only after the identity still matches the pin.
        expect = None
        try:
            with open(os.path.join(root, MIRROR_IDENTITY_FILE)) as f:
                expect = f.read().strip()
        except OSError:
            pass  # mirrors always carry it; no pin → can't verify
        now_ident = feed.identity()
        if expect is not None and now_ident != expect:
            raise IOError(
                "server cohort changed while upgrading mirror "
                f"(identity {expect} -> {now_ident}); the upgrade "
                "was discarded — rerun to mirror the new cohort"
            )
        # Commit order (reads before variants, the staged list's
        # order): variants.jsonl's presence is the upgrade gate, so
        # replacing it LAST makes the gate re-fire after a crash
        # between the two commits.
        for tmp, name in staged:
            os.replace(tmp, os.path.join(root, name))
        _fsync_dir(root)
    finally:
        for tmp, _ in staged:
            # Both the staged .partial-* target and _fetch_to's inner
            # *.tmp-* (left behind when _commit_tmp itself failed):
            # these land in the COMPLETED mirror root, which no staging
            # sweep ever revisits, so a crashed upgrade must not leak
            # them.
            for leftover in (tmp, f"{tmp}.tmp-{os.getpid()}"):
                try:
                    os.unlink(leftover)
                except OSError:
                    pass


def _sidecar_committed(staging: str, ident: str) -> bool:
    """Is a (whole, atomically-committed) sidecar already staged for
    THIS identity? The ``.sidecar-ok`` marker commits after the npz,
    so its presence+content vouches for both files."""
    try:
        with open(os.path.join(staging, MIRROR_SIDECAR_OK)) as f:
            ok = f.read().strip()
    except OSError:
        return False
    return ok == ident and os.path.exists(
        os.path.join(staging, SIDECAR_BASENAME)
    )


def _download_sidecar(feed: MirrorFeed, staging: str, ident: str, light: bool):
    """The binary CSR sidecar, the light mirror's only payload; in full
    mode a pure optimization whose failure must never destroy the
    mandatory JSONL mirror already staged. Commit order: npz first,
    then the ``.sidecar-ok`` marker — a crash between the two leaves a
    staged npz the restart re-fetch check refuses to trust."""
    if _sidecar_committed(staging, ident):
        return
    side = os.path.join(staging, SIDECAR_BASENAME)
    try:
        chunks = feed.export_sidecar()
        tmp = f"{side}.tmp-{os.getpid()}"
        with open(tmp, "wb") as out:
            for chunk in chunks:
                out.write(chunk)
        _commit_tmp(tmp, side)
        _atomic_write_text(os.path.join(staging, MIRROR_SIDECAR_OK), ident)
    except (IOError, OSError) as e:
        if light:
            # A light mirror WITHOUT the sidecar can serve nothing
            # (there is no JSONL to parse) — fail the mirror instead of
            # renaming a husk into place.
            raise IOError(
                "light mirror requires the server's sidecar export, "
                f"which failed: {e}"
            ) from e
        # A cold server may even time out here (its ensure_sidecar
        # parses the whole cohort before responding) — the client then
        # just parses locally.
        if not isinstance(e, ExportUnavailable):
            print(
                f"WARNING: sidecar export failed ({e}); the mirror "
                "will parse locally instead.",
                file=sys.stderr,
            )
        for name in (SIDECAR_BASENAME, MIRROR_SIDECAR_OK):
            path = os.path.join(staging, name)
            # The committed names AND their *.tmp-* partials (left when
            # _commit_tmp itself failed): a tolerated sidecar failure
            # still publishes this staging as the COMPLETED mirror root,
            # which no later sweep revisits — a leftover sidecar-sized
            # tmp would leak there forever.
            for leftover in (path, f"{path}.tmp-{os.getpid()}"):
                try:
                    os.remove(leftover)
                except OSError:
                    pass


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False  # unknown/unparseable owner: no live process
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # EPERM etc.: something owns the pid — treat as alive
    return True


def _host_token() -> str:
    """This host's name, sanitized to the filename/owner-token alphabet
    (hyphens excluded — ``.once-`` dir names parse their owner token up
    to the first hyphen)."""
    import re
    import socket

    return re.sub(
        r"[^A-Za-z0-9._]", "_", socket.gethostname() or "localhost"
    )


def _owner_token() -> str:
    """``pid@host`` — what this process records as the owner of a lock
    file or ``.once-`` staging dir. The host half is what makes
    liveness judgments safe on SHARED cache mounts: a pid number alone
    is meaningless in another host's pid table."""
    return f"{os.getpid()}@{_host_token()}"


def _parse_owner(token: str) -> tuple[int, str]:
    """``pid@host`` → (pid, host); a bare integer (the pre-host legacy
    record, and what tests write directly) parses as a LOCAL owner
    (host '')."""
    pid_s, _, host = token.strip().partition("@")
    try:
        return int(pid_s or "0"), host
    except ValueError:
        return 0, host


def _owner_alive(pid: int, host: str) -> bool:
    """Is the recorded owner's process still alive? A FOREIGN host's
    owner is always treated as alive: ``os.kill(pid, 0)`` probes only
    the local pid table, and on a shared cache mount where flock does
    not propagate, judging a remote peer's pid 'dead' would reap its
    in-flight staging mid-download. (The cost: a genuinely dead remote
    run's staging waits for a populate on ITS host to be reaped.)"""
    if host and host != _host_token():
        return True
    return _pid_alive(pid)


def _acquire_populate_lock(lock_path: str) -> Optional[int]:
    """Advisory lock serializing the SHARED deterministic staging dir
    per (cache, identity, mode): exactly one live process may sweep and
    write it at a time — a concurrent populator would otherwise unlink
    a live peer's in-flight ``*.tmp-*`` or ``.complete`` and fail (or
    wedge) its commit. Returns the open lock fd (release with
    :func:`_release_populate_lock`) or None when a LIVE peer holds it.

    Mutual exclusion is the kernel's ``flock`` — released on ANY death
    of the holder, kill -9 included, so a dead run's lock never needs
    a break-the-stale-pidfile dance (every userspace variant of which
    has a window where two breakers can both 'win'). The holder's
    ``pid@host`` is still recorded in the file, under the flock: the
    prune loop and file-only observers read it, and a recorded owner
    that is alive counts as a live peer even without the flock
    (belt-and-suspenders for mounts where flock does not propagate —
    where a FOREIGN host's record is always treated as alive, since
    its pid table cannot be probed from here)."""
    import fcntl

    while True:
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return None
        # A releasing holder unlinks the path while holding the flock;
        # we may have opened (and now locked) that ORPHANED inode while
        # a fresh acquirer locks the recreated file. Only a lock on the
        # inode still AT the path counts.
        try:
            if os.fstat(fd).st_ino != os.stat(lock_path).st_ino:
                os.close(fd)
                continue
        except OSError:
            os.close(fd)
            continue
        pid, host = _read_lock_owner(fd)
        if pid and _owner_alive(pid, host):
            os.close(fd)  # releases the flock
            return None
        os.lseek(fd, 0, os.SEEK_SET)
        os.ftruncate(fd, 0)
        os.write(fd, _owner_token().encode())
        return fd


def _release_populate_lock(fd: int, lock_path: str) -> None:
    """Unlink BEFORE close: the path disappears while the flock is
    still held, so no peer can lock the doomed inode and then lose the
    path from under it (which would let a third acquirer create a
    fresh lock alongside a live holder)."""
    try:
        os.unlink(lock_path)
    except OSError:
        pass
    os.close(fd)


def _prepare_staging(staging: str, ident: str) -> None:
    """Make the deterministic staging dir reusable (CALLER HOLDS the
    populate lock, so every leftover here is a dead run's): sweep
    ``*.tmp-*`` partials (torn writes — never trustworthy) and any
    premature ``.complete``, and DISCARD the whole dir when its pinned
    identity differs (a stale staging for a cohort the server no
    longer serves must never donate files to the new one)."""
    if os.path.isdir(staging):
        pinned = None
        try:
            with open(os.path.join(staging, MIRROR_IDENTITY_FILE)) as f:
                pinned = f.read().strip()
        except OSError:
            pass
        if pinned is not None and pinned != ident:
            shutil.rmtree(staging, ignore_errors=True)
        else:
            for entry in os.listdir(staging):
                if ".tmp-" in entry or entry == MIRROR_COMPLETE_MARKER:
                    try:
                        os.unlink(os.path.join(staging, entry))
                    except OSError:
                        pass
    os.makedirs(staging, exist_ok=True)


def _download_mirror(
    feed: MirrorFeed, cache_dir: str, root: str, ident: str, mirror_mode: str
) -> None:
    """Populate ``root`` with the served cohort's interchange files:
    download each file tmp→fsync→atomic-rename into a staging dir,
    mark complete, rename the dir.

    The staging dir is DETERMINISTIC — keyed by (identity, mode) and
    serialized by a pid lock — so a cold run killed at any point
    (kill -9 mid-write included) leaves only whole, fsynced files the
    NEXT cold run reuses instead of re-downloading (the
    restart-reuses-partial-mirror contract); partials are only ever
    ``*.tmp-*`` names no reader trusts. A process that finds the lock
    held by a LIVE peer falls back to an isolated one-shot staging dir
    (the historical protocol): both downloads are identical by
    identity, losing the populate race is success, and neither can
    unlink the other's in-flight files.

    ``mirror_mode="light"`` downloads ONLY callsets.json + the sidecar
    — the only remote warm tier that fits hosts with less free disk
    than the cohort's JSONL. The ``.identity``/``.sidecar-ok`` pair records
    that the MIRROR PROTOCOL vouches for the downloaded sidecar (see
    ``_CsrCohort._mirror_sidecar_trusted`` — its file stats can never
    match the server's).
    """
    import tempfile

    os.makedirs(cache_dir, exist_ok=True)
    base = os.path.basename(root)
    lock_path = os.path.join(cache_dir, f".lock-{base}-{mirror_mode}")
    lock_fd = _acquire_populate_lock(lock_path)
    if lock_fd is not None:
        staging = os.path.join(
            cache_dir, f".staging-{base}-{mirror_mode}"
        )
        try:
            _prepare_staging(staging, ident)
            # A failure below LEAVES the staging dir in place: every
            # committed file is whole (atomic rename) and identity-
            # pinned, so the next cold run resumes the download instead
            # of restarting it. Only an identity mismatch discards it.
            _populate_staging(feed, staging, root, ident, mirror_mode)
        finally:
            _release_populate_lock(lock_fd, lock_path)
    else:
        # A live peer owns the shared staging: run the whole protocol
        # in an isolated dir instead (no reuse, no sweeping). The
        # ``.once-<pid>-`` prefix keeps it out of the winner's
        # stale-staging prune while this pid lives.
        staging = tempfile.mkdtemp(
            dir=cache_dir, prefix=f".once-{_owner_token()}-"
        )
        try:
            _populate_staging(feed, staging, root, ident, mirror_mode)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise


def _verify_identity_pin(feed: MirrorFeed, staging: str, ident: str) -> None:
    """The served identity must still match the staging's pin; on a
    mismatch the staged files are an unknown mix of cohorts and the
    whole staging is discarded — never left for a later run to reuse."""
    now_ident = feed.identity()
    if now_ident != ident:
        shutil.rmtree(staging, ignore_errors=True)
        raise IOError(
            "server cohort changed while mirroring "
            f"(identity {ident} -> {now_ident}); rerun to mirror "
            "the new cohort"
        )


def _populate_staging(
    feed: MirrorFeed, staging: str, root: str, ident: str, mirror_mode: str
) -> None:
    """Download into ``staging`` (reusing whole committed files), verify
    the identity, mark complete, and atomically publish as ``root``."""
    light = mirror_mode == "light"
    cache_dir = os.path.dirname(staging)
    # Identity pin FIRST: it is what lets a restart decide whether the
    # staged files are reusable at all.
    _atomic_write_text(os.path.join(staging, MIRROR_IDENTITY_FILE), ident)
    names = (
        ("callsets.json",)
        if light
        else ("callsets.json", "variants.jsonl", "reads.jsonl")
    )
    for name in names:
        path = os.path.join(staging, name)
        reused = os.path.exists(path)
        if _fetch_to(feed, name, path) and not reused:
            obs.instant("mirror_writethrough_file", scope="p", file=name)
            # Re-verify the identity the moment each FRESHLY-DOWNLOADED
            # file commits, not only at the end: a committed file
            # SURVIVES a kill for the next run to reuse, and that run
            # can only check the pin against the CURRENT identity — it
            # cannot tell that a file was fetched during a cohort-swap
            # window the server has since rolled back. Checking here
            # shrinks that poisoned-reuse window from the rest of the
            # download to the instant between commit and check.
            _verify_identity_pin(feed, staging, ident)
    _download_sidecar(feed, staging, ident, light)
    # The mirror's files downloaded over a window in which the server
    # cohort may have CHANGED (mixing old JSONL with a new sidecar —
    # or new JSONL tail with old head). Re-verify the identity before
    # marking complete; on a swap the staged files are an unknown mix
    # and must be discarded, reuse notwithstanding. (This check also
    # backstops the sidecar commit just above, per-file-style.)
    _verify_identity_pin(feed, staging, ident)
    _atomic_write_text(os.path.join(staging, MIRROR_COMPLETE_MARKER), "")
    try:
        os.rename(staging, root)
    except OSError:
        # Lost a populate race: the winner's mirror is identical by
        # identity — never touch an existing complete root (another
        # process may be reading it right now).
        if not os.path.exists(
            os.path.join(root, MIRROR_COMPLETE_MARKER)
        ):
            raise
        shutil.rmtree(staging, ignore_errors=True)
    _fsync_dir(cache_dir)
    # Identity keys on (size, mtime): a regenerated-but-identical
    # server file still mints a new identity, so prune the now-stale
    # sibling mirrors (and orphaned staging dirs) or cache_dir grows
    # without bound. Only after a SUCCESSFUL download — the cold path
    # already moved the whole cohort, a stale reader losing its files
    # mid-run is the rare case pruning-on-warm would make common.
    # ``.once-<pid>-*`` isolated stagings and ``.lock-*`` pid locks are
    # pruned only when their owner is DEAD: a live concurrent populate
    # must never lose its files from under it.
    base = os.path.basename(root)
    for entry in os.listdir(cache_dir):
        stale_mirror = entry.startswith("cohort-") and entry != base
        stale_once = entry.startswith(".once-") and not _owner_alive(
            *_entry_owner(entry, ".once-")
        )
        if stale_mirror or stale_once:
            shutil.rmtree(
                os.path.join(cache_dir, entry), ignore_errors=True
            )
        elif entry.startswith(".staging-") and not entry.startswith(
            f".staging-{base}-"
        ):
            # A DIFFERENT identity's staging may belong to a LIVE
            # populate in a shared cache_dir (HTTP and gRPC sources
            # share caches; two cohorts may mirror concurrently) — its
            # lock, not its name, says whether it is stale, and the
            # reap happens WHILE HOLDING that lock's probe flock so a
            # populate that wins the lock after the probe can never
            # have its staging swept mid-download (see _reap_if_dead).
            _reap_if_dead(
                os.path.join(
                    cache_dir, f".lock-{entry[len('.staging-'):]}"
                ),
                staging_path=os.path.join(cache_dir, entry),
            )
        elif entry.startswith(".lock-"):
            _reap_if_dead(os.path.join(cache_dir, entry))


def _entry_owner(entry: str, prefix: str) -> tuple[int, str]:
    """Owner ``(pid, host)`` embedded in a ``.once-<pid>@<host>-*`` dir
    name (pid 0 = unknown, treated as dead — an unparseable name has no
    live owner to hurt; a legacy ``.once-<pid>-*`` name parses as a
    local owner). ``_host_token`` keeps hyphens out of the host half,
    so the owner token is everything before the first hyphen."""
    return _parse_owner(entry[len(prefix):].split("-", 1)[0])


def _read_lock_owner(fd: int) -> tuple[int, str]:
    """Owner ``(pid, host)`` recorded in an open lock file (pid 0 =
    none/unparseable; host '' = a legacy bare-pid record, judged
    locally). The SINGLE parser shared by acquisition and reaping — the
    two must never diverge on what counts as a recorded owner."""
    try:
        return _parse_owner(os.read(fd, 256).decode(errors="replace"))
    except OSError:
        return 0, ""


def _reap_if_dead(lock_path: str, staging_path: Optional[str] = None) -> None:
    """Reap a dead run's lock file — and optionally its staging dir —
    WITHOUT racing a concurrent acquirer.

    The recorded pid alone is NOT trustworthy: an acquirer holds the
    flock for a window BEFORE its pid lands in the file (empty on first
    creation, or a dead run's stale pid), and a pruner trusting the
    file content would reap that live in-acquisition lock and staging.
    So liveness is probed with the same primitive acquisition uses — a
    non-blocking ``flock`` attempt (a refused probe is a live holder,
    pid content notwithstanding; a granted probe falls back to the
    recorded ``pid@host`` owner, for mounts where flock does not
    propagate — a foreign host's owner is never judged dead) — and
    every destructive step happens WHILE HOLDING the probe flock, only
    if the flocked inode is still the one at the path: a fresh
    acquirer's recreated lock is never unlinked from under it, and a
    peer that wins the flock after this probe released it can never
    have its freshly-prepared staging rmtree'd mid-populate (acquirers
    serialize through this same lock file — ``O_CREAT`` here so even an
    orphaned staging with no lock file left gets a lock to serialize
    on). An acquirer that loses its inode to this reap fails its own
    at-path inode check and retries on a fresh file (the
    ``_release_populate_lock`` protocol)."""
    import fcntl

    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    except OSError:
        return
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return  # a LIVE holder (possibly mid-acquisition)
        try:
            if os.fstat(fd).st_ino != os.stat(lock_path).st_ino:
                return  # path was recreated: not our inode to judge
        except OSError:
            return
        pid, host = _read_lock_owner(fd)
        if pid and _owner_alive(pid, host):
            return  # flock-less mount: the recorded owner lives
        if staging_path is not None:
            shutil.rmtree(staging_path, ignore_errors=True)
        try:
            os.unlink(lock_path)
        except OSError:
            pass
    finally:
        os.close(fd)  # releases the probe flock
