"""Crash flight recorder: the last seconds of telemetry, always on.

The full tracer only records when a telemetry session is active, and it
buffers everything — neither property helps when a serving process is
kill -9'd or wedged: the operator needs *what was happening right
before*, cheaply enough to leave enabled in production. This module is
that black box:

- a fixed-size overwrite ring **per thread** (lock-free single-writer:
  each thread appends only to its own ring; the registry lock is taken
  only at ring creation and at dump time), holding the last K span
  transitions, instants, and metric deltas;
- a periodic flusher daemon that rewrites ``flightrec-last.jsonl``
  atomically every few seconds — SIGKILL cannot be caught, so the
  *previous* periodic snapshot is the kill -9 record;
- final reasoned dumps on the watchdog fail-stop path (registered as a
  pre-exit flush hook, the exit-77 discipline), on an unhandled
  exception (``sys.excepthook`` chain), and on SIGTERM (handler chain,
  main thread only).

Dumps are JSONL: one header line (schema, reason, pid, host), then the
merged rings sorted by wall-clock. The recorder is installed by
long-running servers (``serve-cohort --analyze``); when not installed,
``note()`` is one global read — the data plane pays nothing.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
import types
from typing import Any, Dict, List, Optional, Tuple

from spark_examples_tpu_torch.utils.watchdog import (
    register_flush_hook,
    unregister_flush_hook,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "dump_now",
    "get_recorder",
    "install",
    "note",
    "uninstall",
]

SCHEMA = "spark_examples_tpu_torch.flightrec/v1"

# Last K records per thread. Worker pools are small (analysis workers,
# HTTP handler threads), so total memory is K * threads * ~100 bytes.
DEFAULT_CAPACITY = 512

# Periodic snapshot cadence. This bounds how much history a SIGKILL can
# lose; the write is a few hundred records of JSONL, so seconds-scale
# is cheap.
DEFAULT_FLUSH_INTERVAL_S = 2.0

# (unix ts, kind, name, fields) — fields is the caller's dict by
# reference (never copied on the hot path; serialization copies).
_Record = Tuple[float, str, str, Optional[Dict[str, Any]]]


class _Ring:
    """Overwrite ring with exactly ONE writer thread.

    The owning thread assigns slots without any lock (list slot stores
    are atomic under the GIL); dump-time readers copy the slot list and
    tolerate the single in-flight slot being mid-overwrite — this is
    crash forensics, not a ledger.
    """

    __slots__ = ("slots", "head", "thread")

    def __init__(self, capacity: int, thread: str) -> None:
        self.slots: List[Optional[_Record]] = [None] * capacity
        self.head = 0
        self.thread = thread

    def push(self, rec: _Record) -> None:
        self.slots[self.head % len(self.slots)] = rec
        self.head += 1

    def snapshot(self) -> List[_Record]:
        return [rec for rec in list(self.slots) if rec is not None]


class FlightRecorder:
    """Per-thread rings + merged, time-sorted JSONL dumps."""

    def __init__(self, capacity_per_thread: int = DEFAULT_CAPACITY) -> None:
        self._capacity = max(8, int(capacity_per_thread))
        self._local = threading.local()
        self._rings: List[_Ring] = []
        # Taken only when a NEW thread first records, and at dump time
        # — never on the per-record path.
        self._rings_lock = threading.Lock()
        self._created_unix = time.time()

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self._capacity, threading.current_thread().name)
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def note(
        self,
        kind: str,
        name: str,
        fields: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record one transition into the calling thread's ring."""
        self._ring().push((time.time(), kind, name, fields))

    def snapshot(self) -> List[Dict[str, Any]]:
        """Merged rings as dicts, sorted by wall-clock timestamp."""
        with self._rings_lock:
            rings = list(self._rings)
        records: List[Dict[str, Any]] = []
        for ring in rings:
            for ts, kind, name, fields in ring.snapshot():
                rec: Dict[str, Any] = {
                    "ts_unix": ts,
                    "thread": ring.thread,
                    "kind": kind,
                    "name": name,
                }
                if fields:
                    rec["fields"] = dict(fields)
                records.append(rec)
        records.sort(key=lambda rec: float(rec["ts_unix"]))
        return records

    def dump(self, path: str, reason: str) -> None:
        """Write header + records as JSONL, atomically (tmp + fsync +
        rename — a torn flight record is exactly as useless during the
        incident it exists for as no record at all)."""
        from spark_examples_tpu_torch.resilience import faults

        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        header = {
            "schema": SCHEMA,
            "reason": reason,
            "ts_unix": time.time(),
            "recorder_started_unix": self._created_unix,
            "pid": os.getpid(),
            "host": socket.gethostname(),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in self.snapshot():
                try:
                    line = json.dumps(rec)
                except (TypeError, ValueError):
                    line = json.dumps(
                        {
                            "ts_unix": rec["ts_unix"],
                            "thread": rec["thread"],
                            "kind": rec["kind"],
                            "name": rec["name"],
                            "unserializable_fields": True,
                        }
                    )
                f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
            # Torn-write seam: crashsim (and the chaos suite) kill the
            # dump mid-write here; without the fsync above, the rename
            # below could land a torn dump under the committed name.
            faults.inject_write("flightrec.write", tmp)
        os.replace(tmp, path)


# -- module state (one recorder per process) ---------------------------------

_recorder: Optional[FlightRecorder] = None
_install_lock = threading.Lock()
_dump_dir: Optional[str] = None
_stop_flusher: Optional[threading.Event] = None
_flusher: Optional[threading.Thread] = None
_prev_excepthook: Optional[Any] = None
_prev_sigterm: Optional[Any] = None


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def note(
    kind: str,
    name: str,
    fields: Optional[Dict[str, Any]] = None,
) -> None:
    """Record into the installed recorder; one global read when off."""
    rec = _recorder
    if rec is not None:
        rec.note(kind, name, fields)


def dump_now(reason: str) -> Optional[str]:
    """Write a reasoned dump immediately; returns the path (None when
    the recorder is not installed)."""
    rec, directory = _recorder, _dump_dir
    if rec is None or directory is None:
        return None
    path = os.path.join(directory, f"flightrec-{reason}.jsonl")
    try:
        rec.dump(path, reason)
    except OSError:  # pragma: no cover - dump dir vanished mid-crash
        return None
    return path


def _flush_loop(stop: threading.Event, interval_s: float) -> None:
    # First snapshot immediately: a SIGKILL can land before the first
    # interval elapses, and the whole point of the periodic file is
    # that it exists whenever the process dies uncatchably.
    while True:
        rec, directory = _recorder, _dump_dir
        if rec is None or directory is None:
            return
        try:
            rec.dump(
                os.path.join(directory, "flightrec-last.jsonl"), "periodic"
            )
        except OSError:  # pragma: no cover - transient dump-dir trouble
            pass
        if stop.wait(interval_s):
            return


def _excepthook(
    exc_type: type,
    exc: BaseException,
    tb: Optional[types.TracebackType],
) -> None:
    note("crash", "unhandled_exception", {"type": exc_type.__name__})
    dump_now("exception")
    prev = _prev_excepthook
    if callable(prev):
        prev(exc_type, exc, tb)
    else:  # pragma: no cover - excepthook vanished
        sys.__excepthook__(exc_type, exc, tb)


def _on_sigterm(signum: int, frame: Optional[types.FrameType]) -> None:
    note("crash", "sigterm", None)
    dump_now("sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        # Restore the default disposition and re-deliver so SIGTERM
        # still terminates the process (and the exit status says so).
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def install(
    dump_dir: str,
    capacity_per_thread: int = DEFAULT_CAPACITY,
    flush_interval_s: float = DEFAULT_FLUSH_INTERVAL_S,
    handle_signals: bool = True,
) -> FlightRecorder:
    """Install the process flight recorder (idempotent).

    Registers the watchdog pre-exit flush hook (exit-77 path), chains
    ``sys.excepthook``, chains a SIGTERM handler (main thread only),
    and starts the periodic flusher daemon.
    """
    global _recorder, _dump_dir, _stop_flusher, _flusher
    global _prev_excepthook, _prev_sigterm
    with _install_lock:
        if _recorder is not None:
            return _recorder
        os.makedirs(dump_dir, exist_ok=True)
        _dump_dir = dump_dir
        _recorder = FlightRecorder(capacity_per_thread)
        register_flush_hook(
            "flight-recorder", lambda: dump_now("watchdog")
        )
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        if (
            handle_signals
            and threading.current_thread() is threading.main_thread()
        ):
            try:
                _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
            except ValueError:  # pragma: no cover - embedded interpreter
                _prev_sigterm = None
        _stop_flusher = threading.Event()
        _flusher = threading.Thread(
            target=_flush_loop,
            args=(_stop_flusher, flush_interval_s),
            name="flightrec-flush",
            daemon=True,
        )
        _flusher.start()
        return _recorder


def uninstall() -> None:
    """Tear down (tests): stop the flusher, restore hooks/handlers."""
    global _recorder, _dump_dir, _stop_flusher, _flusher
    global _prev_excepthook, _prev_sigterm
    with _install_lock:
        if _recorder is None:
            return
        if _stop_flusher is not None:
            _stop_flusher.set()
        if _flusher is not None:
            _flusher.join(timeout=2.0)
        unregister_flush_hook("flight-recorder")
        if _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
        if threading.current_thread() is threading.main_thread():
            try:
                if _prev_sigterm is not None:
                    signal.signal(signal.SIGTERM, _prev_sigterm)
            except (ValueError, TypeError):  # pragma: no cover
                pass
        _recorder = None
        _dump_dir = None
        _stop_flusher = None
        _flusher = None
        _prev_excepthook = None
        _prev_sigterm = None
