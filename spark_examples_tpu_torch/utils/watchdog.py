"""Fail-stop watchdog for collective phases — the process-loss answer.

A peer process dying mid-run leaves the survivors blocked inside a
gloo/NCCL collective that Python cannot interrupt: the wait lives in
native code, so no exception, signal handler, or timeout wrapper in the
caller can reclaim the thread. The sound remedy is fail-stop — detect
the stall, kill THIS process loudly with a distinctive exit code, and
let the operator (or a supervisor) relaunch the job; checkpoint/resume
then recovers every host from the last collective round
(``models/pca.py _checkpointed_pod``).

This is the pod-collective analog of the elasticity the reference got
free from Spark's task re-execution (SURVEY.md §2.10): Spark reschedules
a lost executor's tasks onto survivors; an SPMD pod cannot — every
process runs the same collective program — so recovery is
restart-with-resume, and the watchdog's job is to turn "hang forever"
into "die in ``timeout`` seconds with a clear diagnostic".
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Callable, Dict, Iterator, Optional

__all__ = [
    "CollectiveWatchdog",
    "EXIT_COLLECTIVE_TIMEOUT",
    "register_flush_hook",
    "run_flush_hooks",
    "unregister_flush_hook",
]

# Distinctive code so supervisors can tell "peer lost, relaunch me" from
# ordinary failures (sysexits.h stops at 78; 77 = EX_NOPERM is unused in
# this codebase).
EXIT_COLLECTIVE_TIMEOUT = 77

# Pre-exit flush hooks: durable-state owners (the analysis job journal,
# any open checkpoint lane writer) register a flush here so the
# fail-stop path leaves their state as durable as a clean shutdown —
# the same guarantee telemetry already had via flush_telemetry. Keyed
# by name so an owner can replace/unregister its own hook.
_flush_hooks: Dict[str, Callable[[], None]] = {}
_flush_lock = threading.Lock()


def register_flush_hook(name: str, fn: Callable[[], None]) -> None:
    """Register ``fn`` to run right before a fail-stop ``os._exit``
    (latest registration under a name wins)."""
    with _flush_lock:
        _flush_hooks[name] = fn


def unregister_flush_hook(name: str) -> None:
    with _flush_lock:
        _flush_hooks.pop(name, None)


def run_flush_hooks(deadline_s: float = 5.0) -> None:
    """Run every registered hook, best-effort and BOUNDED — a dying
    process must never fail (or hang) for want of one flush. Hooks run
    on a daemon thread joined with a deadline: a flush wedged in the
    kernel (fsync against a hung mount — the very stall that fired the
    watchdog) must not turn fail-stop into a permanent hang."""
    with _flush_lock:
        hooks = list(_flush_hooks.items())
    if not hooks:
        return

    def run_all() -> None:
        for name, fn in hooks:
            try:
                fn()
            except Exception:  # pragma: no cover - dying anyway
                print(
                    f"WARNING: pre-exit flush hook {name!r} failed",
                    file=sys.stderr,
                )

    t = threading.Thread(target=run_all, daemon=True)
    t.start()
    t.join(deadline_s)
    if t.is_alive():  # pragma: no cover - requires wedged storage
        print(
            f"WARNING: pre-exit flush hooks still running after "
            f"{deadline_s}s; exiting without them.",
            file=sys.stderr,
        )


class CollectiveWatchdog:
    """Arms a hard deadline around each collective phase.

    ``timeout_s`` budgets one whole phase INCLUDING its host-side work
    (a checkpoint round = ingest + collective accumulate + snapshot), so
    set it to a multiple of the expected round time, not of network
    latency. ``None``/0 disables arming entirely (the default: a lone
    process or an interactive run should never be shot by a timer).
    """

    def __init__(self, timeout_s: Optional[float]):
        self.timeout_s = timeout_s

    @contextlib.contextmanager
    def armed(self, what: str) -> Iterator[None]:
        if not self.timeout_s:
            yield
            return
        timer = threading.Timer(self.timeout_s, self._fire, (what,))
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            timer.cancel()

    def _fire(self, what: str) -> None:
        print(
            f"FATAL: collective phase '{what}' exceeded "
            f"{self.timeout_s}s — a peer process is likely lost and the "
            "collective will never complete. Exiting "
            f"{EXIT_COLLECTIVE_TIMEOUT}; relaunch the job with the same "
            "manifest and --checkpoint-dir to resume every host from the "
            "last snapshotted round.",
            file=sys.stderr,
            flush=True,
        )
        # Durable state FIRST (job journal, open checkpoint lanes —
        # whatever registered a pre-exit hook), then telemetry: the
        # stall must be ON the trace timeline, not only in stderr, and
        # every flushed file must exist after os._exit.
        run_flush_hooks()
        try:
            from spark_examples_tpu_torch import obs

            obs.instant(
                "collective_watchdog_fired",
                scope="g",
                phase=what,
                timeout_s=self.timeout_s,
            )
            obs.flush_telemetry(reason=f"watchdog fired in '{what}'")
        except Exception:  # pragma: no cover - dying anyway
            pass
        os._exit(EXIT_COLLECTIVE_TIMEOUT)
