"""The process's CPU seconds around a stretch of the run (``getrusage``:
user and system time of every thread). Set against the stretch's wall
seconds they tell a job that waited (on I/O, a lock or the scheduler:
CPU seconds fall behind the wall) from one that ran slower on the CPU
(the same work taking more CPU seconds: a slower host)."""

from __future__ import annotations

import resource

__all__ = ["cpu_s", "describe"]


def cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def describe(cpu: float, seconds: float, jobs: int) -> str:
    """One line: the CPU seconds, a job's share of them, and their share
    of the wall seconds (above 1 where threads ran side by side)."""
    return (f"cpu_s {cpu:.6g}, cpu_s_per_job {cpu / max(jobs, 1):.6g}, "
            f"process_cpu_share {cpu / max(seconds, 1e-9):.6g}")
