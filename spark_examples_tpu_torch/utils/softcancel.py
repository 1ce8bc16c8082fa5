"""Cooperative run deadlines: soft-cancel at block boundaries.

A kill that lands while the card is mid-dispatch leaves the run with no
say in what it loses. The cooperative alternative: whoever launches the
run exports an ABSOLUTE deadline and the driver checks it at block
boundaries — between one device step completing and the next being
issued — exiting cleanly (code :data:`SOFT_CANCEL_EXIT`, telemetry
flushed by the CLI session). A checkpointed run (``--checkpoint-dir``)
resumes from its last shard-group snapshot when rerun.

The deadline is an absolute unix timestamp (not a duration) so child
processes the driver spawns inherit the SAME wall-clock budget through
the environment, and a driver that starts late gets proportionally less,
never more.

The port reads its own variable, :data:`SOFT_DEADLINE_ENV`
(``SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE``): a deadline exported for a
run of the JAX package never cancels a run of the port.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

__all__ = [
    "SOFT_DEADLINE_ENV",
    "SOFT_CANCEL_EXIT",
    "SoftCancel",
    "deadline",
    "remaining",
    "check",
]

SOFT_DEADLINE_ENV = "SPARK_EXAMPLES_TPU_TORCH_SOFT_DEADLINE"

# 75 = EX_TEMPFAIL: the run was healthy, the budget ran out — rerun
# with a checkpoint dir to resume. Distinct from the watchdog's 77
# (collective fail-stop) so operators can tell budget from breakage.
SOFT_CANCEL_EXIT = 75


class SoftCancel(SystemExit):
    """Deadline reached: a CLEAN SystemExit (no traceback spam, the
    telemetry session's exit path still flushes artifacts) carrying
    :data:`SOFT_CANCEL_EXIT`."""

    def __init__(self, where: str, late_s: float):
        super().__init__(SOFT_CANCEL_EXIT)
        self.where = where
        self.late_s = late_s


def deadline(environ=os.environ) -> Optional[float]:
    """The absolute unix-epoch deadline, or None (none set).
    An unparseable value is a loud error — a mistyped deadline that
    silently disables cancellation would let the run overrun its budget."""
    raw = environ.get(SOFT_DEADLINE_ENV, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{SOFT_DEADLINE_ENV}={raw!r} is not a unix timestamp "
            "(unset it to disable)"
        )


def remaining(environ=os.environ) -> Optional[float]:
    """Seconds until the deadline (negative = past), or None."""
    d = deadline(environ)
    return None if d is None else d - time.time()


def check(where: str, environ=os.environ) -> None:
    """Raise :class:`SoftCancel` when the deadline has passed.

    Called at block boundaries (between one device dispatch completing
    and the next being issued) so cancellation NEVER lands mid-dispatch.
    A no-op without the variable — one dict lookup on the hot path.
    """
    left = remaining(environ)
    if left is None or left > 0:
        return
    from spark_examples_tpu_torch import obs

    obs.instant("soft_cancel", scope="p", where=where, late_s=-left)
    print(
        f"Soft-cancel: run deadline reached ({-left:.1f}s past) at "
        f"{where}; exiting cleanly with code {SOFT_CANCEL_EXIT} "
        "(resume with the same --checkpoint-dir).",
        file=sys.stderr,
        flush=True,
    )
    raise SoftCancel(where, -left)
