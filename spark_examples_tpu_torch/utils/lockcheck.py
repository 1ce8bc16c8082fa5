"""Runtime backstop for the ``*_locked`` convention.

The JAX package's ``utils/lockcheck.py``. A static gate cannot see dynamic
dispatch, monkeypatched tests, or an embedder driving the tier directly.
With the check on, every ``*_locked`` method asserts its precondition on
entry — a cheap owner/held probe — so a discipline violation fails loudly
at the exact broken call site instead of surfacing as a torn data
structure minutes later.

The port reads no environment variable for it (the JAX package reads
``SPARK_EXAMPLES_TPU_LOCK_CHECK``): the check is turned on and off with
:func:`set_lock_check`, which the serving and replica tests call around
their whole run. Off (the default) this is one global read per call.
"""

from __future__ import annotations

from typing import Any

__all__ = ["assert_lock_held", "lock_check_enabled", "set_lock_check"]

_enabled = False


def set_lock_check(enabled: bool) -> bool:
    """Turn the ``*_locked`` asserts on or off; returns the previous
    setting so a caller can restore it."""
    global _enabled
    prev, _enabled = _enabled, bool(enabled)
    return prev


def lock_check_enabled() -> bool:
    return _enabled


def assert_lock_held(lock: Any, what: str = "") -> None:
    """Assert the calling thread satisfies a ``*_locked`` precondition.

    RLock and Condition expose ``_is_owned()`` (CPython implementation
    detail, but stable since 2.x) — the precise check: held BY THIS
    THREAD. A plain Lock has no owner concept; ``locked()`` (held by
    somebody) is the best cheap probe and still catches the common bug
    of calling with no lock at all.
    """
    if not _enabled:
        return
    is_owned = getattr(lock, "_is_owned", None)
    held = bool(is_owned()) if callable(is_owned) else lock.locked()
    if not held:
        raise AssertionError(
            f"*_locked convention violated: {what or 'callee'} requires "
            f"its owning lock ({lock!r}) to be held by the caller"
        )
