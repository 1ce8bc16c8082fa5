"""Runtime backstop for the pod protocol's collective congruence.

The port of the JAX package's ``utils/collectivecheck.py``. With
``SPARK_EXAMPLES_TPU_TORCH_COLLECTIVE_CHECK=1`` every pod protocol step
digests its derived (op, geometry) sequence — the route, the padded row
count, the agreed carrier bucket or dense panel width, the payload dtype —
and cross-checks peers over the pod exchange (one extra small frame a
step, nothing when off). A divergent step raises on EVERY process
together, naming the step and the per-process digests, instead of
desyncing the frame protocol or deadlocking a collective later.

The variable is the port's own: the JAX package's switch is never read,
so a setting made for a JAX run does not change a port run. A variable,
not a setter call, because spawned ranks inherit it.

Enablement is itself agreed: each process advertises its flag in the step
header, and the digest exchange runs only when every live process turned
it on — a mixed pod runs unchecked rather than desyncing on unexpected
frames.
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence, Tuple

__all__ = [
    "COLLECTIVE_CHECK_ENV",
    "collective_check_enabled",
    "note_collective_check",
    "step_digest",
    "verify_step_digests",
]

COLLECTIVE_CHECK_ENV = "SPARK_EXAMPLES_TPU_TORCH_COLLECTIVE_CHECK"

# (op name, geometry ints) pairs — one per lockstep operation of the step,
# in issue order.
OpGeometry = Tuple[str, Tuple[int, ...]]


def collective_check_enabled() -> bool:
    """Read on every call (not cached): tests toggle the variable around
    single cases."""
    return os.environ.get(COLLECTIVE_CHECK_ENV, "") not in ("", "0")


def step_digest(stream: int, step: int, ops: Sequence[OpGeometry]) -> int:
    """Order-sensitive 63-bit digest of one protocol step's (op,
    geometry) sequence; never negative (the exchange keeps negative
    values for "check off on this process"). The JAX package's digest,
    bit for bit."""
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{stream}|{step}".encode())
    for op, geometry in ops:
        h.update(b"\x00" + op.encode())
        for g in geometry:
            h.update(b"\x01" + str(int(g)).encode())
    return int.from_bytes(h.digest(), "little") & (2**63 - 1)


def note_collective_check(outcome: str) -> None:
    """Count one cross-checked protocol step: ``agree`` (digests matched
    on every live process) or ``divergence`` (the step raised
    everywhere)."""
    from spark_examples_tpu_torch import obs

    obs.get_registry().counter(
        "collective_check_steps_total",
        "Pod protocol steps cross-checked by the collective-congruence "
        "runtime backstop, by outcome",
    ).labels(outcome=outcome).inc()


def verify_step_digests(
    step: int, digests: Sequence[int], local_digest: int
) -> None:
    """Compare the gathered per-process digests of one step.

    ``digests`` is the (world,) gathered vector. Raises ``RuntimeError``
    on a mismatch — from identical gathered data, so every process raises
    together at the same step.
    """
    distinct = sorted({int(d) for d in digests})
    if len(distinct) <= 1:
        note_collective_check("agree")
        return
    note_collective_check("divergence")
    per_proc = {i: int(d) for i, d in enumerate(digests)}
    raise RuntimeError(
        f"collective-congruence check failed at protocol step {step}: "
        f"per-process (op, geometry) digests diverged {per_proc} "
        f"(local {int(local_digest)}) — the pod is issuing different "
        "collective sequences (version skew, or a geometry derivation "
        "bug); raising on every process together"
    )
