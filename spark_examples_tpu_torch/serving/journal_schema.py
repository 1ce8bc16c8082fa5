"""The journal/job-record key registry — ONE source for both sides.

The serving tier's crash safety rests on a compatibility contract that
was, until this round, enforced only by convention and by the
mixed-version replay tests: every key a journal writer emits must be a
key the replay readers know, and every key added after round 6 must be
ABSENCE-TOLERANT on read (``e.get(...)``, or a subscript guarded by a
``.get`` of the same key), because journals accumulate across server
generations and an old record carries none of the new keys. Drift in
either direction is how a "compatible" change silently orphans every
pre-upgrade journal.

This module is the GL003 schema-sharing pattern applied to durability:
the writer sites (``tier._submit_event`` and friends), the replay
readers (``tier._replay`` / ``_replay_foreign``), the
``journal-compat`` graftlint rule (GL015), the registry-generated
mixed-version replay test, and the crashsim journal scenario all draw
from THESE name sets — one source, shared, so the static gate, the
runtime gate, and the code provably cannot drift apart.

Stdlib-only and import-light on purpose: graftlint loads this file
directly (``importlib`` from source path, the ``validate_trace.py``
discipline), so it must never grow a jax/numpy import.
"""

from __future__ import annotations

# Journal event kinds (the "e" key's closed value set). One line per
# event per state transition, append-only; replay folds them in order.
JOURNAL_EVENT_KINDS = ("submit", "start", "done", "fail")

# Keys a reader may assume present and subscript directly. "e" and
# "id" have ridden every event since round 6; "spec" rides every
# submit since round 6 (readers subscript it inside a tolerant
# try/except that drops the record loudly — a submit without a spec
# is corruption, not version skew).
JOURNAL_REQUIRED_KEYS = frozenset({"e", "id", "spec"})

# Keys that joined after the first journal shipped (or are simply
# optional per event kind). Readers MUST access these tolerantly —
# ``e.get(k)`` or a subscript guarded by ``e.get(k)`` in the same
# statement — because pre-upgrade journals do not carry them:
#   seq/key/ts/rows/error  round 6 (per-kind optional)
#   trace                  round 16 (admission-minted trace id)
#   replica/fence          round 17 (replicated serving)
JOURNAL_OPTIONAL_KEYS = frozenset(
    {"seq", "key", "ts", "trace", "rows", "error", "replica", "fence"}
)

JOURNAL_KEYS = JOURNAL_REQUIRED_KEYS | JOURNAL_OPTIONAL_KEYS

# The serialized Job record (HTTP /jobs surface + the shared-store
# ``jobs/<id>`` index). "replica"/"fence" are stamped only by
# ``tier._index_put`` in replicated mode; "trace_id"/"error"/"result"
# are conditional — every consumer treats the whole record as a
# tolerant dict (``peer_job_record`` returns it verbatim).
JOB_RECORD_REQUIRED_KEYS = frozenset(
    {"id", "state", "tenant", "cached", "submitted_unix", "spec"}
)
JOB_RECORD_OPTIONAL_KEYS = frozenset(
    {"trace_id", "error", "result", "replica", "fence"}
)
JOB_RECORD_KEYS = JOB_RECORD_REQUIRED_KEYS | JOB_RECORD_OPTIONAL_KEYS
