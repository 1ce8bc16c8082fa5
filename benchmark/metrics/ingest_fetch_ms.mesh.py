"""``ingest_fetch_ms`` in ``ukb200k.mesh``: the same reading, by the reader in
``ingest_fetch_ms.py``. The mesh's sparse jobs read the sidecar through
``jsonl.stream_carrying_csr``, and that cell reports ``job_s``, which it moves
there. Layer: sidecar."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "ingest_fetch_ms.py"))["read"]
