"""``shard_wait_ms`` in ``kg1000.chrom``: the same reading, by the reader in
``shard_wait_ms.py``. That cell reports no ``job_s``, so there it moves
``peak_card_mib``. Layer: sidecar."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "shard_wait_ms.py"))["read"]
