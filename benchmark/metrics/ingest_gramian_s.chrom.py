"""``ingest_gramian_s`` in ``kg1000.chrom``: the same reading, by the reader in
``ingest_gramian_s.py``. That cell reports no ``job_s``, so there it moves
``peak_card_mib``. Layer: ingest stage."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "ingest_gramian_s.py"))["read"]
