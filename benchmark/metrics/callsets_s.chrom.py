"""``callsets_s`` in ``kg1000.chrom``: the same reading, by the reader in
``callsets_s.py``. That cell reports no ``job_s``, so there it moves
``peak_card_mib``. Layer: driver and callsets."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "callsets_s.py"))["read"]
