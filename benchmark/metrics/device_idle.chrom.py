"""``device_idle`` in ``kg1000.chrom``: the same reading, by the reader in
``device_idle.py``. That cell reports no ``job_s``, so there it moves
``peak_card_mib``. Layer: device."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "device_idle.py"))["read"]
