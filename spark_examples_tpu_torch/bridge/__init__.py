"""The PcaBackend seam: delegate the dense math from any external driver.

The reference already factors its pipeline so the dense math is replaceable
— the PySpark twin drives the Scala ingest through py4j and hands row RDDs
back to the JVM for the eigendecomposition (``variants_pca.py:123-152``).
This package is that seam as a service: an external driver (the Scala
``VariantsPcaDriver``, or anything else) streams per-variant sample-index
lists — exactly the ``RDD[Seq[Int]]`` interface at
``VariantsPca.scala:153-168`` — and receives principal coordinates computed
on the card (or on the CPU when asked).
"""

from spark_examples_tpu_torch.bridge.backend import (
    PcaBackend,
    TorchPcaBackend,
    PcaBridgeServer,
    PcaBridgeClient,
    iter_call_batches,
)

__all__ = [
    "PcaBackend",
    "TorchPcaBackend",
    "PcaBridgeServer",
    "PcaBridgeClient",
    "iter_call_batches",
]
