"""Mesh and process group: the distributed substrate.

The reference's Spark runtime surface (shuffle, broadcast, accumulators,
driver collects) becomes explicit copies and sums over a grid of devices
(:mod:`~spark_examples_tpu_torch.parallel.mesh`,
:mod:`~spark_examples_tpu_torch.parallel.sharded`) and, across processes,
``torch.distributed`` collectives
(:mod:`~spark_examples_tpu_torch.parallel.distributed`) and, for a pod's
sparse stream, a host TCP exchange
(:mod:`~spark_examples_tpu_torch.parallel.podstream`). A grid may span the
processes of one group: the pod regime.

Axis conventions, the JAX package's:

- ``"data"`` — the variant axis: blocks are split across it and partial
  Gramians summed. G's rows are split across it too.
- ``"model"`` — the sample axis: G's columns are split across it when N is
  large (the sample-sharded tile grid).
"""

from spark_examples_tpu_torch.parallel.distributed import (
    allreduce_gramian,
    allreduce_host_stats,
    initialize_from_env,
    is_coordinator,
    process_count,
    process_index,
)
from spark_examples_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    mesh_spans_processes,
)
from spark_examples_tpu_torch.parallel.sharded import (
    ShardedGramian,
    SpectralGapWarning,
    addressable_sample_bounds,
    gramian_blockwise_global,
    gramian_variant_parallel,
    gramian_variant_parallel_ring,
    sample_bounds_of_indices,
    sharded_gramian_blockwise,
    sharded_pcoa,
    sparse_sharded_gramian_blockwise,
    topk_eig_randomized,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "ShardedGramian",
    "SpectralGapWarning",
    "addressable_sample_bounds",
    "allreduce_gramian",
    "allreduce_host_stats",
    "gramian_blockwise_global",
    "gramian_variant_parallel",
    "gramian_variant_parallel_ring",
    "initialize_from_env",
    "is_coordinator",
    "make_mesh",
    "mesh_spans_processes",
    "process_count",
    "process_index",
    "sample_bounds_of_indices",
    "sharded_gramian_blockwise",
    "sharded_pcoa",
    "sparse_sharded_gramian_blockwise",
    "topk_eig_randomized",
]
