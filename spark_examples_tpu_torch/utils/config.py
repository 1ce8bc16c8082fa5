"""Flag system: the ``pca`` subcommand's configuration.

The JAX package's ``PcaConfig`` / ``add_pca_flags`` cut to what this slice
of the port serves (GenomicsConf/PcaConf parity, ``GenomicsConf.scala:31-101``):
every field and flag here keeps the JAX package's name and default. Options
of routes not ported yet (meshes, checkpoints, file and network sources,
the dense and sketch engines) are accepted and then refused with
``NotImplementedError`` naming the ROADMAP.md item that ports them, never
silently ignored. ``--device`` is the port's own: ``cuda`` by default,
``cpu`` only when asked.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import List, Optional

from spark_examples_tpu_torch.arrays.blocks import DEFAULT_BLOCK_VARIANTS
from spark_examples_tpu_torch.device import DEFAULT_DEVICE
from spark_examples_tpu_torch.genomics.shards import (
    BRCA1_REFERENCES,
    DEFAULT_BASES_PER_SHARD,
    SexChromosomeFilter,
    Shard,
    shards_for_all_references,
    shards_for_references,
)
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
)

__all__ = [
    "PCA_MODES",
    "PcaConfig",
    "add_pca_flags",
    "pca_config_from_args",
    "unported",
]

# The JAX package's --pca-mode registry. This slice serves "sparse".
PCA_MODES = ("auto", "fused", "stream", "sparse", "sketch")

# Reference well-known variantset id (SearchVariantsExample.scala:27-31).
PLATINUM_GENOMES = "3049512673186936334"


def unported(what: str, item: str) -> NotImplementedError:
    """The error every not-yet-ported option raises."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, Queue 1: {item})"
    )


@dataclass
class PcaConfig:
    bases_per_partition: int = DEFAULT_BASES_PER_SHARD
    output_path: Optional[str] = None
    references: str = BRCA1_REFERENCES
    variant_set_ids: List[str] = field(
        default_factory=lambda: [PLATINUM_GENOMES]
    )
    mesh_shape: Optional[str] = None
    block_variants: int = DEFAULT_BLOCK_VARIANTS
    all_references: bool = False
    debug_datasets: bool = False
    min_allele_frequency: Optional[float] = None
    num_pc: int = 2
    precise: bool = False  # host-f64 eigendecomposition
    pca_mode: str = "auto"
    # Dense/sparse switch of the sparse Gramian: a window whose carrier
    # density is strictly below this scatters, at or above it goes dense.
    sparse_density_threshold: float = DEFAULT_SPARSE_DENSITY_THRESHOLD
    checkpoint_dir: Optional[str] = None
    # N above which the finish uses dense eigh instead of the fused
    # subspace iteration.
    dense_eigh_limit: int = 8192
    # Convergence target of the fused finish (None = its default 1e-3).
    eig_tol: Optional[float] = None
    device: str = DEFAULT_DEVICE

    def shards(
        self,
        all_references: bool = False,
        sex_filter: SexChromosomeFilter = SexChromosomeFilter.EXCLUDE_XY,
    ) -> List[Shard]:
        """Partitioner selection — PcaConf.getPartitioner
        (GenomicsConf.scala:92-100)."""
        if all_references:
            return shards_for_all_references(
                sex_filter, self.bases_per_partition
            )
        return shards_for_references(
            self.references, self.bases_per_partition
        )


def add_pca_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--bases-per-partition",
        type=int,
        default=DEFAULT_BASES_PER_SHARD,
        help="Partition each reference using a fixed number of bases",
    )
    p.add_argument(
        "--api-url",
        default=None,
        help="Genomics-compatible HTTP service (not ported yet)",
    )
    p.add_argument(
        "--input-path",
        default=None,
        help="JSONL cohort directory (not ported yet)",
    )
    p.add_argument("--output-path", default=None)
    p.add_argument(
        "--references",
        default=BRCA1_REFERENCES,
        help="Comma separated tuples of reference:start:end",
    )
    p.add_argument(
        "--variant-set-id",
        action="append",
        dest="variant_set_ids",
        default=None,
        help="VariantSet id (one dataset in this slice)",
    )
    p.add_argument(
        "--mesh-shape", default=None, help="Device mesh (not ported yet)"
    )
    p.add_argument(
        "--block-variants", type=int, default=DEFAULT_BLOCK_VARIANTS
    )
    p.add_argument(
        "--all-references",
        action="store_true",
        help="Use all the autosomes (overrides --references)",
    )
    p.add_argument("--debug-datasets", action="store_true")
    p.add_argument("--min-allele-frequency", type=float, default=None)
    p.add_argument("--num-pc", type=int, default=2)
    p.add_argument(
        "--precise",
        action="store_true",
        help="Eigendecompose on host in float64 (Breeze/LAPACK analog)",
    )
    p.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Gramian snapshots (not ported yet)",
    )
    p.add_argument(
        "--dense-eigh-limit",
        type=int,
        default=8192,
        help="N above which the finish uses dense eigh instead of the "
        "fused subspace iteration",
    )
    p.add_argument(
        "--pca-mode",
        choices=PCA_MODES,
        default="auto",
        help="PCA pipeline route; this slice serves 'sparse': sparse-aware "
        "Gramian accumulation straight from CSR carrier windows (a "
        "hand-written CUDA scatter for rare windows, an int8 product for "
        "dense ones) and the fused finish",
    )
    p.add_argument(
        "--sparse-density-threshold",
        type=float,
        default=PcaConfig.sparse_density_threshold,
        help="Windows with carrier density strictly below this scatter, "
        "at or above it they densify onto the int8 product; results are "
        "bit-identical either way",
    )
    p.add_argument(
        "--eig-tol",
        type=float,
        default=None,
        help="Fused-finish convergence target |Cv - lv|/|l| per top-k "
        "pair (default 1e-3): above it the sweep retries with doubled "
        "iterations, then warns",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default=DEFAULT_DEVICE,
        help="Device the run computes on: 'cuda' (default; fails without "
        "a card) or 'cpu'",
    )


def pca_config_from_args(args: argparse.Namespace) -> PcaConfig:
    kwargs = {
        f: getattr(args, f)
        for f in PcaConfig.__dataclass_fields__
        if hasattr(args, f)
    }
    if kwargs.get("variant_set_ids") is None:
        kwargs.pop("variant_set_ids", None)
    return PcaConfig(**kwargs)
