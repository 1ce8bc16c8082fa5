"""The PCoA pipeline driver on PyTorch: meshless ``--pca-mode sparse``.

The port of the JAX package's ``VariantsPcaDriver`` (the reference's
``VariantsPca.scala:36-246``) with the same stage surface — get_data /
filter_dataset / get_calls / ingest_gramian / compute_pca / emit_result /
report_io_stats — for a single-process, meshless, uncheckpointed run:

- ingest: per-variant carrier lists from the source (the fused fast path,
  or the staged Variant path under ``--debug-datasets``) grouped into CSR
  windows of ``--block-variants`` variants;
- Gramian: :func:`~spark_examples_tpu_torch.ops.sparse.
  sparse_gramian_blockwise` on the device — rare windows through the
  hand-written CUDA scatter kernel, dense ones through the int8 product;
- finish: the fused centering + CholeskyQR subspace eig for N ≤
  ``--dense-eigh-limit`` (dense ``eigh`` above it, or when the fused finish
  collapses on a degenerate G), or host float64 with ``--precise``;
- emission byte-format compatible with ``emitResult``
  (``VariantsPca.scala:233-246``): stdout ``name\\tdataset\\tpc1\\tpc2``
  sorted by name; ``--output-path`` writes ``<path>-pca.tsv`` lines
  ``name\\tpc1\\tpc2\\tdataset``.

Options of routes not ported yet raise ``NotImplementedError`` before any
ingest (:func:`spark_examples_tpu_torch.utils.config.unported`).
"""

from __future__ import annotations

import os
import warnings
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.arrays.blocks import windows_from_calls
from spark_examples_tpu_torch.device import resolve_device
from spark_examples_tpu_torch.genomics.callsets import CallsetIndex
from spark_examples_tpu_torch.genomics.datasets import af_filter, calls_stream
from spark_examples_tpu_torch.genomics.shards import SexChromosomeFilter
from spark_examples_tpu_torch.genomics.types import Variant
from spark_examples_tpu_torch.ops.fused import fused_finish
from spark_examples_tpu_torch.ops.pcoa import (
    mllib_principal_components_reference,
    pcoa,
    topk_with_gap_check,
)
from spark_examples_tpu_torch.ops.sparse import sparse_gramian_blockwise
from spark_examples_tpu_torch.utils.config import (
    PCA_MODES,
    PcaConfig,
    unported,
)
from spark_examples_tpu_torch.utils.tracing import StageTimer

__all__ = ["VariantsPcaDriver"]


class VariantsPcaDriver:
    def __init__(self, conf: PcaConfig, source, index=None):
        if conf.num_pc < 1:
            raise ValueError(f"--num-pc must be >= 1, got {conf.num_pc}")
        if conf.pca_mode not in PCA_MODES:
            allowed = ", ".join(repr(m) for m in PCA_MODES)
            raise ValueError(
                f"pca_mode must be one of {allowed}; got "
                f"{conf.pca_mode!r}"
            )
        if conf.sparse_density_threshold < 0:
            raise ValueError(
                "--sparse-density-threshold must be >= 0, got "
                f"{conf.sparse_density_threshold}"
            )
        if conf.pca_mode == "sketch":
            raise unported("--pca-mode sketch", "item 2, sketch engine")
        if conf.pca_mode != "sparse":
            raise unported(
                f"--pca-mode {conf.pca_mode}",
                "item 1, auto/fused/stream dense-blockwise ingest",
            )
        if conf.mesh_shape:
            raise unported("--mesh-shape", "item 5, the mesh layer")
        if conf.checkpoint_dir:
            raise unported(
                "--checkpoint-dir", "item 6, checkpoint/elastic/bridge"
            )
        if len(conf.variant_set_ids) != 1:
            raise unported(
                "multi-dataset join/merge",
                "item 8, JSONL/CSR/network sources",
            )
        self.conf = conf
        self.source = source
        self.device = resolve_device(conf.device)
        self.index = (
            index
            if index is not None
            else CallsetIndex.from_source(source, conf.variant_set_ids)
        )
        # Set by run(): the finished Gramian and the stage timings.
        self.g = None
        self.timer = None

    # -- stage 1: ingest -----------------------------------------------------

    def _manifest(self):
        """The shard manifest — the one place the partitioner parameters
        live."""
        return self.conf.shards(
            all_references=self.conf.all_references,
            sex_filter=SexChromosomeFilter.EXCLUDE_XY,
        )

    def get_data(self) -> List[Iterator[Variant]]:
        """One lazy variant stream per configured variantset (the analog
        of ``VariantsCommon.data``, VariantsCommon.scala:52-66)."""
        shards = self._manifest()

        def stream(vsid: str) -> Iterator[Variant]:
            for shard in shards:
                yield from self.source.stream_variants(vsid, shard)

        return [stream(vsid) for vsid in self.conf.variant_set_ids]

    # -- stage 2: filters ----------------------------------------------------

    def filter_dataset(self, data: Iterable[Variant]) -> Iterator[Variant]:
        if self.conf.min_allele_frequency is not None:
            print(f"Min allele frequency {self.conf.min_allele_frequency}.")
        return af_filter(data, self.conf.min_allele_frequency)

    # -- stage 3: calls ------------------------------------------------------

    def get_calls(
        self, streams: Sequence[Iterable[Variant]]
    ) -> Iterator[List[int]]:
        """Per-variant carrying-sample index lists (the RDD[Seq[Int]]
        interface at VariantsPca.scala:153-168)."""
        if self.conf.debug_datasets:
            streams = [self._debug_wrap(s) for s in streams]
        return calls_stream(list(streams), self.index.indexes)

    @staticmethod
    def _debug_wrap(stream):
        for v in stream:
            alt = "".join(v.alternate_bases or ())
            print(
                f"{v.contig}: ({v.start}, {v.end}) "
                f"ref={v.reference_bases or ''} alt={alt}"
            )
            yield v

    def _fused_ingest_possible(self) -> bool:
        """The fast path fuses ingest → AF filter → call extraction when
        nothing needs full Variant/Call records: no --debug-datasets
        printing, and a source that implements stream_carrying."""
        return not self.conf.debug_datasets and hasattr(
            self.source, "stream_carrying"
        )

    def get_calls_fused(self) -> Iterator[List[int]]:
        """Fused ingest: shards → carrying index lists in manifest order.
        Same observable behavior as get_data → filter_dataset → get_calls
        minus the per-call object materialization."""
        vsid = self.conf.variant_set_ids[0]
        if self.conf.min_allele_frequency is not None:
            print(
                f"Min allele frequency {self.conf.min_allele_frequency}."
            )
        for shard in self._manifest():
            yield from self.source.stream_carrying(
                vsid,
                shard,
                self.index.indexes,
                self.conf.min_allele_frequency,
            )

    # -- stage 4: the Gramian ------------------------------------------------

    def _cohort_windows(self):
        """The ingest tier's carrier lists as CSR windows of
        ``--block-variants`` variants (never densified blocks)."""
        if self._fused_ingest_possible():
            calls = self.get_calls_fused()
        else:
            calls = self.get_calls(
                [self.filter_dataset(d) for d in self.get_data()]
            )
        return windows_from_calls(calls, self.conf.block_variants)

    def _windows_to_gramian(self, windows):
        """CSR carrier windows → finished (N, N) G on the device, each
        window routed by density inside the sparse engine."""
        return sparse_gramian_blockwise(
            windows,
            self.index.size,
            density_threshold=self.conf.sparse_density_threshold,
            block_variants=self.conf.block_variants,
            device=self.device,
        )

    def _gramian_sparse(self):
        return self._windows_to_gramian(self._cohort_windows())

    def ingest_gramian(self):
        """Stages 1-4 as one call: the finished (N, N) float32 G tensor."""
        return self._gramian_sparse()

    # -- stage 5: eigendecomposition ----------------------------------------

    def _pca_fused_eligible(self) -> bool:
        """The fused finish serves N ≤ --dense-eigh-limit unless
        --precise asks for the host float64 route."""
        return (
            not self.conf.precise
            and self.index.size <= self.conf.dense_eigh_limit
        )

    def compute_pca(self, g, timer=None) -> List[Tuple[str, float, float]]:
        if self._pca_fused_eligible():
            kwargs = (
                {"resid_warn": self.conf.eig_tol}
                if self.conf.eig_tol is not None
                else {}
            )
            try:
                coords, _, row_sums = fused_finish(
                    g, self.conf.num_pc, timer=timer, device=self.device,
                    **kwargs,
                )
            except FloatingPointError as e:
                # The CholeskyQR panel collapses on numerically degenerate
                # centered Gramians; dense eigh handles rank deficiency
                # exactly, and N is ≤ --dense-eigh-limit here.
                warnings.warn(
                    "fused finish collapsed on a numerically "
                    f"degenerate centered Gramian ({e}); falling back "
                    "to the dense-eigh finish (exact on rank-deficient "
                    "spectra)"
                )
                if timer is not None:
                    timer.note(
                        "fused finish degenerate -> dense-eigh fallback"
                    )
            else:
                self._print_nonzero_rows(row_sums)
                return self._emit_tuples(coords)
        self._print_nonzero_rows(g.sum(dim=1).cpu().numpy())
        if self.conf.precise:
            gh = g.cpu().numpy()
            coords, _ = topk_with_gap_check(
                lambda kk: mllib_principal_components_reference(gh, kk),
                self.conf.num_pc,
                self.index.size,
                timer=timer,
                vals_are_squared=True,  # covariance eigenvalues = λ(C)²/(n−1)
            )
        else:

            def dense(kk):
                coords, vals = pcoa(g, kk)
                return coords.cpu().numpy(), vals.cpu().numpy()

            coords, _ = topk_with_gap_check(
                dense, self.conf.num_pc, self.index.size, timer=timer
            )
        return self._emit_tuples(coords)

    def _print_nonzero_rows(self, row_sums) -> None:
        nonzero = int((np.asarray(row_sums) > 0).sum())
        print(
            f"Non zero rows in matrix: {nonzero} / {self.index.size}."
        )  # VariantsPca.scala:207-208

    def _emit_tuples(self, coords) -> List[Tuple[str, float, float]]:
        coords = np.asarray(coords)
        callset_ids = self.index.callset_of_index()
        # The reference emits exactly two components regardless of --num-pc
        # (VariantsPca.scala:228-230: array(i), array(i + numRows)).
        pc2 = coords[:, 1] if coords.shape[1] > 1 else np.zeros(len(coords))
        return [
            (callset_ids[i], float(coords[i, 0]), float(pc2[i]))
            for i in range(self.index.size)
        ]

    # -- stage 6: emission ---------------------------------------------------

    def collect_result(
        self, result: Sequence[Tuple[str, float, float]]
    ) -> List[Tuple[str, float, float, str]]:
        """``emitResult``'s row shape — ``(name, pc1, pc2, dataset)``
        sorted by name — without the emission side effects."""
        return sorted(
            (
                self.index.names[cid],
                pc1,
                pc2,
                cid.split("-")[0],  # dataset label, VariantsPca.scala:235
            )
            for cid, pc1, pc2 in result
        )

    def emit_result(self, result: Sequence[Tuple[str, float, float]]) -> None:
        with_names = self.collect_result(result)
        for name, pc1, pc2, dataset in with_names:
            print(f"{name}\t{dataset}\t{pc1}\t{pc2}")
        if self.conf.output_path:
            path = self.conf.output_path + "-pca.tsv"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                for name, pc1, pc2, dataset in with_names:
                    f.write(f"{name}\t{pc1}\t{pc2}\t{dataset}\n")

    # -- observability -------------------------------------------------------

    def report_io_stats(self) -> None:
        stats = getattr(self.source, "stats", None)
        if stats is not None:
            print(stats.report())

    # -- orchestration -------------------------------------------------------

    def _sync(self) -> None:
        """Wait for the device, so a stage's wall-clock includes its
        device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> List[Tuple[str, float, float]]:
        """main() stage order — VariantsPca.scala:38-50. Keeps the
        finished Gramian (``self.g``) and the stage timer (``self.timer``)
        for callers that verify the run."""
        self.timer = timer = StageTimer()
        with timer.stage("ingest+gramian"):
            self.g = self.ingest_gramian()
            self._sync()
        with timer.stage("pca"):
            result = self.compute_pca(self.g, timer=timer)
        with timer.stage("emit"):
            self.emit_result(result)
        self.report_io_stats()
        print(timer.report())
        return result
