"""Callset index: fixes the similarity-matrix dimension N up front.

``VariantsCommon.scala:38-50``: before any variant is read, the driver pages
through the callsets of every configured variantset, assigns each callset a
dense index 0..N−1 (in listing order across sets), and records
callsetId → sampleName. N is the Gramian dimension, fixed before ingest, so
every device tensor is allocated once at its final shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics.sources import VariantSource
from spark_examples_tpu_torch.utils.tracing import CALLSETS_INDEX

__all__ = ["CallsetIndex"]


@dataclass(frozen=True)
class CallsetIndex:
    indexes: Dict[str, int]  # callsetId → dense sample index
    names: Dict[str, str]  # callsetId → sample name

    @property
    def size(self) -> int:
        return len(self.indexes)

    @staticmethod
    def from_source(
        source: VariantSource, variant_set_ids: Sequence[str]
    ) -> "CallsetIndex":
        indexes: Dict[str, int] = {}
        names: Dict[str, str] = {}
        with obs.span(CALLSETS_INDEX):
            for vsid in variant_set_ids:
                for cs in source.list_callsets(vsid):
                    if cs.id not in indexes:
                        indexes[cs.id] = len(indexes)
                        names[cs.id] = cs.name
        print(f"Matrix size: {len(indexes)}")  # VariantsCommon.scala:48
        return CallsetIndex(indexes=indexes, names=names)

    def restricted(
        self,
        samples: Optional[Sequence[str]] = None,
        exclude_samples: Optional[Sequence[str]] = None,
    ) -> Tuple["CallsetIndex", np.ndarray]:
        """Cohort sample restriction → ``(sub_index, remap)``.

        ``samples`` keeps only the named callset ids (None = all);
        ``exclude_samples`` then drops ids. The restricted index
        preserves FULL-index listing order (so permuted sample lists
        are one cohort, and the dense numbering stays deterministic);
        ``remap`` maps full dense index → restricted dense index, with
        ``-1`` for dropped samples — the one array every ingest stream
        is filtered through. Unknown ids are a loud error, like the
        reference's unknown-callset hard error.
        """
        known = set(self.indexes)
        unknown = sorted(
            set(samples or ()) - known
        ) + sorted(set(exclude_samples or ()) - known)
        if unknown:
            raise ValueError(
                f"unknown sample callset id(s) in cohort restriction: "
                f"{unknown[:8]}{'...' if len(unknown) > 8 else ''}"
            )
        # None = all samples; an EXPLICIT empty list falls through to
        # the loud empty-cohort error below.
        keep = known if samples is None else set(samples)
        keep -= set(exclude_samples or ())
        if not keep:
            raise ValueError(
                "cohort restriction leaves no samples "
                "(samples minus exclude_samples is empty)"
            )
        remap = np.full(len(self.indexes), -1, dtype=np.int64)
        indexes: Dict[str, int] = {}
        names: Dict[str, str] = {}
        for cid, idx in sorted(
            self.indexes.items(), key=lambda kv: kv[1]
        ):
            if cid in keep:
                remap[idx] = len(indexes)
                indexes[cid] = len(indexes)
                names[cid] = self.names[cid]
        return CallsetIndex(indexes=indexes, names=names), remap

    def name_of_index(self) -> List[str]:
        """Dense index → sample name (for result emission)."""
        out = [""] * len(self.indexes)
        for cid, idx in self.indexes.items():
            out[idx] = self.names[cid]
        return out

    def callset_of_index(self) -> List[str]:
        out = [""] * len(self.indexes)
        for cid, idx in self.indexes.items():
            out[idx] = cid
        return out
