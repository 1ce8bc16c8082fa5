"""Double-centering (classical MDS / PCoA).

Reference semantics (``VariantsPca.scala:193-223``): row sums are collected
to the driver, broadcast back, and each entry is centered as

    c_ij = g_ij − rowMean_i − colMean_j + matrixMean

with ``matrixMean = ΣG / N²``: three reductions and one elementwise
expression on the tensor's device.
"""

from __future__ import annotations

import torch

__all__ = ["double_center"]


def double_center(g: torch.Tensor) -> torch.Tensor:
    """Center a (possibly non-symmetric) similarity matrix G.

    Returns C with ``C[i, j] = G[i, j] - rowmean[i] - colmean[j] + grandmean``
    in at least float32, as a new tensor. For symmetric G the result is
    symmetric with exactly-zero row/column means (up to float rounding) —
    the property the PCoA eigendecomposition relies on (see
    :mod:`spark_examples_tpu_torch.ops.pcoa`).
    """
    g = g.to(torch.promote_types(g.dtype, torch.float32))
    rowmean = g.mean(dim=1, keepdim=True)
    colmean = g.mean(dim=0, keepdim=True)
    return g - rowmean - colmean + g.mean()
