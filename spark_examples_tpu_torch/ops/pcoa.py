"""Principal-coordinate analysis: eigendecomposition of the centered Gramian.

Reference pipeline (``VariantsPca.scala:224-231``): the double-centered rows
are wrapped in an MLlib ``RowMatrix`` and ``computePrincipalComponents(k)``
runs — which (a) forms the *covariance matrix of the rows* and (b)
eigendecomposes it on the driver via Breeze/LAPACK, returning the top-k
eigenvectors as an N×k matrix whose row i is emitted as sample i's
coordinates.

Equivalence used here: the double-centered matrix C is symmetric with
exactly-zero column means, so the covariance of its rows is
``cov = CᵀC/(n−1) = C²/(n−1)``. C² shares eigenvectors with C and squares
the eigenvalues, so MLlib's principal components are exactly the
eigenvectors of C ordered by **|λ| descending** — one ``eigh`` of C instead
of forming C². :func:`mllib_principal_components_reference` implements
MLlib's literal composition in numpy float64 and is the oracle the device
paths are held against (the 1e-4 parity bar, modulo eigenvector sign, which
is normalized deterministically here).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spark_examples_tpu_torch.ops.centering import double_center

__all__ = [
    "SpectralGapWarning",
    "check_spectral_gap",
    "mllib_principal_components_reference",
    "normalize_eigvec_signs",
    "pcoa",
    "principal_components",
    "topk_with_gap_check",
]


class SpectralGapWarning(UserWarning):
    """Top-k eigenvalue gap is near-degenerate; coordinates are unstable."""


def check_spectral_gap(vals, k: int, warn_ratio: float = 0.95, timer=None):
    """Warn loudly when the k-th eigen-gap is near-degenerate.

    ``vals`` are |λ|-ordered eigen/Ritz values with at least one entry past
    index k−1. A ratio |λ_{k+1}|/|λ_k| near 1 means the top-k eigenbasis is
    rotation-ambiguous: a weakly structured cohort has no well-defined
    PC2, and that must be loud, not silent. The ratio also lands in the
    stage-timer report when a ``timer`` (utils.tracing.StageTimer) is
    passed.
    """
    if len(vals) <= k:
        return  # caller could not supply a value past the gap
    lam_k, lam_next = abs(float(vals[k - 1])), abs(float(vals[k]))
    if lam_k == 0.0:
        return  # rank-deficient below k: coordinates there are zeros
    ratio = lam_next / lam_k
    if timer is not None:
        timer.note(f"spectral gap |λ{k + 1}|/|λ{k}| = {ratio:.4f}")
    if ratio > warn_ratio:
        warnings.warn(
            f"near-degenerate spectral gap: |λ{k + 1}|/|λ{k}| = {ratio:.4f}"
            f" > {warn_ratio}. The top-{k} eigenbasis is rotation-ambiguous"
            " (for dense eigh too) — principal coordinates beyond the"
            " well-separated eigenvalues are unstable on this cohort.",
            SpectralGapWarning,
            stacklevel=3,
        )


def topk_with_gap_check(eig_fn, k, n, timer=None, vals_are_squared=False):
    """Request k+1 eigenpairs, gap-check past k, slice back to k.

    ``eig_fn(kk)`` returns ``(coords (n, kk), vals (kk,))`` ordered by
    magnitude descending. ``vals_are_squared``: MLlib-literal covariance
    eigenvalues are λ(C)²/(n−1), so their ratio is the square of the
    centered-Gramian gap ratio — take the sqrt first so the 0.95 threshold
    means the same cohort everywhere.
    """
    coords, vals = eig_fn(min(k + 1, n))
    v = np.abs(np.asarray(vals, dtype=np.float64))
    if vals_are_squared:
        v = np.sqrt(v)
    check_spectral_gap(v, k, timer=timer)
    return coords[:, :k], vals[:k]


def normalize_eigvec_signs(vecs):
    """Deterministic sign convention: largest-|entry| of each column > 0.

    Eigenvector signs are arbitrary; LAPACK, cuSOLVER and XLA may disagree.
    Fixing the sign so the largest-magnitude component of each column is
    positive (ties broken by lowest row index) makes output stable across
    backends and is the convention the parity tests compare under. Takes
    a numpy array or a tensor and returns the same kind.
    """
    if isinstance(vecs, np.ndarray):
        idx = np.argmax(np.abs(vecs), axis=0)
        signs = np.sign(vecs[idx, np.arange(vecs.shape[1])])
        signs = np.where(signs == 0, 1.0, signs)
        return vecs * signs
    cols = torch.arange(vecs.shape[1], device=vecs.device)
    signs = torch.sign(vecs[vecs.abs().argmax(dim=0), cols])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return vecs * signs


def _symmetric(a: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.eigh symmetrizes its input; torch.linalg.eigh reads one
    # triangle. Symmetrize so both eigensolvers see the same matrix.
    return (a + a.T) / 2


def principal_components(c: torch.Tensor, k: int):
    """Top-k principal components of a double-centered symmetric matrix.

    Returns ``(coords, eigvals)``: ``coords`` is N×k (row i = sample i's
    coordinates), ``eigvals`` the corresponding eigenvalues of C, ordered
    by |λ| descending, signs normalized.
    """
    w, v = torch.linalg.eigh(_symmetric(c))
    order = torch.argsort(-w.abs(), stable=True)[:k]
    return normalize_eigvec_signs(v[:, order]), w[order]


def pcoa(g: torch.Tensor, k: int):
    """Full PCoA of a raw similarity Gramian: center → eigendecompose.

    Returns ``(coords, eigvals)`` as :func:`principal_components` does, on
    G's device: raw eigenvector entries, as the reference emits them.
    """
    return principal_components(double_center(g), k)


def mllib_principal_components_reference(g, k):
    """Literal numpy-f64 emulation of the reference math — the oracle.

    Mirrors ``VariantsPca.scala:198-231`` + MLlib ``RowMatrix
    .computePrincipalComponents``: double-center G, form the row covariance
    ``(CᵀC − n·μμᵀ)/(n−1)`` exactly as MLlib's ``computeCovariance`` does,
    eigendecompose, take top-k by eigenvalue descending, normalize signs.
    Runs on the host in float64 (``--precise``, and the oracle of the
    tests and of ``chip_smoke.py``).
    """
    g = np.asarray(g, dtype=np.float64)
    n = g.shape[0]
    rowmean = g.mean(axis=1, keepdims=True)
    colmean = g.mean(axis=0, keepdims=True)
    c = g - rowmean - colmean + g.mean()
    mu = c.mean(axis=0, keepdims=True)
    cov = (c.T @ c - n * (mu.T @ mu)) / (n - 1)
    w, v = np.linalg.eigh(cov)
    order = np.argsort(-w)[:k]
    return normalize_eigvec_signs(v[:, order]), w[order]
