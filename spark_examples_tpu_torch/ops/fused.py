"""Fused PCoA finish: centering → CholeskyQR subspace eig → row sums.

The finish half of the sparse route: it consumes the finished (N, N) G on
its device and returns the top-k principal coordinates. The top-k
eigendecomposition is randomized subspace iteration with **CholeskyQR**
panel orthonormalization: two matrix products plus a (p, p) Cholesky and a
triangular solve per sweep — numerically fine here because panels are
re-orthonormalized every iteration and PCoA spectra are mild.
Convergence is *checked*, not assumed: the finish computes the top-k Ritz
residuals ``‖C·v − λ·v‖/|λ|`` from its own final products, retries with
doubled iterations above the bar, and then warns loudly
(:class:`EigResidualWarning`).

Semantics match :func:`spark_examples_tpu_torch.ops.pcoa.pcoa`: raw
sign-normalized eigenvectors of the double-centered Gramian ordered by |λ|
descending. Float32 products run at full precision: resolving a CUDA
device turns TF32 off (:mod:`spark_examples_tpu_torch.device`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.ops.centering import double_center
from spark_examples_tpu_torch.ops.pcoa import (
    _symmetric,
    check_spectral_gap,
    normalize_eigvec_signs,
)

__all__ = [
    "EigResidualWarning",
    "fused_finish",
    "subspace_eig_cholqr",
]

# The sweep defaults of the JAX package's fused finish.
_DEF_OVERSAMPLE = 8
_DEF_ITERS = 40


class EigResidualWarning(UserWarning):
    """Subspace iteration left a top-k Ritz residual above the bar."""


def subspace_eig_cholqr(
    c: torch.Tensor,
    k: int,
    oversample: int = 8,
    iters: int = 16,
    seed: int = 0,
    q0=None,
):
    """Top-|λ| eigenpairs of symmetric ``c``.

    Returns ``(vecs (N, p), vals (p,), resid ())`` tensors on ``c``'s
    device with ``p = min(N, k+oversample)``, |λ|-ordered and
    sign-normalized; ``resid`` is the max top-k relative Ritz residual
    computed from the final products (no extra O(N²) work). The start
    panel is ``q0`` when given (an (N, p) array), else standard normal
    draws from a CPU ``torch.Generator`` seeded by ``seed``, so the same
    seed starts from the same panel on either device.
    """
    n = c.shape[0]
    p = min(n, k + oversample)
    if q0 is None:
        gen = torch.Generator().manual_seed(seed)
        q0 = torch.randn((n, p), generator=gen, dtype=c.dtype)
    q = torch.as_tensor(q0, dtype=c.dtype).to(c.device)
    eye = torch.eye(p, dtype=c.dtype, device=c.device)
    eps = torch.finfo(c.dtype).eps
    tiny = torch.finfo(c.dtype).tiny
    for _ in range(iters):
        y = c @ q
        # CholeskyQR: orthonormalize through the (p, p) Gram factor. The
        # jitter is scale-relative (eps · mean column norm²) plus a tiny
        # absolute floor for the all-zero-C edge, so near-rank-deficient
        # panels stay factorizable.
        yty = y.T @ y
        jitter = eps * (torch.trace(yty) / p) + tiny
        # A factorization that fails marks the panel non-finite instead of
        # raising, as the JAX package's Cholesky does: the caller turns a
        # collapsed panel into FloatingPointError (and the driver into the
        # dense-eigh fallback). No host sync.
        r, info = torch.linalg.cholesky_ex(yty + jitter * eye)
        r = torch.where(info == 0, r, torch.full_like(r, float("nan")))
        # q = y · r⁻ᵀ, so qᵀq = r⁻¹(yᵀy)r⁻ᵀ = I.
        q = torch.linalg.solve_triangular(r.T, y, upper=True, left=False)
    y = c @ q
    w, u = torch.linalg.eigh(_symmetric(q.T @ y))
    order = torch.argsort(-w.abs(), stable=True)
    vecs = q @ u[:, order]
    vals = w[order]
    # Top-k Ritz residuals from the products already in hand:
    # C·v = (C·q)·u = y·u, so ‖C·v − λ·v‖ needs no new O(N²) product.
    uk, wk = u[:, order[:k]], vals[:k]
    rk = y @ uk - (q @ uk) * wk
    resid = torch.max(
        torch.linalg.vector_norm(rk, dim=0) / torch.clamp(wk.abs(), min=tiny)
    )
    return normalize_eigvec_signs(vecs), vals, resid


def _finish(g: torch.Tensor, k: int, oversample: int, iters: int, seed: int):
    """Center → subspace eig → row sums, all on G's device. The row sums
    of G feed the "Non zero rows" parity print (VariantsPca.scala:207-208).
    Returns ``(vecs, vals, resid, row_sums)`` as tensors."""
    gf = g.float()
    row_sums = gf.sum(dim=1)
    vecs, vals, resid = subspace_eig_cholqr(
        double_center(gf), k, oversample=oversample, iters=iters, seed=seed
    )
    return vecs, vals, resid, row_sums


def fused_finish(
    g,
    k: int,
    oversample: int = _DEF_OVERSAMPLE,
    iters: int = _DEF_ITERS,
    seed: int = 0,
    timer=None,
    resid_warn: float = 1e-3,
    max_retries: int = 1,
    device=DEFAULT_DEVICE,
):
    """(N, N) Gramian → top-k principal coordinates on ``device``.

    ``resid_warn`` is a CONVERGENCE TARGET, not just a warning bar (the
    driver threads ``--eig-tol`` into it): when the max top-k relative
    Ritz residual exceeds it, the sweep re-runs with doubled iterations
    up to ``max_retries`` times before warning loudly. Eigenvector error
    is O(resid / gap). A non-finite result (a collapsed panel on a
    numerically degenerate G) raises ``FloatingPointError``.

    Returns numpy ``(coords (N, k), vals (k,) float64, row_sums (N,))``.
    """
    gd = torch.as_tensor(g).to(resolve_device(device))
    for attempt in range(max_retries + 1):
        run_iters = iters << attempt
        try:
            vecs, vals, resid, row_sums = _finish(
                gd, k, oversample, run_iters, seed
            )
        except torch.linalg.LinAlgError as e:
            # A collapsed (non-finite) panel can make the final eigh fail
            # outright instead of returning NaN: the same degenerate case.
            raise FloatingPointError(
                f"fused eigendecomposition failed ({e}); the cohort's "
                "centered Gramian is numerically degenerate — rerun with "
                "--precise"
            ) from e
        resid = float(resid)
        if not np.isfinite(resid):
            # Panel collapse is deterministic for a given (G, seed):
            # retrying with doubled iterations would produce the same NaN.
            break
        if resid <= resid_warn:
            break
        if attempt < max_retries and timer is not None:
            timer.note(
                f"fused eig residual {resid:.2e} > {resid_warn:g} "
                f"after {run_iters} iterations — retrying doubled"
            )
    vecs = vecs.cpu().numpy()
    row_sums = row_sums.cpu().numpy()
    vals = vals.cpu().numpy().astype(np.float64)
    if not np.isfinite(vals).all() or not np.isfinite(resid):
        raise FloatingPointError(
            "fused eigendecomposition produced non-finite Ritz values "
            f"(vals={vals[: k + 1]}, resid={resid}); the cohort's "
            "centered Gramian is numerically degenerate — rerun with "
            "--precise"
        )
    if timer is not None:
        timer.note(
            f"fused eig residual {resid:.2e} ({run_iters} iterations)"
        )
    if resid > resid_warn:
        warnings.warn(
            f"fused subspace iteration residual {resid:.2e} exceeds "
            f"{resid_warn:g} after {run_iters} iterations — coordinates "
            "may not have converged to dense-eigh accuracy on this "
            "cohort; use --precise to cross-check",
            EigResidualWarning,
            stacklevel=2,
        )
    check_spectral_gap(vals, k, timer=timer)
    return vecs[:, :k], vals[:k], row_sums
