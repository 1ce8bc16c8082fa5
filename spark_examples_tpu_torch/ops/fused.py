"""Fused PCoA: streamed packed accumulation + the finish on the device.

The shipped composition of the JAX package's ``ops/fused.py`` (its
``bench.py`` calls it the north star): 0/1 blocks are bit-packed on the host
inside the feed's producer thread, copied through the double-buffered
pinned feed, accumulated as ``G += unpack(chunk) @ unpack(chunk).T`` in
place (:func:`pcoa_fused_blocks`, :func:`pcoa_fused_packed`), and then
:func:`fused_finish` runs centering → CholeskyQR subspace eig → row sums on
the device. :func:`fused_forward` is the same composition for one block
held whole.

The finish consumes the finished (N, N) G on its device and returns the
top-k principal coordinates. The top-k
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
from spark_examples_tpu_torch.ops.gramian import (
    gramian_blockwise,
    mxu_cross_product,
)
from spark_examples_tpu_torch.ops.pcoa import (
    _symmetric,
    check_spectral_gap,
    normalize_eigvec_signs,
)

__all__ = [
    "EigResidualWarning",
    "fused_finish",
    "fused_forward",
    "pcoa_fused_blocks",
    "pcoa_fused_packed",
    "subspace_eig_cholqr",
]

# The sweep defaults of the JAX package's fused finish.
_DEF_OVERSAMPLE = 8
_DEF_ITERS = 40
# A top-k Ritz vector whose norm is further than this from 1 marks a
# collapsed panel. An orthonormal float32 panel is within ~1e-6.
RITZ_NORM_TOL = 1e-2


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
    computed from the final products (no extra O(N²) work), and NaN when
    a top-k Ritz vector is not unit norm (a collapsed panel). The start
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
    # A rank-deficient panel can factorize here (the jitter keeps the
    # Cholesky finite) where the JAX package's Cholesky returns NaN; its
    # dropped directions then come back as top-k Ritz vectors far from
    # unit norm (a zero column at N = 2), each with a zero residual. That
    # is the same collapse: mark it non-finite so the caller raises (and
    # the driver falls back to dense eigh) as the reference does.
    norm_dev = (torch.linalg.vector_norm(q @ uk, dim=0) - 1.0).abs().max()
    resid = torch.where(
        norm_dev > RITZ_NORM_TOL, torch.full_like(resid, float("nan")), resid
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


def fused_forward(x, k: int = 2, device=DEFAULT_DEVICE) -> torch.Tensor:
    """The shipped composition as one function on ``device``.

    int8 0/1 indicators (N, V) → int8 Gramian → the fused finish
    (centering + CholeskyQR subspace eig) → (N, k) coordinates, with the
    sweep defaults ``--pca-mode auto`` runs: the composition the JAX
    package's driver contract (``__graft_entry__.entry``) certifies.
    ``x`` (a tensor or array) is moved to ``device``, the card unless the
    caller passes ``"cpu"``; the coordinates stay there.
    """
    x = torch.as_tensor(x).to(resolve_device(device))
    g = mxu_cross_product(x, torch.float32, torch.int8)
    vecs, _, _, _ = _finish(g, k, _DEF_OVERSAMPLE, _DEF_ITERS, 0)
    return vecs[:, :k]


def pcoa_fused_blocks(
    blocks,
    n_samples: int,
    k: int,
    oversample: int = _DEF_OVERSAMPLE,
    iters: int = _DEF_ITERS,
    seed: int = 0,
    compute_dtype=None,
    device=DEFAULT_DEVICE,
    timer=None,
):
    """0/1 indicator blocks → top-k principal coordinates, fully fused.

    The blocks stream through the bit-packed double-buffered accumulator
    (:func:`~spark_examples_tpu_torch.ops.gramian.gramian_blockwise` with
    ``packed=True`` — pack, copy and product overlap; G accumulates in
    place), then :func:`fused_finish` runs on the device. The variant axis
    is unbounded: the device holds G plus a few block transients, never
    the cohort.

    Returns ``(coords (N, k), vals (k,), row_sums (N,))`` as numpy.
    """
    g = gramian_blockwise(
        blocks,
        n_samples,
        packed=True,
        compute_dtype=compute_dtype,
        device=device,
    )
    return fused_finish(
        g, k, oversample=oversample, iters=iters, seed=seed, timer=timer,
        device=device,
    )


def pcoa_fused_packed(
    x_packed: np.ndarray,
    n_bits: int,
    k: int,
    chunk_bits: int = 65536,
    oversample: int = _DEF_OVERSAMPLE,
    iters: int = _DEF_ITERS,
    seed: int = 0,
    compute_dtype=None,
    device=DEFAULT_DEVICE,
    timer=None,
):
    """Packed ``(N, ⌈V/8⌉)`` uint8 indicator matrix → top-k coordinates.

    The packed variant axis is cut into ``chunk_bits``-wide pieces (the
    last zero-padded: zero bytes unpack to inert zero columns) which
    stream through the feed into in-place accumulate steps, then one
    :func:`fused_finish`. ``n_bits`` is V, the true variant count.

    Returns ``(coords (N, k), vals (k,))`` — the semantics of
    ``pcoa(gramian(X), k)``.
    """
    x_packed = np.asarray(x_packed)
    chunk_bits = int(min(chunk_bits, max(8, n_bits)))
    chunk_bytes = (chunk_bits + 7) // 8

    def chunks():
        for off in range(0, x_packed.shape[1], chunk_bytes):
            piece = x_packed[:, off : off + chunk_bytes]
            if piece.shape[1] != chunk_bytes:
                piece = np.pad(
                    piece, ((0, 0), (0, chunk_bytes - piece.shape[1]))
                )
            yield piece

    g = gramian_blockwise(
        chunks(),
        x_packed.shape[0],
        packed=True,
        prepacked=True,
        compute_dtype=compute_dtype,
        device=device,
    )
    coords, vals, _ = fused_finish(
        g, k, oversample=oversample, iters=iters, seed=seed, timer=timer,
        device=device,
    )
    return coords, vals
