"""The plain reference: what a job should produce, worked out again from
the generated carrier lists, in float64, with plain PyTorch, NumPy and
SciPy. It imports nothing of the port and takes nothing the port made.

- ``gramian``: G = X·Xᵀ of the job's sites, X the 0/1 carrier matrix,
  summed block by block in float64 (every count is an exact integer).
- ``coordinates``: the reference's PCoA (``VariantsPca.scala`` with
  MLlib's ``computePrincipalComponents``): double-center G (C = H·G·H);
  C's column means are zero, so MLlib's covariance is C²/(n−1), whose
  eigenvectors are C's; the top k by eigenvalue, each column's sign fixed
  so its largest-magnitude entry (the first, on ties) is positive.
- ``sketch_panel`` and ``sketch_coordinates``: the randomized engine's
  panel Y = H·X·Xᵀ·Ω̃ (Ω̃ = H·Ω) and row sums X·Xᵀ·1, from Ω drawn as
  ``--sketch-seed`` documents it (``numpy.random.default_rng(seed)
  .standard_normal((n, l))`` in float32, l = k + oversample), then the
  shifted Nyström finish on that panel.

``control=True`` computes each in bfloat16 in place of float64: G summed in
bfloat16, the centered G and the eigenvectors held in bfloat16, the
panel's two products and its row sums rounded to bfloat16. That is the precision step below
the configuration's float32, and it has to fail the comparison.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse
import torch

__all__ = [
    "coordinates",
    "gramian",
    "sign_normalized",
    "sketch_coordinates",
    "sketch_omega",
    "sketch_panel",
]

_BLOCK_SITES = 8192


def gramian(cohort, lo: int, hi: int, device="cpu", control=False):
    """(n, n) G of sites [lo, hi) on ``device``: float64, or bfloat16 sums
    with ``control``."""
    n = cohort.n
    dtype = torch.bfloat16 if control else torch.float64
    g = torch.zeros((n, n), dtype=dtype, device=device)
    for b0 in range(lo, hi, _BLOCK_SITES):
        b1 = min(b0 + _BLOCK_SITES, hi)
        a, b = int(cohort.offsets[b0]), int(cohort.offsets[b1])
        rows = torch.from_numpy(cohort.carriers[a:b]).to(device)
        cols = torch.from_numpy(
            np.repeat(np.arange(b1 - b0), np.diff(cohort.offsets[b0:b1 + 1]))
        ).to(device)
        x = torch.zeros((n, b1 - b0), dtype=dtype, device=device)
        x[rows, cols] = 1
        g += x @ x.T
    return g


def sign_normalized(vecs: np.ndarray) -> np.ndarray:
    idx = np.argmax(np.abs(vecs), axis=0)
    signs = np.sign(vecs[idx, np.arange(vecs.shape[1])])
    return vecs * np.where(signs == 0, 1.0, signs)


def coordinates(g: torch.Tensor, k: int, control=False) -> np.ndarray:
    """(n, k) principal coordinates of G, in float64; with ``control`` the
    centered G and the eigenvectors are held in bfloat16 (the eigensolve
    itself runs in float32, the lowest precision ``eigh`` takes)."""
    g = g.to(torch.float64)
    c = g - g.mean(0, keepdim=True) - g.mean(1, keepdim=True) + g.mean()
    if control:
        c = c.to(torch.bfloat16).to(torch.float32)
    vals, vecs = torch.linalg.eigh(c)
    order = torch.argsort(vals, descending=True)[:k]
    vecs = vecs[:, order]
    if control:
        vecs = vecs.to(torch.bfloat16)
    return sign_normalized(vecs.to(torch.float64).cpu().numpy())


def sketch_omega(n: int, width: int, seed: int) -> np.ndarray:
    """Ω as ``--sketch-seed`` documents its draw."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, width)).astype(np.float32)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float64).numpy()


def sketch_panel(cohort, lo: int, hi: int, width: int, seed: int,
                 control=False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(y, omega, row_sums)``: the centered panel H·X·Xᵀ·Ω̃, the centered
    test matrix Ω̃ and G's row sums, for sites [lo, hi)."""
    n = cohort.n
    a, b = int(cohort.offsets[lo]), int(cohort.offsets[hi])
    xt = scipy.sparse.csr_matrix(
        (np.ones(b - a), cohort.carriers[a:b], cohort.offsets[lo:hi + 1] - a),
        shape=(hi - lo, n),
    )  # Xᵀ: a row per site
    omega = sketch_omega(n, width, seed).astype(np.float64)
    omega -= omega.mean(0, keepdims=True)
    if control:
        t = _bf16(xt @ _bf16(omega))
        y = _bf16(xt.T @ t)
    else:
        y = xt.T @ (xt @ omega)
    y -= y.mean(0, keepdims=True)
    row_sums = xt.T @ np.asarray(xt.sum(axis=1)).ravel()
    if control:
        row_sums = _bf16(row_sums)
    return y, omega, row_sums


def sketch_coordinates(y: np.ndarray, omega: np.ndarray, k: int) -> np.ndarray:
    """The shifted Nyström eigensolve of a panel, in float64: with
    ν = √n·eps_f32·‖Y‖_F, Y_ν = Y + ν·Ω̃, Q·R = qr(Y_ν), B = sym(Ω̃ᵀ·Y_ν) =
    L·Lᵀ, U·Σ·Vᵀ = svd(R·L⁻ᵀ); the coordinates are Q·U's first k columns."""
    n = y.shape[0]
    nu = np.sqrt(n) * np.finfo(np.float32).eps * np.linalg.norm(y)
    y_nu = y + nu * omega
    q, r = np.linalg.qr(y_nu)
    bmat = omega.T @ y_nu
    bmat = (bmat + bmat.T) / 2.0
    jitter, eye = 0.0, np.eye(bmat.shape[0])
    for attempt in range(4):
        try:
            chol = np.linalg.cholesky(bmat + jitter * eye)
            break
        except np.linalg.LinAlgError:
            base = max(np.trace(bmat) / bmat.shape[0], nu, 1e-30)
            jitter = base * (1e-12 * 10 ** (2 * attempt))
    else:
        raise np.linalg.LinAlgError("the panel's core is not positive definite")
    m = np.linalg.solve(chol, r.T).T
    u, _, _ = np.linalg.svd(m)
    return sign_normalized((q @ u)[:, :k])
