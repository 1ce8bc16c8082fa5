"""Gramian-free randomized sketch PCA: ``--pca-mode sketch``.

Every other engine accumulates the N×N co-occurrence Gramian G, which at
N = 2^20 samples is 4 TiB of float32. This one recovers the top-k
eigenpairs of the centered Gramian C = H·G·H (H the centering projector)
from streamed products alone, as the JAX package's ``ops/sketch.py`` does:

    C·Ω = Σ_w  H · X_w · (X_wᵀ · (H·Ω))

so each CSR carrier window adds ``Y += X_w · (X_wᵀ · Ω̃)`` with
``Ω̃ = Ω − colmean(Ω)`` (two window-sized products, never an N×N tile),
and the left centering is one column-mean subtraction of the final panel.
The sum over windows does not depend on their order.

Windows are routed by the sparse engine's own rule
(:func:`~spark_examples_tpu_torch.ops.sparse.window_route`):

- **scatter** (rare windows): per variant v, ``t_v = Σ_a Ω̃[carrier_a]``
  is gathered from the padded carrier matrix (the sentinel index N reads
  a zero row appended to Ω̃), then added back to every carrier row of Y.
  The reference does this with an XLA scatter; here it is
  ``index_put_(accumulate=True)`` over the window's real carriers only (no
  padded slot reaches Y), run with PyTorch's deterministic algorithms on,
  so it sorts its indices and adds duplicates in a fixed order on either
  device (the CPU's default kernel adds in parallel, in no fixed order):
  the same seed gives the same panel bits on every run. Work is chunked
  by :data:`SCATTER_CHUNK_VARIANTS` variants, so the gather transient is
  at most chunk·k_bucket·(l+1) elements.
- **dense** (common windows): the window is densified and bit-packed as
  the Gramian's dense route ships it, unpacked on the device to float32,
  and multiplied, ``Y += X·(Xᵀ·Ω̃)`` (float32 products, TF32 off).

Y accumulates in float32, as in the reference. A companion column of ones
on the first pass carries ``X·(Xᵀ·1)`` = G's row sums (integer counts,
exact below 2^24), so the "Non zero rows" print survives without G.

The finish is the reference's shifted Nyström eigensolve, on the host in
float64 numpy, line for line: on one panel it returns the reference's
coordinates bit for bit. With Y = C·Ω and shift ν = √n·eps_f32·‖Y‖_F,

    Y_ν = Y + ν·Ω;  Q·R = qr(Y_ν);  B = sym(Ωᵀ·Y_ν);  L = chol(B)
    U₁·Σ·Vᵀ = svd(R·L⁻ᵀ);  λ̂ = max(Σ² − ν, 0);  V̂ = Q·U₁

``power_iters`` re-streams the windows that many extra times with
Ω ← orth(Y) between passes. No engine here launches a hand-written
kernel: the reference's engine runs on XLA, not Pallas.

Tolerance contract (the reference's, held by the tests against the exact
spectrum at small N):

- full rank (l ≥ n): eigenvalues within ``SKETCH_FULLRANK_RTOL``
  relative, sign-normalized coordinates within ``SKETCH_FULLRANK_ATOL``;
- top k (l < n, ≥ 2 power iterations, a clear gap past k): within
  ``SKETCH_TOPK_RTOL`` and ``SKETCH_TOPK_ATOL``.

On a mesh (``--mesh-shape``) the panel and its finish are
:func:`~spark_examples_tpu_torch.parallel.sharded.sharded_sketch_panel` and
:func:`~spark_examples_tpu_torch.parallel.sharded.sharded_sketch_finish`
(a two-level TSQR over the mesh's row blocks): the panel carries ``mesh``
and :func:`sketch_eig` routes to that finish.

Ω is drawn by numpy from ``--sketch-seed``, so it is bit-identical to the
JAX package's, and a run is reproducible bit for bit from its seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.arrays.blocks import (
    DEFAULT_BLOCK_VARIANTS,
    _check_indices,
)
from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.ops.gramian import unpack_indicator_block
from spark_examples_tpu_torch.ops.pcoa import (
    DEFAULT_RANDOMIZED_OVERSAMPLE,
    DEFAULT_SKETCH_POWER_ITERS,
    check_spectral_gap,
    normalize_eigvec_signs,
    randomized_panel_width,
)
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
    SCATTER_CHUNK_VARIANTS,
    _carrier_operand,
    _dense_operand,
    dense_panel_width,
    window_route,
)
from spark_examples_tpu_torch.utils.tracing import (
    SKETCH_ACCUMULATE,
    SKETCH_FINISH,
    SKETCH_WINDOW,
)

__all__ = [
    "SKETCH_FULLRANK_ATOL",
    "SKETCH_FULLRANK_RTOL",
    "SKETCH_TOPK_ATOL",
    "SKETCH_TOPK_RTOL",
    "SKETCH_WINDOWS",
    "SketchPanel",
    "gaussian_test_matrix",
    "sketch_eig",
    "sketch_host_bytes",
    "sketch_panel_blockwise",
]

# The reference's tolerance contract (module docstring). Full rank: only
# f32 accumulation roundoff and the ν shift, orders below these bars.
SKETCH_FULLRANK_RTOL = 1e-3
SKETCH_FULLRANK_ATOL = 1e-3
# Top k: the randomized approximation error dominates; the bars hold for
# gapped spectra with ≥ 2 power iterations.
SKETCH_TOPK_RTOL = 5e-2
SKETCH_TOPK_ATOL = 5e-2

# Windows applied to a panel, by route, on either device.
SKETCH_WINDOWS = {"scatter": 0, "dense": 0}


def _note_sketch_window(route: str, count: int = 1) -> None:
    """Per-window sketch telemetry, the JAX package's counter."""
    obs.get_registry().counter(
        "sketch_windows_total",
        "CSR windows applied to the randomized sketch panel",
    ).labels(route=route).inc(count)


def sketch_host_bytes(n: int, l: int) -> int:
    """The engine's documented footprint bound: O(N·l) panels — Y (with
    its row-sums column), Ω and the centered Ω̃ in float32, and the
    float64 finish copies of Y and Ω — never O(N²)."""
    return 4 * n * (3 * (l + 1)) + 8 * n * (2 * l)


def gaussian_test_matrix(n: int, width: int, seed: int) -> np.ndarray:
    """Seeded (n, width) float32 Gaussian Ω, drawn by numpy exactly as the
    JAX package draws it (``--sketch-seed``)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, width)).astype(np.float32)


@dataclasses.dataclass
class SketchPanel:
    """What ``ingest_gramian`` returns under the sketch engine, in place of
    an (N, N) Gramian: host float64 arrays.

    ``y`` is the centered sketch C·Ω_final and ``omega`` the final test
    matrix (orth(Y) after power iterations, Ω̃ otherwise); ``row_sums``
    carries G's row sums from the first pass's companion column. A mesh
    run sets ``mesh`` (its panels carry ``n_padded`` rows, the padding
    zero), which routes the finish through
    :func:`~spark_examples_tpu_torch.parallel.sharded.sharded_sketch_finish`."""

    y: np.ndarray
    omega: np.ndarray
    row_sums: np.ndarray
    n: int
    k: int
    l: int
    seed: int
    power_iters: int
    mesh: object = None
    host_peak_bytes: int = 0


@contextlib.contextmanager
def _deterministic_algorithms():
    """PyTorch's deterministic algorithms for the scope, then the caller's
    setting back. The setting is process-wide: torch work of other threads
    during the scope runs under it too.

    This sets ATen's switch alone: ``torch.use_deterministic_algorithms``
    also sets the compiler's flag, and its first call in a process imports
    ``torch._inductor`` (2.5 s on an 8-core CPU host, 10 s a rank in a
    four-card pod's first window), which the port, compiling nothing,
    does not use."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch._C._set_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch._C._set_deterministic_algorithms(enabled, warn_only=warn_only)


def _sketch_scatter_update(
    y: torch.Tensor, omega: torch.Tensor, window_idx, lens
) -> None:
    """One scatter-route window into the panel, in place: ``Y += X·(Xᵀ·Ω̃)``
    without forming X.

    ``omega`` has N + 1 rows, the last all zeros: the padded carrier
    matrix's sentinel N gathers it. Per chunk of
    :data:`SCATTER_CHUNK_VARIANTS` variants, ``t_v`` sums variant v's
    carrier rows of Ω̃ (a fixed-order reduction), then
    ``index_put_(accumulate=True)`` adds ``t_v`` to each real carrier row
    of Y — sorted under deterministic algorithms, so the sum is the same
    on every run.
    """
    n = y.shape[0]
    dev = y.device
    idx = torch.from_numpy(_carrier_operand(window_idx, lens, n))
    idx = idx.to(dev).long()
    # The window's real (carrier, variant) pairs in CSR order: a chunk's
    # pairs are one contiguous run of them.
    offsets = np.concatenate([[0], np.cumsum(lens)])
    carriers = torch.from_numpy(np.asarray(window_idx, np.int64)).to(dev)
    local = np.repeat(
        np.arange(lens.size, dtype=np.int64) % SCATTER_CHUNK_VARIANTS, lens
    )
    local = torch.from_numpy(local).to(dev)
    with _deterministic_algorithms():
        for c0 in range(0, lens.size, SCATTER_CHUNK_VARIANTS):
            c1 = c0 + SCATTER_CHUNK_VARIANTS
            start, end = int(offsets[c0]), int(offsets[min(c1, lens.size)])
            if start == end:
                continue  # no carrier in this chunk
            t = omega[idx[c0:c1]].sum(dim=1)
            y.index_put_(
                (carriers[start:end],), t[local[start:end]], accumulate=True
            )


def _sketch_dense_update(
    y: torch.Tensor, omega: torch.Tensor, xp: torch.Tensor
) -> None:
    """One dense-route window, in place: unpack the bit-packed indicator
    panel to float32 and add ``X·(Xᵀ·Ω̃)``. ``omega`` is Ω̃'s N rows."""
    xb = unpack_indicator_block(xp, 8 * xp.shape[1]).to(y.dtype)
    y += xb @ (xb.T @ omega)


def _center_columns(panel: np.ndarray, n: int) -> np.ndarray:
    """Subtract per-column means over the n real rows; rows past n are
    zeroed back."""
    out = panel - panel[:n].mean(axis=0, keepdims=True)
    out[n:] = 0.0
    return out


def _augmented_omega(
    omega: np.ndarray, n: int, first_pass: bool
) -> np.ndarray:
    """The streamed right-hand panel: centered Ω̃ plus one companion
    column — ones on the first pass (its accumulation is G's row sums),
    zeros on power-iteration passes."""
    aug = np.zeros((omega.shape[0], omega.shape[1] + 1), omega.dtype)
    aug[:, :-1] = _center_columns(omega, n)
    if first_pass:
        aug[:n, -1] = 1.0
    return aug


def sketch_panel_blockwise(
    windows_factory: Callable[[], Iterable[Tuple[np.ndarray, np.ndarray]]],
    n_samples: int,
    k: int,
    oversample: Optional[int] = None,
    power_iters: Optional[int] = None,
    seed: int = 0,
    density_threshold: float = DEFAULT_SPARSE_DENSITY_THRESHOLD,
    block_variants: Optional[int] = None,
    device=DEFAULT_DEVICE,
    sharded: bool = False,
) -> SketchPanel:
    """Stream CSR carrier windows into an (N, k+p) sketch panel on
    ``device``: the meshless sketch engine.

    ``windows_factory`` returns a fresh ``(indices, lens)`` window
    iterator per call: each power iteration re-streams the cohort. The
    panel accumulates on the device; between passes and at the end it
    comes to the host in float64, where Ω ← orth(Y) and the centering run.
    In a process group each rank streams its manifest slice, and the
    ranks' partial panels are summed. ``sharded`` tags the accumulate
    spans as a host-local mesh's (the JAX attribute).
    """
    dev = resolve_device(device)
    if oversample is None:
        oversample = DEFAULT_RANDOMIZED_OVERSAMPLE
    if power_iters is None:
        power_iters = DEFAULT_SKETCH_POWER_ITERS
    width = block_variants or DEFAULT_BLOCK_VARIANTS
    l = randomized_panel_width(n_samples, k, oversample)
    omega0 = gaussian_test_matrix(n_samples, l, seed)
    omega_cur = omega0
    row_sums = np.zeros(n_samples, dtype=np.float64)
    y_host: Optional[np.ndarray] = None
    for p in range(power_iters + 1):
        first = p == 0
        om_dev = torch.zeros(
            (n_samples + 1, l + 1), dtype=torch.float32, device=dev
        )
        om_dev[:n_samples] = torch.from_numpy(
            _augmented_omega(omega_cur, n_samples, first_pass=first)
        )
        y = torch.zeros((n_samples, l + 1), dtype=torch.float32, device=dev)
        attrs = {"sharded": True} if sharded else {}
        with obs.span(
            SKETCH_ACCUMULATE, n=n_samples, l=l, sketch_pass=p, **attrs
        ):
            for window_idx, lens in windows_factory():
                lens = np.asarray(lens)
                window_idx = np.asarray(window_idx)
                _check_indices(window_idx, n_samples)
                route = window_route(lens, n_samples, density_threshold)
                with obs.span(
                    SKETCH_WINDOW,
                    route=route,
                    nnz=int(lens.sum()),
                    variants=int(lens.size),
                ):
                    if route == "scatter":
                        _sketch_scatter_update(y, om_dev, window_idx, lens)
                    else:
                        cols = dense_panel_width(int(lens.size), width)
                        xp = _dense_operand(
                            window_idx, lens, n_samples, cols, n_samples
                        )
                        _sketch_dense_update(
                            y,
                            om_dev[:n_samples],
                            torch.from_numpy(xp).to(dev),
                        )
                SKETCH_WINDOWS[route] += 1
                _note_sketch_window(route)
        y_np = _merge_partial_panels(y.cpu().numpy().astype(np.float64))
        if first:
            row_sums = y_np[:, -1].copy()
        y_host = _center_columns(y_np[:, :-1], n_samples)
        if p < power_iters:
            # Ω ← orth(Y): the next pass streams against an orthonormal
            # basis of the current range.
            q, _ = np.linalg.qr(y_host)
            omega_cur = q.astype(np.float32)
    omega_final = _center_columns(
        (omega_cur if power_iters else omega0).astype(np.float64), n_samples
    )
    return SketchPanel(
        y=y_host,
        omega=omega_final,
        row_sums=row_sums,
        n=n_samples,
        k=k,
        l=l,
        seed=seed,
        power_iters=power_iters,
        host_peak_bytes=sketch_host_bytes(n_samples, l),
    )


def _merge_partial_panels(y_np: np.ndarray) -> np.ndarray:
    """A data-parallel run's per-rank partial panels, summed over the
    process group (each rank streamed its manifest slice). The JAX
    package runs without 64-bit floats, so its merge is float32: the
    port's is too. Identity on one process."""
    from spark_examples_tpu_torch.parallel.distributed import (
        allreduce_gramian,
        process_count,
    )

    if process_count() == 1:
        return y_np
    return allreduce_gramian(y_np.astype(np.float32))


def _nystrom_core(
    r: np.ndarray, b: np.ndarray, nu: float
) -> Tuple[np.ndarray, np.ndarray]:
    """The (k+p)×(k+p) host float64 core: B's Cholesky whitening (with
    jitter retries), the small SVD, and the shift removal. Returns
    ``(u1, vals)`` with ``vals`` descending."""
    b = (b + b.T) / 2.0
    jitter = 0.0
    eye = np.eye(b.shape[0])
    for attempt in range(4):
        try:
            chol = np.linalg.cholesky(b + jitter * eye)
            break
        except np.linalg.LinAlgError:
            base = max(np.trace(b) / b.shape[0], nu, 1e-30)
            jitter = base * (1e-12 * 10 ** (2 * attempt))
    else:
        raise np.linalg.LinAlgError(
            "sketch core matrix B = sym(Omega^T Y_nu) is not positive "
            "definite after jitter retries — the sketch panel is "
            "numerically degenerate (all-zero cohort windows?)"
        )
    # m = R·L⁻ᵀ via one triangular solve: L·Z = Rᵀ ⇒ m = Zᵀ.
    m = np.linalg.solve(chol, r.T).T
    u1, s, _ = np.linalg.svd(m)
    vals = np.maximum(s * s - nu, 0.0)
    return u1, vals


def sketch_eig(
    panel: SketchPanel, k: int, timer=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenpairs of the centered Gramian from a sketch panel, on the
    host in float64.

    Returns ``(coords, vals)``: coords (n, k) sign-normalized unit
    eigenvector entries, the surface the exact finishes emit, and the k
    approximate eigenvalues. The spectral-gap check runs on the full
    l-wide Ritz spectrum, as every exact finish's does. A mesh panel's
    finish is the TSQR of
    :func:`~spark_examples_tpu_torch.parallel.sharded.sharded_sketch_finish`.
    """
    with obs.span(SKETCH_FINISH, n=panel.n, k=k, l=panel.l):
        if panel.mesh is not None:
            from spark_examples_tpu_torch.parallel.sharded import (
                sharded_sketch_finish,
            )

            coords, vals = sharded_sketch_finish(panel, k)
        else:
            y, omega = panel.y, panel.omega
            norm = float(np.linalg.norm(y))
            if norm == 0.0:
                # All-zero cohort: C = 0, every coordinate is 0.
                return np.zeros((panel.n, k)), np.zeros(k)
            nu = np.sqrt(panel.n) * np.finfo(np.float32).eps * norm
            y_nu = y + nu * omega
            q, r = np.linalg.qr(y_nu)
            b = omega.T @ y_nu
            u1, vals = _nystrom_core(r, b, nu)
            coords = q @ u1
        check_spectral_gap(vals, k, timer=timer)
        coords = normalize_eigvec_signs(coords[: panel.n, :k])
        return coords, vals[:k]
