"""Exact rank-k sample corrections for cached Gramians.

The JAX package's ``ops/delta.py`` on PyTorch. The serving tier's
incremental-delta path (``serving/deltas.py``): when a submitted cohort
differs from a cached one by a handful of samples, the cached G is
updated instead of re-accumulated. With X the full-cohort 0/1 indicator
matrix and S/A the target/ancestor sample sets:

- entries over ``S ∩ A`` are UNCHANGED (``G[i, j]`` depends only on
  samples i and j — the AF filter reads the variant record, never the
  cohort), so they GATHER from the cached G;
- rows/columns of added samples ``D = S \\ A`` are a rank-``|D|``
  correction ``C = Σ_v x_v^S (x_v^D)ᵀ`` over exactly the variants some
  touched sample carries — by a ±1 out-of-bounds-drop scatter for rare
  touched sets, by one int8 product for dense ones;
- removed samples contribute by OMISSION (their rows/columns simply do
  not gather); the signed scatter's ``sign=-1`` additionally subtracts a
  sample set's contributions in place, equal and opposite to ``sign=+1``.

Every update is an exact integer count in float32 (far below 2^24), so
the delta result is **bit-identical** to a from-scratch accumulation of
the target cohort and to the JAX package's corrections. The JAX package
runs the scatter as an XLA ``lax.scan`` of ``.at[].add(mode="drop")``
and the dense route as an XLA product — neither is a Pallas kernel — so
here both are torch ops on the correction's device: a ``bincount`` of
in-bounds pair positions, and the Gramian's ``torch._int_mm`` route
(:func:`~spark_examples_tpu_torch.ops.gramian.mxu_cross_product_pair`,
whose operand padding serves touched-column panels as narrow as one row).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_examples_tpu_torch.ops.gramian import mxu_cross_product_pair
from spark_examples_tpu_torch.ops.sparse import (
    DEFAULT_SPARSE_DENSITY_THRESHOLD,
    SCATTER_CHUNK_VARIANTS,
    _carrier_bucket,
    padded_carrier_matrix,
)

__all__ = [
    "delta_gramian",
    "sample_correction",
    "signed_scatter_pairs",
]

# Upper bound on the (variant, row carrier, column carrier) pair
# positions one scatter chunk materializes: the transient the JAX
# package bounds with its 256-variant scan chunk.
_PAIRS_PER_CHUNK = 1 << 24


def signed_scatter_pairs(acc, row_idx, col_idx, sign: int = 1):
    """``acc[row_idx[v,a], col_idx[v,b]] += sign`` for every (v, a, b),
    out-of-bounds indices dropped; ``acc`` is updated in place and
    returned.

    ``row_idx``/``col_idx`` are padded carrier matrices
    (``padded_carrier_matrix``) with matching variant axes, moved to
    ``acc``'s device. The in-bounds pair positions of a chunk of variants
    are counted with ``bincount`` (integer, so order-free) and the counts
    times ``sign`` are added to ``acc`` — the same exact integers as the
    JAX package's scan of ``.at[].add(mode="drop")``.
    """
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    if row_idx.shape[0] != col_idx.shape[0]:
        raise ValueError(
            f"row/col carrier matrices disagree on variants: "
            f"{row_idx.shape[0]} vs {col_idx.shape[0]}"
        )
    n_rows, n_cols = acc.shape
    rows = torch.as_tensor(row_idx).to(acc.device, torch.int64)
    cols = torch.as_tensor(col_idx).to(acc.device, torch.int64)
    k_r, k_c = rows.shape[1], cols.shape[1]
    chunk = max(1, _PAIRS_PER_CHUNK // max(1, k_r * k_c))
    counts = torch.zeros(
        n_rows * n_cols, dtype=torch.int64, device=acc.device
    )
    for lo in range(0, rows.shape[0], chunk):
        r = rows[lo:lo + chunk, :, None].expand(-1, k_r, k_c)
        c = cols[lo:lo + chunk, None, :].expand(-1, k_r, k_c)
        ok = (r >= 0) & (r < n_rows) & (c >= 0) & (c < n_cols)
        flat = r[ok] * n_cols + c[ok]
        if flat.numel():
            counts += torch.bincount(flat, minlength=n_rows * n_cols)
    acc += (sign * counts).reshape(n_rows, n_cols).to(acc.dtype)
    return acc


def _dense_correction(
    rows_full: np.ndarray,
    row_lens: np.ndarray,
    cols_full: np.ndarray,
    col_lens: np.ndarray,
    n_rows: int,
    n_cols: int,
    sign: int,
    device,
) -> np.ndarray:
    """Product route for the correction: densify the touched variants'
    carriers into 0/1 panels and take ONE ``X_S @ X_Dᵀ`` int8 product —
    exact integer counts times an exact ±1, so bit-identical to the
    scatter route. The variant axis pads to the JAX package's power-of-two
    bucket; pad columns are zero and inert. ``_int_mm``'s shape rule
    (more than 16 rows, multiples of 8) is met by the product's own
    operand padding, so an 8-row touched panel is served as is."""
    v_f = int(row_lens.size)
    v_pad = max(_carrier_bucket(v_f), SCATTER_CHUNK_VARIANTS)
    xr = np.zeros((n_rows, v_pad), dtype=np.int8)
    row_cols = np.repeat(np.arange(v_f, dtype=np.int64), row_lens)
    in_rows = rows_full < n_rows  # drop the OOB sentinels
    xr[rows_full[in_rows], row_cols[in_rows]] = 1
    xc = np.zeros((n_cols, v_pad), dtype=np.int8)
    col_cols = np.repeat(np.arange(v_f, dtype=np.int64), col_lens)
    xc[cols_full, col_cols] = 1
    prod = mxu_cross_product_pair(
        torch.from_numpy(xr).to(device),
        torch.from_numpy(xc).to(device),
        torch.float32,
        torch.int8,
    )
    return (prod * float(sign)).cpu().numpy()


def sample_correction(
    windows: Iterable[Tuple[np.ndarray, np.ndarray]],
    row_of_full: np.ndarray,
    col_of_full: np.ndarray,
    n_rows: int,
    n_cols: int,
    sign: int = 1,
    density_threshold: float = DEFAULT_SPARSE_DENSITY_THRESHOLD,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Rank-k correction ``C[r, t] = Σ_v x_v[r] · x_v[t]`` over exactly
    the touched variants of a full-frame CSR window stream.

    ``row_of_full`` / ``col_of_full`` map FULL-frame sample indices to
    target-row / touched-column positions, with a value ``>= n_rows`` /
    ``>= n_cols`` acting as the drop sentinel. Only variants with at least
    one in-bounds column carrier contribute, so the host filter touches
    every window once (vectorized numpy) while the device work pays only
    for the touched variants' carriers. The touched set then routes by
    DENSITY exactly like the sparse engine's windows: below the threshold
    it rides the ±1 scatter; at or above it, the int8 product —
    bit-identical either way. The device work runs on ``device`` (the
    card unless the caller asks for the CPU). Returns an
    exact-integer-count host float32 ``(n_rows, n_cols)`` array.
    """
    dev = resolve_device(device)
    row_of_full = np.asarray(row_of_full, dtype=np.int64)
    col_of_full = np.asarray(col_of_full, dtype=np.int64)
    r_parts: List[np.ndarray] = []
    c_parts: List[np.ndarray] = []
    rlen_parts: List[np.ndarray] = []
    clen_parts: List[np.ndarray] = []
    for window_idx, lens in windows:
        window_idx = np.asarray(window_idx, dtype=np.int64)
        lens = np.asarray(lens, dtype=np.int64)
        if window_idx.size == 0:
            continue
        cols = col_of_full[window_idx]
        hit = cols < n_cols
        if not hit.any():
            continue
        row_of = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
        touched_count = np.bincount(
            row_of, weights=hit, minlength=lens.size
        ).astype(np.int64)
        touched = touched_count > 0
        keep = touched[row_of]
        r_parts.append(row_of_full[window_idx[keep]])
        # The column side keeps ONLY in-bounds (touched) carriers per
        # variant: its carrier bucket is then bounded by k, not by the
        # variant's full carrier count (the dropped entries were all
        # sentinels anyway).
        c_parts.append(cols[hit])
        rlen_parts.append(lens[touched])
        clen_parts.append(touched_count[touched])
    if not rlen_parts:
        return np.zeros((n_rows, n_cols), dtype=np.float32)
    rows_full = np.concatenate(r_parts)
    cols_full = np.concatenate(c_parts)
    row_lens = np.concatenate(rlen_parts)
    col_lens = np.concatenate(clen_parts)
    density = float(row_lens.sum()) / max(
        1, n_rows * int(row_lens.size)
    )
    # The touched-column axis pads to the JAX package's power-of-two
    # bucket; pad columns receive nothing (the host filter already
    # dropped every out-of-set carrier) and are sliced off.
    n_cols_pad = _carrier_bucket(n_cols)
    if density >= density_threshold:
        return _dense_correction(
            rows_full, row_lens, cols_full, col_lens,
            n_rows, n_cols_pad, sign, dev,
        )[:, :n_cols]
    # Row sentinel >= n_rows and column sentinel >= the padded column
    # bound both drop; each side carries its own power-of-two carrier
    # bucket.
    row_mat = padded_carrier_matrix(
        rows_full, row_lens, sentinel=n_rows,
        k_bucket=_carrier_bucket(int(row_lens.max())),
    )
    col_mat = padded_carrier_matrix(
        cols_full, col_lens, sentinel=n_cols_pad,
        k_bucket=_carrier_bucket(int(col_lens.max())),
    )
    acc = torch.zeros((n_rows, n_cols_pad), dtype=torch.float32, device=dev)
    signed_scatter_pairs(acc, row_mat, col_mat, sign)
    return acc.cpu().numpy()[:, :n_cols]


def delta_gramian(
    cached_g: np.ndarray,
    ancestor_full: np.ndarray,
    target_full: np.ndarray,
    n_full: int,
    windows: Iterable[Tuple[np.ndarray, np.ndarray]],
    density_threshold: float = DEFAULT_SPARSE_DENSITY_THRESHOLD,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Cached ancestor G → target-cohort G by gather + rank-k touch-up.

    ``ancestor_full``/``target_full`` are the full-frame sample indices
    of the ancestor/target cohorts IN FRAME ORDER (row i of the
    ancestor G is sample ``ancestor_full[i]``). ``windows`` is a
    full-frame CSR window stream covering the cohort's variants (the
    serving tier feeds its per-base-key window cache, or re-streams the
    source). ``density_threshold`` routes the correction (the JAX
    package's fixed default unless a caller forces a route) and
    ``device`` runs it. Bit-identical to a from-scratch accumulation of
    the target cohort — every entry is the same exact integer count.
    Returns a host float32 array.
    """
    ancestor_full = np.asarray(ancestor_full, dtype=np.int64)
    target_full = np.asarray(target_full, dtype=np.int64)
    if isinstance(cached_g, torch.Tensor):
        cached_g = cached_g.cpu().numpy()
    cached_g = np.asarray(cached_g, dtype=np.float32)
    if cached_g.shape != (ancestor_full.size, ancestor_full.size):
        raise ValueError(
            f"cached G shape {cached_g.shape} does not match ancestor "
            f"frame size {ancestor_full.size}"
        )
    n_t = int(target_full.size)
    anc_of_full = np.full(n_full, -1, dtype=np.int64)
    anc_of_full[ancestor_full] = np.arange(
        ancestor_full.size, dtype=np.int64
    )
    common_t = np.nonzero(anc_of_full[target_full] >= 0)[0]
    added_t = np.nonzero(anc_of_full[target_full] < 0)[0]
    g = np.zeros((n_t, n_t), dtype=np.float32)
    if common_t.size:
        anc_idx = anc_of_full[target_full[common_t]]
        g[np.ix_(common_t, common_t)] = cached_g[np.ix_(anc_idx, anc_idx)]
    if added_t.size:
        # Full-frame → target-row map (sentinel n_t drops non-cohort
        # carriers) and full-frame → added-column map (sentinel k).
        row_of_full = np.full(n_full, n_t, dtype=np.int64)
        row_of_full[target_full] = np.arange(n_t, dtype=np.int64)
        k = int(added_t.size)
        col_of_full = np.full(n_full, k, dtype=np.int64)
        col_of_full[target_full[added_t]] = np.arange(k, dtype=np.int64)
        corr = sample_correction(
            windows, row_of_full, col_of_full, n_t, k, sign=1,
            density_threshold=density_threshold, device=device,
        )
        g[:, added_t] = corr
        g[added_t, :] = corr.T
    return g
