"""Batched log-space PairHMM forward pass — the read-level workload.

The JAX package's ``ops/pairhmm.py``. The read-level computation every
production variant caller spends its cycles on is the PairHMM forward pass:
P(read | haplotype) under a three-state (match / insertion / deletion)
hidden Markov model, one dynamic program per read×haplotype pair, millions
of pairs per sample. The formulation, the JAX package's:

- **anti-diagonals**: cell (i, j) of the DP matrix depends on (i-1, j-1),
  (i-1, j) and (i, j-1) — all on the two previous anti-diagonals, so every
  cell of diagonal d computes in parallel, and a host loop walks d = 1 ..
  R+H (the JAX package's ``lax.scan``). Two carried diagonals per state,
  one masked update per step — no (R+1)×(H+1) matrix is materialized.
- **batched pairs** on a leading batch axis; every op of the recurrence is
  elementwise along the batch, so each pair's result is bit-identical
  whatever tile it rides in and wherever in the tile it sits.
- **log-space f32** with a finite ``PAIRHMM_NEG_INF`` sentinel (a finite
  floor keeps every logaddexp well-defined while exp(sentinel - max)
  underflows to exactly 0).
- **per-pair length masks**: reads and haplotypes bucket to power-of-two
  lengths (:func:`pairhmm_bucket`); cells beyond a pair's true (r, h) are
  masked to the sentinel and padded batch slots (r = 0) report it.

Model (GATK LoglessPairHMM conventions):

- emission at (i, j): ``1 - eps_i`` when read base i matches haplotype
  base j, ``eps_i / 3`` otherwise, with ``eps_i = 10^(-Q_i / 10)`` from
  the read's per-base quality (code 4 = N never matches);
- transitions from two phred-scaled knobs, gap-open ``go`` and
  gap-extend ``ge``: M→M ``1 - 2·10^(-go/10)``, M→{I,D} ``10^(-go/10)``,
  {I,D} self ``10^(-ge/10)``, {I,D}→M ``1 - 10^(-ge/10)``;
- free alignment start: row 0 of the deletion matrix holds ``1/h``
  (haplotype length h), so the likelihood sums over all start offsets;
- result: ``log Σ_j (M[r, j] + I[r, j])`` — natural log.

The scalar float64 numpy golden (:func:`pairhmm_forward_ref`) is the parity
oracle: the batched f32 pass must match it within
:data:`PAIRHMM_FORWARD_RTOL` / :data:`PAIRHMM_FORWARD_ATOL`.

The forward pass is torch ops on ``device`` (the card unless the caller asks
for the CPU), not a hand-written kernel: the JAX package's scan is XLA, not
Pallas. Each diagonal is a fixed sequence of elementwise launches with no
host synchronization; the result comes back once per tile.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_examples_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "DEFAULT_GAP_EXT_PHRED",
    "DEFAULT_GAP_OPEN_PHRED",
    "MIN_GAP_OPEN_PHRED",
    "PAIRHMM_FORWARD_ATOL",
    "PAIRHMM_FORWARD_RTOL",
    "PAIRHMM_NEG_INF",
    "pairhmm_bucket",
    "pairhmm_forward_batch",
    "pairhmm_forward_ref",
]

# Finite log-space floor: far below any reachable log-likelihood
# (a 10 kb read of all-mismatch Q60 bases sits near -1.4e5), yet
# exp(PAIRHMM_NEG_INF - anything) is exactly 0.0 in f32 — masked cells
# contribute nothing and never produce inf - inf NaNs.
PAIRHMM_NEG_INF = -1.0e30

# GATK defaults: gap-open Q45 (~3.2e-5), gap-extend Q10 (0.1).
DEFAULT_GAP_OPEN_PHRED = 45.0
DEFAULT_GAP_EXT_PHRED = 10.0

# Hard floor for the gap-open penalty: at or below 10·log10(2) ≈ 3.01
# the match self-transition 1 - 2·10^(-go/10) is non-positive, its log
# is NaN, and every likelihood in the tile is NaN. Validated loudly at
# the driver boundary, never discovered as a sea of NaNs.
MIN_GAP_OPEN_PHRED = float(10.0 * np.log10(2.0))

# f32-vs-f64 parity contract for the batched forward pass (the JAX
# package's bars). Error grows with the R+H logaddexp chain length; these
# bounds carry an order of magnitude of margin.
PAIRHMM_FORWARD_RTOL = 1e-4
PAIRHMM_FORWARD_ATOL = 2e-2

_MIN_PAIRHMM_BUCKET = 8

_LN10_OVER_10 = float(np.log(10.0) / 10.0)
_LN3 = float(np.log(3.0))

# Masked base codes: a read base or a haplotype base outside ACGT (codes
# >= 4, the padding included) takes a value no base of the other side
# can hold, so one equality is the JAX package's three-way match test.
_NO_READ_BASE = 1000
_NO_HAP_BASE = 2000


def pairhmm_bucket(n: int, floor: int = _MIN_PAIRHMM_BUCKET) -> int:
    """Round a read/haplotype length (or tile batch count) up to a
    power of two (min ``floor``): the tile shapes a cohort produces stay
    O(log R · log H · log B), as in the JAX package."""
    bucket = max(1, floor)
    while bucket < n:
        bucket *= 2
    return bucket


def _logaddexp_composed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max + log1p(exp(-|a - b|))`` from separate ops — the JAX
    package's formula. On the CPU, ``torch.logaddexp``'s vectorized body
    computes ``log(1 + x)`` and its scalar tail ``log1p(x)``, so an
    element's value would depend on where it sits in the tensor; the
    separate ``exp`` and ``log1p`` agree between the two paths."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def pairhmm_forward_batch(
    read_codes,
    read_quals,
    read_lens,
    hap_codes,
    hap_lens,
    gap_open_phred,
    gap_ext_phred,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Log P(read | haplotype) for a tile of pairs.

    Args:
      read_codes: (B, R) int8 base codes (0-3 = ACGT, 4 = N; entries
        past each pair's ``read_lens`` are ignored).
      read_quals: (B, R) per-base phred qualities (int or float).
      read_lens: (B,) true read lengths (0 = padded batch slot).
      hap_codes: (B, H) int8 haplotype base codes.
      hap_lens: (B,) true haplotype lengths.
      gap_open_phred / gap_ext_phred: scalar phred-scaled gap penalties.
      device: where the tile is computed (numpy operands or tensors
        elsewhere are copied there).

    Returns:
      (B,) float32 natural-log likelihoods on ``device``; padded slots
      (read_lens or hap_lens 0) report :data:`PAIRHMM_NEG_INF`. Every op
      along the batch axis is elementwise, so a pair's value is
      bit-identical in any tile composition or order.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    read_codes = torch.as_tensor(read_codes, device=dev)
    read_quals = torch.as_tensor(read_quals, device=dev)
    hap_codes = torch.as_tensor(hap_codes, device=dev)
    b, r_bucket = read_codes.shape
    h_bucket = hap_codes.shape[1]
    w = r_bucket + 1
    n_diag = r_bucket + h_bucket
    lae = torch.logaddexp if dev.type == "cuda" else _logaddexp_composed
    neg = torch.tensor(PAIRHMM_NEG_INF, dtype=f32, device=dev)
    ln10_10 = torch.tensor(_LN10_OVER_10, dtype=f32, device=dev)

    # Per-base emission log-probs, shifted so index i reads base i-1.
    log_eps = -read_quals.to(f32) * ln10_10  # (B, R)
    lp_match = torch.log1p(-torch.exp(log_eps))
    lp_mis = log_eps - torch.tensor(_LN3, dtype=f32, device=dev)
    pad1 = neg.expand(b, 1)
    lpm = torch.cat([pad1, lp_match], 1)  # (B, R+1)
    lpx = torch.cat([pad1, lp_mis], 1)

    # Transition log-probs: float32 scalars computed on the device, as
    # the JAX package computes them.
    go = torch.as_tensor(gap_open_phred, dtype=f32, device=dev)
    ge = torch.as_tensor(gap_ext_phred, dtype=f32, device=dev)
    eps_go = torch.exp(-go * ln10_10)
    t_mm = torch.log1p(-2.0 * eps_go)
    t_open = -go * ln10_10  # log eps_go
    t_ext = -ge * ln10_10  # log eps_ge
    t_close = torch.log1p(-torch.exp(t_ext))

    r_len = torch.as_tensor(read_lens, device=dev).to(torch.int32)[:, None]
    h_len = torch.as_tensor(hap_lens, device=dev).to(torch.int32)[:, None]
    log_init = torch.where(
        h_len > 0, -torch.log(h_len.clamp_min(1).to(f32)), neg
    )  # (B, 1)

    # Codes with non-ACGT bases masked apart (see _NO_READ_BASE).
    rc = read_codes.to(torch.int32)
    rc = torch.cat(
        [torch.full((b, 1), _NO_READ_BASE, dtype=torch.int32, device=dev),
         torch.where(rc < 4, rc, _NO_READ_BASE)],
        1,
    )  # (B, R+1)
    hc = hap_codes.to(torch.int32)
    hc = torch.where(hc < 4, hc, _NO_HAP_BASE)
    # Reversed haplotype padded on both sides so diagonal d's base at
    # read index i — hap[d-1-i] — is one narrow of length R+1 from the
    # host-int start (R+1)+H-d, in bounds for d in [1, R+H].
    pad = torch.full((b, w), _NO_HAP_BASE, dtype=torch.int32, device=dev)
    pad_rev = torch.cat([pad, hc.flip(1), pad], 1)

    # Loop-invariant masks. Cell (i, j = d - i) is live when
    # 1 <= i <= r and 1 <= j <= h: i < d against ``row`` (i where
    # 1 <= i <= r, else past every d) and i + h >= d against ``reach``.
    i_idx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    row = torch.where(
        (i_idx >= 1) & (i_idx <= r_len), i_idx, n_diag + 1
    )  # (B, R+1)
    reach = i_idx + h_len  # (B, R+1)
    d_all = torch.arange(1, n_diag + 1, dtype=torch.int32, device=dev)
    # Boundary row i = 0 (cell (0, d)): the free-start deletion mass,
    # live while the column is inside the haplotype.
    boundary = torch.where(
        d_all[:, None] <= h_len[:, 0], log_init[:, 0], neg
    )  # (R+H, B)
    # Final-row readout: cell (r, d - r) when it lands in-matrix.
    j_r = d_all[:, None] - r_len[:, 0]
    in_row = (
        (r_len[:, 0] >= 1) & (j_r >= 1) & (j_r <= h_len[:, 0])
    )[:, :, None]  # (R+H, B, 1)
    r_index = r_len.to(torch.int64)  # the gather index, built once

    # Diagonal buffers with a leading sentinel column: ``buf[:, 1:]`` is
    # the diagonal, ``buf[:, :-1]`` the diagonal shifted by one read index
    # (the recurrence's i-1). Three per state rotate: d-2, d-1 and the
    # one being written (into d-2's, whose last reader is this step).
    def diag():
        return torch.full((b, w + 1), PAIRHMM_NEG_INF, dtype=f32, device=dev)

    m1, i1, d1 = diag(), diag(), diag()
    m2, i2, d2 = diag(), diag(), diag()
    d1[:, 1:2] = log_init  # D on diagonal 0: cell (0, 0)
    acc = torch.full((b, 1), PAIRHMM_NEG_INF, dtype=f32, device=dev)

    for d in range(1, n_diag + 1):
        hap_at = pad_rev.narrow(1, w + h_bucket - d, w)
        prior = torch.where(hap_at == rc, lpm, lpx)
        m_new = prior + lae(
            t_mm + m2[:, :-1],
            lae(t_close + i2[:, :-1], t_close + d2[:, :-1]),
        )
        i_new = lae(t_open + m1[:, :-1], t_ext + i1[:, :-1])
        d_new = lae(t_open + m1[:, 1:], t_ext + d1[:, 1:])
        valid = (row < d) & (reach >= d)
        torch.where(valid, m_new, neg, out=m2[:, 1:])
        torch.where(valid, i_new, neg, out=i2[:, 1:])
        torch.where(valid, d_new, neg, out=d2[:, 1:])
        d2[:, 1].copy_(boundary[d - 1])
        m_r = torch.gather(m2[:, 1:], 1, r_index)
        i_r = torch.gather(i2[:, 1:], 1, r_index)
        acc = lae(acc, torch.where(in_row[d - 1], lae(m_r, i_r), neg))
        m1, m2 = m2, m1
        i1, i2 = i2, i1
        d1, d2 = d2, d1
    return acc[:, 0]


def pairhmm_forward_ref(
    read_codes,
    read_quals,
    hap_codes,
    gap_open_phred: float = DEFAULT_GAP_OPEN_PHRED,
    gap_ext_phred: float = DEFAULT_GAP_EXT_PHRED,
) -> float:
    """Scalar float64 golden: the full (r+1)×(h+1) log-space DP.

    The direct transcription of the model in the module docstring — no
    diagonals, no masks, no buckets — against which the batched kernel
    holds tolerance parity. Returns ``-inf`` for an empty read or
    haplotype (the kernel's padded slots report the finite sentinel).
    """
    read_codes = np.asarray(read_codes, dtype=np.int64)
    hap_codes = np.asarray(hap_codes, dtype=np.int64)
    quals = np.asarray(read_quals, dtype=np.float64)
    r, h = read_codes.size, hap_codes.size
    if r == 0 or h == 0:
        return float("-inf")
    eps = np.power(10.0, -quals / 10.0)
    lp_match = np.log1p(-eps)
    lp_mis = np.log(eps / 3.0)
    eps_go = 10.0 ** (-float(gap_open_phred) / 10.0)
    eps_ge = 10.0 ** (-float(gap_ext_phred) / 10.0)
    t_mm = np.log1p(-2.0 * eps_go)
    t_open = np.log(eps_go)
    t_ext = np.log(eps_ge)
    t_close = np.log1p(-eps_ge)
    neg = -np.inf
    m = np.full((r + 1, h + 1), neg)
    ins = np.full((r + 1, h + 1), neg)
    dele = np.full((r + 1, h + 1), neg)
    dele[0, :] = -np.log(float(h))
    for i in range(1, r + 1):
        for j in range(1, h + 1):
            hit = (
                read_codes[i - 1] == hap_codes[j - 1]
                and read_codes[i - 1] < 4
                and hap_codes[j - 1] < 4
            )
            prior = lp_match[i - 1] if hit else lp_mis[i - 1]
            m[i, j] = prior + np.logaddexp(
                t_mm + m[i - 1, j - 1],
                np.logaddexp(
                    t_close + ins[i - 1, j - 1],
                    t_close + dele[i - 1, j - 1],
                ),
            )
            ins[i, j] = np.logaddexp(
                t_open + m[i - 1, j], t_ext + ins[i - 1, j]
            )
            dele[i, j] = np.logaddexp(
                t_open + m[i, j - 1], t_ext + dele[i, j - 1]
            )
    row = np.logaddexp(m[r, 1:], ins[r, 1:])
    peak = row.max()
    return float(peak + np.log(np.exp(row - peak).sum()))
