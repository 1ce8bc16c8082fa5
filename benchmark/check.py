"""The comparison that decides ``correct``.

Each number compared has its limit in the configuration's ``limits``:

- ``gram_gap``: the largest |G − G_ref| over the Gramians kept from the
  window (exact integer counts: limit 0);
- ``panel_gap``: the largest relative column error ‖Y_j − Y_ref,j‖ /
  ‖Y_ref,j‖ of the kept sketch panels;
- ``rowsum_gap``: the largest |row sum − reference| of G's row sums that
  the kept panels carry (exact integer counts: limit 0);
- ``coord_gap``: the largest gap of an emitted coordinate, over the jobs
  whose rows were kept (a sample of the window's drawn from the seed, the
  first job always), to the reference's, each column's sign taken as it
  matches best (an eigenvector's sign is arbitrary);
- ``route_misses``: how many of the routes the mix expects did not hold
  (limit 0).

A job whose emitted rows do not name every sample once reads an infinite
``coord_gap``; a kept output of the wrong kind or shape an infinite gap,
and so does a number that no job of the window gave a reading for.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark import reference

__all__ = ["compare", "gaps", "reference_outputs", "route_misses"]

# A gap that stands for "no reading" or "wrong shape": finite, so the result
# line stays plain JSON.
INF = 1e300


def _sketch_cell(mix: dict) -> bool:
    return mix.get("expect", {}).get("sketch_jobs") == "all"


def panel_width(config: dict, n: int) -> int:
    return min(n, int(config["num_pc"]) + max(int(config.get(
        "sketch_oversample", 8)), 1))


def reference_outputs(cell, cohort, job, seed: int, device: str,
                      control: bool = False) -> dict:
    """The reference's outputs of one distinct job (the control's with
    ``control``): coordinates, and G or the sketch panel."""
    from benchmark.jobs import sketch_seed

    k = int(cell.config["num_pc"])
    if _sketch_cell(cell.mix):
        y, omega, row_sums = reference.sketch_panel(
            cohort, job.lo, job.hi, panel_width(cell.config, cohort.n),
            sketch_seed(seed), control=control)
        coords = reference.sketch_coordinates(y, omega, k)
        return {"coords": coords, "panel": (y, row_sums)}
    g = reference.gramian(cohort, job.lo, job.hi, device, control=control)
    coords = reference.coordinates(g, k, control=control)
    return {"coords": coords, "g": g.to(device="cpu", dtype=torch.float64)}


def _coord_gap(got: Optional[np.ndarray], want: np.ndarray) -> float:
    if got is None or got.shape != want.shape or not np.isfinite(got).all():
        return INF
    return float(max(min(np.abs(got[:, j] - want[:, j]).max(),
                         np.abs(got[:, j] + want[:, j]).max())
                     for j in range(want.shape[1])))


def _rows_to_coords(rows, index: Dict[str, int], n: int):
    if rows is None or len(rows) != n:
        return None
    out = np.full((n, 2), np.nan)
    for cid, pc1, pc2 in rows:
        i = index.get(cid)
        if i is None:
            return None
        out[i] = (pc1, pc2)
    return out


_NOT_GIVEN = object()


def gaps(want: dict, coords=_NOT_GIVEN, g=None,
         panel=None) -> Dict[str, float]:
    """The numbers of one output against the reference's ``want``: of the
    coordinates where given (None reads as missing), G, the panel."""
    out = {}
    if coords is not _NOT_GIVEN:
        out["coord_gap"] = _coord_gap(coords, want["coords"][:, :2])
    if g is not None:
        wg = want.get("g")
        if wg is None or tuple(g.shape) != tuple(wg.shape):
            out["gram_gap"] = INF
        else:
            out["gram_gap"] = float((g - wg).abs().max())
    if panel is not None:
        y, row_sums = panel
        wy, wr = want.get("panel", (None, None))
        if wy is None or y.shape != wy.shape:
            out["panel_gap"] = out["rowsum_gap"] = INF
        else:
            err = np.linalg.norm(y - wy, axis=0)
            out["panel_gap"] = float(
                (err / np.maximum(np.linalg.norm(wy, axis=0), 1e-300)).max())
            out["rowsum_gap"] = float(np.abs(row_sums - wr).max())
    return out


def route_misses(mix: dict, routes: dict, jobs_run: int) -> int:
    expect = mix.get("expect", {})
    misses = 0
    launches = routes.get("scatter_launches", 0)
    if expect.get("scatter_launches") == "zero" and launches != 0:
        misses += 1
    if expect.get("scatter_launches") == "positive" and launches <= 0:
        misses += 1
    sketched = routes.get("sketch_jobs", 0)
    if expect.get("sketch_jobs") == "all" and sketched != jobs_run:
        misses += 1
    if expect.get("sketch_jobs") == "none" and sketched != 0:
        misses += 1
    return misses


def compare(cell, cohort, jobs, records, routes, seed: int,
            device: str) -> Dict[str, dict]:
    """The kept rows and outputs of the window's jobs against the
    reference, each distinct job's worked out once."""
    limits = cell.config["limits"]
    worst: Dict[str, float] = {}
    index = {cid: i for i, cid in enumerate(cohort.ids)}
    by_key = {j.key: j for j in jobs}
    sketch = _sketch_cell(cell.mix)
    for key in sorted({r.key for r in records
                       if r.rows is not None or r.kept is not None}):
        want = reference_outputs(cell, cohort, by_key[key], seed, device)
        for r in records:
            if r.key != key or r.error:
                continue
            found = {}
            if r.rows is not None:
                found = gaps(want, coords=_rows_to_coords(r.rows, index,
                                                          cohort.n))
            if r.kept is not None:
                if sketch:
                    panel = getattr(r.kept, "y", None)
                    found.update(gaps(want, panel=(
                        (panel, r.kept.row_sums) if panel is not None
                        else (np.zeros(0), np.zeros(0)))))
                elif hasattr(r.kept, "abs"):
                    found.update(gaps(want, g=r.kept))
                else:
                    found["gram_gap"] = INF
            for name, value in found.items():
                worst[name] = max(worst.get(name, 0.0), value)
        del want
    worst["route_misses"] = float(route_misses(cell.mix, routes,
                                               len(records)))
    # A number that no output gave a reading for has failed.
    return {name: {"value": worst.get(name, INF), "limit": limits[name]}
            for name in limits}
