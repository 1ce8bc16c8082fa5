"""The cohort generator: a configuration's published shape, drawn from a seed.

One general generator reads a configuration file (``configs/<name>.json``)
and a traffic mix's cohort keys (``traffic/<mix>.json``) and draws the
carrier lists of every site. Two draws are defined, chosen by the
configuration's ``model``:

- ``bernoulli`` (the port's own fixture draw, vectorised): every sample
  carries a site with its population's carrier probability, and a carrier
  is ``1/1`` with probability ``hom_share``, else ``0/1``. A site's
  probability in the root population follows a power-law spectrum
  (density ∝ p^-exponent on [1/N, max]), and each population's probability
  drifts from its parent's by a Balding-Nichols draw with the node's
  ``drift`` (F), along the tree the configuration lists; an admixed
  population mixes its sources' probabilities.
- ``carrier_counts`` (biobank scale, where N·V Bernoulli draws would not
  fit a run): a site's carrier count is drawn log-uniformly in
  [min, max], its origin population by ``site_share``, and its carriers
  uniformly within that population.

A site with no carrier is no variant and is drawn again, as is one at or
above the mix's ``af_max`` (the carrier share, as the fixture's ``AF``
field states it). Sites lie on one contig from ``segment_start`` at the
configuration's density. The cohort is written as the JSONL directory the
port's ``JsonlSource`` reads (``callsets.json`` and ``variants.jsonl``,
carriers only).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np

__all__ = ["Cohort", "draw", "population_sizes", "write_jsonl"]

_BASES = np.array(list("ACGT"))


@dataclasses.dataclass
class Cohort:
    """Carrier lists of every site in CSR form, sites sorted by position."""

    n: int
    ids: List[str]
    names: List[str]
    groups: np.ndarray  # (n,) population index of each sample
    contig: str
    positions: np.ndarray  # (v,) int64 start of each site, increasing
    offsets: np.ndarray  # (v + 1,) int64
    carriers: np.ndarray  # (nnz,) int64 sample index, sorted within a site
    hom: np.ndarray  # (nnz,) bool: genotype 1/1 (else 0/1)
    variant_set_id: str

    @property
    def sites(self) -> int:
        return self.positions.size

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def site_range(self, start: int, end: int):
        """Sites whose start lies in [start, end): the rule of a
        ``--references`` region."""
        lo = int(np.searchsorted(self.positions, start, "left"))
        hi = int(np.searchsorted(self.positions, end, "left"))
        return lo, hi


def population_sizes(config: dict) -> Dict[str, int]:
    """Sample count of each population that holds samples, in file order."""
    return {
        p["name"]: int(p["size"])
        for p in config["populations"]
        if int(p.get("size", 0)) > 0
    }


def _sample_names(n: int) -> List[str]:
    # The port's fixture names: 1000-Genomes-style, unique.
    return [f"NA{20000 + i:05d}" if i % 2 == 0 else f"HG{i:05d}"
            for i in range(n)]


def _callset_ids(n: int, vsid: str) -> List[str]:
    width = len(str(max(n - 1, 0)))
    return [f"{vsid}-{i:0{width}d}" for i in range(n)]


def _sample_groups(config: dict, rng) -> np.ndarray:
    sizes = list(population_sizes(config).values())
    groups = np.repeat(np.arange(len(sizes)), sizes)
    return rng.permutation(groups)


def _power_law(rng, size, exponent, lo, hi):
    """Draws with density ∝ p^-exponent on [lo, hi] (inverse CDF)."""
    u = rng.random(size)
    if exponent == 1.0:
        return lo * (hi / lo) ** u
    e = 1.0 - exponent
    return (lo**e + u * (hi**e - lo**e)) ** (1.0 / e)


def _balding_nichols(rng, p, drift):
    p = np.clip(p, 1e-12, 1 - 1e-12)
    scale = (1.0 - drift) / drift
    return rng.beta(p * scale, (1.0 - p) * scale)


def _population_probs(config: dict, rng, size: int) -> np.ndarray:
    """(size, populations with samples) carrier probabilities of new sites."""
    spec = config["spectrum"]
    n = int(config["samples"])
    probs = {
        "root": _power_law(
            rng, size, float(spec["exponent"]), 1.0 / n, float(spec["max"])
        )
    }
    for node in config["populations"]:
        if "mix" in node:
            probs[node["name"]] = sum(
                float(w) * probs[src] for src, w in node["mix"].items()
            )
        else:
            probs[node["name"]] = _balding_nichols(
                rng, probs[node["parent"]], float(node["drift"])
            )
    return np.stack([probs[name] for name in population_sizes(config)], 1)


def _subsets(rng, counts, size):
    """A uniform ``counts[i]``-subset of range(size) for each i, as sorted
    (row, value) pairs: draws with repetition, the repeats drawn again."""
    rows = np.repeat(np.arange(counts.size), counts)
    key = np.unique(rows * size + rng.integers(0, size, rows.size))
    while True:
        missing = counts - np.bincount(key // size, minlength=counts.size)
        if not missing.any():
            return np.divmod(key, size)
        rows = np.repeat(np.arange(counts.size), missing)
        key = np.unique(np.concatenate(
            [key, rows * size + rng.integers(0, size, rows.size)]))


def _bernoulli_chunk(config, groups, members, rng, chunk):
    """One chunk of sites: every sample a carrier with its population's
    probability. Where that probability is small, the carrier count is
    drawn (binomial) and then a uniform subset of that size, which is the
    same distribution at a fraction of the draws."""
    n = groups.size
    p = _population_probs(config, rng, chunk)
    site_of, sample_of = [], []
    for g, idx in enumerate(members):
        pg = p[:, g]
        dense = np.flatnonzero(pg > 0.05)
        if dense.size:
            hits = (rng.random((dense.size, idx.size), dtype=np.float32)
                    < pg[dense, None].astype(np.float32))
            r, c = np.nonzero(hits)
            site_of.append(dense[r])
            sample_of.append(idx[c])
        rare = np.flatnonzero(pg <= 0.05)
        r, c = _subsets(rng, rng.binomial(idx.size, pg[rare]), idx.size)
        site_of.append(rare[r])
        sample_of.append(idx[c])
    key = np.sort(np.concatenate(site_of) * n + np.concatenate(sample_of))
    return np.divmod(key, n)


def _bernoulli_sites(config, groups, rng, want, af_max):
    n = groups.size
    members = [np.flatnonzero(groups == g)
               for g in range(len(population_sizes(config)))]
    chunk = 8192
    counts, carriers, hom = [], [], []
    have = 0
    while have < want:
        site, sample = _bernoulli_chunk(config, groups, members, rng, chunk)
        k = np.bincount(site, minlength=chunk)
        keep = (k > 0) & (k / n < af_max)
        keep &= np.cumsum(keep) <= want - have
        sample = sample[keep[site]]
        counts.append(k[keep])
        carriers.append(sample)
        hom.append(rng.random(sample.size) < float(config["hom_share"]))
        have += int(keep.sum())
    return np.concatenate(counts), np.concatenate(carriers), np.concatenate(hom)


def _count_sites(config, groups, rng, want, af_max):
    n = groups.size
    spec = config["carriers"]
    lo, hi = int(spec["min"]), int(spec["max"])
    pops = list(population_sizes(config))
    share = np.array([float(config["site_share"][p]) for p in pops])
    members = [np.flatnonzero(groups == g) for g in range(len(pops))]
    counts, carriers, hom = [], [], []
    have = 0
    while have < want:
        size = want - have
        c = np.floor(np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size)))
        c = np.minimum(c.astype(np.int64), hi)
        origin = rng.choice(len(pops), size=size, p=share / share.sum())
        site_of, sample_of = [], []
        for g, idx in enumerate(members):
            sites = np.flatnonzero(origin == g)
            per = np.minimum(c[sites], idx.size)
            draws = rng.integers(0, idx.size, int(per.sum()))
            site_of.append(np.repeat(sites, per))
            sample_of.append(idx[draws])
        key = np.unique(
            np.concatenate(site_of) * n + np.concatenate(sample_of)
        )  # duplicates within a site drawn once
        site, sample = np.divmod(key, n)
        k = np.bincount(site, minlength=size)
        keep_site = (k > 0) & (k / n < af_max)
        sample = sample[keep_site[site]]
        counts.append(k[keep_site])
        carriers.append(sample)
        hom.append(rng.random(sample.size) < float(config["hom_share"]))
        have += int(keep_site.sum())
    return np.concatenate(counts), np.concatenate(carriers), np.concatenate(hom)


def draw(config: dict, mix: dict, seed: int) -> Cohort:
    """The cohort of ``config`` under the mix's cohort keys (``sites``
    overrides the configuration's, ``af_max`` caps the carrier share),
    drawn from ``seed``: the same seed gives the same cohort."""
    rng = np.random.default_rng(seed)
    n = int(config["samples"])
    if sum(population_sizes(config).values()) != n:
        raise ValueError("population sizes must sum to samples")
    want = int(mix.get("sites", config["sites"]))
    af_max = float(mix.get("af_max", 1.0))
    groups = _sample_groups(config, rng)
    model = config["model"]
    if model == "bernoulli":
        counts, carriers, hom = _bernoulli_sites(config, groups, rng, want, af_max)
    elif model == "carrier_counts":
        counts, carriers, hom = _count_sites(config, groups, rng, want, af_max)
    else:
        raise ValueError(f"unknown cohort model {model!r}")
    span = int(round(want / float(config["site_density_per_kb"]) * 1000))
    start = int(config["segment_start"])
    positions = start + np.sort(rng.choice(span, size=want, replace=False))
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    vsid = config["variant_set_id"]
    return Cohort(
        n=n,
        ids=_callset_ids(n, vsid),
        names=_sample_names(n),
        groups=groups,
        contig=str(config["contig"]),
        positions=positions.astype(np.int64),
        offsets=offsets,
        carriers=carriers.astype(np.int64),
        hom=hom,
        variant_set_id=vsid,
    )


def write_jsonl(cohort: Cohort, root: str, seed: int = 0) -> int:
    """Write the cohort as a JSONL directory under ``root``; returns the
    bytes written. Each call is ``{"callset_id": ..., "genotype": [...]}``,
    carriers only; a site's ``AF`` is its carrier share, as in the port's
    fixture."""
    os.makedirs(root, exist_ok=True)
    vsid = cohort.variant_set_id
    rows = [
        {"id": cid, "name": name, "variant_set_id": vsid}
        for cid, name in zip(cohort.ids, cohort.names)
    ]
    with open(os.path.join(root, "callsets.json"), "w") as f:
        json.dump(rows, f)
    # Every call string has one width, so a site's calls are one gather of
    # a fixed-width table: row 2·s is sample s as 0/1, row 2·s + 1 as 1/1.
    calls = []
    for cid in cohort.ids:
        for gt in ("[0,1]", "[1,1]"):
            calls.append(f'{{"callset_id":"{cid}","genotype":{gt}}},'.encode())
    table = np.array(calls)
    codes = 2 * cohort.carriers + cohort.hom
    rng = np.random.default_rng([seed, 1])
    ref = rng.integers(0, 4, cohort.sites)
    alt = (ref + rng.integers(1, 4, cohort.sites)) % 4
    shares = cohort.counts() / cohort.n
    written = 0
    with open(os.path.join(root, "variants.jsonl"), "wb") as f:
        for s in range(cohort.sites):
            pos = int(cohort.positions[s])
            head = (
                f'{{"reference_name":"{cohort.contig}","start":{pos},'
                f'"end":{pos + 1},"reference_bases":"{_BASES[ref[s]]}",'
                f'"alternate_bases":["{_BASES[alt[s]]}"],'
                f'"info":{{"AF":["{shares[s]:.6f}"]}},'
                f'"variant_set_id":"{vsid}","calls":['
            ).encode()
            body = table[codes[cohort.offsets[s]:cohort.offsets[s + 1]]]
            line = head + body.tobytes()[:-1] + b"]}\n"
            f.write(line)
            written += len(line)
    return written
