"""The reference agrees with itself at a small N: the blocked G with a
dense product, the coordinates with MLlib's covariance form, the sketch
panel with its dense formula, and the Nyström finish at full rank with
the exact eigenvectors."""

import numpy as np
import pytest
import torch

from benchmark import cohort as cohort_mod, reference
from benchmark.tests.conftest import small_configs


@pytest.fixture(scope="module")
def cohort():
    return cohort_mod.draw(small_configs()[0], {"sites": 3000}, 9)


def _dense(cohort, lo, hi):
    x = np.zeros((cohort.n, hi - lo))
    for s in range(lo, hi):
        x[cohort.carriers[cohort.offsets[s]:cohort.offsets[s + 1]], s - lo] = 1
    return x


def test_gramian_is_the_dense_product(cohort, monkeypatch):
    monkeypatch.setattr(reference, "_BLOCK_SITES", 700)  # several blocks
    x = _dense(cohort, 100, 2900)
    g = reference.gramian(cohort, 100, 2900)
    assert torch.equal(g, torch.from_numpy(x @ x.T))


def test_coordinates_are_mllibs(cohort):
    g = reference.gramian(cohort, 0, cohort.sites).numpy()
    n = g.shape[0]
    c = g - g.mean(1, keepdims=True) - g.mean(0, keepdims=True) + g.mean()
    mu = c.mean(0, keepdims=True)
    cov = (c.T @ c - n * (mu.T @ mu)) / (n - 1)
    w, v = np.linalg.eigh(cov)
    want = reference.sign_normalized(v[:, np.argsort(-w)[:2]])
    got = reference.coordinates(torch.from_numpy(g), 2)
    np.testing.assert_allclose(got, want, atol=1e-9)
    # Unit columns, orthogonal, each with its largest entry positive.
    np.testing.assert_allclose(got.T @ got, np.eye(2), atol=1e-12)
    assert np.all(got[np.abs(got).argmax(0), [0, 1]] > 0)


def test_sketch_panel_is_its_formula(cohort):
    n, width, seed = cohort.n, 10, 1234
    y, omega, row_sums = reference.sketch_panel(cohort, 0, cohort.sites,
                                                width, seed)
    x = _dense(cohort, 0, cohort.sites)
    h = np.eye(n) - 1.0 / n
    om = reference.sketch_omega(n, width, seed).astype(np.float64)
    np.testing.assert_allclose(omega, h @ om, atol=1e-12)
    np.testing.assert_allclose(y, h @ x @ x.T @ h @ om, rtol=1e-10,
                               atol=1e-8)
    assert np.array_equal(row_sums, (x @ x.T).sum(1))


def test_nystrom_at_full_rank_is_exact(cohort):
    n = cohort.n
    x = _dense(cohort, 0, cohort.sites)
    g = x @ x.T
    h = np.eye(n) - 1.0 / n
    c = h @ g @ h
    om = reference.sketch_omega(n, n, 77).astype(np.float64)
    om -= om.mean(0, keepdims=True)
    got = reference.sketch_coordinates(c @ om, om, 2)
    want = reference.coordinates(torch.from_numpy(g), 2)
    gap = np.minimum(np.abs(got - want).max(0), np.abs(got + want).max(0))
    assert gap.max() < 1e-6


def test_control_departs_from_the_reference(cohort):
    g = reference.gramian(cohort, 0, cohort.sites)
    gc = reference.gramian(cohort, 0, cohort.sites, control=True)
    assert g.max() > 256  # counts past bfloat16's exact integers
    assert (gc.to(torch.float64) - g).abs().max() > 0
    a = reference.coordinates(g, 2)
    b = reference.coordinates(gc, 2, control=True)
    assert np.abs(np.abs(a) - np.abs(b)).max() > 1e-4
