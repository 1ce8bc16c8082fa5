"""The port's finish — centering, CholeskyQR subspace eig, dense PCoA and
the host oracle — against the JAX package's, on one structured cohort.

Float stages are held to stated tolerances: double-centering to 1e-6
relative (float32, another reduction order); the subspace iteration fed
the JAX package's own start panel to 1e-5; the fused finish with the
port's own start panel to 1e-4 (the JAX package's fused-vs-stream bar,
``tests/test_pca_pipeline.py::TestFusedPcaMode``); dense ``pcoa`` to 1e-5.
The numpy oracle copy must equal the JAX package's exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_examples_tpu.ops.centering import double_center as jax_center
from spark_examples_tpu.ops.fused import (
    fused_finish as jax_fused_finish,
    subspace_eig_cholqr as jax_subspace,
)
from spark_examples_tpu.ops.pcoa import (
    mllib_principal_components_reference as jax_oracle,
    normalize_eigvec_signs as jax_signs,
    pcoa as jax_pcoa,
)
from spark_examples_tpu_torch.genomics.fixtures import synthetic_cohort
from spark_examples_tpu_torch.ops import fused, pcoa
from spark_examples_tpu_torch.ops.centering import double_center


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def g():
    """G = X·Xᵀ of a 3-population cohort (N=64, V=800) whose top-2
    eigenbasis is well separated (|λ3|/|λ2| ≈ 0.13)."""
    n, v = 64, 800
    src = synthetic_cohort(n, v, seed=3, population_structure=3)
    x = np.zeros((n, v), np.int64)
    for j, rec in enumerate(src._variants):
        for c in rec["calls"]:
            if max(c["genotype"]) > 0:
                x[int(c["callset_id"].rsplit("-", 1)[1]), j] = 1
    return (x @ x.T).astype(np.float32)


def test_double_center_matches_relative(g):
    got = double_center(torch.from_numpy(g)).numpy()
    want = np.asarray(jax_center(jnp.asarray(g)))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_subspace_eig_from_the_jax_start_panel(g):
    c = np.array(jax_center(jnp.asarray(g)))
    key = jax.random.PRNGKey(0)
    q0 = np.array(jax.random.normal(key, (g.shape[0], 10), jnp.float32))
    want_vecs, want_vals, _ = jax_subspace(
        jnp.asarray(c), 2, oversample=8, iters=40, key=key
    )
    vecs, vals, resid = fused.subspace_eig_cholqr(
        torch.from_numpy(c), 2, oversample=8, iters=40, q0=q0
    )
    assert vecs.shape == (64, 10) and float(resid) < 1e-3
    assert np.abs(
        vecs.numpy()[:, :2] - np.asarray(want_vecs)[:, :2]
    ).max() <= 1e-5
    np.testing.assert_allclose(
        vals.numpy()[:2], np.asarray(want_vals)[:2], rtol=1e-5
    )


def test_fused_finish_with_its_own_generator(g):
    coords, vals, row_sums = fused.fused_finish(g, 2, device="cpu")
    want, want_vals, want_rows = jax_fused_finish(jnp.asarray(g), 2)
    assert coords.shape == (64, 2) and vals.dtype == np.float64
    assert np.abs(coords - want).max() <= 1e-4
    np.testing.assert_array_equal(row_sums, np.asarray(want_rows))
    np.testing.assert_allclose(vals, want_vals, rtol=1e-4)


def test_fused_finish_same_seed_same_panel_on_any_call(g):
    a = fused.fused_finish(g, 2, device="cpu")[0]
    b = fused.fused_finish(torch.from_numpy(g), 2, device="cpu")[0]
    np.testing.assert_array_equal(a, b)


def test_fused_finish_non_finite_raises(g):
    bad = g.copy()
    bad[0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        fused.fused_finish(bad, 2, device="cpu")


def test_fused_finish_refuses_without_cuda_by_default(g, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.fused_finish(g, 2)


def test_pcoa_matches(g):
    coords, vals = pcoa.pcoa(torch.from_numpy(g), 3)
    want, want_vals = jax_pcoa(jnp.asarray(g), 3)
    assert np.abs(coords.numpy() - np.asarray(want)).max() <= 1e-5
    np.testing.assert_allclose(
        vals.numpy(), np.asarray(want_vals), rtol=1e-5
    )


def test_oracle_copy_is_exact(g):
    got_vecs, got_vals = pcoa.mllib_principal_components_reference(g, 3)
    want_vecs, want_vals = jax_oracle(g, 3)
    np.testing.assert_array_equal(got_vecs, want_vecs)
    np.testing.assert_array_equal(got_vals, want_vals)


def test_sign_convention_matches_on_numpy_and_tensors():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((12, 4)).astype(np.float32)
    v[3, 1] = 0.0
    want = np.asarray(jax_signs(jnp.asarray(v)))
    np.testing.assert_array_equal(pcoa.normalize_eigvec_signs(v), want)
    np.testing.assert_array_equal(
        pcoa.normalize_eigvec_signs(torch.from_numpy(v)).numpy(), want
    )


def test_gap_check_warns_on_a_flat_spectrum():
    with pytest.warns(pcoa.SpectralGapWarning):
        pcoa.check_spectral_gap(np.array([5.0, 4.0, 3.9]), 2)
    coords, vals = pcoa.topk_with_gap_check(
        lambda kk: (np.ones((4, kk)), np.array([9.0, 4.0, 1.0])[:kk]), 2, 4
    )
    assert coords.shape == (4, 2) and list(vals) == [9.0, 4.0]
