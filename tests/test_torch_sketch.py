"""The port's sketch engine (``--pca-mode sketch``) against the JAX package's.

Both packages run the same numpy-seeded CSR windows on the CPU in one
process. Integer outputs (``row_sums``, ``csr_windows``, the panel width)
and everything numpy draws or finishes (Ω, ``sketch_eig`` on one panel)
must be bit-identical; the float32 panel Y within 1e-5 relative (both sum
the same terms in float32, in different orders); the driver's coordinates
within 1e-4. The reference's own tolerance contract (``SKETCH_*``) is held
against the exact spectrum, as ``tests/test_sketch.py`` holds the JAX
package's meshless engine.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_examples_tpu.arrays.blocks import csr_windows as jax_csr_windows
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.ops import sketch as jax_sketch
from spark_examples_tpu.ops.pcoa import (
    randomized_panel_width as jax_panel_width,
)
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu.utils.config import add_pca_flags as jax_flags
from spark_examples_tpu_torch.arrays.blocks import csr_windows
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops import scatter_kernel, sketch
from spark_examples_tpu_torch.ops.pcoa import (
    normalize_eigvec_signs,
    randomized_panel_width,
)
from spark_examples_tpu_torch.ops.sketch import (
    SKETCH_FULLRANK_ATOL,
    SKETCH_FULLRANK_RTOL,
    SKETCH_TOPK_ATOL,
    SKETCH_TOPK_RTOL,
    SketchPanel,
    gaussian_test_matrix,
    sketch_eig,
    sketch_host_bytes,
    sketch_panel_blockwise,
)
from spark_examples_tpu_torch.ops.sparse import window_route
from spark_examples_tpu_torch.utils.config import PcaConfig, add_pca_flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K = 2
N, V = 36, 240
PANEL_RTOL = 1e-5  # float32 sums of the same terms in another order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def structured_csr(n=N, v=V, seed=0, pops=3):
    """``tests/test_sketch.py``'s cohort: dense X and its CSR twin, with
    ``pops`` well-separated populations (a clean top-(pops−1) gap)."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % pops
    x = np.zeros((n, v), np.int8)
    for j in range(v):
        p_carry = np.where(labels == (j % pops), 0.85, 0.05)
        x[:, j] = rng.random(n) < p_carry
    return x, _csr_of(x)


def _csr_of(x):
    cols, rows = np.nonzero(x.T)
    lens = np.bincount(cols, minlength=x.shape[1])
    offsets = np.zeros(x.shape[1] + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return rows.astype(np.int64), offsets


def mixed_csr(n=64, seed=5):
    """Blocks of 32 variants that alternate between the structured common
    variants (dense at the default 0.02 threshold) and single-carrier rare
    variants (1/64 < 0.02: scatter)."""
    rng = np.random.default_rng(seed)
    x_common, _ = structured_csr(n, 96, seed=seed)
    x = np.zeros((n, 192), np.int8)
    for b in range(3):
        x[:, 64 * b:64 * b + 32] = x_common[:, 32 * b:32 * (b + 1)]
        rare = rng.integers(0, n, 32)
        x[rare, 64 * b + 32 + np.arange(32)] = 1
    return x, _csr_of(x)


def exact_eig(x, k=K):
    """Sign-normalized top-k eigenpairs of C = H·XXᵀ·H in float64."""
    xf = np.asarray(x, np.float64)
    g = xf @ xf.T
    n = g.shape[0]
    h = np.eye(n) - 1.0 / n
    w, u = np.linalg.eigh(h @ g @ h)
    order = np.argsort(w)[::-1][:k]
    return normalize_eigvec_signs(u[:, order]), w[order]


def _port_panel(windows, n=N, k=K, **kw):
    return sketch_panel_blockwise(
        lambda: iter(windows), n, k, device="cpu", **kw
    )


def _jax_panel(windows, n=N, k=K, **kw):
    return jax_sketch.sketch_panel_blockwise(lambda: iter(windows), n, k, **kw)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_spectrum(coords, vals, ref_coords, ref_vals, rtol, atol):
    np.testing.assert_allclose(vals, ref_vals, rtol=rtol)
    assert np.abs(coords - ref_coords).max() <= atol


# -- the small pieces ---------------------------------------------------------


@pytest.mark.parametrize("oversample", [-3, 0, 1, 2, 8, 40])
def test_panel_width_is_the_jax_packages(oversample):
    for n in range(1, 41):
        for k in range(1, 13):
            assert randomized_panel_width(n, k, oversample) == (
                jax_panel_width(n, k, oversample)
            )
    with pytest.raises(ValueError, match="k >= 1"):
        randomized_panel_width(10, 0, oversample)


@pytest.mark.parametrize("n,width,seed", [(20, 5, 11), (37, 10, 0), (1, 3, 7)])
def test_gaussian_test_matrix_is_bit_identical(n, width, seed):
    got = gaussian_test_matrix(n, width, seed)
    assert got.dtype == np.float32 and got.shape == (n, width)
    np.testing.assert_array_equal(
        got, jax_sketch.gaussian_test_matrix(n, width, seed)
    )


def _pair(lens, seed):
    lens = np.asarray(lens, np.int64)
    rng = np.random.default_rng(seed)
    offsets = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return rng.integers(0, 50, int(offsets[-1])).astype(np.int32), offsets


CSR_CASES = {
    "one pair over several blocks": ([_pair([3, 0, 5, 1] * 10, 0)], 7),
    "none and empty shards": (
        [None, _pair([2, 4, 1], 1), (np.zeros(0, np.int64),
                                     np.zeros(1, np.int64)),
         None, _pair([0, 0, 6, 2, 3], 2)],
        3,
    ),
    "pairs smaller than a block": (
        [_pair([1, 2], 3), _pair([4], 4), _pair([2, 2, 2], 5)], 8
    ),
    "block of one": ([_pair([2, 0, 3], 6)], 1),
    "exact multiple": ([_pair([1] * 12, 7)], 4),
}


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_windows_are_bit_identical(case):
    pairs, block = CSR_CASES[case]
    got = list(csr_windows(iter(pairs), block))
    want = list(jax_csr_windows(iter(pairs), block))
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.int64
        assert gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_csr_windows_skip_a_stream_of_empty_shards():
    pairs = [None, (np.zeros(0, np.int64), np.zeros(1, np.int64))]
    assert list(csr_windows(iter(pairs), 4)) == []
    assert list(jax_csr_windows(iter(pairs), 4)) == []


# -- the panel against the JAX package's --------------------------------------

MIXES = {"default": 0.02, "all-dense": 0.0, "all-scatter": float("inf")}


def _mixed_windows(block=32):
    _, pair = mixed_csr()
    return list(csr_windows(iter([pair]), block))


def test_the_default_mix_takes_both_routes():
    routes = [window_route(lens, 64, MIXES["default"])
              for _, lens in _mixed_windows()]
    assert routes.count("scatter") == 3 and routes.count("dense") == 3


@pytest.mark.parametrize("power_iters", [0, 2])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_panel_matches_the_jax_panel(mix, power_iters):
    windows = _mixed_windows()
    kw = dict(power_iters=power_iters, density_threshold=MIXES[mix],
              block_variants=32, seed=4)
    before = dict(sketch.SKETCH_WINDOWS)
    got = _port_panel(windows, n=64, **kw)
    want = _jax_panel(windows, n=64, **kw)
    applied = {r: sketch.SKETCH_WINDOWS[r] - before[r] for r in before}
    assert sum(applied.values()) == len(windows) * (power_iters + 1)
    if mix == "all-dense":
        assert applied["scatter"] == 0
    elif mix == "all-scatter":
        assert applied["dense"] == 0
    else:
        assert applied["scatter"] == applied["dense"] > 0
    np.testing.assert_array_equal(got.row_sums, want.row_sums)
    assert got.y.dtype == got.omega.dtype == np.float64
    assert got.y.shape == want.y.shape == (64, got.l)
    assert _rel(got.y, want.y) <= PANEL_RTOL
    assert _rel(got.omega, want.omega) <= PANEL_RTOL
    if power_iters == 0:
        np.testing.assert_array_equal(got.omega, want.omega)
    assert (got.n, got.k, got.l, got.seed, got.power_iters) == (
        want.n, want.k, want.l, want.seed, want.power_iters
    )
    assert got.host_peak_bytes == want.host_peak_bytes


@pytest.mark.parametrize("power_iters", [0, 2])
def test_shuffled_window_order_matches_the_jax_panel(power_iters):
    windows = list(csr_windows(iter([structured_csr()[1]]), 16))
    shuffled = [windows[i] for i in
                np.random.default_rng(7).permutation(len(windows))]
    got = _port_panel(shuffled, power_iters=power_iters)
    want = _jax_panel(windows, power_iters=power_iters)
    np.testing.assert_array_equal(got.row_sums, want.row_sums)
    assert _rel(got.y, want.y) <= PANEL_RTOL
    assert _rel(got.omega, want.omega) <= PANEL_RTOL


def _as_port_panel(p):
    return SketchPanel(y=p.y, omega=p.omega, row_sums=p.row_sums, n=p.n,
                       k=p.k, l=p.l, seed=p.seed, power_iters=p.power_iters,
                       host_peak_bytes=p.host_peak_bytes)


@pytest.mark.parametrize(
    "kw", [{"power_iters": 0}, {"power_iters": 2},
           {"power_iters": 0, "oversample": N}],
    ids=["one-pass", "power-2", "full-rank"],
)
def test_sketch_eig_on_the_jax_panel_is_bit_identical(kw):
    windows = list(csr_windows(iter([structured_csr()[1]]), 32))
    panel = _jax_panel(windows, block_variants=32, **kw)
    coords, vals = sketch_eig(_as_port_panel(panel), K)
    want_coords, want_vals = jax_sketch.sketch_eig(panel, K)
    np.testing.assert_array_equal(coords, want_coords)
    np.testing.assert_array_equal(vals, want_vals)


# -- the reference's tolerance contract, meshless -----------------------------


def _structured_panel(**kw):
    _, pair = structured_csr()
    kw.setdefault("power_iters", 2)
    return sketch_panel_blockwise(
        lambda: csr_windows(iter([pair]), 32), N, K, block_variants=32,
        device="cpu", **kw,
    )


def test_fixture_has_a_clean_gap():
    x, _ = structured_csr()
    _, vals = exact_eig(x, k=K + 1)
    assert vals[K] / vals[K - 1] < 0.5


def test_topk_matches_exact():
    x, _ = structured_csr()
    coords, vals = sketch_eig(_structured_panel(), K)
    assert_spectrum(coords, vals, *exact_eig(x), SKETCH_TOPK_RTOL,
                    SKETCH_TOPK_ATOL)


def test_full_rank_matches_exact_tightly():
    x, _ = structured_csr()
    panel = _structured_panel(power_iters=0, oversample=N)
    assert panel.l == N
    coords, vals = sketch_eig(panel, K)
    assert_spectrum(coords, vals, *exact_eig(x), SKETCH_FULLRANK_RTOL,
                    SKETCH_FULLRANK_ATOL)


def test_density_edge_windows_and_route_mix():
    """An all-zero window, a single-carrier window and a dense window feed
    one panel through both routes; the route counts record the split."""
    n = 64
    windows = [
        (np.empty(0, np.int64), np.zeros(3, np.int64)),
        (np.array([5], np.int64), np.array([1], np.int64)),
        (np.concatenate([np.arange(32), np.arange(n), np.arange(n)]),
         np.array([32, n, n], np.int64)),
    ]
    x = np.zeros((n, 7), np.int8)
    x[5, 3] = 1
    x[:32, 4] = 1
    x[:, 5] = 1
    x[:, 6] = 1
    before = dict(sketch.SKETCH_WINDOWS)
    panel = _port_panel(windows, n=n, power_iters=0)
    assert sketch.SKETCH_WINDOWS["scatter"] - before["scatter"] == 2
    assert sketch.SKETCH_WINDOWS["dense"] - before["dense"] == 1
    coords, vals = sketch_eig(panel, K)
    ref_c, ref_v = exact_eig(x)
    np.testing.assert_allclose(vals, ref_v, rtol=SKETCH_TOPK_RTOL)
    assert np.abs(coords - ref_c).max() <= SKETCH_TOPK_ATOL
    np.testing.assert_array_equal(
        panel.row_sums, (x.astype(np.float64) @ x.sum(0)).ravel()
    )


def test_all_zero_cohort_yields_zero_coords():
    windows = [(np.empty(0, np.int64), np.zeros(4, np.int64))]
    coords, vals = sketch_eig(_port_panel(windows, n=9, power_iters=0), K)
    np.testing.assert_array_equal(coords, np.zeros((9, K)))
    np.testing.assert_array_equal(vals, np.zeros(K))


def test_same_seed_bit_identical_and_seeds_differ_within_bars():
    x, _ = structured_csr()
    a, av = sketch_eig(_structured_panel(seed=3), K)
    b, bv = sketch_eig(_structured_panel(seed=3), K)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(av, bv)
    c, cv = sketch_eig(_structured_panel(seed=1), K)
    assert np.abs(a - c).max() > 0
    for coords, vals in ((a, av), (c, cv)):
        assert_spectrum(coords, vals, *exact_eig(x), SKETCH_TOPK_RTOL,
                        SKETCH_TOPK_ATOL)


def test_footprint_bound_is_linear_not_quadratic():
    n = 1 << 20
    l = randomized_panel_width(n, 10)
    assert sketch_host_bytes(n, l) < (4 * n * n) // 1000
    assert sketch_host_bytes(2 * n, l) == pytest.approx(
        2 * sketch_host_bytes(n, l), rel=1e-6
    )
    assert sketch_host_bytes(n, l) == jax_sketch.sketch_host_bytes(n, l)
    panel = _structured_panel()
    assert panel.host_peak_bytes == sketch_host_bytes(N, panel.l)
    assert panel.y.nbytes + panel.omega.nbytes <= panel.host_peak_bytes
    assert panel.y.shape == (N, panel.l)


# -- the driver ---------------------------------------------------------------

DRIVER_COHORT = dict(population_structure=3, seed=3)


def _port_driver(mode="sketch", n=N, v=V, **kw):
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     block_variants=64, pca_mode=mode, device="cpu", **kw)
    return VariantsPcaDriver(conf, synthetic_cohort(n, v, **DRIVER_COHORT))


def _jax_driver(mode="sketch", n=N, v=V, **kw):
    conf = JaxConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     block_variants=64, pca_mode=mode, **kw)
    return JaxDriver(conf, jax_synthetic_cohort(n, v, **DRIVER_COHORT))


def _nonzero_line(out):
    return [line for line in out.splitlines() if "Non zero rows" in line]


@pytest.mark.parametrize("power_iters", [0, 2])
def test_driver_matches_the_jax_sketch_driver(power_iters, capsys):
    driver = _port_driver(sketch_power_iters=power_iters)
    before = scatter_kernel.SCATTER_KERNEL_LAUNCHES
    result = driver.run()
    out = capsys.readouterr().out
    want = _jax_driver(sketch_power_iters=power_iters).run()
    want_out = capsys.readouterr().out

    assert isinstance(driver.g, SketchPanel)
    assert scatter_kernel.SCATTER_KERNEL_LAUNCHES == before
    assert [r[0] for r in result] == [r[0] for r in want]
    got = np.array([r[1:] for r in result])
    assert np.isfinite(got).all()
    assert np.abs(got - np.array([r[1:] for r in want])).max() <= 1e-4
    assert _nonzero_line(out) and _nonzero_line(out) == _nonzero_line(
        want_out
    )
    rows = [l for l in out.splitlines() if l.count("\t") == 3]
    want_rows = [l for l in want_out.splitlines() if l.count("\t") == 3]
    assert [r.split("\t")[:2] for r in rows] == [
        r.split("\t")[:2] for r in want_rows
    ]


def test_sketch_driver_matches_stream_within_the_topk_bar(capsys):
    sketch_rows = _port_driver("sketch", sketch_power_iters=2).run()
    stream_rows = _port_driver("stream").run()
    capsys.readouterr()
    a = np.array([r[1:] for r in sketch_rows])
    b = np.array([r[1:] for r in stream_rows])
    assert np.abs(a - b).max() <= SKETCH_TOPK_ATOL
    assert [r[0] for r in sketch_rows] == [r[0] for r in stream_rows]


def test_nonzero_rows_print_survives_without_g(capsys):
    _port_driver("sketch").run()
    out_sketch = capsys.readouterr().out
    _port_driver("stream").run()
    out_stream = capsys.readouterr().out
    line = _nonzero_line(out_sketch)
    assert line and line[0] in out_stream.splitlines()


def test_sketch_selection_agrees_with_the_jax_driver(monkeypatch, capsys):
    for mode, want in (("sketch", True), ("stream", False),
                       ("auto", False), ("sparse", False)):
        port, ref = _port_driver(mode), _jax_driver(mode)
        assert port.sketch_selected() == ref.sketch_selected() == want
    port, ref = _port_driver("auto"), _jax_driver("auto")
    assert port._sparse_host_g_bytes() == ref._sparse_host_g_bytes()
    for driver in (port, ref):
        monkeypatch.setattr(
            driver, "_sparse_host_g_bytes", lambda: (4 << 30) + 1
        )
        assert driver.sketch_selected()
    capsys.readouterr()


class _SizedIndex:
    """A callset index of a given size, for the flip line."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("n,want", [(32768, False), (32769, True)])
def test_auto_flips_past_the_4_gib_g_bound(n, want):
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID], device="cpu")
    driver = VariantsPcaDriver(conf, None, index=_SizedIndex(n))
    ref = JaxDriver(JaxConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID]),
                    None, index=_SizedIndex(n))
    assert driver.sketch_selected() == ref.sketch_selected() == want
    assert driver._sparse_host_g_bytes() == 4 * n * n


def test_auto_past_the_bound_ingests_a_panel(monkeypatch, capsys):
    driver = _port_driver("auto")
    monkeypatch.setattr(
        driver, "_sparse_host_g_bytes",
        lambda: driver.SKETCH_AUTO_G_BYTES + 1,
    )
    panel = driver.ingest_gramian()
    capsys.readouterr()
    assert isinstance(panel, SketchPanel) and panel.y.shape[0] == N


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"pca_mode": "sketch", "checkpoint_dir": "/nonexistent"},
         "does not compose with checkpointed"),
        ({"pca_mode": "sketch", "precise": True}, "cannot honor --precise"),
        ({"pca_mode": "sketch", "sketch_oversample": 0},
         "sketch-oversample must be >= 1"),
        ({"pca_mode": "sketch", "sketch_power_iters": -1},
         "sketch-power-iters must be >= 0"),
    ],
    ids=["checkpoint", "precise", "oversample", "power-iters"],
)
def test_sketch_validations_raise_the_jax_errors(kw, match):
    settings = dict(variant_set_ids=[DEFAULT_VARIANT_SET_ID], **kw)
    with pytest.raises(ValueError, match=match) as got:
        VariantsPcaDriver(PcaConfig(device="cpu", **settings), None)
    with pytest.raises(ValueError) as want:
        JaxDriver(JaxConfig(**settings), None)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "argv",
    [[], ["--pca-mode", "sketch", "--sketch-oversample", "3",
          "--sketch-seed", "7", "--sketch-power-iters", "2"]],
    ids=["defaults", "set"],
)
def test_sketch_flags_parse_to_the_same_config(argv):
    port, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_pca_flags(port)
    jax_flags(ref)
    got, want = port.parse_args(argv), ref.parse_args(argv)
    for name in ("pca_mode", "sketch_oversample", "sketch_seed",
                 "sketch_power_iters"):
        assert getattr(got, name) == getattr(want, name)
        assert getattr(PcaConfig, name) == getattr(JaxConfig, name)


def test_cli_sketch_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "spark_examples_tpu_torch.cli.main", "pca",
         "--fixture-samples", "48", "--fixture-variants", "300",
         "--pca-mode", "sketch", "--sketch-power-iters", "1",
         "--block-variants", "64", "--device", "cpu",
         "--output-path", str(tmp_path / "cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "Non zero rows in matrix: 48 / 48." in out.stdout
    assert sum(l.count("\t") == 3 for l in out.stdout.splitlines()) == 48
    assert len((tmp_path / "cli-pca.tsv").read_text().splitlines()) == 48


def test_the_deterministic_scope_restores_the_setting():
    before = torch.are_deterministic_algorithms_enabled()
    with sketch._deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == before


def test_a_scatter_update_imports_no_compiler():
    """A process's first scatter window sets ATen's deterministic switch
    alone: ``torch.use_deterministic_algorithms`` would import
    ``torch._inductor`` (seconds a process, paid in its first window)."""
    code = (
        "import sys, numpy as np, torch\n"
        "from spark_examples_tpu_torch.ops.sketch import "
        "_sketch_scatter_update\n"
        "y = torch.zeros((6, 3)); om = torch.ones((7, 3)); om[6] = 0\n"
        "_sketch_scatter_update(y, om, np.array([0, 2, 1, 5]), "
        "np.array([2, 2]))\n"
        "assert y.sum() == 24, y\n"
        "print('torch._inductor' in sys.modules)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"
