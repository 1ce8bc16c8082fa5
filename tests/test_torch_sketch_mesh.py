"""The sketch's mesh half against the meshless port, the exact spectrum and
the JAX package's mesh run.

Both packages run the same numpy-seeded CSR windows on the CPU in one
process: the port's mesh repeats the CPU device, the JAX package's takes
the virtual CPU devices of ``tests/conftest.py``. The bars are the JAX
package's own (``tests/test_sketch.py:161-168, 309-316, 356-366, 432-449,
784-830``):

- a mesh panel against the meshless one and the JAX package's mesh panel
  of the same shape: coordinates within 1e-4, eigenvalues within rtol
  1e-5, row sums within rtol 1e-6; the top k within ``SKETCH_TOPK_*`` of
  the exact spectrum; ``n_padded`` a multiple of the device count, the pad
  rows zero and ``host_peak_bytes`` the formula; every window applied
  once a pass;
- ``sketch_tsqr``: ``Q·R`` within 1e-5 relative of the panel, ``QᵀQ``
  within 1e-5 of I, R numpy's up to the signs of its rows; below ``l``
  rows a device the finish takes the host QR (the JAX package's route);
- a pod of two gloo ranks (spawned once for the module, as
  ``tests/test_torch_pod_gramian.py`` does): the panel over each rank's
  window slice against the meshless and the exact run, on both density
  routes and at pipeline depth 0, the TSQR across the ranks, and
  ``pca --pca-mode sketch --mesh-shape`` whose rank-0 rows match one
  process's;
- the driver, ``auto``'s flip on a mesh and a meshed engine's sketch job
  against the JAX driver on its mesh.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from spark_examples_tpu.models.pca import VariantsPcaDriver as JaxDriver
from spark_examples_tpu.genomics.fixtures import (
    synthetic_cohort as jax_synthetic_cohort,
)
from spark_examples_tpu.arrays.blocks import csr_windows as jax_csr_windows
from spark_examples_tpu.ops import sketch as jax_sketch
from spark_examples_tpu.parallel import make_mesh as jax_make_mesh
from spark_examples_tpu.parallel.sharded import (
    sharded_sketch_panel as jax_sharded_sketch_panel,
)
from spark_examples_tpu.serving import AnalysisEngine as JaxEngine
from spark_examples_tpu.utils.config import PcaConfig as JaxConfig
from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.arrays.blocks import csr_windows
from spark_examples_tpu_torch.cli import main as cli
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.ops.pcoa import (
    normalize_eigvec_signs,
    randomized_panel_width,
)
from spark_examples_tpu_torch.ops.sketch import (
    SKETCH_TOPK_ATOL,
    SKETCH_TOPK_RTOL,
    SketchPanel,
    sketch_eig,
    sketch_host_bytes,
    sketch_panel_blockwise,
)
from spark_examples_tpu_torch.parallel.mesh import make_mesh
from spark_examples_tpu_torch.parallel.sharded import (
    sharded_sketch_finish,
    sharded_sketch_panel,
    sketch_tsqr,
)
from spark_examples_tpu_torch.serving import AnalysisEngine
from spark_examples_tpu_torch.utils.config import PcaConfig

K = 2
N, V = 36, 240
BLOCK = 32
COORD_TOL = 1e-4
VALS_RTOL = 1e-5
ROW_SUMS_RTOL = 1e-6
SPECS = ["data:1", "data:2", "data:2,model:2", "data:4"]


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
    cols, rows = np.nonzero(x.T)
    lens = np.bincount(cols, minlength=v)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return x, (rows.astype(np.int64), offsets)


def exact_eig(x, k=K):
    xf = np.asarray(x, np.float64)
    g = xf @ xf.T
    h = np.eye(g.shape[0]) - 1.0 / g.shape[0]
    w, u = np.linalg.eigh(h @ g @ h)
    order = np.argsort(w)[::-1][:k]
    return normalize_eigvec_signs(u[:, order]), w[order]


def _devices(spec):
    return int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))


def _port_panel(mesh=None, seed=1, power_iters=2, **kw):
    _, pair = structured_csr()

    def factory():
        return csr_windows(iter([pair]), BLOCK)

    if mesh is None:
        return sketch_panel_blockwise(
            factory, N, K, power_iters=power_iters, seed=seed,
            block_variants=BLOCK, device="cpu", **kw,
        )
    return sharded_sketch_panel(
        factory, N, K, mesh, power_iters=power_iters, seed=seed,
        block_variants=BLOCK, **kw,
    )


_JAX_MESH_RUNS = {}


def _jax_mesh_run(spec, **kw):
    """The JAX package's mesh panel and finish on ``spec``'s shape."""
    key = (spec, tuple(sorted(kw.items())))
    if key not in _JAX_MESH_RUNS:
        _, pair = structured_csr()
        mesh = jax_make_mesh(spec, devices=jax.devices()[:_devices(spec)])
        panel = jax_sharded_sketch_panel(
            lambda: jax_csr_windows(iter([pair]), BLOCK), N, K, mesh,
            power_iters=2, seed=1, block_variants=BLOCK, **kw,
        )
        coords, vals = jax_sketch.sketch_eig(panel, K)
        _JAX_MESH_RUNS[key] = (panel, np.asarray(coords), np.asarray(vals))
    return _JAX_MESH_RUNS[key]


@pytest.fixture(scope="module")
def meshless():
    panel = _port_panel()
    coords, vals = sketch_eig(panel, K)
    return panel, coords, vals


def _windows_counter():
    counter = obs.get_registry().counter(
        "sketch_windows_total",
        "CSR windows applied to the randomized sketch panel",
    )
    return sum(counter.labels(route=r).value for r in ("scatter", "dense"))


# -- the single-controller mesh ----------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_topk_matches_exact(spec):
    x, _ = structured_csr()
    coords, vals = sketch_eig(_port_panel(make_mesh(spec, device="cpu")), K)
    ref_c, ref_v = exact_eig(x)
    np.testing.assert_allclose(vals, ref_v, rtol=SKETCH_TOPK_RTOL)
    assert np.abs(coords - ref_c).max() <= SKETCH_TOPK_ATOL


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_matches_meshless_same_seed(spec, meshless):
    panel, coords, vals = meshless
    got = _port_panel(make_mesh(spec, device="cpu"))
    got_coords, got_vals = sketch_eig(got, K)
    assert np.abs(got_coords - coords).max() <= COORD_TOL
    np.testing.assert_allclose(got_vals, vals, rtol=VALS_RTOL)
    np.testing.assert_allclose(got.row_sums, panel.row_sums,
                               rtol=ROW_SUMS_RTOL)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_matches_the_jax_mesh_run(spec):
    got = _port_panel(make_mesh(spec, device="cpu"))
    got_coords, got_vals = sketch_eig(got, K)
    want, want_coords, want_vals = _jax_mesh_run(spec)
    assert got.y.shape == np.asarray(want.y).shape
    assert got.host_peak_bytes == want.host_peak_bytes
    np.testing.assert_array_equal(got.row_sums, want.row_sums)
    assert np.abs(got_coords - want_coords).max() <= COORD_TOL
    np.testing.assert_allclose(got_vals, want_vals, rtol=VALS_RTOL)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_panel_bound_covers_padded_rows(spec):
    x, _ = structured_csr()
    panel = _port_panel(make_mesh(spec, device="cpu"))
    n_padded = panel.y.shape[0]
    assert n_padded >= N and n_padded % _devices(spec) == 0
    assert panel.omega.shape == panel.y.shape
    assert panel.host_peak_bytes == sketch_host_bytes(n_padded, panel.l)
    np.testing.assert_array_equal(panel.y[N:], 0.0)
    np.testing.assert_array_equal(panel.omega[N:], 0.0)
    np.testing.assert_array_equal(
        panel.row_sums, (x.astype(np.float64) @ x.sum(0)).ravel()
    )


@pytest.mark.parametrize("threshold", [0.0, 2.0], ids=["dense", "scatter"])
def test_each_route_on_a_mesh_counts_every_window_each_pass(threshold,
                                                            meshless):
    _, pair = structured_csr()
    n_windows = len(list(csr_windows(iter([pair]), BLOCK)))
    before = _windows_counter()
    got = _port_panel(make_mesh("data:2", device="cpu"),
                      density_threshold=threshold)
    assert _windows_counter() - before == 3 * n_windows  # 2 power iters
    want = _port_panel(density_threshold=threshold)
    coords, vals = sketch_eig(got, K)
    want_coords, want_vals = sketch_eig(want, K)
    assert np.abs(coords - want_coords).max() <= COORD_TOL
    np.testing.assert_allclose(vals, want_vals, rtol=VALS_RTOL)


def test_all_zero_cohort_on_a_mesh_gives_zero_coords():
    windows = [(np.empty(0, np.int64), np.zeros(4, np.int64))]
    panel = sharded_sketch_panel(
        lambda: iter(windows), 9, K, make_mesh("data:2", device="cpu"),
        power_iters=0,
    )
    coords, vals = sketch_eig(panel, K)
    np.testing.assert_array_equal(coords, np.zeros((9, K)))
    np.testing.assert_array_equal(vals, np.zeros(K))


# -- the TSQR ----------------------------------------------------------------


def _assert_tsqr(q_blocks, r, y):
    q = np.concatenate([np.asarray(b) for b in q_blocks]).astype(np.float64)
    r = np.asarray(r, np.float64)
    assert np.linalg.norm(q @ r - y) / np.linalg.norm(y) <= 1e-5
    assert np.abs(q.T @ q - np.eye(y.shape[1])).max() <= 1e-5
    _, r_np = np.linalg.qr(y)
    np.testing.assert_allclose(
        np.abs(r), np.abs(r_np), atol=1e-5 * np.abs(r_np).max()
    )
    signs = np.sign(np.diag(r)) * np.sign(np.diag(r_np))
    np.testing.assert_allclose(
        r * signs[:, None], r_np, atol=1e-5 * np.abs(r_np).max()
    )


@pytest.mark.parametrize("spec,rows", [("data:1", 24), ("data:2", 40),
                                       ("data:2,model:2", 48),
                                       ("data:4", 64)])
def test_tsqr_is_numpys_qr(spec, rows):
    y = np.random.default_rng(3).standard_normal((rows, 10))
    q, r = sketch_tsqr(torch.from_numpy(y), make_mesh(spec, device="cpu"))
    assert len(q) == _devices(spec)
    assert all(b.shape == (rows // _devices(spec), 10) for b in q)
    _assert_tsqr([b.numpy() for b in q], r.numpy(), y)


def test_tsqr_refuses_fewer_rows_a_device_than_columns():
    y = torch.zeros((36, 10))
    with pytest.raises(ValueError, match="n_padded / devices >= l"):
        sketch_tsqr(y, make_mesh("data:4", device="cpu"))


@pytest.mark.parametrize("spec", ["data:2,model:2", "data:4"])
def test_finish_takes_the_host_qr_below_l_rows_a_device(spec, monkeypatch):
    from spark_examples_tpu_torch.parallel import sharded

    panel = _port_panel(make_mesh(spec, device="cpu"))
    assert panel.y.shape[0] // _devices(spec) < panel.l
    calls = []
    monkeypatch.setattr(sharded, "sketch_tsqr",
                        lambda *a: calls.append(a))
    coords, vals = sharded_sketch_finish(panel, K)
    assert not calls
    want_coords, want_vals = jax_sketch.sketch_eig(
        _jax_mesh_run(spec)[0], K
    )
    assert np.abs(normalize_eigvec_signs(coords[:N, :K])
                  - np.asarray(want_coords)).max() <= COORD_TOL
    np.testing.assert_allclose(vals[:K], want_vals, rtol=VALS_RTOL)


def test_finish_on_a_mesh_uses_the_tsqr(monkeypatch):
    from spark_examples_tpu_torch.parallel import sharded

    panel = _port_panel(make_mesh("data:2", device="cpu"))
    real, calls = sharded.sketch_tsqr, []

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(sharded, "sketch_tsqr", spy)
    coords, vals = sketch_eig(panel, K)
    assert len(calls) == 1
    meshless = SketchPanel(
        y=panel.y[:N], omega=panel.omega[:N], row_sums=panel.row_sums, n=N,
        k=K, l=panel.l, seed=panel.seed, power_iters=panel.power_iters,
    )
    want_coords, want_vals = sketch_eig(meshless, K)
    assert np.abs(coords - want_coords).max() <= COORD_TOL
    np.testing.assert_allclose(vals, want_vals, rtol=VALS_RTOL)


# -- the driver, auto's flip and a meshed engine ------------------------------

COHORT = dict(population_structure=3, seed=3)


def _driver_rows(mode, mesh_spec=None, **kw):
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     block_variants=64, pca_mode=mode, device="cpu", **kw)
    mesh = make_mesh(mesh_spec, device="cpu") if mesh_spec else None
    driver = VariantsPcaDriver(conf, synthetic_cohort(N, V, **COHORT),
                               mesh=mesh)
    return driver, driver.run()


def _jax_driver_rows(mode, mesh_spec=None, **kw):
    conf = JaxConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     block_variants=64, pca_mode=mode, **kw)
    mesh = (jax_make_mesh(mesh_spec,
                          devices=jax.devices()[:_devices(mesh_spec)])
            if mesh_spec else None)
    return JaxDriver(conf, jax_synthetic_cohort(N, V, **COHORT),
                     mesh=mesh).run()


def _assert_rows(got, want, tol=COORD_TOL):
    assert [r[0] for r in got] == [r[0] for r in want]
    assert np.abs(np.array([r[1:] for r in got])
                  - np.array([r[1:] for r in want])).max() <= tol


def test_driver_sketch_on_a_mesh_matches_meshless_and_jax(capsys):
    driver, rows = _driver_rows("sketch", "data:2,model:2",
                                sketch_power_iters=2)
    assert isinstance(driver.g, SketchPanel) and driver.g.mesh is not None
    _, plain = _driver_rows("sketch", sketch_power_iters=2)
    _assert_rows(rows, plain)
    _assert_rows(rows, _jax_driver_rows("sketch", "data:2,model:2",
                                        sketch_power_iters=2))
    _, stream = _driver_rows("stream")
    _assert_rows(rows, stream, SKETCH_TOPK_ATOL)
    out = capsys.readouterr().out
    assert f"Non zero rows in matrix: {N} / {N}." in out


def test_auto_flips_to_the_sketch_on_a_mesh(monkeypatch):
    monkeypatch.setattr(VariantsPcaDriver, "SKETCH_AUTO_G_BYTES", 0)
    monkeypatch.setattr(JaxDriver, "SKETCH_AUTO_G_BYTES", 0)
    driver, rows = _driver_rows("auto", "data:2")
    assert driver.sketch_selected() and isinstance(driver.g, SketchPanel)
    _assert_rows(rows, _jax_driver_rows("auto", "data:2"))


def test_a_meshed_engine_runs_sketch_jobs():
    conf = PcaConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     block_variants=64, pca_mode="sketch", device="cpu",
                     sketch_power_iters=2)
    engine = AnalysisEngine(synthetic_cohort(N, V, **COHORT),
                            mesh=make_mesh("data:2,model:2", device="cpu"),
                            device="cpu")
    assert engine.delta_stats() is None
    rows = engine.run(conf)
    jax_rows = JaxEngine(
        jax_synthetic_cohort(N, V, **COHORT),
        mesh=jax_make_mesh("data:2,model:2", devices=jax.devices()[:4]),
    ).run(JaxConfig(variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                    block_variants=64, pca_mode="sketch",
                    sketch_power_iters=2))
    assert [(r[0], r[3]) for r in rows] == [(r[0], r[3]) for r in jax_rows]
    np.testing.assert_allclose(np.array([r[1:3] for r in rows]),
                               np.array([r[1:3] for r in jax_rows]),
                               atol=COORD_TOL)


# -- the pod: two gloo ranks --------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(script_path, argv, n=2, timeout=120):
    """Spawn ``n`` ranks of one gloo process group and collect their logs;
    a rank left blocked is killed, never leaked."""
    env = {
        **os.environ,
        "PYTHONPATH": ROOT,
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(_free_port()),
        "WORLD_SIZE": str(n),
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(script_path)] + [str(a) for a in argv],
            env={**env, "RANK": str(i), "LOCAL_RANK": str(i)},
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(n)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs

_POD_WORKER = textwrap.dedent(
    """
    import contextlib, io, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from spark_examples_tpu_torch import obs
    from spark_examples_tpu_torch.arrays.blocks import csr_windows
    from spark_examples_tpu_torch.cli import main as cli
    from spark_examples_tpu_torch.ops.sketch import sketch_eig
    from spark_examples_tpu_torch.parallel import distributed, make_mesh
    from spark_examples_tpu_torch.parallel.mesh import mesh_spans_processes
    from spark_examples_tpu_torch.parallel.sharded import (
        sharded_sketch_panel, sketch_tsqr)

    out_dir, plan = sys.argv[1], json.loads(sys.argv[2])
    assert distributed.initialize_from_env("cpu")
    pid, world = distributed.process_index(), distributed.process_count()
    n, v, pops = 36, 240, 3
    rng = np.random.default_rng(0)
    labels = np.arange(n) % pops
    x = np.zeros((n, v), np.int8)
    for j in range(v):
        x[:, j] = rng.random(n) < np.where(labels == (j % pops), 0.85, 0.05)
    cols, rows = np.nonzero(x.T)
    lens = np.bincount(cols, minlength=v)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    windows = list(csr_windows(iter([(rows.astype(np.int64), offsets)]),
                               32))
    mine = windows[pid::world]
    counter = obs.get_registry().counter(
        "sketch_windows_total",
        "CSR windows applied to the randomized sketch panel")

    def total():
        return sum(counter.labels(route=r).value
                   for r in ("scatter", "dense"))

    report = {"my_windows": len(mine), "runs": {}}
    for name, (spec, kw) in plan["runs"].items():
        mesh = make_mesh(spec, device="cpu")
        assert mesh_spans_processes(mesh)
        before = total()
        panel = sharded_sketch_panel(
            lambda: iter(mine), n, 2, mesh, power_iters=2, seed=1,
            block_variants=32, **kw)
        windows_delta = total() - before
        coords, vals = sketch_eig(panel, 2)
        report["runs"][name] = {
            "coords": np.asarray(coords).tolist(),
            "vals": np.asarray(vals).tolist(),
            "row_sums": np.asarray(panel.row_sums).tolist(),
            "n_padded": int(panel.y.shape[0]),
            "host_peak_bytes": int(panel.host_peak_bytes),
            "windows_delta": windows_delta,
        }
    y = np.random.default_rng(3).standard_normal((48, 10))
    q, r = sketch_tsqr(torch.from_numpy(y),
                       make_mesh("data:2,model:2", device="cpu"))
    report["tsqr"] = {
        "blocks": {str(i): b.numpy().tolist()
                   for i, b in enumerate(q) if b is not None},
        "r": r.numpy().tolist()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["pca", *plan["cli"]]) == 0
    report["stdout"] = buf.getvalue()
    with open(os.path.join(out_dir, f"rank{pid}.json"), "w") as f:
        json.dump(report, f)
    # Tear the group down together before exiting, as torch asks, so no
    # rank's exit races a peer's teardown.
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    """
)

POD_RUNS = {
    "mixed-2x2": ("data:2,model:2", {}),
    "scatter-4": ("data:4", {"density_threshold": 2.0}),
    "dense-lockstep-2x2": ("data:2,model:2", {"density_threshold": 0.0,
                                              "pipeline_depth": 0}),
}
POD_CLI = ["--fixture-samples", "36", "--fixture-variants", "240",
           "--fixture-seed", "3", "--bases-per-partition", "20000",
           "--block-variants", "32", "--device", "cpu", "--pca-mode",
           "sketch", "--sketch-power-iters", "2"]


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    work = tmp_path_factory.mktemp("sketchpod")
    script = work / "worker.py"
    script.write_text(_POD_WORKER)
    plan = {"runs": POD_RUNS,
            "cli": POD_CLI + ["--mesh-shape", "data:2,model:2"]}
    _run_workers(script, [work, json.dumps(plan)], n=2)
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("run", sorted(POD_RUNS))
def test_pod_sketch_matches_meshless_and_exact(run, pod):
    spec, kw = POD_RUNS[run]
    x, _ = structured_csr()
    threshold = kw.get("density_threshold")
    single = _port_panel(
        **({} if threshold is None else {"density_threshold": threshold}))
    single_coords, single_vals = sketch_eig(single, K)
    jax_single = jax_sketch.sketch_panel_blockwise(
        lambda: jax_csr_windows(iter([structured_csr()[1]]), BLOCK), N, K,
        power_iters=2, seed=1, block_variants=BLOCK,
        **({} if threshold is None else {"density_threshold": threshold}),
    )
    jax_coords, jax_vals = jax_sketch.sketch_eig(jax_single, K)
    ref_c, ref_v = exact_eig(x)
    for rank, report in enumerate(pod):
        got = report["runs"][run]
        coords, vals = np.asarray(got["coords"]), np.asarray(got["vals"])
        np.testing.assert_allclose(vals, ref_v, rtol=SKETCH_TOPK_RTOL)
        assert np.abs(coords - ref_c).max() <= SKETCH_TOPK_ATOL
        for want_c, want_v in ((single_coords, single_vals),
                               (jax_coords, jax_vals)):
            assert np.abs(coords - np.asarray(want_c)).max() <= COORD_TOL
            np.testing.assert_allclose(vals, want_v, rtol=VALS_RTOL)
        np.testing.assert_allclose(
            np.asarray(got["row_sums"]),
            (x.astype(np.float64) @ x.sum(0)).ravel(), rtol=ROW_SUMS_RTOL)
        # Every local window entered the protocol once a pass (3 passes).
        assert got["windows_delta"] == 3 * report["my_windows"]
        assert got["n_padded"] % _devices(spec) == 0
        assert got["host_peak_bytes"] == sketch_host_bytes(
            got["n_padded"], randomized_panel_width(N, K))


def test_pod_tsqr_spans_the_ranks(pod):
    y = np.random.default_rng(3).standard_normal((48, 10))
    blocks = {}
    for report in pod:
        blocks.update({int(i): np.asarray(b)
                       for i, b in report["tsqr"]["blocks"].items()})
    assert sorted(blocks) == [0, 1, 2, 3]
    r0, r1 = (np.asarray(rep["tsqr"]["r"]) for rep in pod)
    np.testing.assert_array_equal(r0, r1)  # one replicated second level
    _assert_tsqr([blocks[i] for i in range(4)], r0, y)


def test_pod_cli_sketch_prints_the_one_process_rows(pod):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["pca", *POD_CLI]) == 0
    want = [ln for ln in buf.getvalue().splitlines() if ln.count("\t") == 3]
    got = [ln for ln in pod[0]["stdout"].splitlines() if ln.count("\t") == 3]
    assert [ln.split("\t")[:2] for ln in got] == [
        ln.split("\t")[:2] for ln in want]
    diff = max(abs(float(a) - float(b))
               for g, w in zip(got, want)
               for a, b in zip(g.split("\t")[2:], w.split("\t")[2:]))
    assert diff <= COORD_TOL
    assert not [ln for ln in pod[1]["stdout"].splitlines()
                if ln.count("\t") == 3]
