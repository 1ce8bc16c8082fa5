"""A cell on four cards whose jobs lay G out in tiles over a mesh of this
process's cards (``--mesh-shape data:2,model:2``, four copies of the CPU
here), checked matrix-free: G on a sample of whole row blocks in every
tile row and on every row's sum, the coordinates by ``eigsh`` on an
operator over the carrier lists. A sound run is correct; each fault
planted in the port for the length of one run, and the bfloat16 control
in the program's place, is not:

- ``tile_skipped``: one tile's accumulation skipped (tile (1, 1) keeps
  what it held before every window);
- ``unchanged``: every window leaves every tile unchanged;
- ``half``: half of the windows left out, the tiles doubled;
- ``altered``: one coordinate altered where the driver produces it;
- ``outside_sample``: one row block that the kept sample does not hold
  altered (only the row sums see it).

A cell whose mesh spans other cards than its ``chips`` is not correct.

On one process the tiles' copies of each window are the exchange between
cards: ``tile_skipped`` is a tile that never gets its share.
"""

import numpy as np
import pytest
import torch

from benchmark import check, control, harness, reference
from benchmark import spec as spec_mod
from benchmark.tests.conftest import _mix, small_configs, write_root
from benchmark.tests.test_benchmark_faults import _altered

MESH_FLAGS = ["--mesh-shape", "data:2,model:2"]
# kg1000.mesh's windows take the tiles' int8 product; ukb-wgs.mesh's the
# tile scatter (its threshold of 1 routes every window there).
CELLS = {"kg1000.mesh": "dense", "ukb-wgs.mesh": "scatter"}


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    kg, uk = small_configs()
    limits = {"gram_gap": 0, "coord_gap": 1e-4, "route_misses": 0}
    for cfg in (kg, uk):
        cfg["limits"] = dict(limits)
    mix = {"why": "test: an exact sparse G in tiles over a 2x2 mesh",
           "regions": "segment", "pca_mode": "sparse", "flags": MESH_FLAGS,
           "expect": {"sketch_jobs": "none"}}
    scatter = dict(mix, flags=MESH_FLAGS + ["--sparse-density-threshold",
                                            "1"])
    return write_root(
        str(tmp_path_factory.mktemp("mesh")),
        {"kg1000-p3": kg, "ukb-wgs": uk},
        {"mesh": mix, "mesh-scatter": scatter, "chrom": _mix("chrom")},
        {"kg1000.mesh": ("kg1000-p3", "mesh", 4),
         "ukb-wgs.mesh": ("ukb-wgs", "mesh-scatter", 4),
         "kg1000.chrom": ("kg1000-p3", "chrom"),
         # mesh and cards that disagree
         "kg1000.chrom-on-4": ("kg1000-p3", "chrom", 4),
         "kg1000.mesh-on-1": ("kg1000-p3", "mesh", 1)},
    )


def _tile_skipped(monkeypatch):
    from spark_examples_tpu_torch.parallel import sharded

    def skipping(step):
        def run(g, *a, **kw):
            before = g.tiles[1, 1].clone()
            step(g, *a, **kw)
            g.tiles[1, 1].copy_(before)
        return run

    monkeypatch.setattr(sharded, "_tile_scatter",
                        skipping(sharded._tile_scatter))
    monkeypatch.setattr(sharded, "_accumulate_tiles",
                        skipping(sharded._accumulate_tiles))


def _unchanged(monkeypatch):
    from spark_examples_tpu_torch.parallel import sharded

    monkeypatch.setattr(sharded, "_tile_scatter", lambda g, *a, **kw: None)
    monkeypatch.setattr(sharded, "_accumulate_tiles",
                        lambda g, *a, **kw: None)


def _half(monkeypatch):
    from spark_examples_tpu_torch.models import pca

    blockwise = pca.sparse_sharded_gramian_blockwise

    def half(windows, *a, **kw):
        g = blockwise((w for i, w in enumerate(windows) if i % 2 == 0),
                      *a, **kw)
        for _, tile in g.local_tiles():
            tile.mul_(2)
        return g

    monkeypatch.setattr(pca, "sparse_sharded_gramian_blockwise", half)


# The block ``outside_sample`` alters: tile row 1's fourth of 24 at the
# tests' ukb-wgs size (N = 3,000), which the first job's sample at
# ``_run``'s seed does not hold (the test checks that it does not).
OUTSIDE = slice(1500 + 3 * 64, 1500 + 4 * 64)


def _outside_sample(monkeypatch):
    from spark_examples_tpu_torch.models import pca

    blockwise = pca.sparse_sharded_gramian_blockwise

    def altered(windows, *a, **kw):
        g = blockwise(windows, *a, **kw)
        r0 = OUTSIDE.start - g.splits()[0][1].start
        g.tiles[1, 0][r0:r0 + OUTSIDE.stop - OUTSIDE.start, 0] += 1
        return g

    monkeypatch.setattr(pca, "sparse_sharded_gramian_blockwise", altered)


FAULTS = {"tile_skipped": _tile_skipped, "unchanged": _unchanged,
          "half": _half, "altered": _altered}


def _run(root, cell, trace=False):
    return harness.run_cell(spec_mod.load(root), cell, 2**31 + 11, 0.2,
                            trace=trace, device="cpu")


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_mesh_cell_runs_correct_on_four_cards(mesh_root, cell, trace):
    """The same cells on four CUDA cards (``-m card`` on a four-card
    machine): correct, every card counted."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    result = harness.run_cell(spec_mod.load(mesh_root), cell, 2**31 + 13,
                              2.0, trace=trace, device="cuda")
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]


def test_the_cell_carries_its_chips(mesh_root):
    spec = spec_mod.load(mesh_root)
    assert spec.cell("kg1000.mesh").chips == 4
    assert spec.cell("kg1000.chrom").chips == 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_mesh_run_is_correct(mesh_root, cell, capfd):
    result = _run(mesh_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["gram_gap"]["value"] == 0
    line = capfd.readouterr().err.split("routes over the window: ")[1]
    routes = dict(kv.rsplit("=", 1)
                  for kv in line.splitlines()[0].split(", "))
    windows = {k: float(v) for k, v in routes.items()
               if k.startswith("sparse_gramian_windows_total") and float(v)}
    assert list(windows) == [
        f'sparse_gramian_windows_total{{route="{CELLS[cell]}"}}']


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_mesh_run_is_not_correct(mesh_root, cell, fault,
                                        monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(mesh_root, cell)
    assert not result["correct"]
    failing = {k for k, c in result["checks"].items()
               if c["value"] > c["limit"]}
    if fault == "altered":
        assert failing == {"coord_gap"}
    else:
        assert "gram_gap" in failing


def test_a_block_outside_the_sample_fails_the_row_sums(mesh_root,
                                                       monkeypatch):
    """A row block that no kept sample holds, altered in the port: the
    sampled rows read no gap, the row sums do, and the run is not
    correct."""
    sampled = []
    row_sample = harness._row_sample

    def spy(g, rng):
        out = row_sample(g, rng)
        sampled.append(out)
        return out

    monkeypatch.setattr(harness, "_row_sample", spy)
    monkeypatch.setattr(harness, "KEPT_OUTPUTS", 1)
    _outside_sample(monkeypatch)
    result = _run(mesh_root, "ukb-wgs.mesh")
    assert not result["correct"]
    assert result["checks"]["gram_gap"]["value"] > 0
    (kept,) = sampled
    assert not np.isin(np.arange(OUTSIDE.start, OUTSIDE.stop),
                       kept.rows).any()
    # The same sample without the row sums: no gap.
    spec = spec_mod.load(mesh_root)
    cell = spec.cell("ukb-wgs.mesh")
    from benchmark import cohort as cohort_mod, jobs as jobs_mod

    cohort = cohort_mod.draw(cell.config, cell.mix, 2**31 + 11)
    (job,) = jobs_mod.plan(cell.config, cell.mix, cohort, "", 2**31 + 11,
                           "cpu")
    want = check.reference_rows(cohort, job, kept.rows)
    assert np.array_equal(kept.values, want.values)
    assert (kept.row_sums != want.row_sums).sum() == OUTSIDE.stop - \
        OUTSIDE.start


def test_row_sums_catch_what_the_rows_miss():
    want = check.RowSample(np.array([0, 1]), np.eye(4)[:2],
                           np.ones(4))
    got = check.RowSample(want.rows, want.values.copy(), want.row_sums.copy())
    assert check.gaps({"g": want}, g=got) == {"gram_gap": 0.0}
    got.row_sums[3] += 2
    assert check.gaps({"g": want}, g=got) == {"gram_gap": 2.0}


@pytest.mark.parametrize("cell", ["kg1000.chrom-on-4", "kg1000.mesh-on-1"])
def test_a_mesh_that_is_not_the_cells_cards_is_not_correct(mesh_root, cell):
    """A cell on four cards whose jobs run on one, and a cell on one card
    whose jobs span a mesh of four: every output right, one route
    missed."""
    result = _run(mesh_root, cell)
    assert not result["correct"]
    assert result["checks"]["route_misses"]["value"] == 1
    assert result["checks"]["gram_gap"]["value"] == 0
    assert result["checks"]["coord_gap"]["value"] < 1e-4


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_mesh_control_fails_the_comparison(mesh_root, cell):
    for seed in (1, 2, 3):
        out = control.control_numbers(spec_mod.load(mesh_root), cell, seed,
                                      "cpu")
        assert not out["control_passed"], out
        assert set(out["numbers"]) == {"coord_gap", "gram_gap"}
        assert out["numbers"]["coord_gap"]["value"] > 1e-4, out


def test_row_sample_reads_every_tile_row():
    """The kept rows are whole rows of G, in blocks drawn from the seed,
    some in every tile row, copied from the tiles."""
    from spark_examples_tpu_torch.parallel.mesh import make_mesh
    from spark_examples_tpu_torch.parallel.sharded import ShardedGramian

    n = 301  # padded to 304: tile rows of 152, blocks of 64
    g = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    grid = ShardedGramian.from_full(g, make_mesh("data:2,model:2",
                                                 device="cpu"))
    sample = harness._row_sample(grid, np.random.default_rng(3))
    assert np.array_equal(sample.values, g.numpy()[sample.rows])
    assert np.array_equal(sample.row_sums,
                          g.to(torch.float64).sum(1).numpy())
    assert len(set(sample.rows.tolist())) == sample.rows.size
    # Two blocks a tile row: tile row 0 holds three whole ones, tile row 1
    # two and 21 rows to n.
    assert (sample.rows < 152).sum() == 128
    assert (sample.rows >= 152).sum() in (85, 128)
    again = harness._row_sample(grid, np.random.default_rng(3))
    assert np.array_equal(again.rows, sample.rows)
    # Each tile row's last block is cut at its end, and at n.
    blocks = check.sample_row_blocks([slice(0, 152), slice(152, 301)],
                                     np.random.default_rng(0))
    assert all(b.stop <= (152, 301)[p] for p, b in blocks)


@pytest.mark.parametrize("config", ["kg1000-p3", "ukb-wgs"])
@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 7])
def test_matrix_free_coordinates_are_the_dense_ones(config, seed):
    """``eigsh`` on the carrier operator gives the dense ``eigh``
    coordinates of the committed configurations at the tests' sizes to
    1e-12 (they read 4e-16 to 3e-14): eight orders under the 1e-4 bar and
    four under the program's readings."""
    cfg = dict(zip(["kg1000-p3", "ukb-wgs"], small_configs()))[config]
    cohort = cohort_of(cfg, seed)
    dense = reference.coordinates(
        reference.gramian(cohort, 0, cohort.sites), 2)
    free = reference.coordinates_matrix_free(cohort, 0, cohort.sites, 2,
                                             seed)
    assert check._coord_gap(free, dense) < 1e-12
    rows = np.array([0, 7, cohort.n - 1])
    assert np.array_equal(
        reference.gramian_rows(cohort, 0, cohort.sites, rows),
        reference.gramian(cohort, 0, cohort.sites).numpy()[rows])


def cohort_of(cfg, seed):
    from benchmark import cohort as cohort_mod

    return cohort_mod.draw(cfg, {}, seed)


def _two_card_trace():
    from benchmark.trace import Trace

    device = [(0, 10, "k1", 0), (5, 20, "k2", 0), (50, 60, "k1", 1),
              (55, 70, "k3", 1), (90, 95, "k1", 0)]
    ranges = {"bench.window": [(1, 0, 100)], "bench.job": [(1, 0, 100)],
              "pca": [(1, 40, 100)]}
    return Trace(device, ranges, {}, (0, 100), cards=2)


def test_trace_on_two_cards_is_each_cards_mean():
    t = _two_card_trace()
    # card 0: 0-20 and 90-95 (25 us); card 1: 50-70 (20 us)
    assert t.busy_us() == 22.5
    idle = spec_mod.load().reader("device_idle")
    assert idle(harness.Run(jobs=[], trace=t)) == 77.5
    # idle with no card busy: 20-50, 70-90, 95-100
    assert dict(t.idle_gaps()) == pytest.approx(
        {"bench.job": 20e-6, "pca": 35e-6})
    assert dict(t.device_ops())["k1"] == pytest.approx(25e-6)


def test_trace_on_one_card_reads_as_before():
    """A one-card run's events, all on card 0, read as the one card's
    union did: ``merged_busy_us`` over every event."""
    from benchmark.trace import Trace, merged_busy_us

    t2 = _two_card_trace()
    t = Trace([(*e[:3], 0) for e in t2.device], t2.ranges, {}, (0, 100))
    union = merged_busy_us([e[:2] for e in t2.device], 0, 100)
    assert union == 45
    assert t.busy_us() == union
    assert t.idle_gaps() == t2.idle_gaps()
    assert t.device_ops() == t2.device_ops()
    assert t.kernel_us(["k1"]) == 25


def test_run_refuses_a_cell_on_more_cards_than_it_sees(mesh_root,
                                                       monkeypatch, capsys):
    from benchmark import run

    ran = []
    monkeypatch.setattr(spec_mod, "load",
                        lambda root=None: spec_mod.Spec(mesh_root))
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **kw: ran.append(a[1]) or {"ok": 1})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def main(cell, cards):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        code = run.main(["--workload", cell, "--seed", "1", "--seconds",
                         "1"])
        return code, capsys.readouterr()

    for cards in (0, 1, 3):
        code, out = main("kg1000.mesh", cards)
        assert code != 0 and out.out == ""
        assert f"runs on 4 CUDA card(s); {cards} visible" in out.err
    assert ran == []
    assert main("kg1000.mesh", 4)[0] == 0
    assert main("kg1000.chrom", 1)[0] == 0
    assert ran == ["kg1000.mesh", "kg1000.chrom"]
