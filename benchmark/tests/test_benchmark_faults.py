"""A run with the timed path broken underneath comes out not correct, and
the control (the reference in the program's place, in bfloat16) fails the
comparison, at a size a test holds. The run skips the look for a card and
drives the port on the CPU; each fault is planted in the port for the
length of one run:

- ``unchanged``: every step of the product returns G (or the sketch
  panel) unchanged;
- ``half``: half of the blocks (or sketch windows) left out, the rest
  counted twice, as a mean over them would;
- ``altered``: one coordinate altered where the driver produces it.

A cell on one card has no exchange between cards to leave out.
"""

import numpy as np
import pytest

from benchmark import control, harness, spec as spec_mod


def _unchanged(monkeypatch):
    from spark_examples_tpu_torch.ops import gramian, sketch

    monkeypatch.setattr(gramian, "gramian_accumulate_packed",
                        lambda g, xb, compute_dtype=None: None)
    monkeypatch.setattr(sketch, "_sketch_dense_update",
                        lambda y, omega, xp: None)
    monkeypatch.setattr(sketch, "_sketch_scatter_update",
                        lambda y, omega, idx, lens: None)


def _half(monkeypatch):
    from spark_examples_tpu_torch.models import pca

    dense, panel = pca.gramian_blockwise, pca.sketch_panel_blockwise

    def half_dense(blocks, *a, **kw):
        return dense((b for i, b in enumerate(blocks) if i % 2 == 0),
                     *a, **kw) * 2

    def half_panel(factory, *a, **kw):
        out = panel(lambda: (w for i, w in enumerate(factory())
                             if i % 2 == 0), *a, **kw)
        out.y = out.y * 2
        return out

    monkeypatch.setattr(pca, "gramian_blockwise", half_dense)
    monkeypatch.setattr(pca, "sketch_panel_blockwise", half_panel)


def _altered(monkeypatch):
    from spark_examples_tpu_torch.models import pca

    emit = pca.VariantsPcaDriver._emit_tuples

    def altered(self, coords):
        rows = emit(self, coords)
        cid, pc1, pc2 = rows[0]
        rows[0] = (cid, pc1 + 1e-3, pc2)
        return rows

    monkeypatch.setattr(pca.VariantsPcaDriver, "_emit_tuples", altered)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}
CELLS = ["kg1000.chrom", "kg1000.gene", "ukb-wgs.sketch"]


def _run(root, cell):
    return harness.run_cell(spec_mod.load(root), cell, 2**31 + 7, 0.2,
                            trace=False, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    result = _run(small_root, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(small_root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(small_root, cell)
    assert not result["correct"]
    failing = [k for k, c in result["checks"].items()
               if c["value"] > c["limit"]]
    assert failing


@pytest.mark.parametrize(
    "cell", CELLS + ["kg1000.rare-sparse"])
def test_control_fails_the_comparison(small_root, cell):
    for seed in (1, 2, 3):
        out = control.control_numbers(spec_mod.load(small_root), cell, seed,
                                      "cpu")
        assert not out["control_passed"], out
        assert all(np.isfinite(n["value"]) for n in out["numbers"].values())


def test_sketch_control_fails_the_coordinate_limit(small_root):
    """The bfloat16 control of the sketch cell fails ``coord_gap`` itself,
    not only the panel's numbers: the coordinate limit sits below it."""
    for seed in (1, 2, 3):
        out = control.control_numbers(spec_mod.load(small_root),
                                      "ukb-wgs.sketch", seed, "cpu")
        gap = out["numbers"]["coord_gap"]
        assert gap["value"] > gap["limit"], out
