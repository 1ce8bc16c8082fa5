"""Row emission from columns against the per-row Python loops.

``VariantsPcaDriver.emit_result`` renders the rows in the native host core
(``csrc/genomics_native.cpp``: an index sort over the names' UTF-8 bytes
and one TSV buffer, each float as ``repr`` prints it) and writes each text
at once; ``native=False`` takes the print and file loops, which are the
reference. On every case the two routes print the same bytes and write the
same ``-pca.tsv`` file, ``collect_result`` returns the same rows, and the
rows made from coordinates (``_emit_tuples``) equal the per-index loop's.
``emit_rows_total{route}`` counts the rows each route emitted, and the
formatter, one value a row, equals ``repr`` on the edge values and on
floats drawn across exponents.
"""

import contextlib
import io
import math

import numpy as np
import pytest

from spark_examples_tpu_torch import obs
from spark_examples_tpu_torch.genomics.callsets import CallsetIndex
from spark_examples_tpu_torch.genomics.fixtures import (
    DEFAULT_VARIANT_SET_ID,
    synthetic_cohort,
)
from spark_examples_tpu_torch.genomics.sources import FixtureSource
from spark_examples_tpu_torch.models import emission
from spark_examples_tpu_torch.models.pca import VariantsPcaDriver
from spark_examples_tpu_torch.utils.config import PcaConfig

EDGE = [-0.0, 0.0, 1.0, 1e16, 9.999999999999999e15, 1e-4, 1e-5, 5e-324,
        1.7976931348623157e308, math.inf, -math.inf]


def _spread(rng, size):
    """Floats of either sign, mantissas uniform, exponents -30 to 30."""
    sign = rng.choice([-1.0, 1.0], size)
    return sign * rng.random(size) * 10.0 ** rng.integers(-30, 31, size)


def _case_non_ascii():
    names = ["Ñandú", "北京-7", "🧬sample", "école", "ecole", "Zoë",
             "a\tb", "nul\x00name", "", "ASCII"]
    coords = np.linspace(-1.0, 1.0, 2 * len(names)).reshape(-1, 2)
    ids = [f"set{i % 3}-cs{i}" for i in range(len(names))]
    return names, ids, coords


def _case_duplicate_names():
    # Ties fall to pc1, then pc2, then the dataset; -0.0 equals 0.0, so
    # the last pair keeps its first order.
    rows = [("x", 0.5, 0.1, "b-1"), ("x", 0.25, 0.9, "b-2"),
            ("x", 0.25, 0.3, "b-3"), ("x", 0.25, 0.3, "a-4"),
            ("y", 0.0, 1.0, "c-5"), ("y", -0.0, 1.0, "c-6"),
            ("w", 2.0, 2.0, "d-7"), ("w", 2.0, 2.0, "d-8")]
    names, pc1, pc2, ids = zip(*rows)
    return list(names), list(ids), np.stack([pc1, pc2], 1)


def _case_duplicate_names_with_nan():
    names = ["q", "q", "q", "p", "r"]
    coords = np.array([[math.nan, 1.0], [0.5, 0.5], [0.5, math.nan],
                       [math.nan, math.nan], [1.0, 2.0]])
    return names, [f"s-{i}" for i in range(5)], coords


def _case_ids_without_a_dash():
    ids = ["plain", "a-b-c", "-lead", "trail-", "x--y", "ünï-code"]
    names = [f"S{i}" for i in range(len(ids))]
    return names, ids, np.arange(12, dtype=np.float64).reshape(6, 2) / 7


def _case_edge_coordinates():
    values = EDGE + [-v for v in EDGE[2:]] + [0.1, 1 / 3, 123456.789, 1e15,
                                              1e-5 * 9.99, 2.5e-308, 1e22]
    n = (len(values) + 1) // 2
    coords = np.array(values + [0.0] * (2 * n - len(values))).reshape(n, 2)
    return [f"E{i:02d}" for i in range(n)], [f"e-{i}" for i in range(n)], coords


def _case_random_floats():
    rng = np.random.default_rng(19)
    n = 50_000
    names = [f"R{v:05d}" for v in rng.integers(0, 30_000, n)]  # duplicates
    return names, [f"r{i % 7}-{i}" for i in range(n)], _spread(rng, (n, 2))


def _case_one_component():
    names = ["b", "a", "c"]
    return names, ["d-0", "d-1", "d-2"], np.array([[3.0], [1.0], [2.0]])


def _case_float32():
    rng = np.random.default_rng(3)
    names = [f"F{i}" for i in range(64)]
    coords = rng.standard_normal((64, 2)).astype(np.float32)
    return names, [f"f-{i}" for i in range(64)], coords


CASES = {
    "non_ascii": _case_non_ascii,
    "duplicate_names": _case_duplicate_names,
    "duplicate_names_with_nan": _case_duplicate_names_with_nan,
    "ids_without_a_dash": _case_ids_without_a_dash,
    "edge_coordinates": _case_edge_coordinates,
    "random_floats": _case_random_floats,
    "one_component": _case_one_component,
    "float32": _case_float32,
}


def _driver(names, ids, out_dir):
    index = CallsetIndex(indexes={c: i for i, c in enumerate(ids)},
                         names=dict(zip(ids, names)))
    conf = PcaConfig(device="cpu", variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                     output_path=str(out_dir / "run"))
    return VariantsPcaDriver(conf, FixtureSource(), index=index)


def _emitted(driver, rows, native):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        driver.emit_result(rows, native=native)
    with open(driver.conf.output_path + "-pca.tsv", "rb") as f:
        return out.getvalue(), f.read()


@pytest.mark.parametrize("case", list(CASES))
def test_the_native_rows_are_the_python_loops_bytes(case, tmp_path):
    names, ids, coords = CASES[case]()
    driver = _driver(names, ids, tmp_path)
    rows = driver._emit_tuples(coords)
    pc2 = coords[:, 1] if coords.shape[1] > 1 else np.zeros(len(coords))
    assert type(rows) is list
    # repr: exact for every float, and a NaN equals a NaN.
    assert repr(rows) == repr([(ids[i], float(coords[i, 0]), float(pc2[i]))
                               for i in range(len(ids))])
    assert all(type(v) is float for row in rows for v in row[1:])
    assert repr(driver.collect_result(rows)) == repr(driver.collect_result(
        rows, native=False))
    out, tsv = _emitted(driver, rows, native=True)
    want_out, want_tsv = _emitted(driver, rows, native=False)
    assert out == want_out
    assert tsv == want_tsv
    assert out.count("\n") == len(ids)
    # Rows in another order than the index's: each name looked up by id.
    back = rows[::-1]
    assert repr(driver.collect_result(back)) == repr(driver.collect_result(
        back, native=False))
    assert _emitted(driver, back, True) == _emitted(driver, back, False)


def test_a_lone_surrogate_name_sorts_and_prints_by_code_point(tmp_path):
    names = ["\ud800x", "￿", "\U00010000", "a"]
    ids = [f"s-{i}" for i in range(4)]
    driver = _driver(names, ids, tmp_path)
    rows = driver._emit_tuples(np.ones((4, 2)))
    got = driver.collect_result(rows)
    assert got == driver.collect_result(rows, native=False)
    assert [r[0] for r in got] == sorted(names)
    outs = []
    for native in (True, False):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            driver.conf.output_path = None
            driver.emit_result(rows, native=native)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


def test_no_rows_render_nothing():
    rows = emission.RowColumns([], {})
    order = rows.order()
    assert len(order) == 0 and rows.tuples(order) == []
    assert rows.render(order, emission.STDOUT_LAYOUT) == ""


def test_the_formatter_is_repr():
    rng = np.random.default_rng(11)
    values = np.concatenate([
        EDGE, [-v for v in EDGE], [math.nan, -math.nan, 0.1, 0.3, 1e-4 * 3],
        10.0 ** np.arange(-30, 31), _spread(rng, 100_000),
        rng.integers(0, 2**64, 20_000, dtype=np.uint64).view(np.float64),
    ]).tolist()
    # One row a value, its pc1, under the file layout "name\tpc1\tpc2\tset".
    ids = [f"v-{i}" for i in range(len(values))]
    rows = emission.RowColumns([(c, v, 0.0) for c, v in zip(ids, values)],
                               dict.fromkeys(ids, ""))
    text = rows.render(np.arange(len(values)), emission.FILE_LAYOUT)
    assert [line.split("\t")[1] for line in text.splitlines()] == list(
        map(repr, values))


def _rows_counted(route):
    key = f'emit_rows_total{{route="{route}"}}'
    return obs.get_registry().snapshot()["counters"].get(key, 0)


def test_emit_rows_total_counts_each_routes_rows(tmp_path):
    native0, python0 = _rows_counted("native"), _rows_counted("python")
    driver = VariantsPcaDriver(
        PcaConfig(device="cpu", variant_set_ids=[DEFAULT_VARIANT_SET_ID],
                  bases_per_partition=20000, block_variants=64),
        synthetic_cohort(40, 300, seed=5, population_structure=2),
    )
    with contextlib.redirect_stdout(io.StringIO()):
        rows = driver.run()
    assert len(rows) == 40
    assert _rows_counted("native") - native0 == 40
    assert _rows_counted("python") == python0
    with contextlib.redirect_stdout(io.StringIO()):
        driver.emit_result(rows, native=False)
    assert _rows_counted("python") - python0 == 40
    assert _rows_counted("native") - native0 == 40
