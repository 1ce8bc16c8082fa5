"""Row emission from columns: the order and the bytes of ``emitResult``.

The driver's rows are ``(callset id, pc1, pc2)``. The reference prints each
as ``name\\tdataset\\tpc1\\tpc2`` and writes ``name\\tpc1\\tpc2\\tdataset``
into the ``-pca.tsv`` file, in the order Python's ``sorted`` gives the
``(name, pc1, pc2, dataset)`` tuples, every float as ``repr`` shows it; the
dataset label is the id up to its first ``-`` (VariantsPca.scala:231-244).

:class:`RowColumns` holds the rows as columns. The native host core
(``csrc/genomics_native.cpp``) sorts an index permutation over the names'
UTF-8 bytes (UTF-8 byte order is code-point order) and renders every row
into one buffer, which the driver writes at once. The per-row Python loops
(``VariantsPcaDriver.emit_result(native=False)``) are the tests'
reference; ``emit_rows_total{route}`` counts the rows each route emitted.
"""

from __future__ import annotations

from operator import itemgetter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from spark_examples_tpu_torch import native, obs

__all__ = ["FILE_LAYOUT", "STDOUT_LAYOUT", "RowColumns", "note_rows"]

# emit_rows' layouts: stdout's name, dataset, pc1, pc2 and the -pca.tsv
# file's name, pc1, pc2, dataset.
STDOUT_LAYOUT, FILE_LAYOUT = 0, 1
# The longest repr of a float64 ("-1.7976931348623157e+308"), the
# native core's kReprMax.
_REPR_MAX = 24


def note_rows(route: str, count: int) -> None:
    """Rows emitted by ``route`` (``native`` or ``python``)."""
    obs.get_registry().counter(
        "emit_rows_total", "Result rows emitted, by route"
    ).labels(route=route).inc(count)


def _utf8(strings: List[str]):
    """``strings`` as one UTF-8 blob (lone surrogates kept, as
    ``surrogatepass`` encodes them) and their ``n + 1`` offsets in code
    points, from which the native core finds the bytes."""
    blob = "".join(strings).encode("utf-8", "surrogatepass")
    points = np.zeros(len(strings) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, strings), np.int64, len(strings)),
              out=points[1:])
    return np.frombuffer(blob or b"\0", np.uint8), points


class RowColumns:
    """Rows ``(callset id, pc1, pc2)`` as columns, each id's sample name
    looked up once in ``names`` (callset id → sample name). The
    coordinates are Python floats, as ``_emit_tuples`` makes them."""

    def __init__(
        self, rows: Sequence[Tuple[str, float, float]], names: Dict[str, str]
    ):
        self.rows = rows
        self.ids = list(map(itemgetter(0), rows))
        self.names = list(map(names.__getitem__, self.ids))
        self._names = _utf8(self.names)
        self._ids = _utf8(self.ids)
        n = len(rows)
        self._pc1 = np.fromiter(map(itemgetter(1), rows), np.float64, n)
        self._pc2 = np.fromiter(map(itemgetter(2), rows), np.float64, n)

    def __len__(self) -> int:
        return len(self.ids)

    def _columns(self) -> tuple:
        (names, name_offs), (ids, id_offs) = self._names, self._ids
        return (names.ctypes.data, name_offs.ctypes.data, ids.ctypes.data,
                id_offs.ctypes.data, self._pc1.ctypes.data,
                self._pc2.ctypes.data)

    def _tuples(self) -> List[Tuple[str, float, float, str]]:
        """The reference's ``(name, pc1, pc2, dataset)`` tuples, in the
        rows' order (VariantsPca.scala:235: the label)."""
        return [(name, pc1, pc2, cid.split("-")[0])
                for name, (cid, pc1, pc2) in zip(self.names, self.rows)]

    def order(self) -> np.ndarray:
        """The permutation ``sorted`` gives the ``(name, pc1, pc2,
        dataset)`` tuples."""
        n = len(self)
        order = np.empty(max(n, 1), np.int64)
        if native.load().emit_order(*self._columns(), n,
                                    order.ctypes.data) != 0:
            # Rows of one name carry a NaN, which orders nothing: the
            # tuples themselves are sorted, as the reference sorts them.
            order[:n] = sorted(range(n), key=self._tuples().__getitem__)
        return order[:n]

    def tuples(self, order: np.ndarray) -> List[Tuple[str, float, float, str]]:
        """``collect_result``'s rows in ``order``."""
        tuples = self._tuples()
        return [tuples[i] for i in order.tolist()]

    def render(self, order: np.ndarray, layout: int) -> str:
        """Every row in ``order`` (a permutation from :meth:`order`) as
        one TSV text in ``layout``."""
        n = len(self)
        order = np.ascontiguousarray(order, np.int64)
        if len(order) != n or n and not 0 <= order.min() <= order.max() < n:
            raise ValueError("render: order is not one index a row")
        cap = (len(self._names[0]) + len(self._ids[0])
               + n * (2 * _REPR_MAX + 4))
        out = np.empty(cap, np.uint8)
        size = native.load().emit_rows(*self._columns(),
                                       order.ctypes.data, n, layout,
                                       out.ctypes.data, cap)
        if size < 0:
            raise RuntimeError("emit_rows: the buffer is too small")
        return str(memoryview(out)[:size], "utf-8", "surrogatepass")
