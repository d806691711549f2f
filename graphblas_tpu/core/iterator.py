"""GxB_Iterator equivalents (reference: Include/GraphBLAS.h:11011-11125,
Source/GB_Iterator_*.c — attach/seek/next as static-inline functions over
the 4 formats).

On an accelerator, per-entry device round-trips would be absurd; the iterator
materializes the coordinate streams once (one device->host transfer) and
then iterates host-side at numpy speed — same amortized cost as the
reference's pointer chasing, same API shape."""

from __future__ import annotations

import numpy as np


class EntryIterator:
    """Iterate (i, j, value) over stored entries in storage order
    (GxB_Matrix_Iterator / rowIterator / colIterator)."""

    def __init__(self, A):
        if A._pending:
            A.wait()
        r, c, v = A.coo()
        self._r = np.asarray(r)
        self._c = np.asarray(c)
        self._v = np.asarray(v)
        self._pos = 0

    # -- GxB-style cursor API --------------------------------------------

    @property
    def pmax(self) -> int:
        return len(self._r)

    def seek(self, p: int) -> bool:
        """Position the cursor; returns False if exhausted."""
        self._pos = int(p)
        return self._pos < len(self._r)

    def next(self) -> bool:
        self._pos += 1
        return self._pos < len(self._r)

    def getrow(self) -> int:
        return int(self._r[self._pos])

    def getcol(self) -> int:
        return int(self._c[self._pos])

    def getvalue(self):
        return self._v[self._pos][()]

    # -- pythonic protocol -------------------------------------------------

    def __iter__(self):
        for i in range(len(self._r)):
            yield int(self._r[i]), int(self._c[i]), self._v[i][()]


class RowIterator:
    """Iterate rows, then entries within a row (GxB_rowIterator_*)."""

    def __init__(self, A):
        from .matrix import ROW, SPARSE
        S = A.to_format(SPARSE, ROW)
        self._indptr = np.asarray(S.indptr)
        self._indices = np.asarray(S.indices)
        self._values = np.asarray(S._vals_expanded())
        self.nrows = A.nrows

    def row(self, i: int):
        """(col_indices, values) of row i."""
        lo, hi = self._indptr[i], self._indptr[i + 1]
        return self._indices[lo:hi], self._values[lo:hi]

    def __iter__(self):
        for i in range(self.nrows):
            yield i, *self.row(i)


class ColIterator:
    """Iterate columns, then entries within a column (GxB_colIterator_*)."""

    def __init__(self, A):
        from .matrix import COL, SPARSE
        S = A.to_format(SPARSE, COL)
        self._indptr = np.asarray(S.indptr)
        self._indices = np.asarray(S.indices)
        self._values = np.asarray(S._vals_expanded())
        self.ncols = A.ncols

    def col(self, j: int):
        """(row_indices, values) of column j."""
        lo, hi = self._indptr[j], self._indptr[j + 1]
        return self._indices[lo:hi], self._values[lo:hi]

    def __iter__(self):
        for j in range(self.ncols):
            yield j, *self.col(j)
