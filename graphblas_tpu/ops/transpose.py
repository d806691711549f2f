"""Transpose (reference: Source/GB_transpose.c).

Redesign: a logical transpose of a sparse matrix is O(1) — swap the
shape and flip the orientation tag; the CSR arrays of A are exactly the CSC
arrays of A'.  The reference pays a bucket/sort transpose only to keep its
preferred orientation; here reorientation happens lazily in to_orient()
(sort-based, device-side) only when a kernel actually needs it.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, COL, FULL, HYPER, ROW, SPARSE, Matrix
from .masker import writeback


def logical_transpose(a: Matrix) -> Matrix:
    """A' in O(1) for sparse/hyper; one XLA transpose for bitmap/full."""
    from ..core.convert import _clone
    new_shape = (a.ncols, a.nrows)
    if a.fmt in (SPARSE, HYPER):
        flip = ROW if a.orient == COL else COL
        out = _clone(a, orient=flip)
        out.shape = new_shape
        return out
    vals = a.values if a.iso else a.values.T
    bm = a.bitmap.T if a.fmt == BITMAP else None
    out = _clone(a, values=vals, bitmap=bm)
    out.shape = new_shape
    return out


def maybe_transpose(a: Matrix, tran: bool) -> Matrix:
    return logical_transpose(a) if tran else a


def transpose(A: Matrix, *, C=None, mask=None, accum=None, desc: Descriptor = NULL,
              out_dtype=None):
    """GrB_transpose: C<M> = accum(C, A').  Per the spec, desc.transpose0
    cancels the transpose (C<M> = accum(C, A))."""
    T = A if desc.transpose0 else logical_transpose(A)
    return writeback(C, mask, accum, T.dup() if T is A else T, desc,
                     out_dtype)
