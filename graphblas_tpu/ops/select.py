"""GrB_select: keep entries passing an IndexUnaryOp predicate (reference:
Source/GB_select.h — sparse phase1/phase2 + bitmap paths + positional
specializations; 6.2k LoC there collapse to one predicated compaction)."""

from __future__ import annotations

import jax.numpy as jnp

from ..core import config as CFG
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, INDEX, SPARSE, Matrix
from ..core.ops import IndexUnaryOp
from ..kernels import segment as K
from .masker import writeback
from .transpose import maybe_transpose


def select(A: Matrix, op: IndexUnaryOp, thunk=0, *, C=None, mask=None,
           accum=None, desc: Descriptor = NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    thunk = jnp.asarray(thunk)
    CFG.burble("select %s (%s)", op.name, A.fmt)
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        ii = jnp.broadcast_to(jnp.arange(A.nrows, dtype=jnp.int64)[:, None],
                              A.shape)
        jj = jnp.broadcast_to(jnp.arange(A.ncols, dtype=jnp.int64)[None, :],
                              A.shape)
        keep = (op.fn(v, ii, jj, thunk) != 0) & p
        zv = jnp.where(keep, v, jnp.zeros((), A.dtype.np_dtype))
        Tm = Matrix(A.shape, A.dtype, BITMAP, A.orient, values=zv,
                    bitmap=keep)
    else:
        S = A.to_format(SPARSE) if A.fmt == HYPER else A
        nvec = S._nvec_dim()
        cnt_d, indptr, fidx, fv = _select_fn(op, nvec, S.orient)(
            S.indptr, S.indices, S._vals_expanded(), thunk)
        cnt = int(cnt_d)
        Tm = Matrix(A.shape, A.dtype, SPARSE, S.orient, indptr=indptr,
                    indices=fidx[:cnt], values=fv[:cnt])
    klass = type(A) if C is None else None
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=klass)


_select_jits: dict = {}


def _select_fn(op: IndexUnaryOp, nvec: int, orient: str):
    """One jitted executable for the whole sparse select (predicate +
    stable scatter-compaction + indptr) in one dispatch."""
    import jax
    key = (op, nvec, orient)
    fn = _select_jits.get(key)
    if fn is not None:
        return fn

    def run(indptr, indices, vals, thunk):
        nnz = indices.shape[0]
        vecid = K.expand_rowids(indptr, nnz, nvec)
        if orient == "row":
            rows, cols = vecid, indices
        else:
            rows, cols = indices, vecid
        keep = op.fn(vals, rows.astype(jnp.int64), cols.astype(jnp.int64),
                     thunk) != 0
        cnt = jnp.sum(keep.astype(jnp.int64))
        pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
        tgt = jnp.where(keep, pos, nnz)
        fidx = jnp.zeros((nnz,), INDEX).at[tgt].set(
            indices.astype(INDEX), mode="drop")
        fv = jnp.zeros(vals.shape, vals.dtype).at[tgt].set(
            vals, mode="drop")
        # vecid is CSR-sorted; count kept entries by WEIGHT (0/1) so the
        # sorted segment-sum path applies (a where->nvec remap would
        # break sortedness and fall back to the 2.2 s random scatter)
        counts = K.histogram_sorted(vecid, nvec,
                                    weights=keep.astype(jnp.int32))
        indptr2 = jnp.concatenate(
            [jnp.zeros(1, jnp.int64), jnp.cumsum(counts)]).astype(INDEX)
        return cnt, indptr2, fidx, fv

    fn = jax.jit(run)
    if len(_select_jits) > 64:
        _select_jits.clear()
    _select_jits[key] = fn
    return fn
