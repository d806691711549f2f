"""GrB_apply: unary / bound-binary / index-unary operator application with
optional fused transpose (reference: Source/GB_apply_op.c, GB_apply.c).

Shape here: pattern is unchanged, so apply is one elementwise map over the
values array (plus coordinate streams for positional/index ops) — XLA fuses
the whole thing, and it composes with the O(1) logical transpose."""

from __future__ import annotations

import jax.numpy as jnp

from ..core import config as CFG
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, ROW, SPARSE, Matrix
from ..core.ops import BinaryOp, IndexUnaryOp, UnaryOp
from ..core.types import cast
from .masker import writeback
from .transpose import maybe_transpose


def _coords_dense(A):
    ii = jnp.broadcast_to(jnp.arange(A.nrows, dtype=jnp.int64)[:, None],
                          A.shape)
    jj = jnp.broadcast_to(jnp.arange(A.ncols, dtype=jnp.int64)[None, :],
                          A.shape)
    return ii, jj


def apply(A: Matrix, op, *, bind=None, thunk=None, C=None, mask=None,
          accum=None, desc: Descriptor = NULL, out_dtype=None):
    """op: UnaryOp | IndexUnaryOp | BinaryOp (with bind=("first", s) or
    ("second", s))."""
    A = maybe_transpose(A, desc.transpose0)
    if isinstance(op, UnaryOp):
        zt = T.lookup(out_dtype) if out_dtype else op.out_type(A.dtype)
        Tm = _apply_unary(A, op, zt)
    elif isinstance(op, IndexUnaryOp):
        zt = T.lookup(out_dtype) if out_dtype else op.out_type(A.dtype)
        Tm = _apply_idx(A, op, thunk, zt)
    elif isinstance(op, BinaryOp):
        if op.positional:
            # positional binary ops ignore the bound scalar and read the
            # entry's own indices (reference: GB_apply_op.c positional
            # opcodes route through GB_positional_offset, not the scalar)
            pos = {"firsti": "i", "secondi": "i", "firsti1": "i1",
                   "secondi1": "i1", "firstj": "j", "secondj": "j",
                   "firstj1": "j1", "secondj1": "j1"}[op.positional]
            zt = T.lookup(out_dtype) if out_dtype else T.INT64
            one = pos.endswith("1")
            fn = (lambda v: v + 1) if one else (lambda v: v)
            Tm = _apply_positional(
                A, UnaryOp(op.name, fn, ztype=zt, positional=pos), zt)
            klass = type(A) if C is None else None
            return writeback(C, mask, accum, Tm, desc, out_dtype,
                             out_class=klass)
        if bind is None:
            from ..core import errors as E
            raise E.InvalidValue("binary apply requires bind=('first'|'second', scalar)")
        which, s = bind
        if which == "first":
            st = T.lookup(jnp.asarray(s).dtype)
            zt = T.lookup(out_dtype) if out_dtype else op.out_type(st, A.dtype)
            fn = lambda x: op.fn(jnp.asarray(s), x)
        else:
            st = T.lookup(jnp.asarray(s).dtype)
            zt = T.lookup(out_dtype) if out_dtype else op.out_type(A.dtype, st)
            fn = lambda x: op.fn(x, jnp.asarray(s))
        Tm = _apply_unary(A, UnaryOp("bound", fn, ztype=zt), zt)
    else:
        from ..core import errors as E
        raise E.InvalidValue(f"bad op for apply: {op!r}")
    klass = type(A) if C is None else None
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=klass)


def _apply_unary(A, op, zt):
    from ..core.convert import _clone
    CFG.burble("apply %s (%s)", op.name, A.fmt)
    if op.positional:
        return _apply_positional(A, op, zt)
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        zv = cast(op.fn(v), zt)
        zv = T.wh(p, zv, jnp.zeros((), zt.np_dtype))
        return Matrix(A.shape, zt, BITMAP if A.fmt == BITMAP else FULL,
                      A.orient, values=zv,
                      bitmap=p if A.fmt == BITMAP else None)
    # sparse/hyper: map the (possibly iso) values array directly
    vals = cast(op.fn(A.values), zt)
    return _clone(A, dtype=zt, values=vals)


def _apply_positional(A, op, zt):
    from ..core.convert import _clone
    if A.fmt in (BITMAP, FULL):
        ii, jj = _coords_dense(A)
        src = {"i": ii, "i1": ii, "j": jj, "j1": jj}[op.positional]
        zv = cast(op.fn(src), zt)
        _, p = A.to_dense_pair()
        return Matrix(A.shape, zt, A.fmt, A.orient, values=zv,
                      bitmap=p if A.fmt == BITMAP else None)
    S = A.to_format(SPARSE) if A.fmt == HYPER else A
    rows, cols = S._coords()
    src = {"i": rows, "i1": rows, "j": cols, "j1": cols}[op.positional]
    vals = cast(op.fn(src.astype(jnp.int64)), zt)
    return _clone(S, dtype=zt, values=vals, iso=False)


def _apply_idx(A, op, thunk, zt):
    from ..core.convert import _clone
    thunk = jnp.asarray(0 if thunk is None else thunk)
    if A.fmt in (BITMAP, FULL):
        ii, jj = _coords_dense(A)
        v, p = A.to_dense_pair()
        zv = cast(op.fn(v, ii, jj, thunk), zt)
        zv = T.wh(p, zv, jnp.zeros((), zt.np_dtype))
        return Matrix(A.shape, zt, A.fmt, A.orient, values=zv,
                      bitmap=p if A.fmt == BITMAP else None)
    S = A.to_format(SPARSE) if A.fmt == HYPER else A
    rows, cols = S._coords()
    zv = cast(op.fn(S._vals_expanded(), rows.astype(jnp.int64),
                    cols.astype(jnp.int64), thunk), zt)
    return _clone(S, dtype=zt, values=zv, iso=False)
