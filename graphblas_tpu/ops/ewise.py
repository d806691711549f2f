"""Element-wise operations: eWiseAdd (union), eWiseMult (intersection),
eWiseUnion (union with fill scalars).

Reference: Source/GB_add.h (3-phase union merge), Source/GB_emult.h
(methods 01-10 keyed on sparsity combos), Source/GB_ewise.c (dense fast
paths GB_ewise_fulla/fulln).  Redesign: two fused paths —

  * dense path (any operand bitmap/full): one jnp.where expression; XLA
    fuses it into a single VPU kernel (the fulla/fulln analog, for free).
  * sparse path: one union_merge (stable 64-bit key sort + grouped
    scatter) replacing all ten emult methods and the add phases.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import config as CFG
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix
from ..core.ops import BinaryOp
from ..core.types import cast
from ..kernels import segment as K
from .masker import _keys_of, writeback
from .transpose import maybe_transpose


def _positional_vals(op: BinaryOp, keys, veclen: int, orient: str, dtype):
    vec = (keys // veclen)
    idx = (keys % veclen)
    i, j = (vec, idx) if orient == ROW else (idx, vec)
    k = op.positional
    base = {"firsti": i, "firsti1": i + 1, "firstj": j, "firstj1": j + 1,
            "secondi": i, "secondi1": i + 1, "secondj": j,
            "secondj1": j + 1}[k]
    return base.astype(dtype)


def _ztype(op: BinaryOp, A: Matrix, B: Matrix, out_dtype):
    if out_dtype is not None:
        return T.lookup(out_dtype)
    return op.out_type(A.dtype, B.dtype)


def _check_shapes(A, B):
    from ..core import errors as E
    if A.shape != B.shape:
        raise E.DimensionMismatch(f"{A.shape} vs {B.shape}")


def _ewise(A, B, op, mode, alpha=None, beta=None, *, C=None, mask=None,
           accum=None, desc=NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    B = maybe_transpose(B, desc.transpose1)
    _check_shapes(A, B)
    zt = _ztype(op, A, B, None)
    dense = (A.fmt in (BITMAP, FULL) or B.fmt in (BITMAP, FULL)
             or mask is not None and mask.fmt in (BITMAP, FULL))
    if dense:
        CFG.burble("ewise_%s: dense path", mode)
        Tm = _ewise_dense(A, B, op, mode, zt, alpha, beta)
    else:
        CFG.burble("ewise_%s: sparse merge path", mode)
        Tm = _ewise_sparse(A, B, op, mode, zt, alpha, beta)
    from ..core.matrix import Vector
    klass = Vector if (isinstance(A, Vector) and isinstance(B, Vector)
                       and C is None) else None
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=klass)


def _ewise_dense(A, B, op, mode, zt, alpha, beta):
    av, ap = A.to_dense_pair()
    bv, bp = B.to_dense_pair()
    if op.positional:
        ii = jnp.broadcast_to(jnp.arange(A.nrows)[:, None], A.shape)
        jj = jnp.broadcast_to(jnp.arange(A.ncols)[None, :], A.shape)
        k = op.positional
        zv = {"firsti": ii, "firsti1": ii + 1, "firstj": jj,
              "firstj1": jj + 1, "secondi": ii, "secondi1": ii + 1,
              "secondj": jj, "secondj1": jj + 1}[k].astype(zt.np_dtype)
    elif mode == "union":
        a_ = T.wh(ap, av, jnp.asarray(alpha, av.dtype))
        b_ = T.wh(bp, bv, jnp.asarray(beta, bv.dtype))
        zv = cast(op.fn(a_, b_), zt)
    else:
        zv = cast(op.fn(av, bv), zt)
    if mode == "mult":
        pat = ap & bp
    else:
        pat = ap | bp
        if mode == "add" and not op.positional:
            both = ap & bp
            zv = T.wh(both, zv, T.wh(ap, cast(av, zt), cast(bv, zt)))
    zv = T.wh(pat, zv, jnp.zeros((), zt.np_dtype))
    return Matrix(A.shape, zt, BITMAP, A.orient, values=zv, bitmap=pat)


_ew_finish_jits: dict = {}


def _pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _bucket2(x):
    """Half-octave round-up (compile-variant bound for the finisher)."""
    if x <= 8:
        return max(int(x), 1)
    g = _pow2(x) // 2
    return ((int(x) + g - 1) // g) * g


def _ew_finish_fn(mode, op, zt, veclen, nvec, w, adt, bdt, has_fill,
                  orient):
    """One jitted finisher for the whole post-merge eWise pipeline:
    decode the rode value planes, apply the operator, build indptr —
    one dispatch instead of the ~2 s eager tail (round-4)."""
    import jax
    key = (mode, op, zt, veclen, nvec, w, adt, bdt, has_fill, orient)
    fn = _ew_finish_jits.get(key)
    if fn is not None:
        return fn
    SENT = jnp.int64(2**63 - 1)

    def run(sk, sa, sb, alpha, beta):
        valid = sk != SENT
        keys = sk >> 2
        a_in = (sk & 1) == 1
        b_in = (sk & 2) == 2
        if w == 32:
            LOW = jnp.int64((1 << 32) - 1)
            uav = K._ride_decode(sa & LOW, adt)
            ubv = K._ride_decode(sa >> 32, bdt)
        else:
            uav = K._ride_decode(sa, adt)
            ubv = K._ride_decode(sb, bdt)
        if op.positional:
            zv = _positional_vals(op, keys, veclen, orient, zt.np_dtype)
        elif mode == "union":
            a_ = T.wh(a_in, uav, alpha.astype(uav.dtype))
            b_ = T.wh(b_in, ubv, beta.astype(ubv.dtype))
            zv = cast(op.fn(a_, b_), zt)
        else:
            zv = cast(op.fn(uav, ubv), zt)
        if mode == "add" and not op.positional:
            both = a_in & b_in
            zv = T.wh(both, zv, T.wh(a_in, cast(uav, zt), cast(ubv, zt)))
        if mode == "mult":
            keep = valid & a_in & b_in
            cnt = jnp.sum(keep.astype(jnp.int64))
            k2 = jnp.where(keep, keys, SENT)
            sk2, zv2 = jax.lax.sort((k2, zv), num_keys=1)
            svec = jnp.where(sk2 != SENT, sk2 // veclen, nvec).astype(
                jnp.int32)
            sidx = (sk2 % veclen).astype(INDEX)
            zv = zv2
        else:
            cnt = jnp.sum(valid.astype(jnp.int64))
            svec = jnp.where(valid, keys // veclen, nvec).astype(jnp.int32)
            sidx = (keys % veclen).astype(INDEX)
        indptr = K.indptr_from_sorted(svec, nvec, INDEX)
        return indptr, sidx, zv, cnt

    fn = jax.jit(run)
    if len(_ew_finish_jits) > 64:
        _ew_finish_jits.clear()
    _ew_finish_jits[key] = fn
    return fn


def _ewise_sparse(A, B, op, mode, zt, alpha, beta):
    orient = A.orient
    B = B.to_orient(orient)
    A = A.to_format(SPARSE) if A.fmt == HYPER else A
    B = B.to_format(SPARSE) if B.fmt == HYPER else B
    ak, avals = _keys_of(A)
    bk, bvals = _keys_of(B)
    veclen = A._veclen()
    nvec = A._nvec_dim()
    raw = K.union_merge_raw(ak, avals, bk, bvals,
                            key_bound=veclen * nvec)
    if raw is not None and not zt.shape:
        ng, sk, sa, sb, w = raw
        fn = _ew_finish_fn(mode, op, zt, veclen, nvec, w,
                           jnp.dtype(avals.dtype), jnp.dtype(bvals.dtype),
                           mode == "union", orient)
        az = jnp.asarray(alpha if alpha is not None else 0, avals.dtype)
        bz = jnp.asarray(beta if beta is not None else 0, bvals.dtype)
        indptr, sidx, zv, cnt_d = fn(sk, sa, sb, az, bz)
        cnt = int(cnt_d) if mode == "mult" else ng
        return Matrix(A.shape, zt, SPARSE, orient, indptr=indptr,
                      indices=sidx[:cnt], values=zv[:cnt])
    ukeys, uav, ubv, a_in, b_in = K.union_merge(
        ak, avals, bk, bvals, key_bound=veclen * nvec)
    if op.positional:
        zv = _positional_vals(op, ukeys, veclen, orient, zt.np_dtype)
    elif mode == "union":
        a_ = T.wh(a_in, uav, jnp.asarray(alpha, uav.dtype))
        b_ = T.wh(b_in, ubv, jnp.asarray(beta, ubv.dtype))
        zv = cast(op.fn(a_, b_), zt)
    else:
        zv = cast(op.fn(uav, ubv), zt)
    if mode == "add" and not op.positional:
        both = a_in & b_in
        zv = T.wh(both, zv, T.wh(a_in, cast(uav, zt), cast(ubv, zt)))
    if mode == "mult":
        keep = a_in & b_in
        cnt, (fk, fv) = K.compact(keep, ukeys, zv)
    else:
        fk, fv = ukeys, zv
    nvec = A._nvec_dim()
    uvec, uidx = K.key_split(fk, veclen)
    indptr = K.indptr_from_sorted(uvec, nvec, INDEX)
    return Matrix(A.shape, zt, SPARSE, orient, indptr=indptr, indices=uidx,
                  values=fv)


def ewise_add(A: Matrix, B: Matrix, op: BinaryOp, **kw):
    """GrB_eWiseAdd: set-union apply (reference: Source/GB_add.h)."""
    return _ewise(A, B, op, "add", **kw)


def ewise_mult(A: Matrix, B: Matrix, op: BinaryOp, **kw):
    """GrB_eWiseMult: set-intersection apply (reference: Source/GB_emult.h)."""
    return _ewise(A, B, op, "mult", **kw)


def ewise_union(A: Matrix, alpha, B: Matrix, beta, op: BinaryOp, **kw):
    """GxB_eWiseUnion: union with per-side fill scalars."""
    return _ewise(A, B, op, "union", alpha=alpha, beta=beta, **kw)
