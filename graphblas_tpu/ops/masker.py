"""accum/mask write-back: C<M> = accum(C, T).

Reference: Source/GB_accum_mask.c (Z = accum(C,T) via GB_add, then GB_mask /
GB_masker) and the masker truth table at Source/GB_masker.c:20-27.  The
reference implements ~30 specialized subassign/masker kernels; here two
fused paths cover all cases (SURVEY.md section 7 "hard parts"):

  * dense path — any operand bitmap/full: pure jnp.where algebra, one fused
    XLA kernel, bitmap output.
  * sparse path — all operands sparse/hyper: one union-merge + mask lookup
    + compaction.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import config as CFG
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, COL, FULL, HYPER, INDEX, ROW, SPARSE, Matrix
from ..core.types import cast
from ..kernels import segment as K


def _is_dense(a: Matrix | None) -> bool:
    return a is not None and a.fmt in (BITMAP, FULL)


def mask_bits_dense(mask: Matrix | None, shape, desc: Descriptor):
    """Dense bool mask array with structure/complement applied."""
    if mask is None:
        m = jnp.ones(shape, bool)
        return ~m if desc.mask_complement else m
    mv, mp = mask.to_dense_pair()
    m = mp if desc.mask_structure else (mp & (mv != 0))
    return ~m if desc.mask_complement else m


def mask_bits_at_keys(mask: Matrix, keys, veclen: int, orient: str,
                      desc: Descriptor):
    """Mask bool at each (sorted-key) position — the dot3-style mask lookup
    (reference: GB_masker phase1)."""
    if mask.fmt in (BITMAP, FULL):
        vec = (keys // veclen).astype(jnp.int32)
        idx = (keys % veclen).astype(jnp.int32)
        i, j = (vec, idx) if orient == ROW else (idx, vec)
        mv, mp = mask.to_dense_pair()
        m = mp[i, j] if desc.mask_structure else (mp[i, j] & (mv[i, j] != 0))
    else:
        mk, mvals = _keys_of(mask.to_orient(orient))
        found, pos = K.lookup_sorted(mk, keys)
        if desc.mask_structure:
            m = found
        else:
            m = found & (mvals[pos] != 0) if mvals.shape[0] else found
    return ~m if desc.mask_complement else m


_keys_cache: dict = {}


def _keys_of(a: Matrix):
    """(sorted int64 keys, expanded values) of a sparse/hyper matrix in its
    own orientation's storage order.  Keys are cached per pattern identity
    (patterns are immutable arrays), so the expand-rowids + key pack runs
    once per pattern."""
    a = a.to_format(SPARSE) if a.fmt == HYPER else a
    ck = (id(a.indptr), id(a.indices), a.orient)
    ent = _keys_cache.get(ck)
    if ent is not None and ent[0] is a.indptr and ent[1] is a.indices:
        return ent[2], a._vals_expanded()
    rows, cols = a._coords()
    vec, idx = (rows, cols) if a.orient == ROW else (cols, rows)
    keys = K.make_key(vec, idx, a._veclen())
    if len(_keys_cache) > 16:
        _keys_cache.clear()
    _keys_cache[ck] = (a.indptr, a.indices, keys)
    return keys, a._vals_expanded()


def writeback(C: Matrix | None, mask: Matrix | None, accum, Tm: Matrix,
              desc: Descriptor = NULL, out_dtype=None, out_class=None):
    """Returns the new C (a fresh Matrix; callers transplant in place)."""
    klass = out_class or (type(C) if C is not None else type(Tm))
    dt = T.lookup(out_dtype) if out_dtype is not None else (
        C.dtype if C is not None else Tm.dtype)

    no_c = C is None or (C.fmt in (SPARSE, HYPER) and C.nvals == 0)
    if mask is None and not desc.mask_complement and (accum is None or no_c):
        # transplant fast path (reference: GB_transplant_conform)
        out = _cast_matrix(Tm, dt)
        CFG.burble("writeback: transplant")
        return _reclass(out, klass)

    if C is None:
        C = Matrix.new(dt, Tm.nrows, Tm.ncols, SPARSE, Tm.orient)

    if _is_dense(C) or _is_dense(Tm) or _is_dense(mask):
        CFG.burble("writeback: dense path")
        return _reclass(_writeback_dense(C, mask, accum, Tm, desc, dt), klass)
    CFG.burble("writeback: sparse merge path")
    return _reclass(_writeback_sparse(C, mask, accum, Tm, desc, dt), klass)


def _reclass(a: Matrix, klass):
    if type(a) is klass:
        return a
    obj = object.__new__(klass)
    for s in Matrix.__slots__:
        setattr(obj, s, getattr(a, s, None))
    return obj


def _cast_matrix(a: Matrix, dt) -> Matrix:
    if a.dtype is dt:
        return a
    from ..core.convert import _clone
    return _clone(a, dtype=dt, values=cast(a.values, dt))


def _writeback_dense(C, mask, accum, Tm, desc, dt):
    cv, cp = C.to_dense_pair()
    tv, tp = Tm.to_dense_pair()
    cv = cast(cv, dt)
    tv = cast(tv, dt)
    if accum is None:
        zv, zp = tv, tp
    else:
        both = cp & tp
        acc = cast(accum.fn(cv, tv), dt)
        zv = T.wh(both, acc, T.wh(tp, tv, cv))
        zp = cp | tp
    m = mask_bits_dense(mask, C.shape, desc)
    rv = T.wh(m, zv, cv)
    rp = (zp & m) if desc.replace else jnp.where(m, zp, cp)
    rv = T.wh(rp, rv, jnp.zeros((), dt.np_dtype))
    out = Matrix((C.nrows, C.ncols), dt, BITMAP, C.orient,
                 values=rv, bitmap=rp)
    return out


def _writeback_sparse(C, mask, accum, Tm, desc, dt):
    orient = C.orient
    Tm = Tm.to_orient(orient) if Tm.fmt in (SPARSE, HYPER) else Tm
    Tm = Tm.to_format(SPARSE) if Tm.fmt == HYPER else Tm
    Cs = C.to_format(SPARSE) if C.fmt == HYPER else C
    ck, cvals = _keys_of(Cs)
    tk, tvals = _keys_of(Tm)
    cvals = cast(cvals, dt)
    tvals = cast(tvals, dt)
    ukeys, ucv, utv, c_in, t_in = K.union_merge(
        ck, cvals, tk, tvals, key_bound=Cs._veclen() * Cs._nvec_dim())
    if accum is None:
        zv = T.wh(t_in, utv, ucv)
        z_in = t_in
    else:
        both = c_in & t_in
        zv = T.wh(both, cast(accum.fn(ucv, utv), dt),
                  T.wh(t_in, utv, ucv))
        z_in = c_in | t_in
    if mask is None:
        m = jnp.zeros(ukeys.shape, bool) if desc.mask_complement else \
            jnp.ones(ukeys.shape, bool)
    else:
        m = mask_bits_at_keys(mask, ukeys, C._veclen(), orient, desc)
    keep = (z_in & m) if desc.replace else (z_in & m) | (c_in & ~m)
    rvals = T.wh(m, zv, ucv)
    cnt, (fk, fv) = K.compact(keep, ukeys, rvals)
    veclen = C._veclen()
    nvec = C._nvec_dim()
    uvec, uidx = K.key_split(fk, veclen)
    indptr = K.indptr_from_sorted(uvec, nvec, INDEX)
    return Matrix((C.nrows, C.ncols), dt, SPARSE, orient, indptr=indptr,
                  indices=uidx, values=fv)
