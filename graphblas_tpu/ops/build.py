"""GrB_Matrix_build and the pending-tuple finalizer.

Reference: Source/GB_builder.c — the 5-step pipeline (copy, parallel sort,
detect vectors+duplicates, build indptr, assemble with the dup operator),
which also backs GB_wait (Source/GB_wait.c) and transpose.  Here the
pipeline is a vectorized device program: stable 64-bit key sort + grouping +
segmented reduction under the dup operator.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import errors as E
from ..core import monoid as M
from ..core import ops as OPS
from ..core import types as T
from ..core.matrix import BITMAP, COL, FULL, HYPER, INDEX, ROW, SPARSE
from ..core.ops import BinaryOp
from ..kernels import segment as K

_DUP_MONOIDS = {
    "GrB_PLUS": M.PLUS, "GrB_TIMES": M.TIMES, "GrB_MIN": M.MIN,
    "GrB_MAX": M.MAX, "GrB_LOR": M.LOR, "GrB_LAND": M.LAND,
    "GrB_LXOR": M.LXOR, "GrB_BOR": M.BOR, "GrB_BAND": M.BAND,
    "GxB_ANY": M.ANY,
}
_NAME_TO_OP = {
    "plus": OPS.PLUS, "times": OPS.TIMES, "min": OPS.MIN, "max": OPS.MAX,
    "first": OPS.FIRST, "second": OPS.SECOND, "lor": OPS.LOR,
    "land": OPS.LAND, "lxor": OPS.LXOR, "any": OPS.ANY,
}


def _resolve_dup(dup) -> BinaryOp:
    if isinstance(dup, BinaryOp):
        return dup
    if isinstance(dup, str):
        return _NAME_TO_OP[dup.lower()]
    raise E.InvalidValue(f"bad dup operator {dup!r}")


def _dedup(sorted_vals, gid, ng: int, dup: BinaryOp, is_first, is_last):
    """Combine duplicate groups under the dup operator (builder step 5)."""
    dt = sorted_vals.dtype
    trail = sorted_vals.shape[1:]
    if dup.name == "GrB_FIRST":
        tgt = jnp.where(is_first, gid, ng)
        return jnp.zeros((ng,) + trail, dt).at[tgt].set(sorted_vals,
                                                        mode="drop")
    if dup.name in ("GrB_SECOND", "GxB_ANY"):
        tgt = jnp.where(is_last, gid, ng)
        return jnp.zeros((ng,) + trail, dt).at[tgt].set(sorted_vals,
                                                        mode="drop")
    if dup.name in _DUP_MONOIDS:
        return K.segment_reduce(sorted_vals, gid, ng, _DUP_MONOIDS[dup.name])
    # arbitrary associative dup op: generic segmented scan
    return K.segment_reduce(sorted_vals, gid, ng, M.monoid(dup, 0))


def build_matrix(cls, rows, cols, vals, shape, dtype, dup, orient, iso):
    from ..core import config as CFG
    orient = orient or CFG.GLOBAL.format_default
    nrows, ncols = int(shape[0]), int(shape[1])
    # bounds check BEFORE upload, on the host-side input when available
    # (checking the device copy would pull 2x8 B/nnz back to the host)
    rows_in, cols_in = rows, cols
    rows = None                       # uploaded lazily (sorted-row diet)
    cols = jnp.asarray(cols, INDEX).reshape(-1)
    n = cols.shape[0]
    dup = _resolve_dup(dup)

    dt = T.lookup(dtype) if dtype is not None else None
    ts = dt.shape if dt is not None else ()
    if iso:
        scal = jnp.asarray(vals).reshape(ts)
        if dt is None:
            dt = T.lookup(scal.dtype)
        vals_arr = jnp.broadcast_to(scal.astype(dt.np_dtype), (n,) + ts)
    else:
        vals_arr = jnp.asarray(vals)
        vals_arr = vals_arr.reshape((-1,) + ts)
        if vals_arr.shape[0] == 1 and n > 1:
            vals_arr = jnp.broadcast_to(vals_arr, (n,) + ts)
        if dt is None:
            dt = T.lookup(vals_arr.dtype)
        vals_arr = vals_arr.astype(dt.np_dtype)
    if vals_arr.shape[0] != n:
        raise E.DimensionMismatch("build: index/value length mismatch")

    # bounds check (host-side; skipped for traced inputs)
    try:
        if isinstance(rows_in, (np.ndarray, list, tuple, range)):
            rnp = np.asarray(rows_in).reshape(-1)
            cnp = np.asarray(cols_in).reshape(-1)
        else:
            rnp = np.asarray(rows_in).reshape(-1)
            cnp = np.asarray(cols_in).reshape(-1)
    except Exception:
        rnp = cnp = None
    if rnp is not None and rnp.size:
        if rnp.min() < 0 or rnp.max() >= nrows:
            raise E.IndexOutOfBounds("build: row index out of range")
        if cnp.min() < 0 or cnp.max() >= ncols:
            raise E.IndexOutOfBounds("build: col index out of range")
    # sorted-row upload diet (round-5 ask #5): when the host-side rows
    # are already sorted (the common CSR/COO-dump case), ship per-row
    # COUNTS (4 B/row) instead of row ids (4 B/nnz) and expand on
    # device.  (Reference GB_builder.c step 2 detects sortedness the same
    # way before deciding whether to sort.)
    if rows is None and rnp is not None and rnp.size \
            and rnp.dtype.kind in "iu" and np.all(np.diff(rnp) >= 0):
        counts_h = np.bincount(rnp, minlength=nrows).astype(np.int64)
        ip0 = jnp.concatenate([
            jnp.zeros(1, INDEX),
            jnp.cumsum(jnp.asarray(counts_h, INDEX))])
        rows = K.expand_rowids(ip0, int(rnp.size), nrows)
    if rows is None:
        rows = jnp.asarray(rows_in, INDEX).reshape(-1)

    if orient == ROW:
        vec_ids, idx, nvec, veclen = rows, cols, nrows, ncols
    else:
        vec_ids, idx, nvec, veclen = cols, rows, ncols, nrows

    if n == 0:
        nvec = nrows if orient == ROW else ncols
        out = object.__new__(cls)
        _init_sparse(out, shape, dt, orient, jnp.zeros(nvec + 1, INDEX),
                     jnp.zeros(0, INDEX),
                     jnp.zeros((0,) + dt.shape, dt.np_dtype), False)
        return out

    fast = (not ts and not iso and dup.name in _DUP_MONOIDS
            and K._ride_encode(vals_arr)[0] is not None)
    if fast:
        # fused builder: ONE jitted sort-with-payload phase, one ng sync,
        # one jitted dedup/indptr phase (the reference's 5-step
        # GB_builder as two dispatches)
        ph1 = _build_phase1_fn(veclen)
        skeys, svals, ng_d = ph1(vec_ids, idx, vals_arr)
        ng = int(ng_d)
        ph2 = _build_phase2_fn(nvec, veclen, _DUP_MONOIDS[dup.name],
                               jnp.dtype(vals_arr.dtype))
        indptr, uidx, out_vals = ph2(skeys, svals)
        out = object.__new__(cls)
        _init_sparse(out, shape, dt, orient, indptr, uidx[:ng],
                     out_vals[:ng], False)
        return out
    order, skeys = K.sort_coo(vec_ids, idx, veclen)
    gid, ng = K.group_ids(skeys)
    svals = vals_arr[order]
    is_first = jnp.concatenate([jnp.ones(1, bool), skeys[1:] != skeys[:-1]])
    is_last = jnp.concatenate([skeys[1:] != skeys[:-1], jnp.ones(1, bool)])
    out_vals = _dedup(svals, gid, ng, dup, is_first, is_last)
    ukeys = jnp.zeros((ng,), skeys.dtype).at[gid].set(skeys)
    uvec, uidx = K.key_split(ukeys, veclen)
    indptr = K.indptr_from_sorted(uvec, nvec, INDEX)

    out = object.__new__(cls)
    _init_sparse(out, shape, dt, orient, indptr, uidx,
                 jnp.asarray(vals).reshape((-1,) + dt.shape)[:1]
                 .astype(dt.np_dtype) if iso else out_vals, iso)
    return out


_build_jits: dict = {}


def _build_phase1_fn(veclen: int):
    """Jitted: pack keys, ONE fused sort with the values riding, count
    groups (the builder's copy+sort+count steps)."""
    import jax
    key = ("p1", veclen)
    fn = _build_jits.get(key)
    if fn is None:
        def run(vec_ids, idx, vals):
            keys = K.make_key(vec_ids, idx, veclen)
            skeys, svals = K.sort_with_payload(keys, vals)
            is_new = jnp.concatenate(
                [jnp.ones(1, bool), skeys[1:] != skeys[:-1]])
            return skeys, svals, jnp.sum(is_new.astype(jnp.int64))

        fn = jax.jit(run)
        _build_jits[key] = fn
    return fn


def _build_phase2_fn(nvec: int, veclen: int, mon, vdt):
    """Jitted: dedup under the monoid + unique keys + indptr, all via
    sorted segment ops; outputs at input length, caller slices [:ng]."""
    import jax
    key = ("p2", nvec, veclen, mon, vdt)
    fn = _build_jits.get(key)
    if fn is None:
        def run(skeys, svals):
            n = skeys.shape[0]
            is_new = jnp.concatenate(
                [jnp.ones(1, bool), skeys[1:] != skeys[:-1]])
            gid = jnp.cumsum(is_new.astype(jnp.int32)) - 1
            out_vals = K.segment_reduce(svals, gid, n, mon)
            ukeys = jax.ops.segment_max(skeys, gid, n,
                                        indices_are_sorted=True)
            uvec = (ukeys // veclen).astype(jnp.int32)
            uidx = (ukeys % veclen).astype(INDEX)
            # empty tail groups of segment_max carry -inf-class values;
            # count only real groups (weights = per-position new flags)
            counts = K.histogram_sorted(
                (skeys // veclen).astype(jnp.int32), nvec,
                weights=is_new.astype(jnp.int32))
            indptr = jnp.concatenate(
                [jnp.zeros(1, jnp.int64),
                 jnp.cumsum(counts)]).astype(INDEX)
            return indptr, uidx, out_vals

        fn = jax.jit(run)
        if len(_build_jits) > 64:
            _build_jits.clear()
        _build_jits[key] = fn
    return fn


def _init_sparse(obj, shape, dt, orient, indptr, indices, values, iso):
    obj.shape = (int(shape[0]), int(shape[1]))
    obj.dtype = dt
    obj.fmt = SPARSE
    obj.orient = orient
    obj.iso = bool(iso)
    obj.indptr, obj.h, obj.indices, obj.values, obj.bitmap = (
        indptr, None, indices, values, None)
    obj._pending, obj._nvals_cache, obj.name = [], None, ""


# ---------------------------------------------------------------------------
# pending-tuple finalizer (GrB_wait; reference: Source/GB_wait.c)
# ---------------------------------------------------------------------------

def apply_pending(A, pend) -> None:
    """Apply queued setElement/removeElement events to A in place.

    Event semantics: per (i, j), the LAST event wins (setElement overwrites,
    removeElement deletes) — matching the reference, where setElement
    pending tuples use dup=SECOND and deletions become zombies
    (GB_matrix.h:313-390)."""
    dt = A.dtype.np_dtype
    ii, jj, vv, dd = [], [], [], []
    for rows, cols, val, dup in pend:
        k = len(rows)
        ii.append(np.asarray(rows, np.int64))
        jj.append(np.asarray(cols, np.int64))
        if dup == "delete":
            vv.append(np.zeros(k, dt))
            dd.append(np.ones(k, bool))
        else:
            v = np.broadcast_to(np.asarray(val).astype(dt).reshape(-1), (k,))
            vv.append(v)
            dd.append(np.zeros(k, bool))
    ii = np.concatenate(ii)
    jj = np.concatenate(jj)
    vv = np.concatenate(vv)
    dd = np.concatenate(dd)
    if (ii.min() < 0 or ii.max() >= A.nrows or jj.min() < 0
            or jj.max() >= A.ncols):
        raise E.InvalidIndex("setElement index out of range")

    if A.fmt in (BITMAP, FULL):
        vals = A._vals_expanded()
        bm = A.bitmap if A.fmt == BITMAP else jnp.ones(A.shape, bool)
        # apply sequentially within one scatter: last event wins with numpy
        # -style ordered scatter on host semantics — emulate by dropping all
        # but the last event per key first.
        keep = _last_event_mask(ii, jj, A.ncols)
        ii2, jj2, vv2, dd2 = ii[keep], jj[keep], vv[keep], dd[keep]
        vals = vals.at[ii2, jj2].set(jnp.asarray(vv2))
        bm = bm.at[ii2, jj2].set(jnp.asarray(~dd2))
        A.values, A.bitmap, A.iso = vals, bm, False
        if A.fmt == FULL and dd2.any():
            A.fmt = BITMAP
        elif A.fmt == BITMAP:
            A._nvals_cache = None
        return

    # sparse/hyper path: merge finalized events with existing entries
    was_hyper = A.fmt == HYPER
    S = A.to_format(SPARSE) if was_hyper else A
    keep = _last_event_mask(ii, jj, A.ncols)
    ii, jj, vv, dd = ii[keep], jj[keep], vv[keep], dd[keep]
    if S.orient == ROW:
        pk = ii * S.ncols + jj
        veclen, nvec = S.ncols, S.nrows
    else:
        pk = jj * S.nrows + ii
        veclen, nvec = S.nrows, S.ncols
    psort = np.argsort(pk, kind="stable")
    pk, vv, dd = pk[psort], vv[psort], dd[psort]

    rows, cols = S._coords()
    vec_ids, idx = (rows, cols) if S.orient == ROW else (cols, rows)
    ekeys = K.make_key(vec_ids, idx, veclen)
    ukeys, eav, pbv, e_in, p_in = K.union_merge(
        ekeys, S._vals_expanded(), jnp.asarray(pk), jnp.asarray(vv),
        key_bound=veclen * nvec)
    p_del = jnp.zeros(ukeys.shape[0], bool).at[
        jnp.searchsorted(ukeys, jnp.asarray(pk))].set(jnp.asarray(dd),
                                                      mode="drop")
    keep_mask = (e_in | p_in) & ~(p_in & p_del)
    newv = jnp.where(p_in, pbv.astype(dt), eav)
    cnt, (fk, fv) = K.compact(keep_mask, ukeys, newv)
    uvec, uidx = K.key_split(fk, veclen)
    indptr = K.indptr_from_sorted(uvec, nvec, INDEX)
    A.fmt, A.orient = SPARSE, S.orient
    A.indptr, A.indices, A.values, A.iso = indptr, uidx, fv, False
    A.h, A._nvals_cache = None, None
    if was_hyper:
        A._replace_from(A.to_format(HYPER))


def _last_event_mask(ii, jj, ncols):
    key = ii * np.int64(ncols) + jj
    order = np.argsort(key, kind="stable")
    sk = key[order]
    is_last = np.ones(len(sk), bool)
    is_last[:-1] = sk[1:] != sk[:-1]
    keep = np.zeros(len(sk), bool)
    keep[order[is_last]] = True
    return keep
