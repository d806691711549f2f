"""Format & conversion engine (reference: Source/GB_convert_*.c — 20 files,
GB_conform.c, hyper<->sparse<->bitmap<->full rules in GB_matrix.h:394-458).

All conversions are device-side array programs; bitmap->sparse needs one
host sync of nnz (the static-shape tax, paid exactly where the reference
pays a malloc)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import config as CFG
from . import errors as E
from .matrix import BITMAP, COL, FULL, HYPER, INDEX, ROW, SPARSE, Matrix


def _clone(a: Matrix, **kw) -> Matrix:
    obj = object.__new__(type(a))
    obj.shape, obj.dtype = a.shape, a.dtype
    obj.fmt, obj.orient, obj.iso = a.fmt, a.orient, a.iso
    obj.indptr, obj.h, obj.indices, obj.values, obj.bitmap = (
        a.indptr, a.h, a.indices, a.values, a.bitmap)
    obj._pending, obj._nvals_cache, obj.name = [], None, a.name
    for k in ("sparsity_control", "hyper_switch", "bitmap_switch"):
        if getattr(a, k, None) is not None:
            setattr(obj, k, getattr(a, k))
    for k, v in kw.items():
        setattr(obj, k, v)
    return obj


def convert(a: Matrix, fmt: str, orient: str) -> Matrix:
    CFG.burble("convert %s/%s -> %s/%s", a.fmt, a.orient, fmt, orient)
    # normalize via sparse when crossing both format and orientation
    if a.fmt == HYPER:
        a = _hyper_to_sparse(a)
    if a.fmt == fmt and a.orient == orient:
        return a
    if fmt in (BITMAP, FULL):
        # orientation is metadata-only for dense layouts
        if a.fmt == SPARSE:
            return _sparse_to_dense(a, fmt, orient)
        if a.fmt == BITMAP and fmt == FULL:
            return _bitmap_to_full(a, orient)
        if a.fmt == FULL and fmt == BITMAP:
            return _clone(a, fmt=BITMAP, orient=orient,
                          bitmap=jnp.ones(a.shape, bool))
        return _clone(a, orient=orient)
    # target is sparse or hyper
    if a.fmt in (BITMAP, FULL):
        a = _dense_to_sparse(a, orient)
    elif a.orient != orient:
        a = _sparse_reorient(a, orient)
    if fmt == HYPER:
        a = _sparse_to_hyper(a)
    return a


# -- hyper <-> sparse (reference: GB_convert_hyper_to_sparse.c and back) ----

def _hyper_to_sparse(a: Matrix) -> Matrix:
    nvec = a._nvec_dim()
    nh = int(a.h.shape[0])
    full_ptr = jnp.zeros(nvec + 1, INDEX)
    if nh:
        # counts per listed vector scattered to the full vector space
        counts = jnp.diff(a.indptr)
        allcounts = jnp.zeros(nvec, INDEX).at[a.h].set(counts)
        full_ptr = jnp.concatenate([jnp.zeros(1, INDEX),
                                    jnp.cumsum(allcounts).astype(INDEX)])
    return _clone(a, fmt=SPARSE, h=None, indptr=full_ptr)


def _sparse_to_hyper(a: Matrix) -> Matrix:
    counts = jnp.diff(a.indptr)
    nonempty = counts > 0
    nh = int(jnp.sum(nonempty))
    from ..kernels import segment as K
    _, (h,) = K.compact(nonempty, jnp.arange(a._nvec_dim(), dtype=INDEX))
    hptr = jnp.concatenate([jnp.zeros(1, INDEX),
                            jnp.cumsum(counts[h]).astype(INDEX)]) \
        if nh else jnp.zeros(1, INDEX)
    return _clone(a, fmt=HYPER, h=h, indptr=hptr)


# -- sparse -> dense --------------------------------------------------------

def _sparse_to_dense(a: Matrix, fmt: str, orient: str) -> Matrix:
    vals, present = a.to_dense_pair()
    if fmt == FULL:
        if a.nvals != a.nrows * a.ncols:
            raise E.InvalidValue(
                "cannot convert to full: not all entries present")
        return _clone(a, fmt=FULL, orient=orient, indptr=None, indices=None,
                      values=vals, iso=False, bitmap=None)
    return _clone(a, fmt=BITMAP, orient=orient, indptr=None, indices=None,
                  values=vals, iso=False, bitmap=present)


def _bitmap_to_full(a: Matrix, orient: str) -> Matrix:
    if a.nvals != a.nrows * a.ncols:
        raise E.InvalidValue("cannot convert to full: not all entries present")
    return _clone(a, fmt=FULL, orient=orient, bitmap=None,
                  values=a._vals_expanded(), iso=False)


# -- dense -> sparse ---------------------------------------------------------

def _dense_to_sparse(a: Matrix, orient: str) -> Matrix:
    from ..kernels import segment as K
    if a.fmt == FULL:
        present = jnp.ones(a.shape, bool)
    else:
        present = a.bitmap
    vals = a._vals_expanded()
    if orient == COL:
        present_o = present.T
        vals_o = vals.T
        nvec, veclen = a.ncols, a.nrows
    else:
        present_o, vals_o = present, vals
        nvec, veclen = a.nrows, a.ncols
    flat_p = present_o.reshape(-1)
    flat_v = vals_o.reshape(-1)
    pos = jnp.arange(flat_p.shape[0], dtype=jnp.int64)
    nnz, (kept_pos, kept_vals) = K.compact(flat_p, pos, flat_v)
    vec_ids = (kept_pos // veclen).astype(INDEX)
    idx = (kept_pos % veclen).astype(INDEX)
    indptr = K.indptr_from_sorted(vec_ids, nvec, INDEX)
    return _clone(a, fmt=SPARSE, orient=orient, bitmap=None,
                  indptr=indptr, indices=idx, values=kept_vals, iso=False)


# -- sparse orientation flip (CSR <-> CSC): a full sort-based transpose of
#    the storage, NOT of the logical matrix (reference: GB_convert cross
#    product of formats; logical transpose lives in ops/transpose.py) -------

_reorient_jits: dict = {}


def _reorient_fn(old_nvec: int, new_nvec: int, iso: bool):
    """One jitted executable for the whole CSR<->CSC reorient pipeline
    (coords -> key -> sort -> split -> indptr) in one dispatch."""
    import jax
    key = (old_nvec, new_nvec, iso)
    fn = _reorient_jits.get(key)
    if fn is not None:
        return fn
    from ..kernels import segment as K

    def run(indptr, indices, values):
        nnz = indices.shape[0]
        vecid = K.expand_rowids(indptr, nnz, old_nvec)
        # flip: new vec = stored idx, new idx = stored vec;
        # new veclen == old nvec
        keys = indices.astype(K.KEY) * old_nvec + vecid.astype(K.KEY)
        if iso:
            skeys = jnp.sort(keys)
            svals = values
        else:
            skeys, svals = K.sort_with_payload(keys, values)
        svec = (skeys // old_nvec).astype(INDEX)
        sidx = (skeys % old_nvec).astype(INDEX)
        indptr2 = K.indptr_from_sorted(svec, new_nvec, INDEX)
        return indptr2, sidx, svals

    fn = jax.jit(run)
    if len(_reorient_jits) > 32:
        _reorient_jits.clear()
    _reorient_jits[key] = fn
    return fn


def _sparse_reorient(a: Matrix, orient: str) -> Matrix:
    old_nvec = a._nvec_dim()
    new_nvec = a.ncols if orient == COL else a.nrows
    fn = _reorient_fn(old_nvec, new_nvec, bool(a.iso))
    indptr, sidx, svals = fn(a.indptr, a.indices,
                             a.values if a.iso else a._vals_expanded())
    return _clone(a, orient=orient, indptr=indptr, indices=sidx,
                  values=svals)


# -- conform (reference: Source/GB_conform.c — applied after every op) ------

def conform(a: Matrix, like: Matrix | None = None) -> Matrix:
    """Auto format switching after every op (reference: Source/GB_conform.c,
    rules at Source/Shared/GB_matrix.h:394-458).

    Decisions are keyed on the matrix's ``sparsity_control`` (set via
    ``Matrix.set("sparsity_control", ...)``; "auto" allows every format)
    and the hyper/bitmap switches (per-matrix override, else global):

      * all entries present and FULL allowed          -> full
      * density > bitmap_switch and BITMAP allowed    -> bitmap
      * bitmap with density < bitmap_switch/2         -> sparse (hysteresis)
      * sparse with nonempty-vector fraction below
        hyper_switch and HYPER allowed                -> hypersparse
      * hyper with fraction >= 2*hyper_switch         -> sparse

    The density rules need nvals — a device-to-host sync — so
    in nonblocking mode they run only when nvals is already known (the
    static-shape analog of the reference deferring work to GrB_wait);
    blocking mode always evaluates them, as the spec requires results to
    be finished."""
    mn = a.nrows * a.ncols
    if mn == 0 or getattr(a, "_pending", None):
        return a
    src = like if like is not None else a   # controls live on the C target
    ctrl = getattr(src, "sparsity_control", None) or "auto"
    allowed = ({HYPER, SPARSE, BITMAP, FULL} if ctrl == "auto"
               else {c.strip() for c in ctrl.split("+")})
    bsw = getattr(src, "bitmap_switch", None)
    if bsw is None:
        bsw = CFG.GLOBAL.bitmap_switch
    hsw = getattr(src, "hyper_switch", None)
    if hsw is None:
        hsw = CFG.GLOBAL.hyper_switch

    nv = None
    if a.fmt == FULL:
        nv = mn
    elif CFG.GLOBAL.blocking or a._nvals_cache is not None:
        nv = a.nvals

    out = a
    if nv is not None:
        d = nv / mn
        if nv == mn and FULL in allowed and a.fmt != FULL:
            out = convert(a, FULL, a.orient)
        elif a.fmt in (SPARSE, HYPER) and d > bsw and BITMAP in allowed:
            out = convert(a, BITMAP, a.orient)
        elif a.fmt == BITMAP and d <= bsw / 2 and SPARSE in allowed:
            out = convert(a, SPARSE, a.orient)
        elif a.fmt == FULL and nv < mn:  # pragma: no cover - full is total
            out = convert(a, BITMAP, a.orient)
    if out.fmt == SPARSE and HYPER in allowed and nv is not None:
        nvec = out._nvec_dim()
        # sufficient, sync-free: nonempty <= nvals, so nvals < h*nvec
        # implies the nonempty fraction is below the switch
        if nvec and nv < hsw * nvec:
            out = convert(out, HYPER, out.orient)
    elif out.fmt == HYPER and SPARSE in allowed:
        nvec = out._nvec_dim()
        if nvec and out.h.shape[0] >= 2 * hsw * nvec:
            out = convert(out, SPARSE, out.orient)
    if out is not a:
        CFG.burble("conform: %s -> %s", a.fmt, out.fmt)
    return out
