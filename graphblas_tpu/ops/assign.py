"""GrB_assign / GxB_subassign: C(I,J)<M> = accum(C(I,J), A).

Reference: Source/GB_assign.c, GB_subassigner_method.c — ~30 numbered
methods keyed on {scalar?, accum?, mask?, comp?, replace?, C format,
aliasing} (20.3k LoC).  Redesign (SURVEY.md §7 "hard parts"): a handful
of orthogonal fused paths —

  * subassign  = extract region -> writeback on the subregion -> splice
  * assign     = build T (C with region replaced, unmasked) -> global mask
  * scalar assign with sparse mask + ALL region = one sparse merge
    (the reference's celebrated C<M>=x fast path, Method 05d/05e)
  * dense C    = pure jnp.where scatter algebra

The mask-scope difference (assign: all C; subassign: C(I,J)) is exactly the
reference's GrB_assign/GxB_subassign distinction.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import (BITMAP, COL, FULL, HYPER, INDEX, ROW, SPARSE,
                           Matrix, Scalar, Vector)
from ..core.types import cast
from ..kernels import segment as K
from .extract import extract_pattern, normalize_index
from .masker import _keys_of, mask_bits_at_keys, writeback
from .transpose import maybe_transpose


def assign(C: Matrix, A, I=None, J=None, *, mask=None, accum=None,
           desc: Descriptor = NULL, subassign=False) -> Matrix:
    Iv = normalize_index(I, C.nrows)
    Jv = normalize_index(J, C.ncols)
    is_scalar = np.isscalar(A) or (hasattr(A, "ndim") and A.ndim == 0) or \
        isinstance(A, Scalar)
    if isinstance(A, Scalar):
        A = A.value()
    full_region = len(Iv) == C.nrows and len(Jv) == C.ncols and \
        np.array_equal(Iv, np.arange(C.nrows)) and \
        np.array_equal(Jv, np.arange(C.ncols))

    # fast path: C<M> = scalar over ALL with sparse mask and sparse C
    # (reference Method 05d/05e — the "C(M)=A in 0.8s vs 4-5 days" case)
    if (is_scalar and full_region and mask is not None
            and mask.fmt in (SPARSE, HYPER) and C.fmt in (SPARSE, HYPER)
            and not desc.mask_complement and accum is None
            and not desc.replace):
        CFG.burble("assign: sparse-mask scalar fast path")
        return _scalar_mask_merge(C, A, mask, desc)

    if not is_scalar:
        A = maybe_transpose(A, desc.transpose0)
        if A.shape != (len(Iv), len(Jv)):
            # row/col assign convenience: 1xN or Nx1 against the region
            if A.shape == (len(Jv), len(Iv)):
                raise E.DimensionMismatch(
                    f"assign: A {A.shape} vs region {(len(Iv), len(Jv))}"
                    " (transposed?)")
            raise E.DimensionMismatch(
                f"assign: A {A.shape} vs region {(len(Iv), len(Jv))}")

    if subassign:
        return _subassign(C, A, Iv, Jv, is_scalar, mask, accum, desc)
    return _assign_full_mask(C, A, Iv, Jv, is_scalar, mask, accum, desc)


def _region_matrix(C, A, Iv, Jv, is_scalar):
    """A as a (len(I), len(J)) matrix; scalars become iso-full."""
    if not is_scalar:
        return A
    dt = C.dtype
    val = jnp.asarray(A).astype(dt.np_dtype).reshape(1)
    return Matrix((len(Iv), len(Jv)), dt, FULL, C.orient, iso=True,
                  values=val)


def _subassign(C, A, Iv, Jv, is_scalar, mask, accum, desc):
    CFG.burble("subassign: extract-writeback-splice")
    Am = _region_matrix(C, A, Iv, Jv, is_scalar)
    S = extract_pattern(C, Iv, Jv)
    d2 = desc.with_(transpose0=False, transpose1=False)
    Z = writeback(S, mask, accum, Am, d2, out_dtype=C.dtype)
    return _splice(C, Z, Iv, Jv)


def _assign_full_mask(C, A, Iv, Jv, is_scalar, mask, accum, desc):
    CFG.burble("assign: global-mask path")
    Am = _region_matrix(C, A, Iv, Jv, is_scalar)
    S = extract_pattern(C, Iv, Jv)
    d_none = NULL
    Z = writeback(S, None, accum, Am, d_none, out_dtype=C.dtype)
    Tfull = _splice(C, Z, Iv, Jv)
    d2 = desc.with_(transpose0=False, transpose1=False)
    R = writeback(C, mask, None, Tfull, d2, out_dtype=C.dtype)
    if desc.replace:
        return R
    # outside the region, entries revert to C (assign never deletes outside
    # C(I,J) unless replace) — reference: GB_assign.c C_replace_phase
    return _restore_outside(R, C, Iv, Jv)


def _splice(C, Z, Iv, Jv):
    """C with region (Iv, Jv) replaced by Z (region-shaped)."""
    if C.fmt in (BITMAP, FULL):
        cv, cp = C.to_dense_pair()
        zv, zp = Z.to_dense_pair()
        ii = jnp.asarray(Iv)[:, None]
        jj = jnp.asarray(Jv)[None, :]
        cv = cv.at[ii, jj].set(cast(zv, C.dtype))
        cp = cp.at[ii, jj].set(zp)
        return Matrix(C.shape, C.dtype, BITMAP, C.orient, values=cv,
                      bitmap=cp)
    # sparse: drop C entries inside the region, add Z remapped to global
    S = C.to_format(SPARSE) if C.fmt == HYPER else C
    rows, cols = S._coords()
    in_i = jnp.zeros(C.nrows, bool).at[jnp.asarray(Iv)].set(True)
    in_j = jnp.zeros(C.ncols, bool).at[jnp.asarray(Jv)].set(True)
    outside = ~(in_i[rows] & in_j[cols])
    cnt, (orow, ocol, oval) = K.compact(outside, rows, cols,
                                        cast(S._vals_expanded(), C.dtype))
    Zs = Z.to_format(SPARSE) if Z.fmt in (BITMAP, FULL, HYPER) else Z
    zr, zc = Zs._coords()
    gi = jnp.asarray(Iv)[zr]
    gj = jnp.asarray(Jv)[zc]
    zv = cast(Zs._vals_expanded(), C.dtype)
    arow = jnp.concatenate([orow.astype(jnp.int64), gi.astype(jnp.int64)])
    acol = jnp.concatenate([ocol.astype(jnp.int64), gj.astype(jnp.int64)])
    aval = jnp.concatenate([oval, zv])
    vec, idx, nvec, veclen = ((arow, acol, C.nrows, C.ncols)
                              if S.orient == ROW else
                              (acol, arow, C.ncols, C.nrows))
    order, skeys = K.sort_coo(vec, idx, veclen)
    svec, sidx = K.key_split(skeys, veclen)
    indptr = K.indptr_from_sorted(svec, nvec, INDEX)
    return Matrix(C.shape, C.dtype, SPARSE, S.orient, indptr=indptr,
                  indices=sidx, values=aval[order])


def _restore_outside(R, C, Iv, Jv):
    """R with entries outside region reverted to C (pattern and values)."""
    if R.fmt in (BITMAP, FULL) or C.fmt in (BITMAP, FULL):
        rv, rp = R.to_dense_pair()
        cv, cp = C.to_dense_pair()
        in_i = jnp.zeros(C.nrows, bool).at[jnp.asarray(Iv)].set(True)
        in_j = jnp.zeros(C.ncols, bool).at[jnp.asarray(Jv)].set(True)
        region = in_i[:, None] & in_j[None, :]
        nv = jnp.where(region, rv, cast(cv, R.dtype))
        np_ = jnp.where(region, rp, cp)
        nv = jnp.where(np_, nv, jnp.zeros((), R.dtype.np_dtype))
        return Matrix(C.shape, R.dtype, BITMAP, C.orient, values=nv,
                      bitmap=np_)
    # both sparse: splice C's outside entries into R's region entries
    Rs = R.to_format(SPARSE, C.orient)
    rr, rc = Rs._coords()
    in_i = jnp.zeros(C.nrows, bool).at[jnp.asarray(Iv)].set(True)
    in_j = jnp.zeros(C.ncols, bool).at[jnp.asarray(Jv)].set(True)
    inside = in_i[rr] & in_j[rc]
    cnt, (ir, ic, iv) = K.compact(inside, rr, rc, Rs._vals_expanded())
    Zregion = Matrix(C.shape, R.dtype, SPARSE, C.orient)
    # build matrix from region entries + C outside entries
    S = C.to_format(SPARSE) if C.fmt == HYPER else C
    crows, ccols = S._coords()
    outside = ~(in_i[crows] & in_j[ccols])
    cnt2, (orow, ocol, oval) = K.compact(outside, crows, ccols,
                                         cast(S._vals_expanded(), R.dtype))
    arow = jnp.concatenate([orow.astype(jnp.int64), ir.astype(jnp.int64)])
    acol = jnp.concatenate([ocol.astype(jnp.int64), ic.astype(jnp.int64)])
    aval = jnp.concatenate([oval, iv])
    vec, idx, nvec, veclen = ((arow, acol, C.nrows, C.ncols)
                              if S.orient == ROW else
                              (acol, arow, C.ncols, C.nrows))
    order, skeys = K.sort_coo(vec, idx, veclen)
    svec, sidx = K.key_split(skeys, veclen)
    indptr = K.indptr_from_sorted(svec, nvec, INDEX)
    return Matrix(C.shape, R.dtype, SPARSE, S.orient, indptr=indptr,
                  indices=sidx, values=aval[order])


def _scalar_mask_merge(C, scalar, mask, desc):
    """C<M> = x with M sparse: union-merge C with M's pattern carrying the
    scalar (reference: GB_subassign 05d/05e)."""
    orient = C.orient
    Cs = C.to_format(SPARSE) if C.fmt == HYPER else C
    Ms = mask.to_format(SPARSE, orient) if mask.fmt == HYPER \
        else mask.to_orient(orient)
    ck, cvals = _keys_of(Cs)
    mk, mvals = _keys_of(Ms)
    if not desc.mask_structure:
        keepm = mvals != 0
        cntm, (mk,) = K.compact(keepm, mk)
    sval = jnp.asarray(scalar).astype(C.dtype.np_dtype)
    mfill = jnp.broadcast_to(sval, mk.shape)
    ukeys, ucv, umv, c_in, m_in = K.union_merge(
        ck, cvals, mk, mfill, key_bound=Cs._veclen() * Cs._nvec_dim())
    vals = jnp.where(m_in, umv, ucv)
    veclen = C._veclen()
    uvec, uidx = K.key_split(ukeys, veclen)
    indptr = K.indptr_from_sorted(uvec, C._nvec_dim(), INDEX)
    return Matrix(C.shape, C.dtype, SPARSE, orient, indptr=indptr,
                  indices=uidx, values=vals)
