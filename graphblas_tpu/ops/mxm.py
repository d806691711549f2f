"""mxm / mxv / vxm: C<M> = accum(C, A (+).(x) B) over any semiring.

Reference architecture (what this replaces, not how):
  * GB_mxm / GB_AxB_meta (Source/GB_mxm.c, GB_AxB_meta.c): CSR/CSC
    normalization, swap rule, flip-multiply, method selection among
    rowscale/colscale/dot2/dot3/dot4/saxpy3/saxbit/saxpy4/saxpy5.
  * saxpy3 Gustavson+hash task machinery (Source/GB_AxB_saxpy3*).

Design:
  * Logical transposes are free (orientation metadata), so the meta
    algorithm reduces to: normalize A to row-storage, flip the multiply
    instead of materializing transposes (same trick as GB_AxB_meta.c:453),
    then select a kernel by operand formats:
      - dense x dense  -> jnp.matmul for plus-times real semirings,
                          chunked broadcast-reduce otherwise
      - sparse x dense -> row-gather + segmented reduce (saxpy4/5 analog)
      - sparse x sparse -> ESC (expand-sort-compress) SpGEMM: flop-exact
                          expansion via searchsorted, 64-bit key sort,
                          segmented reduction (replaces Gustavson/hash
                          tasks; the sort plays the hash table's role)
  * dot3 analog: when a mask is present, product streams are pre-filtered
    by the effective write mask before the sort — work becomes
    O(flops into mask) like the reference's dot3 (Source/GB_AxB_dot3.c).
  * accum/mask/replace semantics all land in ops/masker.writeback.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import (BITMAP, COL, FULL, HYPER, INDEX, ROW, SPARSE,
                           Matrix, Vector)
from ..core.semiring import Semiring
from ..core.types import cast
from ..kernels import segment as K
from .masker import mask_bits_at_keys, writeback
from .transpose import logical_transpose, maybe_transpose

_MATMUL_ADD = {"GrB_PLUS"}  # monoids whose dense path can ride jnp.matmul
_MATMUL_MULT = {"GrB_TIMES"}


def _dense(a):
    return a.fmt in (BITMAP, FULL)


def _ztype(sr: Semiring, A, B, out_dtype=None):
    if out_dtype is not None:
        return T.lookup(out_dtype)
    # typed predefined semirings compute and output in their declared
    # domain (comparator semirings still output the mult's bool ztype;
    # typed positional semirings output the declared INT32/INT64)
    dt = getattr(sr, "declared_type", None)
    if dt is not None:
        if sr.mult.positional:
            return dt
        return sr.mult.ztype or dt
    return sr.mult.out_type(A.dtype, B.dtype)


def _positional_product_vals(pos_kind, i, k, j, zt):
    """Semiring-context positional multiply: z = f(a_ik, b_kj) with
    FIRSTI=i, FIRSTJ=k, SECONDI=k, SECONDJ=j (reference:
    Doc/GraphBLAS_UserGuide.tex positional-op table; the values depend only
    on the product triple (i,k,j), not on operand storage)."""
    src = {"firsti": i, "firsti1": i + 1, "firstj": k,
           "firstj1": k + 1, "secondi": k, "secondi1": k + 1,
           "secondj": j, "secondj1": j + 1}[pos_kind]
    return src.astype(zt.np_dtype)


def _ident_relabel(i, k, j):
    return i, k, j


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _mask_done(Tm, mask, C, accum, desc):
    """True when the kernel already applied the write mask exactly and the
    writeback can transplant (reference: dot3's C pattern IS the mask
    pattern, so GB_mxm transplants — Source/GB_mxm.c:180-199).  Requires
    no prior C content and no accum: only then is the masked writeback a
    pure pattern filter the kernel has already performed."""
    if mask is None or not getattr(Tm, "_mask_applied", False):
        return False
    if accum is not None:
        return False
    return C is None or (C.fmt in (SPARSE, HYPER) and C.nvals == 0)


def mxm(A: Matrix, B: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    B = maybe_transpose(B, desc.transpose1)
    if A.ncols != B.nrows:
        raise E.DimensionMismatch(f"mxm: {A.shape} x {B.shape}")
    if C is not None and C.shape != (A.nrows, B.ncols):
        raise E.DimensionMismatch("mxm: C shape")
    zt = _ztype(sr, A, B, None)
    Tm = _mxm_dispatch(A, B, sr, zt, mask, desc, accum)
    if _mask_done(Tm, mask, C, accum, desc):
        CFG.burble("mxm: mask applied in-kernel, transplant writeback")
        return writeback(C, None, accum, Tm,
                         desc.with_(mask_complement=False), out_dtype)
    return writeback(C, mask, accum, Tm, desc, out_dtype)


def mxv(A: Matrix, u: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    """w<m> = accum(w, A (+).(x) u).  desc.transpose0 transposes A."""
    A = maybe_transpose(A, desc.transpose0)
    if A.ncols != u.nrows:
        raise E.DimensionMismatch(f"mxv: {A.shape} x {u.shape}")
    zt = _ztype(sr, A, u, None)
    Tm = _mxm_dispatch(A, u, sr, zt, mask, desc, accum)
    d2 = desc.with_(transpose0=False)
    if _mask_done(Tm, mask, C, accum, d2):
        CFG.burble("mxv: mask applied in-kernel, transplant writeback")
        return writeback(C, None, accum, Tm,
                         d2.with_(mask_complement=False), out_dtype,
                         out_class=Vector)
    return writeback(C, mask, accum, Tm, d2, out_dtype, out_class=Vector)


def vxm(u: Matrix, A: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    """w<m> = accum(w, u' (+).(x) A) == mxv(A', u) with multiply flipped
    (the reference's flip-binop trick, GB_AxB_meta.c:453-468).  Positional
    multiplies are not flipped; the kernel's product triple is relabeled
    instead: semantic (i,k,j) = (0, k_kernel, i_kernel).
    desc.transpose1 transposes A."""
    A = maybe_transpose(A, desc.transpose1)
    if A.nrows != u.nrows:
        raise E.DimensionMismatch(f"vxm: {u.shape}' x {A.shape}")
    zt = _ztype(sr, u, A, None)
    d2 = desc.with_(transpose0=False, transpose1=False)
    # SpMSpV fast path: u sparse, A sparse ROW -> compute u' (x) A
    # DIRECTLY as a 1-row SpGEMM over A's rows at supp(u).  The old
    # A'-times-u formulation physically transposed A (seconds at GAP
    # scale) before touching the ~nnz(u)*deg products that actually
    # matter (reference analog: the saxpy SpMSpV of
    # Source/GB_AxB_saxpy.c with a sparse accumulator).
    if (u.fmt in (SPARSE, HYPER) and u.orient == COL
            and A.fmt in (SPARSE, HYPER) and A.orient == ROW
            and not sr.mult.positional
            and mask is None and not u._pending and not A._pending):
        Tv = _spmspv_scatter(u, A, sr, zt)
        if Tv is not None:
            CFG.burble("vxm: spmspv dense-accumulator path")
            return writeback(C, mask, accum, Tv, d2, out_dtype,
                             out_class=Vector)
        # u is n-by-1 stored by column, so its logical transpose is
        # ALREADY the 1-by-n CSR row — zero data movement
        ut = logical_transpose(u.to_format(SPARSE, COL))
        CFG.burble("vxm: spmspv path (1-row spgemm, no transpose)")
        Tm = _spgemm_esc(ut, A, sr, zt, None, d2, accum)
        Tv = logical_transpose(Tm)
        return writeback(C, mask, accum, Tv, d2, out_dtype,
                         out_class=Vector)
    At = logical_transpose(A)
    if sr.mult.positional:
        sr2 = sr
        relabel = lambda i, k, j: (jnp.zeros_like(i), k, i)
    else:
        sr2 = Semiring(sr.add, sr.mult.flipped(), name=sr.name + "_flip")
        relabel = _ident_relabel
    Tm = _mxm_dispatch(At, u, sr2, zt, mask, desc, accum, relabel)
    if _mask_done(Tm, mask, C, accum, d2):
        CFG.burble("vxm: mask applied in-kernel, transplant writeback")
        return writeback(C, None, accum, Tm,
                         d2.with_(mask_complement=False), out_dtype,
                         out_class=Vector)
    return writeback(C, mask, accum, Tm, d2, out_dtype, out_class=Vector)


# ---------------------------------------------------------------------------
# SpMSpV: dense-accumulator saxpy (reference: the sparse-times-sparse-vector
# regime of GB_AxB_saxpy.c — Gustavson with a dense accumulator of size n)
# ---------------------------------------------------------------------------

_SPMSPV_ADDS = ("GrB_PLUS", "GrB_MIN", "GrB_MAX", "GrB_LOR", "GxB_ANY")


def _bucket8(x):
    """Round up to pow2(x)/8 granularity (executable reuse, <=12.5% pad)."""
    if x <= 8:
        return max(int(x), 1)
    p = 1
    while p < x:
        p *= 2
    g = p // 8
    return ((int(x) + g - 1) // g) * g


_spmspv_cache = {}
_spmspv_flops_cache: dict = {}


def _spmspv_fn(Fb, m, add_name, mult, zt_name, logical):
    key = (Fb, m, add_name, mult, zt_name, logical)
    fn = _spmspv_cache.get(key)
    if fn is not None:
        return fn
    kdt = jnp.dtype(zt_name) if not logical else jnp.dtype(jnp.int32)

    def run(ui, uv, aip, aix, av, cumf, ident):
        k = ui.shape[0]
        pos = jnp.arange(Fb, dtype=cumf.dtype)
        e = jnp.minimum(jnp.searchsorted(cumf[1:], pos, side="right"),
                        k - 1)
        off = pos - cumf[e]
        valid = pos < cumf[-1]
        p = jnp.where(valid, aip[ui[e]] + off, 0)
        j = aix[p]
        prod = mult.fn(uv[e], av[p]).astype(kdt)
        tgt = jnp.where(valid, j, m)
        pres = jnp.zeros((m,), jnp.int32).at[tgt].max(
            valid.astype(jnp.int32), mode="drop") > 0
        if add_name == "GrB_PLUS":
            y = jnp.zeros((m,), kdt).at[tgt].add(
                jnp.where(valid, prod, 0), mode="drop")
        else:
            fill = jnp.where(valid, prod, ident.astype(kdt))
            acc = jnp.full((m,), ident.astype(kdt))
            if add_name == "GrB_MIN":
                y = acc.at[tgt].min(fill, mode="drop")
            else:                       # MAX / LOR / ANY
                y = acc.at[tgt].max(fill, mode="drop")
            y = jnp.where(pres, y, 0)
        # column shapes emitted here so the op is ONE dispatch end to end
        return y[:, None], pres[:, None]

    fn = jax.jit(run)
    _spmspv_cache[key] = fn
    return fn


def _spmspv_scatter(u, A, sr, zt):
    """w = u' (x) A with u sparse: expand the ~nnz(u)*deg products and
    scatter into a dense length-n accumulator under the add monoid.
    Returns a BITMAP Vector (conform re-sparsifies), or None when the
    monoid/dtype cannot ride a scatter."""
    add_name = sr.add.op.name
    if add_name not in _SPMSPV_ADDS or getattr(zt, "shape", None):
        return None
    if zt.is_complex:
        return None
    m = A.ncols
    ui = u.indices.astype(INDEX)
    k = int(ui.shape[0])
    if k == 0:
        return Vector(m, zt, SPARSE)
    uv = u._vals_expanded()
    aip = A.indptr
    if A.fmt == HYPER:
        A = A.to_format(SPARSE, ROW)
        aip = A.indptr
    ck = (id(u.indices), id(aip), int(ui.shape[0]))
    ent = _spmspv_flops_cache.get(ck)
    if ent is not None and ent[0] is u.indices and ent[1] is aip:
        cumf, F = ent[2], ent[3]
    else:
        blen = jnp.diff(aip).astype(jnp.int64)[ui]
        cumf = jnp.concatenate([jnp.zeros(1, jnp.int64),
                                jnp.cumsum(blen)])
        F = int(cumf[-1])            # one host sync; cached per (u, A)
        if len(_spmspv_flops_cache) > 8:
            _spmspv_flops_cache.clear()
        _spmspv_flops_cache[ck] = (u.indices, aip, cumf, F)
    if F == 0:
        return Vector(m, zt, SPARSE)
    Fb = _bucket8(F)
    logical = bool(zt.is_bool)
    fn = _spmspv_fn(Fb, m, add_name, sr.mult, np.dtype(zt.np_dtype).name,
                    logical)
    ident = jnp.asarray(sr.add.identity_for(
        np.int32 if logical else zt.np_dtype))
    y, pres = fn(ui, uv, aip, A.indices, A._vals_expanded(), cumf, ident)
    return Vector(m, zt, BITMAP, values=cast(y, zt), bitmap=pres)


# ---------------------------------------------------------------------------
# method selection (the GB_AxB_meta analog)
# ---------------------------------------------------------------------------

def _is_diagonal(a: Matrix) -> bool:
    """Host-side diagonal-operand detection (reference: GB_AxB_meta.c
    rowscale/colscale selection, Source/GB_rowscale.c / GB_colscale.c)."""
    if a.fmt not in (SPARSE,) or a.nrows != a.ncols or a._pending:
        return False
    nnz = int(a.indices.shape[0])
    if nnz != a.nrows:
        return False
    ip = np.asarray(a.indptr)
    if not (np.diff(ip) == 1).all():
        return False
    return bool((np.asarray(a.indices) == np.arange(nnz)).all())


def _rowscale(D: Matrix, B: Matrix, sr, zt, relabel) -> Matrix:
    """C = D*B with D diagonal: scale B's vector-k entries by d[k]."""
    if sr.mult.positional:
        return None
    d = D._vals_expanded()
    Br = B.to_format(SPARSE, ROW) if (B.fmt != SPARSE or B.orient != ROW) \
        else B
    nnz = int(Br.indices.shape[0])
    rows = K.expand_rowids(Br.indptr, nnz, B.nrows)
    vals = cast(sr.mult.fn(d[rows], Br._vals_expanded()), zt)
    from ..core.convert import _clone
    return _clone(Br, dtype=zt, values=vals, iso=False)


def _colscale(A: Matrix, D: Matrix, sr, zt, relabel) -> Matrix:
    """C = A*D with D diagonal: scale A's column-j entries by d[j]."""
    if sr.mult.positional:
        return None
    d = D._vals_expanded()
    Ar = A.to_format(SPARSE, ROW) if (A.fmt != SPARSE or A.orient != ROW) \
        else A
    vals = cast(sr.mult.fn(Ar._vals_expanded(), d[Ar.indices]), zt)
    from ..core.convert import _clone
    return _clone(Ar, dtype=zt, values=vals, iso=False)


def _mxm_dispatch(A, B, sr, zt, mask, desc, accum,
                  relabel=_ident_relabel) -> Matrix:
    # diagonal-operand fast paths (reference: GB_rowscale / GB_colscale)
    if not _dense(A) and not _dense(B) and relabel is _ident_relabel:
        if _is_diagonal(A):
            out = _rowscale(A, B, sr, zt, relabel)
            if out is not None:
                CFG.burble("mxm: rowscale (diagonal A)")
                return out
        if _is_diagonal(B):
            out = _colscale(A, B, sr, zt, relabel)
            if out is not None:
                CFG.burble("mxm: colscale (diagonal B)")
                return out
    if desc.axb_method == "dense" or (_dense(A) and _dense(B)):
        CFG.burble("mxm: dense path (%s x %s)", A.fmt, B.fmt)
        return _mxm_dense(A, B, sr, zt, relabel)
    if _dense(B) and not _dense(A):
        CFG.burble("mxm: spmm path (sparse x %s)", B.fmt)
        return _spmm(A, B, sr, zt, relabel)
    if _dense(A) and not _dense(B):
        # C = A*B == (B'*A')' with multiply flipped; spmm on the flip
        CFG.burble("mxm: spmm-flip path (%s x sparse)", A.fmt)
        if sr.mult.positional:
            sr2 = sr
            rel2 = lambda i, k, j: relabel(j, k, i)
        else:
            sr2 = Semiring(sr.add, sr.mult.flipped(), name=sr.name + "_flip")
            rel2 = lambda i, k, j: relabel(i, k, j)
        Ct = _spmm(logical_transpose(B), logical_transpose(A), sr2, zt, rel2)
        return logical_transpose(Ct)
    CFG.burble("mxm: ESC spgemm path")
    return _spgemm_esc(A, B, sr, zt, mask, desc, accum, relabel)


# ---------------------------------------------------------------------------
# dense x dense
# ---------------------------------------------------------------------------

def _mxm_dense(A, B, sr, zt, relabel=_ident_relabel) -> Matrix:
    av, ap = A.to_dense_pair()
    bv, bp = B.to_dense_pair()
    m, k = A.shape
    n = B.ncols
    add_name, mult_name = sr.add.op.name, sr.mult.name
    real = not (zt.is_complex or zt.is_bool) and not sr.mult.positional
    all_present = A.fmt == FULL and B.fmt == FULL
    # HIGHEST keeps f32 products out of TF32 on GPUs (the reference's
    # fp32 semantics); integer and f64 operands ignore it
    prec = jax.lax.Precision.HIGHEST
    if (add_name in _MATMUL_ADD and mult_name in _MATMUL_MULT and real
            and all_present):
        # matmul fast path (reference analog: dot2 with full operands)
        CFG.burble("mxm dense: matmul")
        cv = jnp.matmul(cast(av, zt), cast(bv, zt), precision=prec,
                        preferred_element_type=zt.np_dtype)
        return Matrix((m, n), zt, FULL, A.orient, values=cv)
    # generic semiring: chunked broadcast-reduce over k.
    ident = jnp.asarray(sr.add.identity_for(zt.np_dtype), zt.np_dtype)
    if mult_name in ("GrB_TIMES",) and add_name in _MATMUL_ADD and real:
        # plus-times with holes: holes multiply as 0 == additive identity
        cv = jnp.matmul(jnp.where(ap, cast(av, zt), 0),
                        jnp.where(bp, cast(bv, zt), 0), precision=prec,
                        preferred_element_type=zt.np_dtype)
        present = (jnp.matmul(ap.astype(jnp.float32), bp.astype(jnp.float32),
                              preferred_element_type=jnp.float32) > 0)
        cv = jnp.where(present, cv, jnp.zeros((), zt.np_dtype))
        return Matrix((m, n), zt, BITMAP, A.orient, values=cv,
                      bitmap=present)
    CFG.burble("mxm dense: generic broadcast-reduce")
    CHUNK = max(1, min(k, (1 << 22) // max(1, m)))  # bound m*CHUNK*n memory
    mult, add = sr.mult, sr.add

    def body(carry, kc):
        acc, pres = carry
        a_blk = jax.lax.dynamic_slice_in_dim(av, kc, CHUNK, axis=1)
        ap_blk = jax.lax.dynamic_slice_in_dim(ap, kc, CHUNK, axis=1)
        b_blk = jax.lax.dynamic_slice_in_dim(bv, kc, CHUNK, axis=0)
        bp_blk = jax.lax.dynamic_slice_in_dim(bp, kc, CHUNK, axis=0)
        both = ap_blk[:, :, None] & bp_blk[None, :, :]
        if mult.positional:
            ii = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int64)[:, None, None],
                                  (m, CHUNK, n))
            kk = jnp.broadcast_to(
                (jnp.arange(CHUNK, dtype=jnp.int64) + kc)[None, :, None],
                (m, CHUNK, n))
            jj = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int64)[None, None, :],
                                  (m, CHUNK, n))
            ri, rk, rj = relabel(ii, kk, jj)
            prod = _positional_product_vals(mult.positional, ri, rk, rj, zt)
        else:
            # struct types: operands carry trailing field dims; insert the
            # broadcast axis at position 2/0 of the ENTRY dims
            if zt.shape:
                fa = a_blk.reshape(a_blk.shape[:2] + (1,) + a_blk.shape[2:])
                fb = b_blk.reshape((1,) + b_blk.shape)
                prod = cast(mult.fn(fa, fb), zt)
            else:
                prod = cast(mult.fn(a_blk[:, :, None], b_blk[None, :, :]), zt)
        prod = T.wh(both, prod, ident)
        red = _reduce_axis1(prod, add, zt)
        anyp = jnp.any(both, axis=1)
        newacc = T.wh(anyp, cast(add.op.fn(acc, red), zt), acc)
        newacc = T.wh(anyp & ~pres, red, newacc)
        return (newacc, pres | anyp), None

    kpad = -(-k // CHUNK) * CHUNK
    if kpad != k:
        padA = ((0, 0), (0, kpad - k)) + ((0, 0),) * len(zt.shape)
        padB = ((0, kpad - k), (0, 0)) + ((0, 0),) * len(zt.shape)
        av = jnp.pad(av, padA)
        ap = jnp.pad(ap, ((0, 0), (0, kpad - k)))
        bv = jnp.pad(bv, padB)
        bp = jnp.pad(bp, ((0, kpad - k), (0, 0)))
    init = (jnp.broadcast_to(ident, (m, n) + zt.shape).astype(zt.np_dtype),
            jnp.zeros((m, n), bool))
    (acc, pres), _ = jax.lax.scan(
        body, init, jnp.arange(0, kpad, CHUNK))
    acc = T.wh(pres, acc, jnp.zeros((), zt.np_dtype))
    return Matrix((m, n), zt, BITMAP, A.orient, values=acc, bitmap=pres)


def _reduce_axis1(prod, add, zt):
    name = add.op.name
    # sum/prod must pin the accumulator dtype: numpy/jnp promote sub-64-bit
    # integers to 64-bit by default, breaking scan carry types
    if name == "GrB_PLUS":
        return jnp.sum(prod, axis=1, dtype=zt.np_dtype)
    if name == "GrB_MIN":
        return jnp.min(prod, axis=1)
    if name == "GrB_MAX":
        return jnp.max(prod, axis=1)
    if name == "GrB_TIMES":
        return jnp.prod(prod, axis=1, dtype=zt.np_dtype)
    if name == "GrB_LOR":
        return jnp.any(prod != 0, axis=1).astype(prod.dtype)
    if name == "GrB_LAND":
        return jnp.all(prod != 0, axis=1).astype(prod.dtype)
    if name == "GrB_LXOR":
        return (jnp.sum((prod != 0).astype(jnp.int32), axis=1) % 2
                ).astype(prod.dtype)
    if name == "GxB_ANY":
        return jnp.max(prod, axis=1)
    # generic: log-depth fold over axis 1
    def fold(x):
        while x.shape[1] > 1:
            half = x.shape[1] // 2
            rest = x[:, 2 * half:]
            x = cast(add.op.fn(x[:, :half], x[:, half:2 * half]), zt)
            if rest.shape[1]:
                x = jnp.concatenate([x, rest], axis=1)
        return x[:, 0]
    return fold(jnp.moveaxis(prod, 1, 1))


# ---------------------------------------------------------------------------
# sparse x dense (SpMM / SpMV) — the saxpy4/saxpy5/dot analog family
# ---------------------------------------------------------------------------

def _spmm(A: Matrix, B: Matrix, sr, zt, relabel=_ident_relabel) -> Matrix:
    """C(bitmap) = A(sparse) x B(bitmap/full).  Row-gather + segmented
    reduce; XLA turns the gather+multiply+segment_sum into fused HBM-bound
    loops (per-chip analog of saxpy4, Source/GB_AxB_saxpy4.c)."""
    Ar = A.to_format(SPARSE, ROW) if (A.fmt != SPARSE or A.orient != ROW) \
        else A
    m, k = A.shape
    n = B.ncols
    nnz = int(Ar.indices.shape[0])
    bv, bp = B.to_dense_pair()
    mult, add = sr.mult, sr.add
    ident = jnp.asarray(add.identity_for(zt.np_dtype), zt.np_dtype)
    if nnz == 0:
        return Matrix((m, n), zt, BITMAP, ROW,
                      values=jnp.full((m, n), jnp.zeros((), zt.np_dtype)),
                      bitmap=jnp.zeros((m, n), bool))
    rows = K.expand_rowids(Ar.indptr, nnz, m)
    cols = Ar.indices
    avals = Ar._vals_expanded()
    brow = bv[cols, :]                     # [nnz, n] gather of B rows
    bpres = bp[cols, :]
    if mult.positional:
        ii = jnp.broadcast_to(rows.astype(jnp.int64)[:, None], (nnz, n))
        kk = jnp.broadcast_to(cols.astype(jnp.int64)[:, None], (nnz, n))
        jj = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int64)[None, :],
                              (nnz, n))
        ri, rk, rj = relabel(ii, kk, jj)
        prod = _positional_product_vals(mult.positional, ri, rk, rj, zt)
    else:
        prod = cast(mult.fn(avals[:, None], brow), zt)
    prod = jnp.where(bpres, prod, ident)
    out = K.segment_reduce(prod, rows, m, add, indices_are_sorted=True)
    pres = jax.ops.segment_max(bpres.astype(jnp.int32), rows, m,
                               indices_are_sorted=True) > 0
    out = jnp.where(pres, out, jnp.zeros((), zt.np_dtype))
    return Matrix((m, n), zt, BITMAP, ROW, values=out, bitmap=pres)


def vxm_chain(u, A, sr: Semiring, steps: int):
    """K-step vxm pipeline: y0 = u; yk = y(k-1) (+).(x) A."""
    import graphblas_tpu as gb
    y = u
    for _ in range(int(steps)):
        y = gb.vxm(y, A, sr)
    return y


def spmv_arrays(indptr, indices, values, x, m: int):
    """Raw CSR SpMV (plus-times): gather x at the column ids, multiply,
    and sum each row's run of products (XLA gather + segment_sum)."""
    nnz = indices.shape[0]
    rows = K.expand_rowids(indptr, nnz, m)
    return jax.ops.segment_sum(values * x[indices], rows, m,
                               indices_are_sorted=True)


# ---------------------------------------------------------------------------
# sparse x sparse: ESC SpGEMM (saxpy3 analog)
# ---------------------------------------------------------------------------

@jax.jit
def _flop_count(a_cols, b_indptr):
    blen = jnp.diff(b_indptr)
    f = blen[a_cols].astype(jnp.int64)
    cumf = jnp.concatenate([jnp.zeros(1, jnp.int64), jnp.cumsum(f)])
    return cumf, cumf[-1]


SPGEMM_FLOP_BLOCK = 1 << 24   # peak expanded products per row block


def _spgemm_esc(A, B, sr, zt, mask, desc, accum,
                relabel=_ident_relabel) -> Matrix:
    """Expand-sort-compress SpGEMM, tiled by row blocks.

    Phase 0 (flopcount; reference: GB_AxB_saxpy3_flopcount.c): exact product
    count F = sum over A entries of |B(k,:)|; one host sync.
    Phase 0.5 (tiling; reference: the coarse-task slicing of
    GB_AxB_saxpy3_slice_balanced): A's rows are grouped into blocks of
    <= SPGEMM_FLOP_BLOCK products so peak memory is O(F_block), not O(F) —
    nd24k-class C=S^2 (F ~ 1e9+) runs without OOM.
    Phase 1 (expand): product p -> (A entry e, B offset) via searchsorted on
    the cumulative flop array; produces i/j/value streams of length F_block.
    Phase 1.5 (dot3 analog): if a mask is present, products are pre-filtered
    by the effective write mask (safe: writeback re-applies the mask).
    Phase 2 (sort+compress): 64-bit key sort + segmented reduce under the
    add monoid (reference: saxpy3 phases 2-5).

    A sparse/hyper mask is applied exactly by the prefilter, so the result
    is marked and mxm/mxv/vxm transplant instead of re-masking in writeback
    (the reference's dot3 transplant, Source/GB_mxm.c:180-199).
    """
    Ar = A.to_format(SPARSE, ROW) if (A.fmt != SPARSE or A.orient != ROW) \
        else A
    Br = B.to_format(SPARSE, ROW) if (B.fmt != SPARSE or B.orient != ROW) \
        else B
    m, k = A.shape
    n = B.ncols
    nnzA = int(Ar.indices.shape[0])
    out = None
    if nnzA == 0 or int(Br.indices.shape[0]) == 0:
        out = Matrix((m, n), zt, SPARSE, ROW)
    else:
        cumf, F = _flop_count(Ar.indices, Br.indptr)
        F = int(F)
        CFG.burble("spgemm: %d flops (nnzA=%d nnzB=%d)", F, nnzA,
                   int(Br.indices.shape[0]))
        if F == 0:
            out = Matrix((m, n), zt, SPARSE, ROW)
    if out is None:
        out = _spgemm_blocks(Ar, Br, cumf, F, sr, zt, mask, desc, relabel)
    if mask is not None and mask.fmt in (SPARSE, HYPER):
        out._mask_applied = True
    return out


def _spgemm_blocks(Ar, Br, cumf, F, sr, zt, mask, desc, relabel):
    m = Ar.nrows
    n = Br.ncols
    a_rows = K.expand_rowids(Ar.indptr, int(Ar.indices.shape[0]), m)
    if F <= SPGEMM_FLOP_BLOCK:
        indptr, uidx, cv = _spgemm_block(Ar, Br, a_rows, cumf, 0, F, sr, zt,
                                         m, n, mask, desc, relabel)
        return Matrix((m, n), zt, SPARSE, ROW, indptr=indptr, indices=uidx,
                      values=cv)
    # row-block tiling: split at row boundaries so each block expands at
    # most SPGEMM_FLOP_BLOCK products (a single row larger than the block
    # still processes alone — entry-granular splitting of one row would
    # break dedup)
    ip_h = np.asarray(Ar.indptr).astype(np.int64)
    row_cum = np.asarray(cumf)[ip_h]         # cumulative flops at row starts
    starts = [0]
    while starts[-1] < m:
        r0 = starts[-1]
        r1 = int(np.searchsorted(row_cum, row_cum[r0] + SPGEMM_FLOP_BLOCK,
                                 side="right")) - 1
        starts.append(max(r1, r0 + 1))
    CFG.burble("spgemm: %d row blocks", len(starts) - 1)
    parts = []
    for r0, r1 in zip(starts[:-1], starts[1:]):
        f0, f1 = int(row_cum[r0]), int(row_cum[r1])
        if f1 == f0:
            parts.append((np.zeros(r1 - r0 + 1, np.int64), None, None))
            continue
        indptr_b, uidx, cv = _spgemm_block(
            Ar, Br, a_rows, cumf, f0, f1 - f0, sr, zt, m, n, mask, desc,
            relabel, row_lo=r0, row_hi=r1, F_total=F)
        parts.append((np.asarray(indptr_b), uidx, cv))
    # assemble: per-block indptrs concatenate with running offsets
    counts = np.concatenate([np.diff(p[0]) for p in parts])
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    idx_parts = [p[1] for p in parts if p[1] is not None]
    val_parts = [p[2] for p in parts if p[2] is not None]
    uidx = jnp.concatenate(idx_parts) if idx_parts else \
        jnp.zeros(0, INDEX)
    cv = jnp.concatenate(val_parts) if val_parts else \
        jnp.zeros(0, zt.np_dtype)
    return Matrix((m, n), zt, SPARSE, ROW,
                  indptr=jnp.asarray(indptr.astype(INDEX)), indices=uidx,
                  values=cv)


def _next_pow2_i(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _spgemm_block(Ar, Br, a_rows, cumf, f0, Fb, sr, zt, m, n, mask, desc,
                  relabel, row_lo=0, row_hi=None, F_total=None):
    """One ESC pass over products [f0, f0+Fb); returns (indptr_slice,
    indices, values) where indptr_slice covers rows [row_lo, row_hi).
    Fb pads to a power of two so tiled blocks share compiled shapes; pad
    products carry an out-of-range sentinel key and drop after the sort."""
    row_hi = m if row_hi is None else row_hi
    Fb_pad = _next_pow2_i(Fb)
    sentinel = None
    if F_total is not None and f0 + Fb_pad > F_total:
        sentinel = m * n
    elif Fb_pad > Fb:
        sentinel = m * n
    keys, prod = _spgemm_expand(Ar, Br, a_rows, cumf, Fb_pad, sr, zt, n,
                                relabel, f0=f0,
                                valid_hi=(f0 + Fb if sentinel is not None
                                          else None), sentinel=sentinel)
    if mask is not None and mask.fmt in (SPARSE, HYPER):
        eff = mask_bits_at_keys(mask, keys, n, ROW, desc)
        kept, (keys, prod) = K.compact(eff, keys, prod)
        CFG.burble("spgemm: mask prefilter %d -> %d products", Fb, kept)
        if kept == 0:
            return (jnp.zeros(row_hi - row_lo + 1, INDEX),
                    jnp.zeros(0, INDEX), jnp.zeros(0, zt.np_dtype))
    order = jnp.argsort(keys, stable=False)
    skeys = keys[order]
    sprod = prod[order]
    gid, ng = K.group_ids(skeys)
    cv = K.segment_reduce(sprod, gid, ng, sr.add)
    ukeys = jnp.zeros((ng,), skeys.dtype).at[gid].set(skeys)
    if sentinel is not None and ng and int(ukeys[ng - 1]) >= sentinel:
        ng -= 1                      # drop the pad group (sorts last)
        ukeys, cv = ukeys[:ng], cv[:ng]
    uvec, uidx = K.key_split(ukeys, n)
    if row_lo or row_hi != m:
        uvec = uvec - row_lo
    indptr = K.indptr_from_sorted(uvec, row_hi - row_lo, INDEX)
    return indptr, uidx, cv



def _spgemm_expand(Ar, Br, a_rows, cumf, F: int, sr, zt, n: int,
                   relabel=_ident_relabel, f0: int = 0, valid_hi=None,
                   sentinel=None):
    mult = sr.mult
    nnzA = Ar.indices.shape[0]
    p = jnp.arange(F, dtype=jnp.int64) + jnp.int64(f0)
    e = jnp.searchsorted(cumf[1:], p, side="right").astype(jnp.int64)
    e = jnp.minimum(e, nnzA - 1)
    off = jnp.maximum(p - cumf[e], 0)
    b_pos = jnp.minimum(Br.indptr[Ar.indices[e]].astype(jnp.int64) + off,
                        Br.indices.shape[0] - 1)
    i = a_rows[e].astype(jnp.int64)
    ka = Ar.indices[e].astype(jnp.int64)
    j = Br.indices[b_pos].astype(jnp.int64)
    keys = i * n + j
    if sentinel is not None:
        keys = jnp.where(p < valid_hi, keys, jnp.int64(sentinel))
    if mult.positional:
        ri, rk, rj = relabel(i, ka, j)
        prod = _positional_product_vals(mult.positional, ri, rk, rj, zt)
    else:
        av = Ar._vals_expanded()[e]
        bvv = Br._vals_expanded()[b_pos]
        prod = cast(mult.fn(av, bvv), zt)
    return keys, prod
