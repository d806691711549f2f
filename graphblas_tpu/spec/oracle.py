"""Executable specification: dense numpy mimics of every GraphBLAS op.

This is this package's equivalent of the reference's Octave "spec" files
(Test/GB_spec_mxm.m, GB_spec_accum_mask.m, ... — reference: Test/Contents.m)
— a naive, obviously-correct dense implementation with explicit pattern
arrays, defining the semantics (typecast order, accum/mask behavior,
descriptor handling) independently of the optimized library.  The test
harness sweeps random matrices through both and compares.

Everything here is plain numpy on (values, pattern) pairs; clarity over
speed by design.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.monoid import Monoid
from ..core.ops import BinaryOp, IndexUnaryOp, UnaryOp
from ..core.semiring import Semiring


@dataclasses.dataclass
class SpecMat:
    """Dense (values, pattern) pair."""

    values: np.ndarray
    pattern: np.ndarray  # bool, same shape

    @classmethod
    def empty(cls, shape, dtype):
        return cls(np.zeros(shape, dtype), np.zeros(shape, bool))

    @classmethod
    def from_gb(cls, A):
        v, p = A.to_dense_pair()
        return cls(np.asarray(v), np.asarray(p))

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def copy(self):
        return SpecMat(self.values.copy(), self.pattern.copy())

    def cast(self, dtype):
        dt = T.lookup(dtype)
        out = _cast_np(self.values, dt.np_dtype)
        return SpecMat(np.where(self.pattern, out, np.zeros(1, dt.np_dtype)),
                       self.pattern.copy())


def _cast_np(vals, dt):
    """numpy version of core.types.cast (round-to-nearest float->int)."""
    dt = np.dtype(dt)
    src = np.asarray(vals)
    if src.dtype == dt:
        return src.copy()
    if dt == np.bool_:
        return src != 0
    if np.issubdtype(dt, np.integer) and (
            np.issubdtype(src.dtype, np.floating)
            or np.issubdtype(src.dtype, np.complexfloating)):
        real = src.real if np.issubdtype(src.dtype, np.complexfloating) else src
        info = np.iinfo(dt)
        with np.errstate(invalid="ignore"):
            r = np.rint(real)
            r = np.where(np.isnan(real), 0.0, r)
            r = np.clip(r, float(info.min), float(info.max))
        return r.astype(dt)
    if not np.issubdtype(dt, np.complexfloating) and np.issubdtype(
            src.dtype, np.complexfloating):
        return src.real.astype(dt)
    return src.astype(dt)


def _apply_np(fn, *args):
    """Evaluate a traced-op callable on numpy inputs (jnp ops accept numpy;
    result converted back to numpy)."""
    out = fn(*args)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# accum / mask (reference: Test/GB_spec_accum_mask.m semantics)
# ---------------------------------------------------------------------------

def spec_accum(C: SpecMat, T_: SpecMat, accum: BinaryOp | None,
               out_dtype) -> SpecMat:
    """Z = accum(C, T): union pattern; both -> accum, single -> passthrough
    (typecast to C's type)."""
    dt = T.lookup(out_dtype).np_dtype
    if accum is None:
        return T_.cast(dt)
    both = C.pattern & T_.pattern
    only_c = C.pattern & ~T_.pattern
    only_t = T_.pattern & ~C.pattern
    z = np.zeros(C.shape, dt)
    if both.any():
        z[both] = _cast_np(_apply_np(accum.fn, C.values[both],
                                     T_.values[both]), dt)
    z[only_c] = _cast_np(C.values[only_c], dt)
    z[only_t] = _cast_np(T_.values[only_t], dt)
    return SpecMat(z, C.pattern | T_.pattern)


def spec_mask(C: SpecMat, M: SpecMat | None, Z: SpecMat,
              desc: Descriptor) -> SpecMat:
    """R = C where !m, Z where m (with replace/complement/structure)."""
    if M is None:
        m = np.ones(C.shape, bool)
    else:
        m = M.pattern.copy() if desc.mask_structure else (
            M.pattern & (M.values != 0))
    if desc.mask_complement:
        m = ~m
    rvals = np.where(m, Z.values, C.values)
    if desc.replace:
        rpat = Z.pattern & m
    else:
        rpat = np.where(m, Z.pattern, C.pattern)
    return SpecMat(np.where(rpat, rvals, np.zeros(1, C.dtype)), rpat)


def spec_accum_mask(C: SpecMat, M: SpecMat | None, accum, T_: SpecMat,
                    desc: Descriptor) -> SpecMat:
    Z = spec_accum(C, T_, accum, C.dtype)
    return spec_mask(C, M, Z, desc)


def _maybe_t(A: SpecMat, tran: bool) -> SpecMat:
    return SpecMat(A.values.T, A.pattern.T) if tran else A


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def spec_mxm(C: SpecMat, M, accum, sr: Semiring, A: SpecMat, B: SpecMat,
             desc: Descriptor = NULL) -> SpecMat:
    """C<M> = accum(C, A (+) . (x) B)  — naive triple loop over the monoid."""
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    m, k = A.shape
    k2, n = B.shape
    assert k == k2
    mult, add = sr.mult, sr.add
    ztype = mult.out_type(T.lookup(A.dtype), T.lookup(B.dtype)).np_dtype
    tvals = np.zeros((m, n), ztype)
    tpat = np.zeros((m, n), bool)
    for i in range(m):
        for j in range(n):
            acc = None
            for kk in range(k):
                if A.pattern[i, kk] and B.pattern[kk, j]:
                    x, y = A.values[i, kk], B.values[kk, j]
                    if mult.positional:
                        x, y = _positional_sub(mult.positional, i, kk, kk, j)
                    t = _apply_np(mult.fn, np.asarray(x), np.asarray(y))
                    t = _cast_np(t, ztype)[()]
                    acc = t if acc is None else _cast_np(
                        _apply_np(add.op.fn, np.asarray(acc),
                                  np.asarray(t)), ztype)[()]
            if acc is not None:
                tvals[i, j] = acc
                tpat[i, j] = True
    return spec_accum_mask(C, M, accum, SpecMat(tvals, tpat), desc)


def _positional_sub(kind, ix, jx, iy, jy):
    base = {"firsti": ix, "firsti1": ix + 1, "firstj": jx, "firstj1": jx + 1,
            "secondi": iy, "secondi1": iy + 1, "secondj": jy,
            "secondj1": jy + 1}[kind]
    return np.int64(base), np.int64(base)


def spec_ewise_add(C, M, accum, op: BinaryOp, A: SpecMat, B: SpecMat,
                   desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    ztype = op.out_type(T.lookup(A.dtype), T.lookup(B.dtype)).np_dtype
    both = A.pattern & B.pattern
    tvals = np.zeros(A.shape, ztype)
    if both.any():
        tvals[both] = _cast_np(
            _apply_np(op.fn, A.values[both], B.values[both]), ztype)
    onlya = A.pattern & ~B.pattern
    onlyb = B.pattern & ~A.pattern
    tvals[onlya] = _cast_np(A.values[onlya], ztype)
    tvals[onlyb] = _cast_np(B.values[onlyb], ztype)
    return spec_accum_mask(C, M, accum,
                           SpecMat(tvals, A.pattern | B.pattern), desc)


def spec_ewise_mult(C, M, accum, op: BinaryOp, A: SpecMat, B: SpecMat,
                    desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    ztype = op.out_type(T.lookup(A.dtype), T.lookup(B.dtype)).np_dtype
    both = A.pattern & B.pattern
    tvals = np.zeros(A.shape, ztype)
    if both.any():
        tvals[both] = _cast_np(
            _apply_np(op.fn, A.values[both], B.values[both]), ztype)
    return spec_accum_mask(C, M, accum, SpecMat(tvals, both), desc)


def spec_ewise_union(C, M, accum, op: BinaryOp, A: SpecMat, alpha,
                     B: SpecMat, beta, desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    ztype = op.out_type(T.lookup(A.dtype), T.lookup(B.dtype)).np_dtype
    av = np.where(A.pattern, A.values, np.asarray(alpha, A.dtype))
    bv = np.where(B.pattern, B.values, np.asarray(beta, B.dtype))
    union = A.pattern | B.pattern
    tvals = np.zeros(A.shape, ztype)
    if union.any():
        tvals[union] = _cast_np(_apply_np(op.fn, av[union], bv[union]), ztype)
    return spec_accum_mask(C, M, accum, SpecMat(tvals, union), desc)


def spec_apply(C, M, accum, op, A: SpecMat, desc: Descriptor = NULL,
               bind=None, thunk=None) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    m, n = A.shape
    if isinstance(op, UnaryOp):
        ztype = op.out_type(T.lookup(A.dtype)).np_dtype
        tvals = np.zeros(A.shape, ztype)
        if op.positional:
            ii, jj = np.indices(A.shape)
            src = {"i": ii, "i1": ii + 1, "j": jj, "j1": jj + 1}[op.positional]
            tvals = _cast_np(src, ztype)
        elif A.pattern.any():
            tvals[A.pattern] = _cast_np(
                _apply_np(op.fn, A.values[A.pattern]), ztype)
    elif isinstance(op, IndexUnaryOp):
        ztype = op.out_type(T.lookup(A.dtype)).np_dtype
        ii, jj = np.indices(A.shape)
        out = _apply_np(op.fn, A.values, ii, jj, thunk)
        tvals = np.where(A.pattern, _cast_np(out, ztype), np.zeros(1, ztype))
    else:  # BinaryOp bind1st/bind2nd
        which, scalar = bind
        if which == "first":
            ztype = op.out_type(T.lookup(np.asarray(scalar).dtype),
                                T.lookup(A.dtype)).np_dtype
            out = _apply_np(op.fn, np.broadcast_to(np.asarray(scalar),
                                                   A.shape), A.values)
        else:
            ztype = op.out_type(T.lookup(A.dtype),
                                T.lookup(np.asarray(scalar).dtype)).np_dtype
            out = _apply_np(op.fn, A.values,
                            np.broadcast_to(np.asarray(scalar), A.shape))
        tvals = np.where(A.pattern, _cast_np(out, ztype), np.zeros(1, ztype))
    tvals = np.where(A.pattern, tvals, np.zeros(1, tvals.dtype))
    return spec_accum_mask(C, M, accum, SpecMat(tvals, A.pattern.copy()),
                           desc)


def spec_select(C, M, accum, op: IndexUnaryOp, A: SpecMat, thunk,
                desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    ii, jj = np.indices(A.shape)
    keep = np.asarray(_apply_np(op.fn, A.values, ii, jj, thunk)) != 0
    keep = keep & A.pattern
    tvals = np.where(keep, A.values, np.zeros(1, A.dtype))
    return spec_accum_mask(C, M, accum, SpecMat(tvals, keep), desc)


def spec_reduce_vector(C, M, accum, mon: Monoid, A: SpecMat,
                       desc: Descriptor = NULL) -> SpecMat:
    """w<m> = accum(w, reduce-rows(A)) — reduce along each row."""
    A = _maybe_t(A, desc.transpose0)
    m, n = A.shape
    dt = A.dtype
    tvals = np.zeros((m, 1), dt)
    tpat = np.zeros((m, 1), bool)
    for i in range(m):
        acc = None
        for j in range(n):
            if A.pattern[i, j]:
                v = A.values[i, j]
                acc = v if acc is None else _cast_np(
                    _apply_np(mon.op.fn, np.asarray(acc), np.asarray(v)),
                    dt)[()]
        if acc is not None:
            tvals[i, 0] = acc
            tpat[i, 0] = True
    return spec_accum_mask(C, M, accum, SpecMat(tvals, tpat), desc)


def spec_reduce_scalar(mon: Monoid, A: SpecMat, accum=None, init=None):
    vals = A.values[A.pattern]
    acc = None
    for v in vals.ravel():
        acc = v if acc is None else _cast_np(
            _apply_np(mon.op.fn, np.asarray(acc), np.asarray(v)),
            A.dtype)[()]
    if acc is None:
        acc = mon.identity_for(A.dtype)
    if accum is not None and init is not None:
        acc = _apply_np(accum.fn, np.asarray(init), np.asarray(acc))[()]
    return acc


def spec_transpose(C, M, accum, A: SpecMat, desc: Descriptor = NULL) -> SpecMat:
    # NOTE: GrB_transpose with desc.transpose0 set means NO transpose
    A2 = A if desc.transpose0 else SpecMat(A.values.T, A.pattern.T)
    return spec_accum_mask(C, M, accum, A2.copy(), desc)


def spec_extract(C, M, accum, A: SpecMat, I, J,
                 desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    sub = SpecMat(A.values[np.ix_(I, J)], A.pattern[np.ix_(I, J)])
    return spec_accum_mask(C, M, accum, sub, desc)


def spec_subassign(C: SpecMat, M, accum, A: SpecMat, I, J,
                   desc: Descriptor = NULL) -> SpecMat:
    """GxB_subassign: mask is over C(I,J) (reference: GrB_assign vs
    GxB_subassign mask-scope distinction, Source/GB_assign.c)."""
    sub = SpecMat(C.values[np.ix_(I, J)], C.pattern[np.ix_(I, J)])
    newsub = spec_accum_mask(sub, M, accum, A, desc)
    R = C.copy()
    R.values[np.ix_(I, J)] = _cast_np(newsub.values, C.dtype)
    R.pattern[np.ix_(I, J)] = newsub.pattern
    R.values[~R.pattern] = 0
    return R


def spec_assign(C: SpecMat, M, accum, A: SpecMat, I, J,
                desc: Descriptor = NULL) -> SpecMat:
    """GrB_assign: mask is over all of C."""
    T_ = C.copy()
    # expand A into C-shaped T at (I, J); outside (I,J) T keeps C
    sub = SpecMat(C.values[np.ix_(I, J)], C.pattern[np.ix_(I, J)])
    z = spec_accum(sub, A.cast(C.dtype), accum, C.dtype)
    T_.values[np.ix_(I, J)] = z.values
    T_.pattern[np.ix_(I, J)] = z.pattern
    R = spec_mask(C, M, T_, desc)
    # C_replace outside (I,J): entries outside the assign region are only
    # deleted when replace & mask excludes them... GrB_assign semantics:
    # outside C(I,J), C is untouched EXCEPT under replace where mask=0.
    if not desc.replace:
        out = np.ones(C.shape, bool)
        out[np.ix_(I, J)] = False
        R.pattern[out] = C.pattern[out]
        R.values[out] = C.values[out]
        R.values[~R.pattern] = 0
    return R


def spec_kron(C, M, accum, op: BinaryOp, A: SpecMat, B: SpecMat,
              desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    ztype = op.out_type(T.lookup(A.dtype), T.lookup(B.dtype)).np_dtype
    m, n = A.shape
    p, q = B.shape
    tv = np.zeros((m * p, n * q), ztype)
    tp = np.kron(A.pattern, B.pattern).astype(bool)
    av = np.kron(A.values, np.ones((p, q), A.dtype))
    bv = np.kron(np.ones((m, n), B.dtype), B.values)
    if tp.any():
        tv[tp] = _cast_np(_apply_np(op.fn, av[tp], bv[tp]), ztype)
    return spec_accum_mask(C, M, accum, SpecMat(tv, tp), desc)
