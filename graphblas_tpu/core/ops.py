"""GraphBLAS operators as traced JAX callables.

The reference carries every operator as a C function pointer plus its C
source string for the runtime JIT (reference: Source/Shared/GB_Operator.h,
Source/GB_ops.c — ~80 unary ops, ~300 typed binary ops, index-unary ops,
positional ops).  Here the entire FactoryKernels/JIT apparatus collapses:
an operator IS a traceable Python callable, and ``jax.jit`` specializes every
kernel for (op x dtype x sparsity) for free.

Operators are polymorphic over dtype by default (one object per op name, like
the reference's GrB_PLUS covering all typed variants GrB_PLUS_{T}); a fixed
output type (e.g. BOOL for comparators) is declared via ``ztype``.

Positional binary ops (FIRSTI/FIRSTJ/SECONDI/SECONDJ +-1, reference:
Include/GraphBLAS.h GxB_FIRSTI_INT64 etc.) carry a ``positional`` tag; kernels
substitute entry coordinates for values before calling ``fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from . import types as T


# ---------------------------------------------------------------------------
# operator classes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnaryOp:
    """z = f(x)  (reference: GrB_UnaryOp)."""

    name: str
    fn: Callable[[Any], Any]
    ztype: Optional[T.Type] = None  # None => same as input
    positional: Optional[str] = None  # 'i' | 'i1' | 'j' | 'j1'

    def __call__(self, x):
        return self.fn(x)

    def out_type(self, xtype: T.Type) -> T.Type:
        return self.ztype or xtype

    def __repr__(self):
        return f"UnaryOp({self.name})"


@dataclasses.dataclass(frozen=True)
class BinaryOp:
    """z = f(x, y)  (reference: GrB_BinaryOp)."""

    name: str
    fn: Callable[[Any, Any], Any]
    ztype: Optional[T.Type] = None  # None => same as (promoted) input
    positional: Optional[str] = None  # 'firsti'|'firsti1'|'firstj'|'firstj1'
    #                                   |'secondi'|'secondi1'|'secondj'|'secondj1'
    commutative: bool = False

    def __call__(self, x, y):
        return self.fn(x, y)

    def out_type(self, xtype: T.Type, ytype: T.Type | None = None) -> T.Type:
        if self.ztype is not None:
            return self.ztype
        if self.positional:
            return T.INT64
        if ytype is None or xtype is ytype:
            return xtype
        return T.upcast_pair(xtype, ytype)

    def flipped(self) -> "BinaryOp":
        """The op with arguments swapped — the reference's GB_flip_binop
        trick (Source/GB_AxB_meta.c:453-468) to avoid explicit transposes."""
        if self.commutative:
            return self
        flip_pos = {"firsti": "secondi", "firsti1": "secondi1",
                    "firstj": "secondj", "firstj1": "secondj1",
                    "secondi": "firsti", "secondi1": "firsti1",
                    "secondj": "firstj", "secondj1": "firstj1"}
        f = self.fn
        return BinaryOp(self.name + "_flipped", lambda x, y: f(y, x),
                        ztype=self.ztype,
                        positional=flip_pos.get(self.positional),
                        commutative=False)

    def __repr__(self):
        return f"BinaryOp({self.name})"


@dataclasses.dataclass(frozen=True)
class IndexUnaryOp:
    """z = f(x, i, j, thunk)  (reference: GrB_IndexUnaryOp, used by
    GrB_select / GrB_apply; Source/GB_select.h:16-184)."""

    name: str
    fn: Callable[[Any, Any, Any, Any], Any]
    ztype: Optional[T.Type] = None
    # True when the op depends only on (i, j, thunk) — lets select/apply skip
    # reading values (reference: positional selectors TRIL/TRIU/...).
    positional: bool = False
    # True when the op depends only on the value.
    value_only: bool = False

    def __call__(self, x, i, j, thunk):
        return self.fn(x, i, j, thunk)

    def out_type(self, xtype: T.Type) -> T.Type:
        return self.ztype or xtype

    def __repr__(self):
        return f"IndexUnaryOp({self.name})"


# ---------------------------------------------------------------------------
# integer division semantics
# ---------------------------------------------------------------------------
# The reference defines integer x/0 (GB_math.h GB_idiv_*): 0/0 = 0,
# x/0 = INT_MAX (x>0) or INT_MIN (x<0) for signed; UINT_MAX for unsigned.
# Floats follow IEEE.  C-style truncating division for ints.

def _int_div(x, y):
    dt = np.dtype(jnp.result_type(x, y))
    if not np.issubdtype(dt, np.integer):
        return x / y
    info = np.iinfo(dt)
    safe = jnp.where(y == 0, 1, y)
    # C truncating division (jnp // floors, so fix up signs).
    q = x // safe
    r = x - q * safe
    trunc = jnp.where((r != 0) & ((x < 0) != (safe < 0)), q + 1, q)
    # typed scalars: bare python ints overflow jnp for uint64
    imax = dt.type(info.max)
    imin = dt.type(info.min)
    zero = dt.type(0)
    if np.issubdtype(dt, np.signedinteger):
        div0 = jnp.where(x == 0, zero,
                         jnp.where(x > 0, imax, imin)).astype(dt)
    else:
        div0 = jnp.where(x == 0, zero, imax).astype(dt)
    return jnp.where(y == 0, div0, trunc.astype(dt))


def _minmax(kind):
    # GraphBLAS MIN/MAX are "omitnan" (reference: GB_math.h fmin/fmax
    # semantics): NaN loses against any number.
    def f(x, y):
        if kind == "min":
            return jnp.minimum(x, y) if not np.issubdtype(
                np.dtype(jnp.result_type(x, y)), np.floating) else jnp.fmin(x, y)
        return jnp.maximum(x, y) if not np.issubdtype(
            np.dtype(jnp.result_type(x, y)), np.floating) else jnp.fmax(x, y)
    return f


def _signum(x):
    dt = np.dtype(jnp.result_type(x))
    if dt == np.bool_:
        return x
    return jnp.sign(x)


def _bshift(x, s):
    # reference GB_bitshift_*: shift left if s>0, arithmetic right if s<0;
    # |s| >= nbits gives 0 (or sign-fill for right shift of signed).
    dt = np.dtype(jnp.result_type(x))
    nbits = dt.itemsize * 8
    s = s.astype(np.int32) if hasattr(s, "astype") else np.int32(s)
    ls = jnp.clip(s, 0, nbits)
    rs = jnp.clip(-s, 0, nbits)
    left = jnp.where(ls >= nbits, jnp.zeros_like(x), x << ls.astype(dt))
    if np.issubdtype(dt, np.signedinteger):
        rshift = x >> jnp.minimum(rs, nbits - 1).astype(dt)
    else:
        rshift = jnp.where(rs >= nbits, jnp.zeros_like(x), x >> rs.astype(dt))
    return jnp.where(s >= 0, left, rshift)


# ---------------------------------------------------------------------------
# built-in binary ops (reference: Source/GB_ops.c, Include/GraphBLAS.h)
# ---------------------------------------------------------------------------

FIRST = BinaryOp("GrB_FIRST", lambda x, y: x)
SECOND = BinaryOp("GrB_SECOND", lambda x, y: y)
ONEB = BinaryOp("GrB_ONEB", lambda x, y: jnp.ones_like(x), commutative=True)
PAIR = ONEB  # GxB_PAIR is the historical name for GrB_ONEB
ANY = BinaryOp("GxB_ANY", lambda x, y: y, commutative=True)  # "pick either"
PLUS = BinaryOp("GrB_PLUS", lambda x, y: jnp.add(x, y), commutative=True)
MINUS = BinaryOp("GrB_MINUS", lambda x, y: jnp.subtract(x, y))
RMINUS = BinaryOp("GxB_RMINUS", lambda x, y: jnp.subtract(y, x))
TIMES = BinaryOp("GrB_TIMES", lambda x, y: jnp.multiply(x, y), commutative=True)
DIV = BinaryOp("GrB_DIV", _int_div)
RDIV = BinaryOp("GxB_RDIV", lambda x, y: _int_div(y, x))
MIN = BinaryOp("GrB_MIN", _minmax("min"), commutative=True)
MAX = BinaryOp("GrB_MAX", _minmax("max"), commutative=True)
POW = BinaryOp("GxB_POW", lambda x, y: jnp.power(x, y))

# comparators, bool result (GrB_EQ/NE/GT/LT/GE/LE)
EQ = BinaryOp("GrB_EQ", lambda x, y: x == y, ztype=T.BOOL, commutative=True)
NE = BinaryOp("GrB_NE", lambda x, y: x != y, ztype=T.BOOL, commutative=True)
GT = BinaryOp("GrB_GT", lambda x, y: x > y, ztype=T.BOOL)
LT = BinaryOp("GrB_LT", lambda x, y: x < y, ztype=T.BOOL)
GE = BinaryOp("GrB_GE", lambda x, y: x >= y, ztype=T.BOOL)
LE = BinaryOp("GrB_LE", lambda x, y: x <= y, ztype=T.BOOL)

# "IS" comparators, same-type result (GxB_ISEQ etc.)
def _as_in(fn):
    def f(x, y):
        dt = jnp.result_type(x, y)
        return fn(x, y).astype(dt)
    return f

ISEQ = BinaryOp("GxB_ISEQ", _as_in(lambda x, y: x == y), commutative=True)
ISNE = BinaryOp("GxB_ISNE", _as_in(lambda x, y: x != y), commutative=True)
ISGT = BinaryOp("GxB_ISGT", _as_in(lambda x, y: x > y))
ISLT = BinaryOp("GxB_ISLT", _as_in(lambda x, y: x < y))
ISGE = BinaryOp("GxB_ISGE", _as_in(lambda x, y: x >= y))
ISLE = BinaryOp("GxB_ISLE", _as_in(lambda x, y: x <= y))

# boolean ops applied in the input type's domain (x,y cast to bool, result
# back — reference semantics for LOR over non-bool types)
def _boolop(fn):
    def f(x, y):
        dt = jnp.result_type(x, y)
        return fn(x != 0, y != 0).astype(dt)
    return f

LOR = BinaryOp("GrB_LOR", _boolop(jnp.logical_or), commutative=True)
LAND = BinaryOp("GrB_LAND", _boolop(jnp.logical_and), commutative=True)
LXOR = BinaryOp("GrB_LXOR", _boolop(jnp.logical_xor), commutative=True)
LXNOR = BinaryOp("GrB_LXNOR", _boolop(lambda a, b: a == b), commutative=True)

# bitwise (integers only)
BOR = BinaryOp("GrB_BOR", lambda x, y: x | y, commutative=True)
BAND = BinaryOp("GrB_BAND", lambda x, y: x & y, commutative=True)
BXOR = BinaryOp("GrB_BXOR", lambda x, y: x ^ y, commutative=True)
BXNOR = BinaryOp("GrB_BXNOR", lambda x, y: ~(x ^ y), commutative=True)
BGET = BinaryOp("GxB_BGET", lambda x, y: (x >> y.astype(jnp.result_type(x))) & jnp.ones_like(x))
BSET = BinaryOp("GxB_BSET", lambda x, y: x | (jnp.ones_like(x) << y.astype(jnp.result_type(x))))
BCLR = BinaryOp("GxB_BCLR", lambda x, y: x & ~(jnp.ones_like(x) << y.astype(jnp.result_type(x))))
BSHIFT = BinaryOp("GxB_BSHIFT", _bshift)

# float-math binaries
ATAN2 = BinaryOp("GxB_ATAN2", jnp.arctan2)
HYPOT = BinaryOp("GxB_HYPOT", jnp.hypot, commutative=True)
FMOD = BinaryOp("GxB_FMOD", jnp.fmod)
REMAINDER = BinaryOp("GxB_REMAINDER", lambda x, y: x - y * jnp.rint(x / y))
LDEXP = BinaryOp("GxB_LDEXP", lambda x, y: x * jnp.exp2(y.astype(jnp.result_type(x))))
COPYSIGN = BinaryOp("GxB_COPYSIGN", jnp.copysign)
CMPLX = BinaryOp("GxB_CMPLX", lambda x, y: jax_complex(x, y), ztype=T.FC64)

def jax_complex(x, y):
    import jax.lax as lax
    return lax.complex(x, y)

# positional multiply ops (reference: GxB_FIRSTI_INT64 family) — kernels
# substitute coordinates; fn here receives the already-substituted values.
FIRSTI = BinaryOp("GxB_FIRSTI", lambda x, y: x, positional="firsti")
FIRSTI1 = BinaryOp("GxB_FIRSTI1", lambda x, y: x + 1, positional="firsti1")
FIRSTJ = BinaryOp("GxB_FIRSTJ", lambda x, y: x, positional="firstj")
FIRSTJ1 = BinaryOp("GxB_FIRSTJ1", lambda x, y: x + 1, positional="firstj1")
SECONDI = BinaryOp("GxB_SECONDI", lambda x, y: y, positional="secondi")
SECONDI1 = BinaryOp("GxB_SECONDI1", lambda x, y: y + 1, positional="secondi1")
SECONDJ = BinaryOp("GxB_SECONDJ", lambda x, y: y, positional="secondj")
SECONDJ1 = BinaryOp("GxB_SECONDJ1", lambda x, y: y + 1, positional="secondj1")


# ---------------------------------------------------------------------------
# built-in unary ops
# ---------------------------------------------------------------------------

IDENTITY = UnaryOp("GrB_IDENTITY", lambda x: x)
AINV = UnaryOp("GrB_AINV", lambda x: jnp.negative(x) if np.dtype(jnp.result_type(x)) != np.bool_ else x)
ONE = UnaryOp("GxB_ONE", jnp.ones_like)
ABS = UnaryOp("GrB_ABS", jnp.abs)
MINV = UnaryOp("GrB_MINV", lambda x: _int_div(jnp.ones_like(x), x))
LNOT = UnaryOp("GrB_LNOT", lambda x: (~(x != 0)).astype(jnp.result_type(x)))
BNOT = UnaryOp("GrB_BNOT", lambda x: ~x)

SQRT = UnaryOp("GxB_SQRT", jnp.sqrt)
LOG = UnaryOp("GxB_LOG", jnp.log)
EXP = UnaryOp("GxB_EXP", jnp.exp)
LOG2 = UnaryOp("GxB_LOG2", jnp.log2)
LOG10 = UnaryOp("GxB_LOG10", jnp.log10)
LOG1P = UnaryOp("GxB_LOG1P", jnp.log1p)
EXP2 = UnaryOp("GxB_EXP2", jnp.exp2)
EXPM1 = UnaryOp("GxB_EXPM1", jnp.expm1)
SIN = UnaryOp("GxB_SIN", jnp.sin)
COS = UnaryOp("GxB_COS", jnp.cos)
TAN = UnaryOp("GxB_TAN", jnp.tan)
ASIN = UnaryOp("GxB_ASIN", jnp.arcsin)
ACOS = UnaryOp("GxB_ACOS", jnp.arccos)
ATAN = UnaryOp("GxB_ATAN", jnp.arctan)
SINH = UnaryOp("GxB_SINH", jnp.sinh)
COSH = UnaryOp("GxB_COSH", jnp.cosh)
TANH = UnaryOp("GxB_TANH", jnp.tanh)
ASINH = UnaryOp("GxB_ASINH", jnp.arcsinh)
ACOSH = UnaryOp("GxB_ACOSH", jnp.arccosh)
ATANH = UnaryOp("GxB_ATANH", jnp.arctanh)
SIGNUM = UnaryOp("GxB_SIGNUM", _signum)
CEIL = UnaryOp("GxB_CEIL", jnp.ceil)
FLOOR = UnaryOp("GxB_FLOOR", jnp.floor)
ROUND = UnaryOp("GxB_ROUND", jnp.rint)
TRUNC = UnaryOp("GxB_TRUNC", jnp.trunc)
CBRT = UnaryOp("GxB_CBRT", jnp.cbrt)
LGAMMA = UnaryOp("GxB_LGAMMA", lambda x: _lgamma(x))
TGAMMA = UnaryOp("GxB_TGAMMA", lambda x: _tgamma(x))
ERF = UnaryOp("GxB_ERF", lambda x: _erf(x))
ERFC = UnaryOp("GxB_ERFC", lambda x: _erfc(x))

def _lgamma(x):
    import jax.scipy.special as sp
    return sp.gammaln(x)

def _tgamma(x):
    import jax.scipy.special as sp
    return jnp.exp(sp.gammaln(x)) * jnp.where(
        (x < 0) & (jnp.floor(x / 2) * 2 != jnp.floor(x)), 1.0, 1.0)

def _erf(x):
    import jax.scipy.special as sp
    return sp.erf(x)

def _erfc(x):
    import jax.scipy.special as sp
    return sp.erfc(x)

def _frexpx(x):
    m, _ = jnp.frexp(x)
    return m


def _frexpe(x):
    _, e = jnp.frexp(x)
    return e.astype(jnp.result_type(x))


FREXPX = UnaryOp("GxB_FREXPX", _frexpx)
FREXPE = UnaryOp("GxB_FREXPE", _frexpe)

CONJ = UnaryOp("GxB_CONJ", jnp.conj)
CREAL = UnaryOp("GxB_CREAL", jnp.real, ztype=T.FP64)
CIMAG = UnaryOp("GxB_CIMAG", jnp.imag, ztype=T.FP64)
CARG = UnaryOp("GxB_CARG", jnp.angle, ztype=T.FP64)
ISINF = UnaryOp("GxB_ISINF", jnp.isinf, ztype=T.BOOL)
ISNAN = UnaryOp("GxB_ISNAN", jnp.isnan, ztype=T.BOOL)
ISFINITE = UnaryOp("GxB_ISFINITE", jnp.isfinite, ztype=T.BOOL)

POSITIONI = UnaryOp("GxB_POSITIONI", lambda i: i, ztype=T.INT64, positional="i")
POSITIONI1 = UnaryOp("GxB_POSITIONI1", lambda i: i + 1, ztype=T.INT64, positional="i1")
POSITIONJ = UnaryOp("GxB_POSITIONJ", lambda j: j, ztype=T.INT64, positional="j")
POSITIONJ1 = UnaryOp("GxB_POSITIONJ1", lambda j: j + 1, ztype=T.INT64, positional="j1")


# ---------------------------------------------------------------------------
# built-in index-unary ops (reference: GrB_IndexUnaryOp list,
# Include/GraphBLAS.h; select semantics in Source/GB_select.h)
# ---------------------------------------------------------------------------

ROWINDEX = IndexUnaryOp("GrB_ROWINDEX", lambda x, i, j, k: i + k,
                        ztype=T.INT64, positional=True)
COLINDEX = IndexUnaryOp("GrB_COLINDEX", lambda x, i, j, k: j + k,
                        ztype=T.INT64, positional=True)
DIAGINDEX = IndexUnaryOp("GrB_DIAGINDEX", lambda x, i, j, k: j - i + k,
                         ztype=T.INT64, positional=True)
TRIL = IndexUnaryOp("GrB_TRIL", lambda x, i, j, k: j <= i + k,
                    ztype=T.BOOL, positional=True)
TRIU = IndexUnaryOp("GrB_TRIU", lambda x, i, j, k: j >= i + k,
                    ztype=T.BOOL, positional=True)
DIAG = IndexUnaryOp("GrB_DIAG", lambda x, i, j, k: j == i + k,
                    ztype=T.BOOL, positional=True)
OFFDIAG = IndexUnaryOp("GrB_OFFDIAG", lambda x, i, j, k: j != i + k,
                       ztype=T.BOOL, positional=True)
COLLE = IndexUnaryOp("GrB_COLLE", lambda x, i, j, k: j <= k,
                     ztype=T.BOOL, positional=True)
COLGT = IndexUnaryOp("GrB_COLGT", lambda x, i, j, k: j > k,
                     ztype=T.BOOL, positional=True)
ROWLE = IndexUnaryOp("GrB_ROWLE", lambda x, i, j, k: i <= k,
                     ztype=T.BOOL, positional=True)
ROWGT = IndexUnaryOp("GrB_ROWGT", lambda x, i, j, k: i > k,
                     ztype=T.BOOL, positional=True)
VALUENE = IndexUnaryOp("GrB_VALUENE", lambda x, i, j, k: x != k,
                       ztype=T.BOOL, value_only=True)
VALUEEQ = IndexUnaryOp("GrB_VALUEEQ", lambda x, i, j, k: x == k,
                       ztype=T.BOOL, value_only=True)
VALUEGT = IndexUnaryOp("GrB_VALUEGT", lambda x, i, j, k: x > k,
                       ztype=T.BOOL, value_only=True)
VALUEGE = IndexUnaryOp("GrB_VALUEGE", lambda x, i, j, k: x >= k,
                       ztype=T.BOOL, value_only=True)
VALUELT = IndexUnaryOp("GrB_VALUELT", lambda x, i, j, k: x < k,
                       ztype=T.BOOL, value_only=True)
VALUELE = IndexUnaryOp("GrB_VALUELE", lambda x, i, j, k: x <= k,
                       ztype=T.BOOL, value_only=True)


def unary_op(fn, name="user_unary", ztype=None) -> UnaryOp:
    """User-defined unary op (reference: GrB_UnaryOp_new) — any traceable
    callable works; no C source string or JIT needed."""
    return UnaryOp(name, fn, ztype=T.lookup(ztype) if ztype else None)


def binary_op(fn, name="user_binary", ztype=None, commutative=False) -> BinaryOp:
    """User-defined binary op (reference: GrB_BinaryOp_new)."""
    return BinaryOp(name, fn, ztype=T.lookup(ztype) if ztype else None,
                    commutative=commutative)


def index_unary_op(fn, name="user_idxunop", ztype=None) -> IndexUnaryOp:
    """User-defined index-unary op (reference: GrB_IndexUnaryOp_new)."""
    return IndexUnaryOp(name, fn, ztype=T.lookup(ztype) if ztype else None)
