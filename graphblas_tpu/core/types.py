"""GraphBLAS type system on JAX dtypes.

The reference defines 13 built-in types (reference: Include/GraphBLAS.h:630-643
— bool, int8..64, uint8..64, fp32/fp64, complex fc32/fc64) plus user-defined
C-struct types (GrB_Type_new).  Here a ``Type`` wraps a jnp dtype; typecasting
rules follow the GraphBLAS spec (C-style casts, round-to-nearest for
float->int in the reference's GB_cast_* — we use C truncation semantics from
jnp.astype which matches XLA; the spec permits implementation-defined
rounding, and the reference uses nearbyint: we replicate that explicitly in
``cast`` so integer results match the reference bit-for-bit).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Type:
    """A GraphBLAS scalar type (reference: GrB_Type, Source/GB_opaque.h).

    ``shape`` != () makes this a user-defined struct/array type (the
    reference's GrB_Type_new with sizeof(struct): Demo gauss/wildtype
    types).  Values of such a type are arrays of ``dtype`` with trailing
    dims ``shape`` — a struct of homogeneous fields stored SoA on the device.
    User operators receive/return (..., *shape) arrays."""

    name: str
    dtype: Any  # numpy dtype of the (scalar or field) element
    shape: tuple = ()

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def is_float(self) -> bool:
        return np.issubdtype(self.np_dtype, np.floating)

    @property
    def is_complex(self) -> bool:
        return np.issubdtype(self.np_dtype, np.complexfloating)

    @property
    def is_integer(self) -> bool:
        return np.issubdtype(self.np_dtype, np.integer)

    @property
    def is_bool(self) -> bool:
        return self.np_dtype == np.bool_ and not self.shape

    @property
    def is_struct(self) -> bool:
        return bool(self.shape)

    @property
    def is_signed(self) -> bool:
        return np.issubdtype(self.np_dtype, np.signedinteger)

    def __repr__(self):
        return f"Type({self.name})"


# The 13 built-in types (reference: Include/GraphBLAS.h:630-643).
BOOL = Type("GrB_BOOL", np.bool_)
INT8 = Type("GrB_INT8", np.int8)
INT16 = Type("GrB_INT16", np.int16)
INT32 = Type("GrB_INT32", np.int32)
INT64 = Type("GrB_INT64", np.int64)
UINT8 = Type("GrB_UINT8", np.uint8)
UINT16 = Type("GrB_UINT16", np.uint16)
UINT32 = Type("GrB_UINT32", np.uint32)
UINT64 = Type("GrB_UINT64", np.uint64)
FP32 = Type("GrB_FP32", np.float32)
FP64 = Type("GrB_FP64", np.float64)
FC32 = Type("GxB_FC32", np.complex64)
FC64 = Type("GxB_FC64", np.complex128)

# Extension: bfloat16 — not in the reference; the tensor cores' natural
# input type, exposed so dense mxm paths can use it.
BF16 = Type("GxB_BF16", jnp.bfloat16)

ALL_TYPES = [BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
             FP32, FP64, FC32, FC64]

_BY_DTYPE = {t.np_dtype: t for t in ALL_TYPES + [BF16]}
_BY_NAME = {t.name: t for t in ALL_TYPES + [BF16]}


def lookup(x) -> Type:
    """Resolve a Type from a Type / dtype / dtype-like / name."""
    if isinstance(x, Type):
        return x
    if isinstance(x, str) and x in _BY_NAME:
        return _BY_NAME[x]
    try:
        dt = np.dtype(x)
    except TypeError:
        dt = np.dtype(x.dtype)
    try:
        return _BY_DTYPE[dt]
    except KeyError:
        raise KeyError(f"no GraphBLAS type for dtype {dt!r}") from None


def struct_type(name: str, dtype, shape) -> Type:
    """User-defined struct/array type (reference: GrB_Type_new;
    Demo/Program/gauss_demo.c, wildtype_demo.c).  ``shape`` is the field
    shape, e.g. (2,) for a 2-int gauss struct, (4, 4) for wildtype."""
    return Type(name, np.dtype(dtype), tuple(int(d) for d in shape))


def expand_mask(mask, vals):
    """Right-pad a boolean mask's dims to broadcast over values that carry
    trailing struct-field dims."""
    extra = vals.ndim - mask.ndim
    if extra <= 0:
        return mask
    return mask.reshape(mask.shape + (1,) * extra)


def wh(mask, a, b):
    """jnp.where with the mask broadcast over struct-field dims."""
    a = jnp.asarray(a)
    nd = max(a.ndim, jnp.asarray(b).ndim)
    extra = nd - mask.ndim
    if extra > 0:
        mask = mask.reshape(mask.shape + (1,) * extra)
    return jnp.where(mask, a, b)


def cast(value, to: Type | Any):
    """GraphBLAS typecast (reference: Source/GB_casting.h).

    Matches the reference semantics: float->integer uses round-to-nearest
    (the reference casts via nearbyint, GB_casting.h GB_cast_to_int*), and
    anything->bool is (x != 0).  Struct types cast only to themselves.
    """
    to = lookup(to)
    src = jnp.asarray(value)
    if to.is_struct:
        # Reference: UDTs cast only to themselves (GB_casting.h) — reject
        # sources that don't already carry the struct's field shape.
        k = len(to.shape)
        if src.ndim < k or tuple(src.shape[src.ndim - k:]) != to.shape:
            from .errors import DomainMismatch
            raise DomainMismatch(
                f"cannot cast shape {src.shape} to struct type "
                f"{to.name}{to.shape}")
        return src.astype(to.np_dtype)
    if src.dtype == to.np_dtype:
        return src
    if to.is_bool:
        return src != 0
    if to.is_integer and (np.issubdtype(src.dtype, np.floating)
                          or np.issubdtype(src.dtype, np.complexfloating)):
        real = jnp.real(src) if np.issubdtype(src.dtype, np.complexfloating) else src
        info = np.iinfo(to.np_dtype)
        # nearbyint + clamp to the target range, NaN -> 0: reference
        # GB_casting.h GB_cast_to_int* behavior.
        r = jnp.rint(real)
        r = jnp.where(jnp.isnan(real), 0.0, r)
        r = jnp.clip(r, float(info.min), float(info.max))
        return r.astype(to.np_dtype)
    if not to.is_complex and np.issubdtype(src.dtype, np.complexfloating):
        return jnp.real(src).astype(to.np_dtype)
    return src.astype(to.np_dtype)


def upcast_pair(a: Type, b: Type) -> Type:
    """Type of a op b under numpy promotion — used only for convenience API
    defaults; explicit op signatures take precedence (like the reference's
    typed operator variants)."""
    return lookup(np.promote_types(a.np_dtype, b.np_dtype))
