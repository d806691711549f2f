"""The GraphBLAS matrix object.

Reference: Source/Shared/GB_matrix.h — one struct for Matrix/Vector/Scalar,
8 storage formats = {hypersparse, sparse, bitmap, full} x {by-row (CSR),
by-col (CSC)}, iso-valued matrices (GB_matrix.h:495-513), pending tuples and
zombies for non-blocking mode (GB_matrix.h:313-390).

Redesign decisions (NOT a port):
  * A Matrix is a JAX pytree: leaves are device arrays (indptr/h/indices/
    values/bitmap), aux data is static metadata (shape/format/orientation/
    iso/dtype).  Any op can therefore flow through jit/vmap/shard_map.
  * Arrays are exact-sized (nnz is static Python metadata), matching XLA's
    static-shape model.  Ops that produce sparse output of a priori unknown
    size run a device-side symbolic count, sync the count to host, then run
    the numeric phase — the same phase structure as the reference's
    phase1/phase2 kernels (e.g. Source/GB_add.h:34-94), with the host sync
    replacing cumsum-to-malloc.
  * Zombies are unnecessary: deletion happens by compaction in ``wait``.
    Pending tuples are host-side COO buffers appended by setElement/assign
    in non-blocking mode, finalized by ``wait`` (reference: GB_wait.c).
  * bitmap/full store values in logical (nrows, ncols) layout; orientation
    only matters for the sparse/hyper formats (row-major XLA layout already
    serves both).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import config as CFG
from . import errors as E
from . import types as T

HYPER = "hyper"
SPARSE = "sparse"
BITMAP = "bitmap"
FULL = "full"
FORMATS = (HYPER, SPARSE, BITMAP, FULL)

ROW = "row"   # CSR-like: vectors are rows (reference default, is_csc=false)
COL = "col"   # CSC-like: vectors are columns

INDEX = np.int32  # index dtype; per-shard nnz < 2^31 (distributed shards
#                   keep this true even for pod-scale graphs)


def _ident_op():
    from . import ops as _OPS
    return _OPS.IDENTITY


def _np(x):
    return np.asarray(x)


def _default_semiring():
    from . import semiring as SR
    return SR.PLUS_TIMES


@jax.tree_util.register_pytree_node_class
class Matrix:
    """GrB_Matrix.  See module docstring for the storage model."""

    __slots__ = ("shape", "fmt", "orient", "iso", "dtype",
                 "indptr", "h", "indices", "values", "bitmap",
                 "_pending", "_nvals_cache", "name",
                 "sparsity_control", "hyper_switch", "bitmap_switch",
                 "_mask_applied")

    def __init__(self, shape, dtype, fmt=SPARSE, orient=None, iso=False,
                 indptr=None, h=None, indices=None, values=None, bitmap=None,
                 name=""):
        orient = orient or CFG.GLOBAL.format_default
        if fmt not in FORMATS:
            raise E.InvalidValue(f"bad format {fmt!r}")
        if orient not in (ROW, COL):
            raise E.InvalidValue(f"bad orientation {orient!r}")
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = T.lookup(dtype)
        self.fmt = fmt
        self.orient = orient
        self.iso = bool(iso)
        self.indptr = indptr
        self.h = h
        self.indices = indices
        self.values = values
        self.bitmap = bitmap
        self._pending = []     # list of (rows, cols, vals, dup_op) host COO
        self._nvals_cache = None
        self.name = name
        if fmt in (SPARSE, HYPER) and indptr is None:
            # empty matrix
            nvec = 0 if fmt == HYPER else self._nvec_dim()
            self.indptr = jnp.zeros(nvec + 1, INDEX)
            self.indices = jnp.zeros(0, INDEX)
            self.values = jnp.zeros(0, self.dtype.np_dtype)
            if fmt == HYPER:
                self.h = jnp.zeros(0, INDEX)

    # -- basic geometry ----------------------------------------------------

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    def _nvec_dim(self) -> int:
        """Number of vectors for the sparse format (rows if ROW-oriented)."""
        return self.shape[0] if self.orient == ROW else self.shape[1]

    def _veclen(self) -> int:
        return self.shape[1] if self.orient == ROW else self.shape[0]

    @property
    def nvals(self) -> int:
        """Number of stored entries (GrB_Matrix_nvals).  Host-synced for
        bitmap format; static metadata otherwise."""
        if self._pending:
            self.wait()
        if self.fmt in (SPARSE, HYPER):
            return int(self.indices.shape[0])
        if self.fmt == FULL:
            return self.nrows * self.ncols
        if self._nvals_cache is None:
            self._nvals_cache = int(jnp.sum(self.bitmap))
        return self._nvals_cache

    # -- pytree protocol ---------------------------------------------------

    def tree_flatten(self):
        if self._pending:
            self.wait()
        leaves = (self.indptr, self.h, self.indices, self.values, self.bitmap)
        aux = (self.shape, self.dtype, self.fmt, self.orient, self.iso,
               type(self))
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        shape, dtype, fmt, orient, iso, klass = aux
        obj = object.__new__(klass)
        obj.shape, obj.dtype, obj.fmt, obj.orient, obj.iso = (
            shape, dtype, fmt, orient, iso)
        obj.indptr, obj.h, obj.indices, obj.values, obj.bitmap = leaves
        obj._pending = []
        obj._nvals_cache = None
        obj.name = ""
        return obj

    # -- construction ------------------------------------------------------

    @classmethod
    def new(cls, dtype, nrows, ncols, fmt=SPARSE, orient=None):
        """GrB_Matrix_new: empty matrix."""
        if fmt in (BITMAP, FULL):
            ty = T.lookup(dtype)
            vals = jnp.zeros((nrows, ncols) + ty.shape, ty.np_dtype)
            bm = jnp.zeros((nrows, ncols), bool) if fmt == BITMAP else None
            return cls((nrows, ncols), dtype, fmt, orient, values=vals,
                       bitmap=bm)
        return cls((nrows, ncols), dtype, fmt, orient)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=None, dup="plus",
                 orient=None, iso=False):
        """GrB_Matrix_build (reference: Source/GB_build.c / GB_builder.c).

        The builder pipeline (copy -> sort -> find dups -> make indptr ->
        assemble with dup operator) runs as vectorized device code here; see
        ops/build.py for the implementation."""
        from ..ops import build as _build
        return _build.build_matrix(cls, rows, cols, vals, shape, dtype, dup,
                                   orient, iso)

    @classmethod
    def from_dense(cls, arr, orient=None):
        """Full matrix from a dense array (all entries present)."""
        arr = jnp.asarray(arr)
        assert arr.ndim == 2
        return cls(arr.shape, T.lookup(arr.dtype), FULL, orient, values=arr)

    @classmethod
    def from_dense_masked(cls, arr, present, orient=None):
        """Bitmap matrix from (values, present) pair."""
        arr = jnp.asarray(arr)
        present = jnp.asarray(present, bool)
        return cls(arr.shape, T.lookup(arr.dtype), BITMAP, orient,
                   values=arr, bitmap=present)

    @classmethod
    def from_mtx(cls, path, dtype=None, orient=None):
        """Load a Matrix Market file via the native C++ parser
        (graphblas_tpu/utils/native.py; scipy fallback)."""
        from ..utils import native as NV
        rows, cols, vals, shape = NV.read_mtx(str(path))
        return cls.from_coo(rows, cols, vals, shape, dtype=dtype,
                            dup="plus", orient=orient)

    @classmethod
    def from_scipy(cls, sp, orient=None, dtype=None):
        """Construct from a scipy.sparse matrix (zero-copy of the CSR/CSC
        arrays where formats line up)."""
        import scipy.sparse as sps
        orient = orient or CFG.GLOBAL.format_default
        want = sps.csr_matrix if orient == ROW else sps.csc_matrix
        m = want(sp)
        m.sort_indices()
        dt = T.lookup(dtype) if dtype is not None else T.lookup(m.dtype)
        vals = m.data.astype(dt.np_dtype) if dtype is not None else m.data
        return cls(sp.shape, dt, SPARSE, orient,
                   indptr=jnp.asarray(m.indptr, INDEX),
                   indices=jnp.asarray(m.indices, INDEX),
                   values=jnp.asarray(vals))

    def to_scipy(self):
        import scipy.sparse as sps
        a = self.to_format(SPARSE)
        indptr, indices = _np(a.indptr), _np(a.indices)
        vals = _np(a._vals_expanded())
        klass = sps.csr_matrix if a.orient == ROW else sps.csc_matrix
        return klass((vals, indices, indptr), shape=self.shape)

    def dup(self) -> "Matrix":
        """GrB_Matrix_dup.  Arrays are immutable so sharing is safe; this is
        the reference's shallow-copy optimization made universal."""
        if self._pending:
            self.wait()
        obj = object.__new__(type(self))
        for s in Matrix.__slots__:
            setattr(obj, s, getattr(self, s, None))
        obj._pending = []
        return obj

    def clear(self) -> None:
        """GrB_Matrix_clear: remove all entries, keep shape/type."""
        fresh = Matrix.new(self.dtype, self.nrows, self.ncols,
                           SPARSE if self.fmt == HYPER else self.fmt,
                           self.orient)
        self._replace_from(fresh)

    def _replace_from(self, other: "Matrix") -> None:
        """In-place adoption of another matrix's contents (the transplant
        step, reference: GB_transplant_conform)."""
        if other._pending:
            other.wait()
        for s in ("shape", "fmt", "orient", "iso", "dtype", "indptr", "h",
                  "indices", "values", "bitmap", "_nvals_cache"):
            setattr(self, s, getattr(other, s))
        self._pending = []

    # -- values access -----------------------------------------------------

    def _vals_expanded(self):
        """values with iso-compression undone (sparse formats: length nnz
        [+ struct field dims]; bitmap/full: (nrows, ncols[, *fields]))."""
        ts = self.dtype.shape
        if not self.iso:
            return self.values
        if self.fmt in (SPARSE, HYPER):
            n = self.indices.shape[0]
            return jnp.broadcast_to(self.values.reshape(ts), (n,) + ts)
        return jnp.broadcast_to(self.values.reshape(ts), self.shape + ts)

    def iso_value(self):
        if not self.iso:
            raise E.InvalidValue("matrix is not iso")
        return self.values.reshape(())

    # -- dense pair (the universal internal representation) ----------------

    def to_dense_pair(self, fill=None):
        """(values[nrows,ncols], present[nrows,ncols]) — the bitmap view.
        Used by dense kernels; absent entries hold ``fill`` (default 0)."""
        if self._pending:
            self.wait()
        dt = self.dtype.np_dtype
        ts = self.dtype.shape
        fill = dt.type(0) if fill is None else dt.type(fill)
        if self.fmt == FULL:
            return self._vals_expanded(), jnp.ones(self.shape, bool)
        if self.fmt == BITMAP:
            v = self._vals_expanded()
            return T.wh(self.bitmap, v, fill), self.bitmap
        a = self.to_format(SPARSE) if self.fmt == HYPER else self
        rows, cols = a._coords()
        vals = a._vals_expanded()
        dense = jnp.full(self.shape + ts, fill, dt).at[rows, cols].set(vals)
        present = jnp.zeros(self.shape, bool).at[rows, cols].set(True)
        return dense, present

    def _coords(self):
        """(row_ids, col_ids) of stored entries, sparse/hyper format only,
        in storage order."""
        from ..kernels import segment as K
        nnz = int(self.indices.shape[0])
        if self.fmt == HYPER:
            vec_pos = K.expand_rowids(self.indptr, nnz, self.h.shape[0])
            vec_ids = self.h[vec_pos] if self.h.shape[0] else vec_pos
        else:
            vec_ids = K.expand_rowids(self.indptr, nnz, self._nvec_dim())
        if self.orient == ROW:
            return vec_ids, self.indices
        return self.indices, vec_ids

    def coo(self):
        """(rows, cols, values) device arrays — GrB_Matrix_extractTuples."""
        if self._pending:
            self.wait()
        a = self.to_format(SPARSE) if self.fmt in (BITMAP, FULL, HYPER) else self
        r, c = a._coords()
        return r, c, a._vals_expanded()

    # -- format conversion (reference: Source/GB_convert_*.c, 20 files) ----

    def to_format(self, fmt, orient=None) -> "Matrix":
        if self._pending:
            self.wait()
        orient = orient or self.orient
        if fmt == self.fmt and orient == self.orient:
            return self
        from . import convert
        return convert.convert(self, fmt, orient)

    def to_orient(self, orient) -> "Matrix":
        return self.to_format(self.fmt, orient)

    # -- pending-tuple machinery (non-blocking mode) -----------------------

    def _add_pending(self, rows, cols, vals, dup):
        self._pending.append((np.atleast_1d(_np(rows)),
                              np.atleast_1d(_np(cols)),
                              vals, dup))
        self._nvals_cache = None
        if CFG.GLOBAL.blocking:
            self.wait()

    def wait(self) -> "Matrix":
        """GrB_Matrix_wait: finalize pending updates (reference:
        Source/GB_wait.c — builder on the tuple list, then merge)."""
        if not self._pending:
            return self
        pend, self._pending = self._pending, []
        from ..ops import build as _build
        _build.apply_pending(self, pend)
        return self

    # -- element access (reference: Source/GB_setElement.c, GB_Element.h) --

    def _check_index(self, i, j):
        # bounds-checked up front like the reference (GrB_INVALID_INDEX
        # from GrB_*_setElement), not deferred to wait()
        if not (0 <= int(i) < self.nrows and 0 <= int(j) < self.ncols):
            raise E.IndexOutOfBounds(
                f"({i},{j}) outside {self.nrows}x{self.ncols}")

    def set_element(self, i, j, value):
        self._check_index(i, j)
        self._add_pending(i, j, value, "second")

    def remove_element(self, i, j):
        self._check_index(i, j)
        self._add_pending(i, j, None, "delete")

    def extract_element(self, i, j):
        """GrB_Matrix_extractElement: raises NoValue if absent."""
        if self._pending:
            self.wait()
        from ..ops import element
        return element.extract_element(self, i, j)

    def is_stored_element(self, i, j) -> bool:
        if self._pending:
            self.wait()
        from ..ops import element
        return element.is_stored(self, i, j)

    @staticmethod
    def _is_point(x) -> bool:
        return isinstance(x, (int, np.integer))

    def __getitem__(self, ij):
        """A[i, j] -> element; A[I, J] with slices/lists -> extract;
        A[M] with a Matrix/bool mask -> masked extract C<M>=A (the
        @GrB-style indexing sugar; reference: GraphBLAS/@GrB, logical
        indexing via gblogassign.c/gblogextract.c)."""
        from .. import api
        if isinstance(ij, Matrix):
            from .descriptor import Descriptor
            return api.apply(self, _ident_op(), mask=ij,
                            desc=Descriptor(mask_structure=True))
        i, j = ij
        if self._is_point(i) and self._is_point(j):
            return self.extract_element(i, j)
        from .. import api
        I = [i] if self._is_point(i) else i
        J = [j] if self._is_point(j) else j
        return api.extract(self, I, J)

    def __setitem__(self, ij, value):
        if isinstance(ij, Matrix):
            # logical mask assign C(M) = x (the reference's headline
            # @GrB case, gblogassign.c — "C(M)=A in 0.8 s vs MATLAB
            # 4-5 days"): scalar -> masked scalar assign (method-05d
            # class); Matrix -> masked assign over ALL
            from .. import api
            from .descriptor import Descriptor
            d = Descriptor(mask_structure=True)
            api.assign(self, value, mask=ij, desc=d)
            return
        i, j = ij
        if self._is_point(i) and self._is_point(j) and np.isscalar(value):
            self.set_element(i, j, value)
            return
        from .. import api
        I = [i] if self._is_point(i) else i
        J = [j] if self._is_point(j) else j
        api.subassign(self, value, I, J)

    # -- @GrB-style operator sugar (reference: GraphBLAS/@GrB m-files) -----

    def _ewise_or_bind(self, other, op, reverse=False):
        from .. import api
        if isinstance(other, Matrix):
            a, b = (other, self) if reverse else (self, other)
            return api.ewise_add(a, b, op)
        bind = ("first", other) if reverse else ("second", other)
        return api.apply(self, op, bind=bind)

    def __add__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.PLUS)

    def __radd__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.PLUS, reverse=True)

    def __sub__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.MINUS)

    def __rsub__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.MINUS, reverse=True)

    def __mul__(self, other):
        from .. import api
        from . import ops as OPS
        if isinstance(other, Matrix):
            return api.ewise_mult(self, other, OPS.TIMES)
        return api.apply(self, OPS.TIMES, bind=("second", other))

    def __rmul__(self, other):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.TIMES, bind=("first", other))

    def __truediv__(self, other):
        from .. import api
        from . import ops as OPS
        if isinstance(other, Matrix):
            return api.ewise_mult(self, other, OPS.DIV)
        return api.apply(self, OPS.DIV, bind=("second", other))

    def __matmul__(self, other):
        from .. import api
        if isinstance(other, Vector):
            return api.mxv(self, other, _default_semiring())
        return api.mxm(self, other, _default_semiring())

    def __neg__(self):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.AINV)

    def __abs__(self):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.ABS)

    def __pow__(self, s):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.POW, bind=("second", s))

    @property
    def T(self):
        from ..ops.transpose import logical_transpose
        return logical_transpose(self)

    def astype(self, dtype):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.IDENTITY, out_dtype=dtype)

    def isequal(self, other, rtol=0.0, atol=0.0) -> bool:
        """Same shape, same pattern, same values (within tolerance)."""
        if self.shape != other.shape:
            return False
        av, ap = self.to_dense_pair()
        bv, bp = other.to_dense_pair()
        if bool(jnp.any(ap != bp)):
            return False
        if rtol == 0.0 and atol == 0.0:
            return not bool(jnp.any(jnp.where(ap, av != bv, False)))
        diff = jnp.abs(av - bv) <= atol + rtol * jnp.abs(bv)
        return bool(jnp.all(jnp.where(ap, diff, True)))

    def reduce(self, mon, **kw):
        from .. import api
        return api.reduce(self, mon, **kw)

    def reduce_scalar(self, mon, **kw):
        from .. import api
        return api.reduce_scalar(self, mon, **kw)

    def resize(self, nrows, ncols) -> None:
        from ..ops.resize import resize as _rs
        self._replace_from(_rs(self, nrows, ncols))

    def reshape(self, nrows, ncols, by_col=True):
        from ..ops.resize import reshape as _rh
        return _rh(self, nrows, ncols, by_col)

    # -- per-object get/set (reference: GrB_get/GrB_set over matrices,
    #    Source/GB_get_set.h, GxB_Matrix_Option_*) -------------------------

    def get(self, name: str):
        opts = {"format": self.fmt, "orientation": self.orient,
                "nrows": self.nrows, "ncols": self.ncols,
                "dtype": self.dtype.name, "iso": self.iso,
                "name": self.name,
                "sparsity_control": getattr(self, "sparsity_control", None)
                or "auto",
                "hyper_switch": getattr(self, "hyper_switch", None),
                "bitmap_switch": getattr(self, "bitmap_switch", None)}
        if name not in opts:
            raise E.InvalidValue(f"unknown option {name!r}")
        return opts[name]

    def set(self, name: str, value) -> None:
        if name == "format":
            self._replace_from(self.to_format(value))
        elif name == "orientation":
            self._replace_from(self.to_orient(value))
        elif name == "name":
            self.name = str(value)
        elif name == "sparsity_control":
            # "auto" or a "+"-joined subset of hyper/sparse/bitmap/full
            # (reference: GxB_SPARSITY_CONTROL bitmask)
            valid = {HYPER, SPARSE, BITMAP, FULL}
            if value != "auto" and \
                    not {c.strip() for c in str(value).split("+")} <= valid:
                raise E.InvalidValue(f"bad sparsity_control {value!r}")
            self.sparsity_control = value
        elif name in ("hyper_switch", "bitmap_switch"):
            setattr(self, name, float(value))
        else:
            raise E.InvalidValue(f"unknown/read-only option {name!r}")

    # -- diagnostics (reference: GxB_Matrix_fprint / GB_matvec_check.c) ----

    def check(self) -> None:
        """Validity check: indptr monotone & terminal, indices in range and
        sorted within vectors, bitmap/values shapes consistent."""
        if self.fmt in (SPARSE, HYPER):
            p = _np(self.indptr)
            if p[0] != 0 or p[-1] != self.indices.shape[0]:
                raise E.InvalidObject("indptr endpoints")
            if (np.diff(p) < 0).any():
                raise E.InvalidObject("indptr not monotone")
            idx = _np(self.indices)
            if idx.size and (idx.min() < 0 or idx.max() >= self._veclen()):
                raise E.InvalidObject("indices out of range")
            for k in range(len(p) - 1):
                s = idx[p[k]:p[k + 1]]
                if (np.diff(s) <= 0).any():
                    raise E.InvalidObject(f"vector {k} not strictly sorted")
            if self.fmt == HYPER:
                hh = _np(self.h)
                if hh.size and ((np.diff(hh) <= 0).any() or hh.min() < 0
                                or hh.max() >= self._nvec_dim()):
                    raise E.InvalidObject("hyperlist invalid")
        if self.fmt == BITMAP and self.bitmap.shape != self.shape:
            raise E.InvalidObject("bitmap shape")
        if self.fmt in (BITMAP, FULL) and not self.iso:
            if self.values.shape != self.shape + self.dtype.shape:
                raise E.InvalidObject("values shape")

    def fprint(self, level: int = 2, name: str = "", file=None) -> None:
        """GxB_Matrix_fprint analog: pretty-print with validity check
        (reference: Source/GB_matvec_check.c).  level: 0 silent check,
        1 header, 2 + a few entries, 3 all entries."""
        import sys
        out = file or sys.stdout
        self.check()
        if level == 0:
            return
        nm = name or self.name or type(self).__name__
        print(f"{nm}: {self!r}", file=out)
        if level >= 2:
            limit = None if level >= 3 else 8
            r, c, v = self.coo()
            r, c, v = _np(r), _np(c), _np(v)
            shown = len(r) if limit is None else min(limit, len(r))
            for k in range(shown):
                print(f"  ({r[k]},{c[k]})  {v[k]}", file=out)
            if shown < len(r):
                print(f"  ... ({len(r) - shown} more)", file=out)

    def memory_usage(self) -> int:
        """GxB_Matrix_memoryUsage."""
        tot = 0
        for a in (self.indptr, self.h, self.indices, self.values, self.bitmap):
            if a is not None:
                tot += a.size * a.dtype.itemsize
        return tot

    def __repr__(self):
        nv = "?" if self.fmt == BITMAP and self._nvals_cache is None \
            else self.nvals
        return (f"{type(self).__name__}({self.shape[0]}x{self.shape[1]} "
                f"{self.dtype.name} {self.fmt}/{self.orient}"
                f"{' iso' if self.iso else ''} nvals={nv})")


@jax.tree_util.register_pytree_node_class
class Vector(Matrix):
    """GrB_Vector == n-by-1 matrix stored by column (reference treats
    vectors exactly this way; Source/GB_vector.h)."""

    def __init__(self, n_or_shape, dtype, fmt=SPARSE, **kw):
        if isinstance(n_or_shape, tuple):
            shape = n_or_shape
            assert shape[1] == 1
        else:
            shape = (int(n_or_shape), 1)
        kw.pop("orient", None)
        super().__init__(shape, dtype, fmt, COL, **kw)

    @property
    def size(self):
        return self.shape[0]

    @classmethod
    def new(cls, dtype, n, fmt=SPARSE, orient=None):
        if fmt in (BITMAP, FULL):
            dt = T.lookup(dtype).np_dtype
            vals = jnp.zeros((n, 1), dt)
            bm = jnp.zeros((n, 1), bool) if fmt == BITMAP else None
            return cls(n, dtype, fmt, values=vals, bitmap=bm)
        return cls(n, dtype, fmt)

    @classmethod
    def from_coo(cls, idx, vals, n, dtype=None, dup="plus", iso=False):
        from ..ops import build as _build
        idx = np.atleast_1d(_np(idx))
        return _build.build_matrix(cls, idx, np.zeros_like(idx), vals,
                                   (n, 1), dtype, dup, COL, iso)

    @classmethod
    def from_dense(cls, arr, orient=None):
        arr = jnp.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        return cls(arr.shape, T.lookup(arr.dtype), FULL, values=arr)

    @classmethod
    def from_dense_masked(cls, arr, present, orient=None):
        arr = jnp.asarray(arr)
        present = jnp.asarray(present, bool)
        if arr.ndim == 1:
            arr, present = arr[:, None], present[:, None]
        return cls(arr.shape, T.lookup(arr.dtype), BITMAP,
                   values=arr, bitmap=present)

    def to_dense_1d(self, fill=None):
        v, p = self.to_dense_pair(fill)
        return v[:, 0], p[:, 0]

    def set_element(self, i, value, _v=None):
        if _v is not None:            # matrix-style (i, j, value)
            super().set_element(i, value, _v)
        else:
            super().set_element(i, 0, value)

    def extract_element(self, i, j=None):
        return super().extract_element(i, 0 if j is None else j)

    def __getitem__(self, i):
        if isinstance(i, tuple):
            return super().extract_element(*i)
        return self.extract_element(i)

    def __setitem__(self, i, value):
        if isinstance(i, tuple):
            super().set_element(i[0], i[1], value)
        else:
            self.set_element(i, value)


@jax.tree_util.register_pytree_node_class
class Scalar(Matrix):
    """GrB_Scalar == 1-by-1 matrix (reference: Source/GB_Scalar* )."""

    def __init__(self, dtype, fmt=SPARSE, **kw):
        kw.pop("orient", None)
        super().__init__((1, 1), dtype, fmt, COL, **kw)

    @classmethod
    def from_value(cls, value, dtype=None):
        dt = T.lookup(dtype) if dtype is not None else T.lookup(
            jnp.asarray(value).dtype)
        s = cls(dt)
        s.set_element(0, 0, value)
        s.wait()
        return s

    @property
    def is_empty(self) -> bool:
        return self.nvals == 0

    def value(self):
        return self.extract_element(0, 0)
