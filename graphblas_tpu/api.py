"""Public operation API (the GrB_* call surface, reference:
Include/GraphBLAS.h).  Functional signatures: every op returns the result
matrix; passing ``C=`` makes the op behave like the C API (C is updated in
place through accum/mask and returned)."""

from __future__ import annotations

from .core.descriptor import NULL, Descriptor
from .core.matrix import Matrix, Scalar, Vector
from .ops import apply as _apply_mod
from .ops import ewise as _ewise
from .ops import reduce as _reduce
from .ops import select as _select_mod
from .ops import transpose as _transpose_mod


def _finish(C, out):
    from .core.convert import conform
    if isinstance(out, Matrix):
        # sparsity control is a property of the C target (reference:
        # per-matrix GxB_SPARSITY_CONTROL governs GB_conform on C)
        out = conform(out, like=C)
    if C is not None:
        C._replace_from(out)
        return C
    return out


def ewise_add(A, B, op, *, C=None, mask=None, accum=None, desc=NULL,
              out_dtype=None):
    return _finish(C, _ewise.ewise_add(A, B, op, C=C, mask=mask, accum=accum,
                                       desc=desc, out_dtype=out_dtype))


def ewise_mult(A, B, op, *, C=None, mask=None, accum=None, desc=NULL,
               out_dtype=None):
    return _finish(C, _ewise.ewise_mult(A, B, op, C=C, mask=mask,
                                        accum=accum, desc=desc,
                                        out_dtype=out_dtype))


def ewise_union(A, alpha, B, beta, op, *, C=None, mask=None, accum=None,
                desc=NULL, out_dtype=None):
    return _finish(C, _ewise.ewise_union(A, alpha, B, beta, op, C=C,
                                         mask=mask, accum=accum, desc=desc,
                                         out_dtype=out_dtype))


def apply(A, op, *, bind=None, thunk=None, C=None, mask=None, accum=None,
          desc=NULL, out_dtype=None):
    return _finish(C, _apply_mod.apply(A, op, bind=bind, thunk=thunk, C=C,
                                       mask=mask, accum=accum, desc=desc,
                                       out_dtype=out_dtype))


def select(A, op, thunk=0, *, C=None, mask=None, accum=None, desc=NULL,
           out_dtype=None):
    return _finish(C, _select_mod.select(A, op, thunk, C=C, mask=mask,
                                         accum=accum, desc=desc,
                                         out_dtype=out_dtype))


def reduce(A, mon, *, C=None, mask=None, accum=None, desc=NULL,
           out_dtype=None):
    """Matrix -> Vector rowwise reduce (GrB_Matrix_reduce_Monoid)."""
    return _finish(C, _reduce.reduce_to_vector(A, mon, C=C, mask=mask,
                                               accum=accum, desc=desc,
                                               out_dtype=out_dtype))


def reduce_scalar(A, mon, *, accum=None, init=None, out_dtype=None):
    """Matrix/Vector -> scalar reduce (GrB_Matrix_reduce_TYPE)."""
    return _reduce.reduce_to_scalar(A, mon, accum=accum, init=init,
                                    out_dtype=out_dtype)


def transpose(A, *, C=None, mask=None, accum=None, desc=NULL, out_dtype=None):
    return _finish(C, _transpose_mod.transpose(A, C=C, mask=mask,
                                               accum=accum, desc=desc,
                                               out_dtype=out_dtype))


def mxm(A, B, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    from .ops import mxm as _mxm
    return _finish(C, _mxm.mxm(A, B, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def mxv(A, u, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    from .ops import mxm as _mxm
    return _finish(C, _mxm.mxv(A, u, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def vxm(u, A, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    from .ops import mxm as _mxm
    return _finish(C, _mxm.vxm(u, A, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def vxm_chain(u, A, semiring, steps):
    """K-step vxm pipeline: y0 = u; yk = y(k-1) (+).(x) A."""
    from .ops import mxm as _mxm
    return _mxm.vxm_chain(u, A, semiring, steps)


def extract(A, I=None, J=None, *, C=None, mask=None, accum=None, desc=NULL,
            out_dtype=None):
    from .ops import extract as _ex
    return _finish(C, _ex.extract(A, I, J, C=C, mask=mask, accum=accum,
                                  desc=desc, out_dtype=out_dtype))


def assign(C, A, I=None, J=None, *, mask=None, accum=None, desc=NULL):
    from .ops import assign as _as
    return _finish(C, _as.assign(C, A, I, J, mask=mask, accum=accum,
                                 desc=desc, subassign=False))


def subassign(C, A, I=None, J=None, *, mask=None, accum=None, desc=NULL):
    from .ops import assign as _as
    return _finish(C, _as.assign(C, A, I, J, mask=mask, accum=accum,
                                 desc=desc, subassign=True))


def kronecker(A, B, op, *, C=None, mask=None, accum=None, desc=NULL,
              out_dtype=None):
    from .ops import kron as _kron
    return _finish(C, _kron.kron(A, B, op, C=C, mask=mask, accum=accum,
                                 desc=desc, out_dtype=out_dtype))


def concat(tiles, *, C=None):
    from .ops import concat as _cc
    return _finish(C, _cc.concat(tiles))


def split(A, row_sizes, col_sizes):
    from .ops import concat as _cc
    return _cc.split(A, row_sizes, col_sizes)


def diag(v, k=0):
    from .ops import diag as _dg
    return _dg.diag(v, k)


def sort(A, op=None, *, ascending=True, desc=NULL):
    from .ops import sort as _sort
    return _sort.sort(A, op, ascending=ascending, desc=desc)


def vector_diag(A, k=0):
    """v = k-th diagonal of A (GxB_Vector_diag)."""
    from .ops import diag as _dg
    return _dg.vector_diag(A, k)
