"""Named-algebra registry tests: the reference's predefined-object counts
(reference: Include/GraphBLAS.h:8252-8345 — 1553 semirings; Source/
GB_ops.c:584-660 — 77 monoids) and spot-check semantics."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.core import names as N
from graphblas_tpu.core import types as T


def test_semiring_count_is_1553():
    names = N.semiring_names()
    assert len(names) == 1553
    assert len(set(names)) == 1553


def test_monoid_count_is_77():
    names = N.monoid_names()
    assert len(names) == 77
    assert len(set(names)) == 77


def test_op_counts():
    assert len(N.binary_op_names()) >= 300
    assert len(set(N.binary_op_names())) == len(N.binary_op_names())
    assert len(N.unary_op_names()) >= 80
    assert len(N.index_unary_op_names()) >= 40
    assert len(N.type_names()) == 13


def test_every_semiring_resolves():
    for name in N.semiring_names():
        sr = N.lookup(name)
        assert sr.name == name
        assert sr.declared_type is not None
    for name in N.grb_semiring_names():
        sr = N.lookup(name)
        assert sr.declared_type is not None


def test_every_monoid_resolves_with_identity():
    for name in N.monoid_names() + N.grb_monoid_names():
        mon = N.lookup(name)
        ident = mon.identity_for(mon.declared_type.np_dtype)
        assert ident is not None


def test_every_op_resolves():
    for name in (N.binary_op_names() + N.unary_op_names()
                 + N.index_unary_op_names()):
        assert N.lookup(name) is not None


def test_attribute_access():
    sr = N.GxB_MIN_PLUS_FP32
    assert sr.declared_type is T.FP32
    assert sr.add.op.name == "GrB_MIN"
    with pytest.raises(AttributeError):
        N.GxB_NO_SUCH_THING


def test_named_semiring_works_in_mxm():
    sr = N.lookup("GxB_MIN_PLUS_FP64")
    A = gb.Matrix.from_dense(np.array([[1.0, 2.0], [3.0, 4.0]]))
    B = gb.Matrix.from_dense(np.array([[10.0, 20.0], [30.0, 40.0]]))
    C = gb.mxm(A, B, sr)
    want = np.minimum.reduce(
        np.array([[1.0, 2.0], [3.0, 4.0]])[:, :, None]
        + np.array([[10.0, 20.0], [30.0, 40.0]])[None, :, :], axis=1)
    got = np.asarray(C.to_dense_pair()[0])
    np.testing.assert_allclose(got, want)


def test_typed_binop_casts_inputs():
    op = N.lookup("GrB_PLUS_INT8")
    out = op(np.int32(200), np.int32(100))  # casts to int8 first: wraps
    assert out.dtype == np.int8


def test_typed_monoid_identity():
    mon = N.lookup("GxB_MIN_INT8_MONOID")
    assert mon.identity_for(np.int8) == np.iinfo(np.int8).max
    assert mon.declared_type is T.INT8


def test_sampled_semirings_differential_mxm():
    """Differential check: a deterministic sample of the 1553 predefined
    semirings through mxm on small dense matrices vs a numpy oracle."""
    import numpy.random as npr
    rng = np.random.default_rng(3)
    names = N.semiring_names()
    sample = [names[i] for i in range(0, len(names), 97)]   # ~16 semirings
    A = rng.integers(1, 5, (4, 3)).astype(np.float64)
    B = rng.integers(1, 5, (3, 5)).astype(np.float64)

    def oracle(sr, A, B, zt):
        # computed IN the declared dtype (integer wraparound matches the
        # kernel's semantics)
        add = sr.add.op.fn
        mult = sr.mult
        out = np.empty((A.shape[0], B.shape[1]), zt)
        for i in range(A.shape[0]):
            for j in range(B.shape[1]):
                acc = None
                for k in range(A.shape[1]):
                    if mult.positional:
                        v = np.asarray({
                            "firsti": i, "firsti1": i + 1, "firstj": k,
                            "firstj1": k + 1, "secondi": k,
                            "secondi1": k + 1, "secondj": j,
                            "secondj1": j + 1}[mult.positional], zt)
                    else:
                        v = np.asarray(mult.fn(A[i, k], B[k, j]), zt)
                    acc = v if acc is None else np.asarray(add(acc, v), zt)
                out[i, j] = acc
        return out

    for name in sample:
        sr = N.lookup(name)
        ty = sr.declared_type
        if ty.is_complex or ty.is_bool:
            continue   # complex/bool oracle casting is covered elsewhere
        if sr.add.op.name == "GxB_ANY":
            continue   # ANY picks an arbitrary member by spec
        zt = (np.int64 if sr.mult.positional
              else sr.mult.out_type(ty, ty).np_dtype)
        Ad = A.astype(ty.np_dtype)
        Bd = B.astype(ty.np_dtype)
        GA = gb.Matrix.from_dense(Ad)
        GB_ = gb.Matrix.from_dense(Bd)
        C = gb.mxm(GA, GB_, sr)
        got = np.asarray(C.to_dense_pair()[0])
        want = oracle(sr, Ad, Bd, zt)
        np.testing.assert_allclose(
            got.astype(np.float64), want.astype(np.float64), rtol=1e-6,
            err_msg=name)
