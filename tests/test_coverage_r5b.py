"""Round-5 second coverage batch: @GrB operator sugar, the legacy
(struct-payload) union-merge engine, and the chunk-padded dense-x-dense
generic-semiring path."""

import numpy as np
import pytest
import scipy.sparse as sp

import graphblas_tpu as gb
from graphblas_tpu.core import semiring as SR
from graphblas_tpu.core import types as T
from graphblas_tpu.core.matrix import ROW, SPARSE


def _m(dense):
    co = sp.coo_matrix(dense)
    return gb.Matrix.from_coo(co.row, co.col, co.data, dense.shape)


def test_operator_sugar_roundtrip():
    A = _m(np.array([[1.0, 0.0], [0.0, 2.0]]))
    B = _m(np.array([[0.0, 3.0], [4.0, 0.0]]))
    assert (A + B).to_scipy().toarray()[0, 1] == 3.0
    assert (5.0 + A).to_scipy().toarray()[0, 0] == 6.0    # __radd__
    assert (A - 1.0).to_scipy().toarray()[1, 1] == 1.0
    assert (5.0 - A).to_scipy().toarray()[0, 0] == 4.0    # __rsub__
    assert (A * 3.0).to_scipy().toarray()[1, 1] == 6.0
    assert (3.0 * A).to_scipy().toarray()[0, 0] == 3.0    # __rmul__
    assert (A / 2.0).to_scipy().toarray()[1, 1] == 1.0
    got = (A @ B).to_scipy().toarray()                    # __matmul__
    want = np.array([[1.0, 0.0], [0.0, 2.0]]) @ np.array(
        [[0.0, 3.0], [4.0, 0.0]])
    np.testing.assert_allclose(got, want)
    assert (-A).to_scipy().toarray()[0, 0] == -1.0
    assert abs(-A).to_scipy().toarray()[0, 0] == 1.0
    assert (A ** 2).to_scipy().toarray()[1, 1] == 4.0
    assert A.T.shape == (2, 2)


def test_struct_payload_legacy_merge():
    """Struct-typed SPARSE eWise rides the legacy argsort merge engine
    (segment._merge_phase1/2 — ride-encoding refuses struct payloads)."""
    G = T.struct_type("Pair5b", np.int64, (2,))
    ADD = gb.binary_op(lambda x, y: x + y, "p5b_add")
    r = np.array([0, 1, 2])
    c = np.array([1, 2, 0])
    v = np.arange(6, dtype=np.int64).reshape(3, 2)
    A = gb.Matrix.from_coo(r, c, v, (3, 3), dtype=G, dup=ADD)
    r2 = np.array([0, 2])
    c2 = np.array([1, 2])
    v2 = np.array([[10, 10], [20, 20]], np.int64)
    B = gb.Matrix.from_coo(r2, c2, v2, (3, 3), dtype=G, dup=ADD)
    A = A.to_format(SPARSE, ROW)
    B = B.to_format(SPARSE, ROW)
    C = gb.ewise_add(A, B, ADD)
    rows, cols, vals = (np.asarray(x) for x in C.coo())
    got = {(int(i), int(j)): list(np.asarray(val))
           for i, j, val in zip(rows, cols, vals)}
    assert got[(0, 1)] == [10, 11]
    assert got[(2, 2)] == [20, 20]
    assert got[(1, 2)] == [2, 3]
    assert got[(2, 0)] == [4, 5]


def test_dense_dense_generic_chunked():
    """Dense x dense under a non-matmul semiring with k not a multiple of
    the scan CHUNK (the kpad branch of the broadcast-reduce path)."""
    rng = np.random.default_rng(1)
    m, k, n = 600, 7001, 3     # CHUNK = min(k, 2^22/m) = 6990 -> kpad
    Ad = rng.standard_normal((m, k)).astype(np.float32)
    Bd = rng.standard_normal((k, n)).astype(np.float32)
    A = gb.Matrix.from_dense(Ad)
    B = gb.Matrix.from_dense(Bd)
    C = gb.mxm(A, B, SR.MIN_PLUS)
    got = np.asarray(C.to_dense_pair()[0])
    want = (Ad[:, :, None] + Bd[None, :, :]).min(axis=1)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)
