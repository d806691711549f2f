"""SpMV and the masked plus-pair reduction on the plain XLA path: the
semiring cases, skewed rows and masks that the deleted routed and one-hot
tiers were tested with, checked against spec/oracle.py or scipy."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
from graphblas_tpu.core import monoid as MON
from graphblas_tpu.core import ops as OPS
from graphblas_tpu.core import semiring as SR
from graphblas_tpu.core import types as T
from graphblas_tpu.core.descriptor import Descriptor
from graphblas_tpu.ops.mxm import spmv_arrays, vxm_chain
from graphblas_tpu.spec import oracle as spec

from harness import assert_matches, random_gb

_MULTS = {"plus": OPS.PLUS, "times": OPS.TIMES, "first": OPS.FIRST,
          "second": OPS.SECOND, "pair": OPS.PAIR}
_ADDS = {"min": MON.MIN, "max": MON.MAX}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mult", sorted(_MULTS))
@pytest.mark.parametrize("add", sorted(_ADDS))
def test_mxv_minmax_semirings(rng, add, mult, dtype):
    """(min|max).(plus|times|first|second|pair) SpMV, empty rows absent."""
    s = SR.semiring(_ADDS[add], _MULTS[mult])
    A, sA = random_gb(rng, 40, 30, 0.12, dtype=dtype)
    x = rng.standard_normal(30).astype(dtype)
    u = gb.Vector.from_dense(x)
    got = gb.mxv(A, u, s)
    want = spec.spec_mxm(spec.SpecMat.empty((40, 1), dtype), None, None, s,
                         sA, spec.SpecMat(x[:, None], np.ones((30, 1), bool)))
    tol = 1e-6 if dtype == np.float32 else 1e-12
    assert_matches(got, want, rtol=tol, atol=tol, msg=f"{add}_{mult}")


def _skewed(kind, rng, n=3000):
    """Power-law shapes: one column holding most entries, zipf columns,
    or one row holding a large share of all entries."""
    bg_r, bg_c = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    if kind == "hub_column":
        r, c = rng.integers(0, n, 6 * n), np.full(6 * n, 17)
    elif kind == "zipf_columns":
        r, c = rng.integers(0, n, 6 * n), (rng.zipf(1.4, 6 * n) - 1) % n
    else:                                  # heavy_row
        r, c = np.full(n // 2, 7), rng.choice(n, n // 2, replace=False)
    rows, cols = np.concatenate([r, bg_r]), np.concatenate([c, bg_c])
    vals = rng.random(rows.size) + 0.5
    S = sps.csr_matrix((vals, (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    return S


@pytest.mark.parametrize("kind", ["hub_column", "zipf_columns",
                                  "heavy_row"])
def test_mxv_skewed_rows(rng, kind):
    S = _skewed(kind, rng)
    n = S.shape[0]
    A = gb.Matrix.from_scipy(S)
    x = rng.random(n)
    present = np.diff(S.indptr) > 0
    y, p = (np.asarray(a) for a in gb.mxv(
        A, gb.Vector.from_dense(x), SR.PLUS_TIMES).to_dense_1d())
    np.testing.assert_array_equal(p, present)
    np.testing.assert_allclose(y[present], (S @ x)[present], rtol=1e-12)
    y, p = (np.asarray(a) for a in gb.mxv(
        A, gb.Vector.from_dense(x), SR.MIN_PLUS).to_dense_1d())
    prod = S.data + x[S.indices]
    want = np.minimum.reduceat(prod, S.indptr[:-1][present])
    np.testing.assert_array_equal(p, present)
    np.testing.assert_array_equal(y[present], want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_arrays_vs_scipy(rng, dtype):
    S = _skewed("zipf_columns", rng).astype(dtype)
    x = rng.random(S.shape[1]).astype(dtype)
    y = np.asarray(spmv_arrays(S.indptr.astype(np.int32),
                               S.indices.astype(np.int32), S.data, x,
                               S.shape[0]))
    want = S.astype(np.float64) @ x.astype(np.float64)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(y - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("structure", [True, False])
@pytest.mark.parametrize("comp", [False, True])
def test_masked_plus_pair_reduce(rng, comp, structure):
    """C<L> = L * L' under plus-pair, then reduce to a scalar (the triangle
    counting idiom), with structural/valued and complemented masks."""
    A, sA = random_gb(rng, 24, 24, 0.2, dtype=np.int64)
    L = gb.select(A, gb.operators.TRIL, -1)
    sL = spec.SpecMat.from_gb(L)
    d = Descriptor(mask_structure=structure, mask_complement=comp,
                   transpose1=True)
    C = gb.mxm(L, L, SR.PLUS_PAIR, mask=L, desc=d, out_dtype=T.INT64)
    want = spec.spec_mxm(spec.SpecMat.empty((24, 24), np.int64), sL, None,
                         SR.PLUS_PAIR, sL, sL, d)
    assert_matches(C, want)
    got = int(gb.reduce_scalar(C, MON.PLUS, out_dtype=T.INT64))
    assert got == int(want.values[want.pattern].sum())


def test_vxm_chain_is_repeated_vxm(rng):
    A, _ = random_gb(rng, 30, 30, 0.15)
    u = gb.Vector.from_dense(rng.random(30))
    got = vxm_chain(u, A, SR.PLUS_TIMES, 3)
    want = u
    for _ in range(3):
        want = gb.vxm(want, A, SR.PLUS_TIMES)
    np.testing.assert_allclose(np.asarray(got.to_dense_1d()[0]),
                               np.asarray(want.to_dense_1d()[0]))
    assert vxm_chain(u, A, SR.PLUS_TIMES, 0) is u
