"""The ESC SpGEMM (the one sparse x sparse path) against scipy: unmasked,
masked and complemented, integer min-plus and plus-pair counts, each in a
single block and tiled over several row blocks."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
from graphblas_tpu.core import semiring as SR
from graphblas_tpu.core import types as T
from graphblas_tpu.core.descriptor import Descriptor
from graphblas_tpu.ops import mxm as MXM


def _rand(n, nnz, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    S = sps.csr_matrix(
        (rng.integers(1, 5, nnz).astype(dtype),
         (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
        shape=(n, n))
    S.sum_duplicates()
    return S


@pytest.fixture(params=["one_block", "row_blocks"])
def blocks(request, monkeypatch):
    if request.param == "row_blocks":
        monkeypatch.setattr(MXM, "SPGEMM_FLOP_BLOCK", 2048)
    return request.param


def test_tier_unmasked_plus_times(blocks):
    S = _rand(150, 1200, 0)
    A = gb.Matrix.from_scipy(S)
    C = gb.mxm(A, A, SR.PLUS_TIMES)
    want = S @ S
    got = C.to_scipy()
    assert got.nnz == want.nnz
    assert abs(got - want).max() < 1e-4


@pytest.mark.parametrize("comp", [False, True])
def test_tier_masked(blocks, comp):
    S = _rand(120, 900, 1)
    A = gb.Matrix.from_scipy(S)
    M = gb.select(A, gb.operators.TRIL, -1)
    d = Descriptor(mask_structure=True, mask_complement=comp)
    C = gb.mxm(A, A, SR.PLUS_TIMES, mask=M, desc=d)
    ref = (S @ S).toarray()
    Mm = sps.tril(S, -1).toarray() != 0
    want = np.where(~Mm if comp else Mm, ref, 0)
    got = C.to_scipy().toarray()
    assert np.allclose(got, want, rtol=1e-4)


def test_tier_min_plus_int(blocks):
    S = _rand(100, 700, 2, np.int32)
    A = gb.Matrix.from_scipy(S)
    C = gb.mxm(A, A, SR.MIN_PLUS, out_dtype=T.INT64)
    D = S.toarray().astype(np.int64)
    BIG = np.int64(1) << 40
    Dm = np.where(D != 0, D, BIG)
    want = np.minimum.reduce(
        Dm[:, :, None] + Dm[None, :, :], axis=1)
    pat = ((D != 0).astype(np.int64) @ (D != 0).astype(np.int64)) > 0
    got = C.to_scipy().toarray()
    assert np.array_equal(got[pat], want[pat])


def test_pair_counts(blocks):
    S = _rand(100, 900, 3)
    A = gb.Matrix.from_scipy(S)
    C = gb.mxm(A, A, SR.PLUS_PAIR, out_dtype=T.INT64)
    want = ((S != 0).astype(np.int64) @ (S != 0).astype(np.int64))
    got = C.to_scipy()
    assert abs(got - want).nnz == 0
