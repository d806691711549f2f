"""Round-5 fallback-path coverage: the numpy merge tier of eWise (used
when the native union_merge_raw sweep is unavailable or the output is a
struct type) and the no-library branches of every ctypes wrapper —
tested by forcing the fallbacks, asserting identical results."""

import numpy as np
import pytest
import scipy.sparse as sp

import graphblas_tpu as gb
from graphblas_tpu.core import types as T
from graphblas_tpu.kernels import segment as K
from graphblas_tpu.utils import native as NV


@pytest.fixture
def mats():
    rng = np.random.default_rng(3)
    A = sp.random(40, 50, density=0.15, format="csr", random_state=1,
                  dtype=np.float64)
    B = sp.random(40, 50, density=0.15, format="csr", random_state=2,
                  dtype=np.float64)
    Ac, Bc = A.tocoo(), B.tocoo()
    return (gb.Matrix.from_coo(Ac.row, Ac.col, Ac.data, (40, 50)),
            gb.Matrix.from_coo(Bc.row, Bc.col, Bc.data, (40, 50)),
            A, B)


def test_ewise_numpy_merge_tier(monkeypatch, mats):
    """Force the jnp union-merge fallback (K.union_merge path,
    ewise lines past the raw fast tier + segment._merge_phase*)."""
    Ag, Bg, A, B = mats
    want_add = (A + B).toarray()
    want_mult = A.multiply(B).toarray()
    monkeypatch.setattr(K, "union_merge_raw", lambda *a, **k: None)
    C = gb.ewise_add(Ag, Bg, gb.operators.PLUS)
    np.testing.assert_allclose(C.to_scipy().toarray(), want_add,
                               rtol=1e-12)
    C = gb.ewise_mult(Ag, Bg, gb.operators.TIMES)
    np.testing.assert_allclose(C.to_scipy().toarray(), want_mult,
                               rtol=1e-12)
    # eWiseUnion with per-side fill scalars through the fallback
    C = gb.ewise_union(Ag, 10.0, Bg, 20.0, gb.operators.PLUS)
    dense = np.where((A.toarray() != 0) | (B.toarray() != 0),
                     np.where(A.toarray() != 0, A.toarray(), 10.0)
                     + np.where(B.toarray() != 0, B.toarray(), 20.0),
                     0.0)
    np.testing.assert_allclose(C.to_scipy().toarray(), dense, rtol=1e-12)
    # positional multiply through the fallback (FIRSTI: z = i)
    C = gb.ewise_add(Ag, Bg, gb.operators.FIRSTI)
    got = C.to_scipy().tocoo()
    np.testing.assert_array_equal(np.asarray(got.data, np.int64), got.row)


def _no_lib(monkeypatch):
    monkeypatch.setattr(NV, "_lib", None)
    monkeypatch.setattr(NV, "_tried", True)


def test_native_wrappers_numpy_fallbacks(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 40, 300).astype(np.uint64)
    arr = np.sort(rng.integers(0, 1 << 30, 200).astype(np.int64))
    native_perm = NV.radix_argsort_u64(keys)
    native_blob = NV.delta_encode(arr)
    sh = NV.byteshuffle(arr)
    _no_lib(monkeypatch)
    assert not NV.available()
    np.testing.assert_array_equal(NV.radix_argsort_u64(keys), native_perm)
    blob = NV.delta_encode(arr)
    np.testing.assert_array_equal(NV.delta_decode(blob, len(arr)), arr)
    # a native gbd1 blob without the library raises (documented)
    with pytest.raises(RuntimeError):
        NV.delta_decode(native_blob, len(arr))
    b2 = NV.byteshuffle(arr)
    np.testing.assert_array_equal(
        NV.byteunshuffle(b2, np.int64, len(arr)), arr)
    np.testing.assert_array_equal(
        NV.byteunshuffle(sh, np.int64, len(arr)), arr)


def test_read_mtx_scipy_fallback(monkeypatch, tmp_path):
    p = tmp_path / "t.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "3 3 2\n1 1 1.5\n3 2 2.5\n")
    native = NV.read_mtx(str(p))
    _no_lib(monkeypatch)
    fb = NV.read_mtx(str(p))
    for a, b in zip(native, fb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
