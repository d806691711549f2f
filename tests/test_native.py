"""Native C++ runtime layer tests (native/gbtpu_native.cpp): radix sort,
gbz codec primitives, Matrix Market IO, gbz serialize round trip."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.utils import native as NV

from harness import assert_matches, random_gb


def test_native_builds():
    assert NV.available(), "native library should build in this image"


def test_radix_sort(rng):
    keys = rng.integers(0, 1 << 62, 100000).astype(np.uint64)
    perm = NV.radix_argsort_u64(keys)
    sk = keys[perm]
    assert (np.diff(sk.astype(np.int64)) >= 0).all()
    np.testing.assert_array_equal(np.sort(keys), sk)


def test_radix_sort_matches_numpy_stable(rng):
    keys = rng.integers(0, 50, 10000).astype(np.uint64)  # many dups
    perm = NV.radix_argsort_u64(keys)
    np.testing.assert_array_equal(keys[perm], np.sort(keys))
    # stability: equal keys keep original order
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(perm, want)


def test_delta_codec(rng):
    a = np.cumsum(rng.integers(0, 10, 5000)).astype(np.int64)
    blob = NV.delta_encode(a)
    assert len(blob) < a.nbytes / 3  # sorted ints compress well
    back = NV.delta_decode(blob, len(a))
    np.testing.assert_array_equal(a, back)
    # negative deltas too
    b = rng.integers(-1000, 1000, 1000).astype(np.int64)
    np.testing.assert_array_equal(NV.delta_decode(NV.delta_encode(b),
                                                  len(b)), b)


def test_byteshuffle(rng):
    a = rng.standard_normal(1000).astype(np.float32)
    blob = NV.byteshuffle(a)
    back = NV.byteunshuffle(blob, np.float32, 1000)
    np.testing.assert_array_equal(a, back)


def test_gbz_serialize(rng):
    from graphblas_tpu.ops import serialize as ser
    A, sA = random_gb(rng, 50, 50, 0.1)
    gbz = ser.serialize(A, compression="gbz")
    zl = ser.serialize(A, compression="zlib")
    B = ser.deserialize(gbz)
    assert_matches(B, sA)
    # gbz should beat plain zlib on index-heavy matrices
    assert len(gbz) <= len(zl) * 1.1


def test_mtx_roundtrip(rng, tmp_path):
    import scipy.io as sio
    import scipy.sparse as sps
    S = sps.random(40, 30, 0.2, format="coo", random_state=1)
    p = tmp_path / "m.mtx"
    sio.mmwrite(p, S)
    A = gb.Matrix.from_mtx(p)
    assert A.shape == (40, 30)
    got = A.to_scipy()
    assert abs(got - S.tocsr()).max() < 1e-12


def test_mtx_symmetric(tmp_path):
    p = tmp_path / "sym.mtx"
    p.write_text("""%%MatrixMarket matrix coordinate real symmetric
3 3 3
1 1 2.0
2 1 3.0
3 2 4.0
""")
    A = gb.Matrix.from_mtx(p)
    d = A.to_scipy().toarray()
    want = np.array([[2, 3, 0], [3, 0, 4], [0, 4, 0]], float)
    np.testing.assert_allclose(d, want)


def test_mtx_pattern(tmp_path):
    p = tmp_path / "pat.mtx"
    p.write_text("""%%MatrixMarket matrix coordinate pattern general
2 2 2
1 2
2 1
""")
    A = gb.Matrix.from_mtx(p)
    np.testing.assert_allclose(A.to_scipy().toarray(),
                               [[0, 1], [1, 0]])
