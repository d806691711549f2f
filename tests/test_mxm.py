"""Differential tests for mxm/mxv/vxm over semirings x formats x masks —
the flagship op (reference hot path, SURVEY.md §3.2)."""

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu import operators as ops
from graphblas_tpu.core import semiring as sr
from graphblas_tpu.core.descriptor import NULL, Descriptor
from graphblas_tpu.spec import oracle as spec

from harness import assert_matches, random_gb, random_mask

SEMIRINGS = [sr.PLUS_TIMES, sr.MIN_PLUS, sr.MAX_TIMES, sr.LOR_LAND,
             sr.PLUS_PAIR, sr.ANY_PAIR, sr.MIN_FIRST, sr.PLUS_SECOND]
FMT_PAIRS = [(gb.SPARSE, gb.SPARSE), (gb.SPARSE, gb.BITMAP),
             (gb.BITMAP, gb.SPARSE), (gb.BITMAP, gb.BITMAP),
             (gb.SPARSE, gb.FULL), (gb.FULL, gb.FULL)]


def _mk(rng, m, n, density, fmt, dtype=np.float64):
    if fmt == gb.FULL:
        dense = rng.standard_normal((m, n)).astype(dtype)
        A = gb.Matrix.from_dense(dense)
        return A, spec.SpecMat.from_gb(A)
    return random_gb(rng, m, n, density, dtype=dtype, fmt=fmt)


@pytest.mark.parametrize("s", SEMIRINGS, ids=lambda s: s.name)
def test_mxm_semirings(rng, s):
    dtype = np.bool_ if s is sr.LOR_LAND else np.float64
    A, sA = random_gb(rng, 7, 6, 0.35, dtype=dtype)
    B, sB = random_gb(rng, 6, 8, 0.35, dtype=dtype)
    got = gb.mxm(A, B, s)
    zt = s.mult.out_type(A.dtype, B.dtype).np_dtype
    want = spec.spec_mxm(spec.SpecMat.empty((7, 8), zt), None, None, s,
                         sA, sB)
    if s is sr.ANY_PAIR:
        gv, gp = (np.asarray(x) for x in got.to_dense_pair())
        np.testing.assert_array_equal(gp, want.pattern)
        return
    assert_matches(got, want, msg=s.name)


@pytest.mark.parametrize("fa,fb", FMT_PAIRS)
def test_mxm_formats(rng, fa, fb):
    A, sA = _mk(rng, 6, 7, 0.4, fa)
    B, sB = _mk(rng, 7, 5, 0.4, fb)
    got = gb.mxm(A, B, sr.PLUS_TIMES)
    want = spec.spec_mxm(spec.SpecMat.empty((6, 5), np.float64), None, None,
                         sr.PLUS_TIMES, sA, sB)
    assert_matches(got, want, msg=f"{fa}x{fb}")


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.bool_])
def test_mxm_int_exact(rng, dtype):
    s = sr.LOR_LAND if dtype == np.bool_ else sr.PLUS_TIMES
    A, sA = random_gb(rng, 8, 8, 0.4, dtype=dtype)
    B, sB = random_gb(rng, 8, 8, 0.4, dtype=dtype)
    got = gb.mxm(A, B, s)
    want = spec.spec_mxm(spec.SpecMat.empty((8, 8), dtype), None, None, s,
                         sA, sB)
    assert_matches(got, want)  # bit-for-bit on int/bool


@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("replace", [False, True])
def test_mxm_masked(rng, comp, replace):
    desc = Descriptor(mask_complement=comp, replace=replace)
    A, sA = random_gb(rng, 7, 7, 0.35)
    B, sB = random_gb(rng, 7, 7, 0.35)
    C, sC = random_gb(rng, 7, 7, 0.3)
    M, sM = random_mask(rng, 7, 7, 0.5)
    got = gb.mxm(A, B, sr.PLUS_TIMES, C=C.dup(), mask=M, accum=ops.PLUS,
                 desc=desc)
    want = spec.spec_mxm(sC, sM, ops.PLUS, sr.PLUS_TIMES, sA, sB, desc)
    assert_matches(got, want, msg=f"comp={comp} replace={replace}")


def test_mxm_transpose_descs(rng):
    A, sA = random_gb(rng, 6, 7, 0.4)
    B, sB = random_gb(rng, 6, 8, 0.4)
    d = Descriptor(transpose0=True)
    got = gb.mxm(A, B, sr.PLUS_TIMES, desc=d)
    want = spec.spec_mxm(spec.SpecMat.empty((7, 8), np.float64), None, None,
                         sr.PLUS_TIMES, sA, sB, d)
    assert_matches(got, want)
    d2 = Descriptor(transpose0=True, transpose1=True)
    B2, sB2 = random_gb(rng, 8, 6, 0.4)
    got = gb.mxm(A, B2, sr.PLUS_TIMES, desc=d2)
    want = spec.spec_mxm(spec.SpecMat.empty((7, 8), np.float64), None, None,
                         sr.PLUS_TIMES, sA, sB2, d2)
    assert_matches(got, want)


def test_mxm_positional(rng):
    A, sA = random_gb(rng, 5, 6, 0.4)
    B, sB = random_gb(rng, 6, 7, 0.4)
    s = sr.MIN_SECONDI
    got = gb.mxm(A, B, s)
    want = spec.spec_mxm(spec.SpecMat.empty((5, 7), np.int64), None, None,
                         s, sA, sB)
    assert_matches(got, want)


@pytest.mark.parametrize("fmt", [gb.SPARSE, gb.BITMAP, gb.FULL])
def test_mxv(rng, fmt):
    A, sA = random_gb(rng, 9, 7, 0.35)
    u, su = _mk(rng, 7, 1, 0.5, fmt)
    got = gb.mxv(A, u, sr.PLUS_TIMES)
    assert isinstance(got, gb.Vector)
    want = spec.spec_mxm(spec.SpecMat.empty((9, 1), np.float64), None, None,
                         sr.PLUS_TIMES, sA, su)
    assert_matches(got, want, msg=fmt)


def test_mxv_masked(rng):
    A, sA = random_gb(rng, 8, 8, 0.35)
    u, su = random_gb(rng, 8, 1, 0.6, klass=gb.Vector)
    w, sw = random_gb(rng, 8, 1, 0.4, klass=gb.Vector)
    M, sM = random_mask(rng, 8, 1, 0.5, klass=gb.Vector)
    got = gb.mxv(A, u, sr.MIN_PLUS, C=w.dup(), mask=M, accum=ops.MIN)
    want = spec.spec_mxm(sw, sM, ops.MIN, sr.MIN_PLUS, sA, su)
    assert_matches(got, want)


@pytest.mark.parametrize("s", [sr.PLUS_TIMES, sr.LOR_LAND, sr.MIN_PLUS],
                         ids=lambda s: s.name)
def test_vxm(rng, s):
    dtype = np.bool_ if s is sr.LOR_LAND else np.float64
    A, sA = random_gb(rng, 7, 9, 0.35, dtype=dtype)
    u, su = random_gb(rng, 7, 1, 0.6, dtype=dtype, klass=gb.Vector)
    got = gb.vxm(u, A, s)
    assert isinstance(got, gb.Vector)
    # w = u'A == (A' u)'
    want = spec.spec_mxm(spec.SpecMat.empty((9, 1), dtype), None, None,
                         s, spec.SpecMat(sA.values.T, sA.pattern.T), su)
    assert_matches(got, want, msg=s.name)


def test_vxm_positional(rng):
    # BFS-parent pattern: w = u' MIN_FIRSTJ A.  Semiring positional
    # semantics (reference UserGuide table): z = f(a_ik, b_kj), FIRSTJ = k;
    # for vxm u'(0,k) * A(k,j) that is k — the source vertex id.
    A, sA = random_gb(rng, 6, 6, 0.5)
    u, su = random_gb(rng, 6, 1, 0.6, klass=gb.Vector)
    got = gb.vxm(u, A, sr.MIN_FIRSTJ)
    n = 6
    want_vals = np.zeros((n, 1), np.int64)
    want_pat = np.zeros((n, 1), bool)
    for j in range(n):
        ks = [k for k in range(n)
              if su.pattern[k, 0] and sA.pattern[k, j]]
        if ks:
            want_vals[j, 0] = min(ks)
            want_pat[j, 0] = True
    assert_matches(got, spec.SpecMat(want_vals, want_pat))


def test_mxm_empty(rng):
    A = gb.Matrix.new(gb.types.FP64, 5, 6)
    B, _ = random_gb(rng, 6, 4, 0.5)
    got = gb.mxm(A, B, sr.PLUS_TIMES)
    assert got.nvals == 0
    assert got.shape == (5, 4)


def test_mxm_dim_mismatch(rng):
    A, _ = random_gb(rng, 5, 6, 0.3)
    B, _ = random_gb(rng, 5, 6, 0.3)
    with pytest.raises(gb.errors.DimensionMismatch):
        gb.mxm(A, B, sr.PLUS_TIMES)


def test_rowscale_colscale_diagonal(rng):
    """Diagonal-operand fast paths (reference: GB_rowscale/GB_colscale)."""
    import scipy.sparse as sps
    n = 30
    S = sps.random(n, n, density=0.2, random_state=np.random.RandomState(9),
                   format="csr", dtype=np.float64)
    d = rng.standard_normal(n)
    D = gb.api.diag(gb.Vector.from_dense(d))
    A = gb.Matrix.from_scipy(S)
    C1 = gb.mxm(D, A, sr.PLUS_TIMES)        # rowscale
    C2 = gb.mxm(A, D, sr.PLUS_TIMES)        # colscale
    want1 = sps.diags(d) @ S
    want2 = S @ sps.diags(d)
    np.testing.assert_allclose(np.asarray(C1.to_dense_pair()[0]),
                               want1.toarray(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(C2.to_dense_pair()[0]),
                               want2.toarray(), rtol=1e-12)


def test_spgemm_row_block_tiling(rng, monkeypatch):
    """Tiled ESC (peak memory O(F_block)) matches the single-pass result
    (VERDICT r1 #3)."""
    import scipy.sparse as sps
    from graphblas_tpu.ops import mxm as MXM
    from graphblas_tpu.core import semiring as sr
    n = 300
    A = sps.random(n, n, density=0.05, random_state=np.random.RandomState(7),
                   format="csr", dtype=np.float64)
    B = sps.random(n, n, density=0.05, random_state=np.random.RandomState(8),
                   format="csr", dtype=np.float64)
    want = (A @ B).toarray()
    gA, gB = gb.Matrix.from_scipy(A), gb.Matrix.from_scipy(B)
    C1 = gb.mxm(gA, gB, sr.PLUS_TIMES)
    monkeypatch.setattr(MXM, "SPGEMM_FLOP_BLOCK", 16384)  # force several blocks
    C2 = gb.mxm(gA, gB, sr.PLUS_TIMES)
    for C in (C1, C2):
        got = np.zeros((n, n))
        got_v, got_p = C.to_dense_pair()
        got = np.where(np.asarray(got_p), np.asarray(got_v), 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_spgemm_tiled_masked(rng, monkeypatch):
    import scipy.sparse as sps
    from graphblas_tpu.ops import mxm as MXM
    from graphblas_tpu.core import semiring as sr
    n = 200
    A = sps.random(n, n, density=0.06, random_state=np.random.RandomState(9),
                   format="csr", dtype=np.float64)
    M = sps.random(n, n, density=0.1, random_state=np.random.RandomState(10),
                   format="csr", dtype=np.float64)
    M.data[:] = 1.0
    gA = gb.Matrix.from_scipy(A)
    gM = gb.Matrix.from_scipy(M)
    ref = gb.mxm(gA, gA, sr.PLUS_TIMES, mask=gM)
    monkeypatch.setattr(MXM, "SPGEMM_FLOP_BLOCK", 8192)
    tiled = gb.mxm(gA, gA, sr.PLUS_TIMES, mask=gM)
    rv, rp = ref.to_dense_pair()
    tv, tp = tiled.to_dense_pair()
    np.testing.assert_array_equal(np.asarray(rp), np.asarray(tp))
    np.testing.assert_allclose(np.asarray(rv)[np.asarray(rp)],
                               np.asarray(tv)[np.asarray(tp)], rtol=1e-10)


def test_spmspv_scatter_path(rng):
    """vxm with sparse u rides the dense-accumulator SpMSpV (no transpose
    of A, no SpGEMM machinery) and matches the oracle for PLUS/MIN/LOR."""
    import scipy.sparse as sps
    from graphblas_tpu.core import semiring as SRM

    n = 300
    S = sps.random(n, n, density=0.03, format="csr",
                   random_state=np.random.RandomState(11),
                   dtype=np.float32)
    A = gb.Matrix.from_scipy(S)
    xi = np.sort(rng.choice(n, 40, replace=False)).astype(np.int64)
    xv = rng.standard_normal(40).astype(np.float32)
    xs = gb.Vector.from_coo(xi, xv, n)
    xd = np.zeros(n)
    xd[xi] = xv
    got = np.asarray(gb.vxm(xs, A, SRM.PLUS_TIMES).to_scipy()
                     .toarray()).ravel()
    want = S.T.astype(np.float64) @ xd
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # MIN_PLUS through the min-scatter branch
    d = S.toarray()
    ym = np.asarray(gb.vxm(xs, A, SRM.MIN_PLUS).to_scipy()
                    .toarray()).ravel()
    wantm = np.full(n, np.inf)
    for j in range(n):
        for i in xi:
            if d[i, j] != 0:
                wantm[j] = min(wantm[j], xd[i] + d[i, j])
    fin = np.isfinite(wantm)
    np.testing.assert_allclose(ym[fin], wantm[fin], rtol=1e-5)
    assert (ym[~fin] == 0).all()
    # bool LOR_LAND (also covers the bool-build plus->lor collapse)
    xb = gb.Vector.from_coo(xi, np.ones(40, bool), n, dtype="bool")
    yb = np.asarray(gb.vxm(xb, A, SRM.LOR_LAND, out_dtype="bool")
                    .to_scipy().toarray()).ravel() != 0
    assert np.array_equal(yb, (d[xi, :] != 0).any(0))
