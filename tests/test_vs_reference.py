"""Differential tests against the COMPILED reference (round-4 ask #8;
the reference's own strategy: Test/GB_spec_compare.m).

Fixtures are produced by experiments/ref_dump.c run against the
SuiteSparse:GraphBLAS COMPACT build on this host and committed under
tests/fixtures/ref/.  Inputs regenerate here via the same LCG; every op
asserts BIT-FOR-BIT equality on integer/boolean semirings
(BASELINE.json requirement).  Skipped when fixtures are absent."""

import os
import struct

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.core import monoid as MON
from graphblas_tpu.core import semiring as SR
from graphblas_tpu.core import types as T
from graphblas_tpu.core.descriptor import Descriptor

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "ref")

pytestmark = pytest.mark.skipif(not os.path.isdir(FIXDIR),
                                reason="reference fixtures not present")

MASK64 = (1 << 64) - 1


def _lcg_stream(seed, count):
    s = seed
    out = np.empty(count, np.uint64)
    for k in range(count):
        s = (s * 6364136223846793005 + 1442695040888963407) & MASK64
        out[k] = s >> 33
    return out


def gen_coo(seed, n, nnz, vmax):
    draws = _lcg_stream(seed, nnz * 3).reshape(nnz, 3)
    ri = (draws[:, 0] % n).astype(np.int64)
    ci = (draws[:, 1] % n).astype(np.int64)
    vi = (draws[:, 2] % vmax).astype(np.int64) + 1
    return ri, ci, vi


def build_int64(seed, n, nnz, vmax):
    ri, ci, vi = gen_coo(seed, n, nnz, vmax)
    return gb.Matrix.from_coo(ri, ci, vi, (n, n), dtype=T.INT64,
                              dup=gb.operators.PLUS)


def build_bool(seed, n, nnz):
    ri, ci, vi = gen_coo(seed, n, nnz, 2)
    return gb.Matrix.from_coo(ri, ci, vi == 2, (n, n), dtype=T.BOOL,
                              dup=gb.operators.LOR)


def load_fixture(name):
    path = os.path.join(FIXDIR, name + ".bin")
    with open(path, "rb") as f:
        nr, nc, nv = struct.unpack("<3q", f.read(24))
        body = np.frombuffer(f.read(), np.int64)
    rows = body[:nv]
    cols = body[nv:2 * nv]
    vals = body[2 * nv:3 * nv]
    return (nr, nc), rows, cols, vals


def assert_matches(C, name):
    shape, rows, cols, vals = load_fixture(name)
    assert C.shape == shape
    Cs = C.to_scipy().tocoo()
    order = np.lexsort((Cs.col, Cs.row))
    gr, gc = Cs.row[order].astype(np.int64), Cs.col[order].astype(np.int64)
    gv = np.asarray(Cs.data)[order].astype(np.int64)
    assert gr.shape[0] == rows.shape[0], (name, gr.shape[0], rows.shape[0])
    np.testing.assert_array_equal(gr, rows, err_msg=name)
    np.testing.assert_array_equal(gc, cols, err_msg=name)
    np.testing.assert_array_equal(gv, vals, err_msg=name)


@pytest.fixture(scope="module")
def mats():
    return {
        "A": build_int64(1, 97, 800, 9),
        "B": build_int64(2, 97, 700, 9),
        "Ab": build_bool(3, 128, 2000),
        "Bb": build_bool(4, 128, 1800),
    }


def test_inputs_match(mats):
    assert_matches(mats["A"], "in_A")
    assert_matches(mats["B"], "in_B")
    assert_matches(mats["Ab"].astype(T.INT64), "in_Ab")
    assert_matches(mats["Bb"].astype(T.INT64), "in_Bb")


def test_mxm_plus_times(mats):
    C = gb.mxm(mats["A"], mats["B"], SR.PLUS_TIMES, out_dtype=T.INT64)
    assert_matches(C, "mxm_plus_times")


def test_mxm_masked(mats):
    C = gb.mxm(mats["A"], mats["B"], SR.PLUS_TIMES, mask=mats["A"],
               desc=Descriptor(mask_structure=True), out_dtype=T.INT64)
    assert_matches(C, "mxm_masked")


def test_mxm_lor_land(mats):
    C = gb.mxm(mats["Ab"], mats["Bb"], SR.LOR_LAND)
    assert_matches(C.astype(T.INT64), "mxm_lor_land")


def test_mxm_min_plus(mats):
    C = gb.mxm(mats["A"], mats["B"], SR.MIN_PLUS, out_dtype=T.INT64)
    assert_matches(C, "mxm_min_plus")


def test_ewiseadd_plus(mats):
    C = gb.ewise_add(mats["A"], mats["B"], gb.operators.PLUS)
    assert_matches(C, "ewiseadd_plus")


def test_ewisemult_times(mats):
    C = gb.ewise_mult(mats["A"], mats["B"], gb.operators.TIMES)
    assert_matches(C, "ewisemult_times")


def test_transpose(mats):
    from graphblas_tpu.core.matrix import ROW, SPARSE
    C = gb.transpose(mats["A"]).to_format(SPARSE, ROW)
    assert_matches(C, "transpose")


def test_extract_sub(mats):
    C = gb.extract(mats["A"], np.arange(10, 61), np.arange(20, 81))
    assert_matches(C, "extract_sub")


def test_select_tril(mats):
    C = gb.select(mats["A"], gb.operators.TRIL, -1)
    assert_matches(C, "select_tril")


def test_apply_ainv(mats):
    C = gb.apply(mats["A"], gb.operators.AINV)
    assert_matches(C, "apply_ainv")


def test_reduce_plus(mats):
    s = int(gb.reduce_scalar(mats["A"], MON.PLUS, out_dtype=T.INT64))
    _, _, _, vals = load_fixture("reduce_plus")
    assert s == int(vals[0])


def test_kron_times():
    K1 = build_int64(5, 12, 40, 5)
    K2 = build_int64(6, 11, 30, 5)
    C = gb.kronecker(K1, K2, gb.operators.TIMES)
    assert_matches(C, "kron_times")


# ---------------------------------------------------------------------------
# round-5 widening: accum x mask(comp,valued,structure) x replace x
# descriptor transposes + assign + vectors + the reference's own Demo
# graphs (VERDICT r4 missing #1/#2; reference method: Test/testall.m's
# accum/mask/descriptor cross products via GB_spec_compare.m)
# ---------------------------------------------------------------------------

def _vec_from_fixture(C):
    """97x1 matrix fixture comparison helper for vector results."""
    return C


@pytest.fixture(scope="module")
def mats5(mats):
    out = dict(mats)
    out["C0"] = build_int64(7, 97, 500, 9)
    Mr = build_int64(8, 97, 900, 2)
    out["M2"] = gb.apply(Mr, gb.operators.MINUS, bind=("second", 1),
                         out_dtype=T.INT64)
    # u: 60 sequential (value, index) draws from one LCG stream (the C
    # side interleaves value/index per setElement; later duplicates
    # overwrite earlier ones)
    draws = _lcg_stream(9, 120)
    uv = np.zeros(97, np.int64)
    up = np.zeros(97, bool)
    for k in range(60):
        val = int(draws[2 * k] % 9) + 1
        idx = int(draws[2 * k + 1] % 97)
        uv[idx] = val
        up[idx] = True
    out["u"] = gb.Vector.from_dense_masked(uv, up).astype(T.INT64)
    return out


def _as_col_matrix(w):
    """Vector -> n x 1 Matrix for fixture comparison."""
    n = w.nrows
    iv, _, vv = w.coo()
    return gb.Matrix.from_coo(np.asarray(iv), np.zeros(len(iv), np.int64),
                              np.asarray(vv), (n, 1), dtype=T.INT64)


def test_in5(mats5):
    assert_matches(mats5["C0"], "in_C0")
    assert_matches(mats5["M2"], "in_M2")
    assert_matches(_as_col_matrix(mats5["u"]), "in_u")


def test_mxm_accum(mats5):
    C = mats5["C0"].dup()
    C = gb.mxm(mats5["A"], mats5["B"], SR.PLUS_TIMES, C=C,
               accum=gb.operators.PLUS, out_dtype=T.INT64)
    assert_matches(C, "mxm_accum")


def test_mxm_mask_comp(mats5):
    C = gb.mxm(mats5["A"], mats5["B"], SR.PLUS_TIMES, mask=mats5["A"],
               desc=Descriptor(mask_structure=True, mask_complement=True),
               out_dtype=T.INT64)
    assert_matches(C, "mxm_mask_comp")


def test_mxm_mask_accum_replace(mats5):
    C = mats5["C0"].dup()
    C = gb.mxm(mats5["A"], mats5["B"], SR.PLUS_TIMES, C=C,
               mask=mats5["M2"], accum=gb.operators.PLUS,
               desc=Descriptor(replace=True), out_dtype=T.INT64)
    assert_matches(C, "mxm_mask_accum_replace")


def test_mxm_mask_valued(mats5):
    C = gb.mxm(mats5["A"], mats5["B"], SR.PLUS_TIMES, mask=mats5["M2"],
               out_dtype=T.INT64)
    assert_matches(C, "mxm_mask_valued")


def test_mxm_descriptor_transposes(mats5):
    A, B = mats5["A"], mats5["B"]
    assert_matches(gb.mxm(A, B, SR.PLUS_TIMES, out_dtype=T.INT64,
                          desc=Descriptor(transpose0=True)), "mxm_at_b")
    assert_matches(gb.mxm(A, B, SR.PLUS_TIMES, out_dtype=T.INT64,
                          desc=Descriptor(transpose1=True)), "mxm_a_bt")
    assert_matches(gb.mxm(A, B, SR.PLUS_TIMES, out_dtype=T.INT64,
                          desc=Descriptor(transpose0=True,
                                          transpose1=True)), "mxm_at_bt")


def test_mxv_plus_times(mats5):
    w = gb.mxv(mats5["A"], mats5["u"], SR.PLUS_TIMES, out_dtype=T.INT64)
    assert_matches(_as_col_matrix(w), "mxv_plus_times")


def test_mxv_minplus_comp_accum(mats5):
    w = gb.mxv(mats5["A"], mats5["u"], SR.PLUS_TIMES, out_dtype=T.INT64)
    w = gb.mxv(mats5["A"], mats5["u"], SR.MIN_PLUS, C=w,
               mask=mats5["u"], accum=gb.operators.PLUS,
               desc=Descriptor(mask_complement=True), out_dtype=T.INT64)
    assert_matches(_as_col_matrix(w), "mxv_minplus_comp_accum")


def test_ewiseadd_comp_replace(mats5):
    C = mats5["C0"].dup()
    C = gb.ewise_add(mats5["A"], mats5["B"], gb.operators.PLUS, C=C,
                     mask=mats5["M2"],
                     desc=Descriptor(mask_complement=True, replace=True))
    assert_matches(C, "ewiseadd_comp_replace")


def test_ewiseadd_accum_max(mats5):
    C = mats5["C0"].dup()
    C = gb.ewise_add(mats5["A"], mats5["B"], gb.operators.PLUS, C=C,
                     accum=gb.operators.MAX)
    assert_matches(C, "ewiseadd_accum_max")


def test_ewisemult_masked_min(mats5):
    C = gb.ewise_mult(mats5["A"], mats5["B"], gb.operators.MIN,
                      mask=mats5["M2"])
    assert_matches(C, "ewisemult_masked_min")


def test_ewiseadd_lor(mats5):
    C = gb.ewise_add(mats5["Ab"], mats5["Bb"], gb.operators.LOR)
    assert_matches(C.astype(T.INT64), "ewiseadd_lor")


def test_assign_accum(mats5):
    ni = 47
    Asub = gb.extract(mats5["A"], np.arange(ni), np.arange(ni))
    C = mats5["C0"].dup()
    C = gb.assign(C, Asub, np.arange(50, 50 + ni), np.arange(50, 50 + ni),
                  accum=gb.operators.PLUS)
    assert_matches(C, "assign_accum")


def test_assign_mask_replace(mats5):
    C = mats5["C0"].dup()
    C = gb.assign(C, mats5["B"], mask=mats5["M2"],
                  desc=Descriptor(replace=True))
    assert_matches(C, "assign_mask_replace")


def test_assign_scalar_mask(mats5):
    C = mats5["C0"].dup()
    C = gb.assign(C, 7, mask=mats5["A"],
                  desc=Descriptor(mask_structure=True))
    assert_matches(C, "assign_scalar_mask")


def test_extract_backwards(mats5):
    II = 96 - np.arange(97)
    JJ = np.minimum(2 * np.arange(49) + 1, 96)
    C = gb.extract(mats5["A"], II, JJ)
    assert_matches(C, "extract_backwards")


def test_apply_bind_tran(mats5):
    C = gb.apply(mats5["A"], gb.operators.MINUS, bind=("second", 3),
                 desc=Descriptor(transpose0=True), out_dtype=T.INT64)
    assert_matches(C, "apply_bind_tran")


def test_select_valuegt_masked(mats5):
    C = gb.select(mats5["A"], gb.operators.VALUEGT, 5, mask=mats5["M2"])
    assert_matches(C, "select_valuegt_masked")


def test_reduce_rows_cols(mats5):
    w = gb.reduce(mats5["A"], MON.PLUS, out_dtype=T.INT64)
    assert_matches(_as_col_matrix(w), "reduce_rows")
    w = gb.reduce(mats5["A"], MON.PLUS, out_dtype=T.INT64,
                  desc=Descriptor(transpose0=True))
    assert_matches(_as_col_matrix(w), "reduce_cols")


def test_concat_2x2(mats5):
    A, B = mats5["A"], mats5["B"]
    C = gb.concat([[A, B], [B, A]])
    assert_matches(C, "concat_2x2")


def test_diag_km1(mats5):
    C = gb.diag(mats5["u"], k=-1)
    assert_matches(C.astype(T.INT64), "diag_km1")


# ---- the reference's own Demo graphs --------------------------------------

DEMO_DIR = "/root/reference/Demo/Matrix"


def load_demo_int64(name):
    """Mirror of ref_dump.c's load_demo_int64: 0-based triplet text,
    values replaced by (i*31 + j*17) % 9 + 1 for exact int64 compare."""
    path = os.path.join(DEMO_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f"demo matrix {name} not present")
    tri = np.loadtxt(path, usecols=(0, 1), dtype=np.int64, ndmin=2)
    ri, ci = tri[:, 0], tri[:, 1]
    vi = (ri * 31 + ci * 17) % 9 + 1
    dim = int(max(ri.max(), ci.max())) + 1
    return gb.Matrix.from_coo(ri, ci, vi, (dim, dim), dtype=T.INT64,
                              dup=gb.operators.PLUS)


@pytest.fixture(scope="module")
def west():
    return load_demo_int64("west0067")


@pytest.fixture(scope="module")
def bcs():
    return load_demo_int64("bcsstk01")


def test_west_inputs(west):
    assert_matches(west, "in_west")


def test_west_mxm(west):
    C = gb.mxm(west, west, SR.PLUS_TIMES, out_dtype=T.INT64)
    assert_matches(C, "west_mxm")


def test_west_tc(west):
    L = gb.select(west, gb.operators.TRIL, -1)
    C = gb.mxm(L, L, SR.PLUS_PAIR, mask=L,
               desc=Descriptor(mask_structure=True, transpose1=True),
               out_dtype=T.INT64)
    assert_matches(C, "west_tc")


def test_west_min_plus(west):
    C = gb.mxm(west, west, SR.MIN_PLUS, out_dtype=T.INT64)
    assert_matches(C, "west_min_plus")


def test_bcs_inputs(bcs):
    assert_matches(bcs, "in_bcs")


def test_bcs_mxm_bt(bcs):
    C = gb.mxm(bcs, bcs, SR.PLUS_TIMES, out_dtype=T.INT64,
               desc=Descriptor(transpose1=True))
    assert_matches(C, "bcs_mxm_bt")


def test_bcs_ewiseadd_masked(bcs):
    C = gb.ewise_add(bcs, bcs, gb.operators.PLUS, mask=bcs,
                     desc=Descriptor(mask_structure=True))
    assert_matches(C, "bcs_ewiseadd_masked")
