"""Tests that need the card (marker ``gpu``; the ``gpu`` fixture skips them
elsewhere).  Run: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"""

import pathlib
import sys

import numpy as np
import pytest

import graphblas_tpu as gb
from graphblas_tpu.core import semiring as SR

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


@pytest.mark.gpu
def test_dense_fp32_mxm_is_not_tf32(gpu):
    """A float32 product on the GPU may run in TF32 (about 1e-3 relative)
    unless the precision is pinned; dense mxm keeps fp32 semantics."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    C = gb.mxm(gb.Matrix.from_dense(a), gb.Matrix.from_dense(b),
               SR.PLUS_TIMES)
    got = np.asarray(C.to_dense_pair()[0], np.float64)
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("phase", sorted(CS.PHASES))
def test_chip_smoke_phase_on_card(gpu, phase):
    recs = CS.run(CS.SMALL, [phase])
    bad = [r for r in recs if not r["ok"]]
    assert recs and not bad, bad
