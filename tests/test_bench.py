"""bench.py's pieces that run without a card: the peak table, the byte
counts and the trace reduction."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import bench  # noqa: E402


def test_peak_for_known_and_unknown_card():
    assert bench.peak_for("NVIDIA H200")["hbm_bytes_per_s"] == 4.8e12
    with pytest.raises(KeyError, match="no published peak"):
        bench.peak_for("cpu")


def test_byte_counts():
    # CSR ids + fp32 values, indptr, x and y once
    assert bench.spmv_bytes(10, 20, 100, 4) == 100 * 8 + 11 * 4 + 80 + 40
    assert bench.spgemm_bytes(10, 50, 200, 120, 8) == 370 * 12 + 2 * 11 * 4


def test_median_time_orders_min_median_max():
    t, tmin, tmax = bench.median_time(lambda: jnp.ones(8) + 1, reps=3)
    assert 0 <= tmin <= t <= tmax


def test_device_time_by_op_reduces_a_trace(tmp_path):
    f = jax.jit(lambda x: jnp.cumsum(x) * 2)
    x = jnp.ones(1 << 16)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    lines = bench.device_time_by_op(str(tmp_path), plane_prefix="/host:")
    assert lines
    for rec in lines.values():
        assert 0 <= rec["busy_ns"] <= rec["span_ns"]
        assert rec["top"] and all(n >= 1 for _, _, n in rec["top"])
