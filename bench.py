#!/usr/bin/env python3
"""Plain-path bandwidth probe on the GPU: how close the XLA forms of SpMV
(ops/mxm.spmv_arrays: gather + segment_sum) and of ESC SpGEMM (gb.mxm,
sparse x sparse) come to the card's memory bandwidth.

    python bench.py [--trace DIR]

Graphs are chip_smoke.py's (same generators, same seed): SpMV on the GAP
kron and urand graphs at scale 22 (fp32 and fp64 values), SpGEMM on urand
scale 20, degree 16.  Each result is the median of REPS calls timed on the
host clock, each ending in block_until_ready, after one warm-up call.

Achieved bytes/s divides the bytes the operation cannot avoid (below) by
that time, and is reported against two ceilings: the published HBM peak
of the card (PEAKS, keyed by device_kind; an unknown card is an error)
and a large device copy measured in the same process.

  SpMV:   nnz * (4 + w) + (m + 1) * 4 + n * w + m * w bytes (CSR column
          ids and values once, x and y once; w = value width)
  SpGEMM: (nnz(A) + products + nnz(C)) * (4 + w) + 2 * (m + 1) * 4 bytes
          (A once, one B entry per product, C written once)

Prints the card's name and power limit, then one JSON line per result.
With --trace, one more call of each operation runs under jax.profiler and
its device events are summed per name (device_time_by_op) and printed.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as CS

REPS = 10

# Published HBM peaks, keyed by jax device_kind (NVIDIA data sheets).
PEAKS = {
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12,
                    "source": "NVIDIA H200 Tensor Core GPU data sheet"},
}


def peak_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for {device_kind!r}; add it to "
                       "PEAKS with its source")
    return PEAKS[device_kind]


def median_time(fn, reps=REPS):
    jax.block_until_ready(fn())                # warm-up (compiles)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)


def copy_bandwidth(nbytes=4 << 30):
    """Read + write bytes/s of a large elementwise pass (a + 1)."""
    a = jnp.zeros((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    t, _, _ = median_time(lambda: f(a))
    return 2 * nbytes / t


def device_time_by_op(trace_dir, top=8, plane_prefix="/device:"):
    """Reduce the newest profiler trace under trace_dir: for every line of
    every device plane, the union of its event intervals (busy_ns), the
    span from first start to last end, and the top event names by summed
    duration."""
    files = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(files[-1])
    out = {}
    for pl in pd.planes:
        if not pl.name.startswith(plane_prefix):
            continue
        for ln in pl.lines:
            agg = collections.defaultdict(lambda: [0.0, 0])
            iv = []
            for e in ln.events:
                agg[e.name][0] += e.duration_ns
                agg[e.name][1] += 1
                iv.append((e.start_ns, e.end_ns))
            if not iv:
                continue
            iv.sort()
            busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
            for st, en in iv[1:]:
                if st > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = st, en
                else:
                    cur_e = max(cur_e, en)
            busy += cur_e - cur_s
            ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
            out[f"{pl.name} {ln.name}"] = {
                "busy_ns": busy, "span_ns": iv[-1][1] - iv[0][0],
                "top": [[k, v[0], v[1]] for k, v in ranked]}
    return out


def traced(trace_dir, name, fn):
    """Run fn once under the profiler; returns the reduced trace."""
    d = os.path.join(trace_dir, name)
    with jax.profiler.trace(d):
        jax.block_until_ready(fn())
    return device_time_by_op(d)


def spmv_bytes(m, n, nnz, w):
    return nnz * (4 + w) + (m + 1) * 4 + n * w + m * w


def spgemm_bytes(m, nnz_a, products, nnz_c, w):
    return (nnz_a + products + nnz_c) * (4 + w) + 2 * (m + 1) * 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace one call of each operation into DIR")
    args = ap.parse_args(argv)
    import graphblas_tpu as gb
    from graphblas_tpu.core import semiring as SR
    from graphblas_tpu.ops.mxm import spmv_arrays

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 2
    peak = peak_for(dev.device_kind)
    gb.init()
    print(CS.gpu_info(), flush=True)
    base = {"device_kind": dev.device_kind, "platform": dev.platform,
            "device_count": len(jax.devices())}

    copy_bw = copy_bandwidth()
    print(json.dumps({**base, "metric": "copy_bytes_per_s",
                      "bytes_per_s": copy_bw,
                      "share_of_peak": copy_bw / peak["hbm_bytes_per_s"]}),
          flush=True)

    def emit(name, t, tmin, tmax, nbytes, **extra):
        print(json.dumps({
            **base, "metric": name, "time_s": t, "time_min_s": tmin,
            "time_max_s": tmax, "bytes": nbytes,
            "bytes_per_s": nbytes / t,
            "share_of_peak": nbytes / t / peak["hbm_bytes_per_s"],
            "share_of_copy": nbytes / t / copy_bw,
            "peak_source": peak["source"], **extra}), flush=True)

    sm = CS.Smoke(CS.Config())
    f = jax.jit(spmv_arrays, static_argnums=4)
    for name in ("kron", "urand"):
        g = sm.graph(name)
        for dt in (np.float32, np.float64):
            A = g.matrix(dt).to_format(gb.SPARSE, gb.ROW)
            ip, ix, v = A.indptr, A.indices, A._vals_expanded()
            x = jnp.ones((g.n,), dt)
            nnz = int(ix.shape[0])
            t, tmin, tmax = median_time(lambda: f(ip, ix, v, x, g.n))
            w = np.dtype(dt).itemsize
            metric = f"spmv_{name}_{np.dtype(dt).name}"
            emit(metric, t, tmin, tmax, spmv_bytes(g.n, g.n, nnz, w),
                 nnz=nnz, nnz_per_s=nnz / t)
            if args.trace:
                print(json.dumps({"trace": metric, "lines": traced(
                    args.trace, metric, lambda: f(ip, ix, v, x, g.n))}),
                    flush=True)
        sm.drop(name)

    g = sm.graph("spgemm")
    A = g.matrix(np.float32).to_format(gb.SPARSE, gb.ROW)
    deg = jnp.diff(A.indptr)
    products = int(jnp.sum(deg[A.indices].astype(jnp.int64)))
    C = gb.mxm(A, A, SR.PLUS_TIMES)
    t, tmin, tmax = median_time(lambda: gb.mxm(A, A, SR.PLUS_TIMES), 3)
    nnz_a, nnz_c = int(A.nvals), int(C.nvals)
    emit("spgemm_urand_float32", t, tmin, tmax,
         spgemm_bytes(g.n, nnz_a, products, nnz_c, 4), nnz_a=nnz_a,
         products=products, nnz_c=nnz_c, products_per_s=products / t,
         peak_bytes_in_use=(dev.memory_stats() or {}).get(
             "peak_bytes_in_use"))
    if args.trace:
        print(json.dumps({"trace": "spgemm_urand_float32", "lines": traced(
            args.trace, "spgemm", lambda: gb.mxm(A, A, SR.PLUS_TIMES))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
