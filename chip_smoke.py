#!/usr/bin/env python3
"""Smoke test of graphblas_tpu on an NVIDIA GPU: drives the public API once
at GAP Benchmark Suite scale and checks every result against a host
reference computed independently (scipy / numpy in float64).

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --devices 4   # four cards: the sharded path only

Graphs are the two GAP synthetic classes, generated on the device from
``--seed`` with jax.random: ``kron`` (Graph500 Kronecker, A=.57 B=.19
C=.19, vertex ids permuted, symmetrized) and ``urand`` (uniform random,
symmetrized), both at scale 22 with edge factor 16 (4.2M vertices, about
134M stored entries).  Duplicate edges are summed by the build's
duplicate monoid, in the library and in the reference alike.

Phases on one card:
  build       Matrix.from_coo of both graphs in fp32 and fp64
  mxv         plus-times fp32/fp64 and min-plus fp32 SpMV on both graphs
  algorithms  bfs_levels_fused, bfs_levels, pagerank_fused, sssp and
              connected_components on kron
  spgemm      plus-times mxm on urand scale 20, degree 16 (not
              symmetrized: about 268M products)
  tc          triangle_count on kron scale 16
  ops         ewise_add, transpose, extract, masked assign and reduce on
              int64 urand scale 20 graphs (exact)
  dense       dense mxm: fp32 4096^2 (fails under TF32) and int64 1024^2

Every check prints one JSON line with its error, the tolerance and why,
the median wall time of the call ending in block_until_ready (the first,
compiling call separately), and the device's peak_bytes_in_use so far.
The last line is {"ok": true, "device": {...}} only when every check
passed.  With no GPU the script exits at once with status 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sps
from scipy.sparse import csgraph

import graphblas_tpu as gb
from graphblas_tpu import algorithms as alg
from graphblas_tpu import parallel as par
from graphblas_tpu.core import monoid as MON
from graphblas_tpu.core import semiring as SR
from graphblas_tpu.core.descriptor import Descriptor


@dataclasses.dataclass(frozen=True)
class Config:
    scale: int = 22          # kron / urand (GAP: kron and urand classes)
    edge_factor: int = 16
    spgemm_scale: int = 20
    tc_scale: int = 16
    ops_scale: int = 20
    dense_n: int = 4096
    dense_int_n: int = 1024
    pagerank_iters: int = 20
    reps: int = 3            # timed calls after the first
    seed: int = 0


# Small enough for the CPU tests; same code paths.
SMALL = Config(scale=10, spgemm_scale=8, tc_scale=8, ops_scale=8,
               dense_n=64, dense_int_n=32, pagerank_iters=10, reps=0)


# ---------------------------------------------------------------------------
# graph generators (on the device, from a seed)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def kron_edges(key, scale: int, edge_factor: int):
    """Graph500 Kronecker edges: one quadrant draw per bit level (A=.57,
    B=.19, C=.19, D=.05), then a random relabelling of the vertices so
    locality is not an artifact of the generator.  Returns int32 (src, dst,
    weight in (0, 1]) of n * edge_factor directed edges."""
    n = 1 << scale
    m = n * edge_factor
    a, ab, abc = 0.57, 0.57 + 0.19, 0.57 + 0.19 + 0.19

    def level(lvl, rc):
        r, c = rc
        u = jax.random.uniform(jax.random.fold_in(key, lvl), (m,))
        down = u >= ab                               # quadrant C or D
        right = ((u >= a) & (u < ab)) | (u >= abc)   # quadrant B or D
        return (r | (down.astype(jnp.int32) << lvl),
                c | (right.astype(jnp.int32) << lvl))

    z = jnp.zeros((m,), jnp.int32)
    r, c = jax.lax.fori_loop(0, scale, level, (z, z))
    perm = jax.random.permutation(jax.random.fold_in(key, scale), n)
    perm = perm.astype(jnp.int32)
    w = 1.0 - jax.random.uniform(jax.random.fold_in(key, scale + 1), (m,))
    return perm[r], perm[c], w


@functools.partial(jax.jit, static_argnums=(1, 2))
def urand_edges(key, scale: int, edge_factor: int):
    """Uniform random edges (the GAP urand class)."""
    n = 1 << scale
    m = n * edge_factor
    k1, k2, k3 = jax.random.split(key, 3)
    r = jax.random.randint(k1, (m,), 0, n, jnp.int32)
    c = jax.random.randint(k2, (m,), 0, n, jnp.int32)
    w = 1.0 - jax.random.uniform(k3, (m,))
    return r, c, w


class Graph:
    """Device edge list, the library matrices built from it, and the host
    reference (scipy CSR with float64 values, duplicates summed)."""

    def __init__(self, name, kind, scale, edge_factor, key, symmetric=True,
                 int_weights=False):
        gen = kron_edges if kind == "kron" else urand_edges
        t0 = time.perf_counter()
        r, c, w = gen(key, scale, edge_factor)
        if int_weights:
            w = jnp.floor(w * 9).astype(jnp.int64) + 1
        if symmetric:
            r, c, w = (jnp.concatenate([r, c]), jnp.concatenate([c, r]),
                       jnp.concatenate([w, w]))
        r.block_until_ready()
        self.gen_s = time.perf_counter() - t0
        self.name, self.n = name, 1 << scale
        self.rows, self.cols, self.w = r, c, w
        self._mats = {}
        self._ref = None

    def build(self, dtype):
        """Matrix.from_coo of the edge list, duplicates summed."""
        return gb.Matrix.from_coo(self.rows, self.cols, self.w.astype(dtype),
                                  (self.n, self.n), dup="plus")

    def matrix(self, dtype):
        if dtype not in self._mats:
            self._mats[dtype] = self.build(dtype)
        return self._mats[dtype]

    def ref(self):
        if self._ref is None:
            r, c, w = (np.asarray(a) for a in (self.rows, self.cols, self.w))
            dt = np.int64 if w.dtype.kind == "i" else np.float64
            S = sps.csr_matrix((w.astype(dt), (r, c)), shape=(self.n,) * 2)
            S.sum_duplicates()
            self._ref = S
        return self._ref


# ---------------------------------------------------------------------------
# the run: records, timing, comparisons
# ---------------------------------------------------------------------------

def _block(x):
    return jax.block_until_ready(x)


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Smoke:
    def __init__(self, cfg: Config, emit=None):
        self.cfg = cfg
        self.emit = emit or (lambda rec: None)
        self.records = []
        self._graphs = {}
        self._key = jax.random.key(cfg.seed)

    def key(self, name):
        return jax.random.fold_in(self._key,
                                  zlib.crc32(name.encode()) & 0x7FFFFFFF)

    def graph(self, name):
        """Graphs by name: kron, urand (scale, symmetric), spgemm (urand,
        not symmetric), tc (kron), ops_a / ops_b (int64 urand), dist_mxm
        (urand at the tc scale)."""
        if name not in self._graphs:
            c = self.cfg
            spec = {
                "kron": ("kron", c.scale, True, False),
                "urand": ("urand", c.scale, True, False),
                "spgemm": ("urand", c.spgemm_scale, False, False),
                "tc": ("kron", c.tc_scale, True, False),
                "ops_a": ("urand", c.ops_scale, False, True),
                "ops_b": ("urand", c.ops_scale, False, True),
                "dist_mxm": ("urand", c.tc_scale, True, False),
            }[name]
            kind, scale, sym, iw = spec
            self._graphs[name] = Graph(name, kind, scale, c.edge_factor,
                                       self.key(name), sym, iw)
        return self._graphs[name]

    def drop(self, name):
        self._graphs.pop(name, None)

    def timed(self, fn):
        """(result, timing) for fn(): the first call (which compiles) and
        the median of cfg.reps more, each ending in block_until_ready."""
        t0 = time.perf_counter()
        out = _block(fn())
        first = time.perf_counter() - t0
        ts = []
        for _ in range(self.cfg.reps):
            t0 = time.perf_counter()
            out = _block(fn())
            ts.append(time.perf_counter() - t0)
        return out, {"first_s": first,
                     "time_s": statistics.median(ts) if ts else first}

    def check(self, phase, case, err, tol, why="", timing=None, **extra):
        err = float(err)
        rec = {"phase": phase, "case": case, "ok": bool(err <= tol),
               "err": err, "tol": tol}
        if why:
            rec["tol_reason"] = why
        rec.update(timing or {})
        rec.update(extra)
        rec["peak_bytes_in_use"] = _peak_bytes()
        self.records.append(rec)
        self.emit(rec)
        return rec["ok"]

    def fail(self, phase, error):
        rec = {"phase": phase, "case": "exception", "ok": False,
               "error": error}
        self.records.append(rec)
        self.emit(rec)


def _np(x):
    return np.asarray(x)


def _csr(M):
    """(indptr, indices, values) host arrays of a library matrix as CSR."""
    S = M.to_format(gb.SPARSE, gb.ROW)
    return _np(S.indptr), _np(S.indices), _np(S._vals_expanded())


def _rel(got, want):
    """max |got - want| / max |want| over float arrays (0 when both are
    empty); inf on a shape mismatch."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if want.size == 0:
        return 0.0
    scale = max(np.abs(want).max(), np.finfo(np.float64).tiny)
    return float(np.abs(got - want).max() / scale)


def _csr_mismatch(got, S, exact):
    """Pattern mismatches (count) and value error of a library CSR triple
    against a canonical scipy CSR."""
    ip, ix, v = got
    if ip.shape != S.indptr.shape or not np.array_equal(ip, S.indptr):
        return float("inf")
    if not np.array_equal(ix, S.indices):
        return float("inf")
    if exact:
        return float(np.count_nonzero(v != S.data))
    return _rel(v, S.data)


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------

FP32_TOL = 1e-5
FP32_WHY = ("relative to max |ref|: fp32 values and sums; segment_sum "
            "accumulates with atomics in an order that changes per run")
FP64_TOL = 1e-12
FP64_WHY = ("relative to max |ref|: fp64 sums in another order than the "
            "reference; atomics reorder them from run to run")


def phase_build(sm: Smoke):
    for name in ("kron", "urand"):
        g = sm.graph(name)
        S = g.ref()
        for dt in (np.float32, np.float64):
            A, tm = sm.timed(lambda: g.build(dt))
            g._mats[dt] = A
            ip, ix, v = _csr(A)
            nv_err = abs(int(A.nvals) - S.nnz)
            pat = 0 if (np.array_equal(ip, S.indptr)
                        and np.array_equal(ix, S.indices)) else 1
            rows_sum = int(np.dot(np.diff(ip).astype(np.int64),
                                  np.arange(g.n, dtype=np.int64) % 1009))
            want_sum = int(np.dot(np.diff(S.indptr).astype(np.int64),
                                  np.arange(g.n, dtype=np.int64) % 1009))
            sm.check("build", f"{name}/{np.dtype(dt).name}/pattern",
                     nv_err + pat + abs(rows_sum - want_sum), 0,
                     "exact: nvals, indptr, indices and a row-count "
                     "checksum", tm, nvals=int(A.nvals), n=g.n,
                     gen_s=g.gen_s)
            tol, why = ((FP32_TOL, FP32_WHY) if dt == np.float32
                        else (FP64_TOL, FP64_WHY))
            sm.check("build", f"{name}/{np.dtype(dt).name}/values",
                     _rel(v, S.data), tol, why)


def phase_mxv(sm: Smoke):
    rng = np.random.default_rng(sm.cfg.seed)
    for name in ("kron", "urand"):
        g = sm.graph(name)
        S = g.ref()
        x = rng.random(g.n)
        present = np.diff(S.indptr) > 0
        cases = [("plus_times", np.float32, SR.PLUS_TIMES),
                 ("plus_times", np.float64, SR.PLUS_TIMES),
                 ("min_plus", np.float32, SR.MIN_PLUS)]
        for sname, dt, sr in cases:
            A = g.matrix(dt)
            u = gb.Vector.from_dense(x.astype(dt))
            w, tm = sm.timed(lambda: gb.mxv(A, u, sr))
            y, p = (_np(a) for a in w.to_dense_1d())
            if sname == "plus_times":
                want = S @ x.astype(dt).astype(np.float64)
            else:
                want = np.full(g.n, np.inf)
                prod = _np(A._vals_expanded()).astype(np.float64) \
                    + x.astype(dt).astype(np.float64)[S.indices]
                starts = S.indptr[:-1][present]
                want[present] = np.minimum.reduceat(prod, starts)
            err = float("inf") if not np.array_equal(p, present) \
                else _rel(y[present], want[present])
            tol, why = ((FP32_TOL, FP32_WHY) if dt == np.float32
                        else (FP64_TOL, FP64_WHY))
            sm.check("mxv", f"{name}/{sname}/{np.dtype(dt).name}", err,
                     tol, why, tm, nnz=int(S.nnz))
    sm.drop("urand")


def _bfs_ref(S, src):
    """BFS levels (-1 unreached) from scipy's BFS tree."""
    order, pred = csgraph.breadth_first_order(S, src, directed=True,
                                              return_predecessors=True)
    lev = np.full(S.shape[0], -1, np.int64)
    lev[src] = 0
    todo = order[1:]
    while todo.size:
        pl = lev[pred[todo]]
        done = pl >= 0
        lev[todo[done]] = pl[done] + 1
        todo = todo[~done]
    return lev


def phase_algorithms(sm: Smoke):
    g = sm.graph("kron")
    S = g.ref()
    deg = np.diff(S.indptr)
    cand = np.random.default_rng(sm.cfg.seed).permutation(g.n)
    src = int(cand[np.argmax(deg[cand] > 0)])
    A = g.matrix(np.float32)
    lev_ref = _bfs_ref(S, src)

    lev, tm = sm.timed(lambda: alg.bfs_levels_fused(A, src))
    sm.check("algorithms", "kron/bfs_levels_fused",
             np.count_nonzero(_np(lev) != lev_ref), 0, "exact", tm,
             source=src, depth=int(lev_ref.max()))

    lv, tm = sm.timed(lambda: alg.bfs_levels(A, src))
    v, p = (_np(a) for a in lv.to_dense_1d())
    got = np.where(p, v, -1)
    sm.check("algorithms", "kron/bfs_levels", np.count_nonzero(
        got != lev_ref), 0, "exact", tm, source=src)

    iters = sm.cfg.pagerank_iters
    (r, it), tm = sm.timed(lambda: alg.pagerank_fused(
        A, damping=0.85, tol=0.0, max_iter=iters))
    it = int(it)
    P = sps.csr_matrix((np.ones(S.nnz), S.indices, S.indptr), S.shape)
    outdeg = deg.astype(np.float64)
    safe = np.where(outdeg > 0, outdeg, 1.0)
    rr = np.full(g.n, 1.0 / g.n)
    for _ in range(it):
        dang = rr[outdeg == 0].sum()
        rr = 0.85 * (P.T @ (rr / safe) + dang / g.n) + 0.15 / g.n
    sm.check("algorithms", "kron/pagerank_fused",
             np.abs(_np(r).astype(np.float64) - rr).sum(), 1e-5,
             "L1 against float64 power iteration: fp32 ranks and sums",
             tm, iters=it)

    A64 = g.matrix(np.float64)
    d, tm = sm.timed(lambda: alg.sssp(A64, src))
    d = _np(d)
    dref = csgraph.dijkstra(S, directed=True, indices=src)
    fin = np.isfinite(dref)
    err = float("inf") if not np.array_equal(np.isfinite(d), fin) \
        else _rel(d[fin], dref[fin])
    sm.check("algorithms", "kron/sssp", err, 1e-12,
             "relative: the same fp64 path sums in the same order; only "
             "ties may differ", tm)

    lab, tm = sm.timed(lambda: alg.connected_components(A))
    _, cl = csgraph.connected_components(S, directed=False)
    _, first = np.unique(cl, return_index=True)   # min vertex per label
    want = first[np.searchsorted(np.unique(cl), cl)]
    sm.check("algorithms", "kron/connected_components",
             np.count_nonzero(_np(lab) != want), 0, "exact", tm,
             components=int(first.size))


def phase_spgemm(sm: Smoke):
    g = sm.graph("spgemm")
    A = g.matrix(np.float32)
    C, tm = sm.timed(lambda: gb.mxm(A, A, SR.PLUS_TIMES))
    got = _csr(C)
    S = g.ref()
    S32 = S.astype(np.float32).astype(np.float64)
    R = S32 @ S32
    R.sum_duplicates()
    R.sort_indices()
    nnzA = S.nnz
    flops = int(np.diff(S.indptr)[S.indices].sum())
    sm.check("spgemm", "urand/plus_times/fp32", _csr_mismatch(got, R, False),
             FP32_TOL, FP32_WHY + "; pattern exact", tm, nnz_a=int(nnzA),
             products=flops, nvals=int(C.nvals))
    sm.drop("spgemm")


def phase_tc(sm: Smoke):
    g = sm.graph("tc")
    A = g.matrix(np.float32)
    ntri, tm = sm.timed(lambda: alg.triangle_count(A))
    S = g.ref()
    L = sps.tril(S, -1, format="csr")
    L.data = np.ones_like(L.data, np.int64)
    LT = L.T.tocsr()
    want = 0
    for r0 in range(0, g.n, 1 << 14):       # bounds the L @ L' rows alive
        Lb = L[r0:r0 + (1 << 14)]
        want += int((Lb @ LT).multiply(Lb).sum())
    sm.check("tc", "kron/triangle_count", abs(int(ntri) - want), 0, "exact",
             tm, triangles=want)
    sm.drop("tc")


def phase_ops(sm: Smoke):
    ga, gbb = sm.graph("ops_a"), sm.graph("ops_b")
    A, B = ga.matrix(np.int64), gbb.matrix(np.int64)
    SA, SB = ga.ref(), gbb.ref()
    n = ga.n
    exact = "exact (int64)"

    C, tm = sm.timed(lambda: gb.ewise_add(A, B, gb.operators.PLUS))
    R = (SA + SB).tocsr()
    R.sort_indices()
    sm.check("ops", "ewise_add", _csr_mismatch(_csr(C), R, True), 0, exact,
             tm)

    T, tm = sm.timed(lambda: gb.transpose(A))
    R = SA.T.tocsr()
    R.sort_indices()
    sm.check("ops", "transpose", _csr_mismatch(_csr(T), R, True), 0, exact,
             tm)

    rng = np.random.default_rng(sm.cfg.seed)
    k = n // 4
    I = np.sort(rng.choice(n, k, replace=False))
    J = np.sort(rng.choice(n, k, replace=False))
    E_, tm = sm.timed(lambda: gb.extract(A, I, J))
    R = SA[I][:, J].tocsr()
    R.sort_indices()
    sm.check("ops", "extract", _csr_mismatch(_csr(E_), R, True), 0, exact,
             tm)

    w, tm = sm.timed(lambda: gb.reduce(A, MON.PLUS))
    v, p = (_np(a) for a in w.to_dense_1d())
    rs = np.asarray(SA.sum(axis=1)).ravel()
    pres = np.diff(SA.indptr) > 0
    sm.check("ops", "reduce_rows", (0 if np.array_equal(p, pres) else 1)
             + np.count_nonzero(v[pres] != rs[pres]), 0, exact, tm)

    # C<M>(I,J) = B(I,J) with C = A and a structural mask M = pattern(B)
    Bsub = gb.extract(B, I, J)
    d = Descriptor(mask_structure=True)
    C, tm = sm.timed(lambda: gb.assign(A.dup(), Bsub, I, J, mask=B, desc=d))
    ca = SA.tocoo()
    ck = ca.row.astype(np.int64) * n + ca.col
    mk = np.sort(SB.tocoo().row.astype(np.int64) * n + SB.tocoo().col)
    in_i = np.zeros(n, bool)
    in_i[I] = True
    in_j = np.zeros(n, bool)
    in_j[J] = True
    keep_c = ~(in_i[ca.row] & in_j[ca.col]) | ~np.isin(ck, mk)
    sub = SB[I][:, J].tocoo()
    ak = I[sub.row].astype(np.int64) * n + J[sub.col]
    keep_a = np.isin(ak, mk)
    keys = np.concatenate([ck[keep_c], ak[keep_a]])
    vals = np.concatenate([ca.data[keep_c], sub.data[keep_a]])
    R = sps.csr_matrix((vals, (keys // n, keys % n)), shape=(n, n))
    R.sort_indices()
    sm.check("ops", "assign_masked", _csr_mismatch(_csr(C), R, True), 0,
             exact, tm)
    sm.drop("ops_a")
    sm.drop("ops_b")


def phase_dense(sm: Smoke):
    rng = np.random.default_rng(sm.cfg.seed)
    n = sm.cfg.dense_n
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A, B = gb.Matrix.from_dense(a), gb.Matrix.from_dense(b)
    C, tm = sm.timed(lambda: gb.mxm(A, B, SR.PLUS_TIMES))
    want = a.astype(np.float64) @ b.astype(np.float64)
    sm.check("dense", f"fp32/{n}", _rel(_np(C.to_dense_pair()[0]), want),
             1e-5, "relative to max |ref|: fp32 accumulation; TF32 would "
             "give ~1e-3", tm)
    n = sm.cfg.dense_int_n
    a = rng.integers(-50, 50, (n, n)).astype(np.int64)
    b = rng.integers(-50, 50, (n, n)).astype(np.int64)
    A, B = gb.Matrix.from_dense(a), gb.Matrix.from_dense(b)
    C, tm = sm.timed(lambda: gb.mxm(A, B, SR.PLUS_TIMES))
    sm.check("dense", f"int64/{n}", np.count_nonzero(
        _np(C.to_dense_pair()[0]) != a @ b), 0, "exact", tm)


# ---------------------------------------------------------------------------
# four cards: the sharded path against the same calls on one card
# ---------------------------------------------------------------------------

def _shards_ok(arrays, ndev):
    """Number of problems with the placement: every array must have one
    shard on each of ndev distinct devices."""
    bad = 0
    for a in arrays:
        devs = [s.device for s in a.addressable_shards]
        bad += int(len(set(devs)) != ndev or len(devs) != ndev)
    return bad


def _dist_to_csr(D):
    ip, ix, vl, nz = (_np(a) for a in (D.indptr, D.indices, D.values, D.nnz))
    rows, cols, vals = [], [], []
    for d in range(D.ndev):
        k = int(nz[d])
        r = np.repeat(np.arange(D.rows_per), np.diff(ip[d]))[:k]
        rows.append(r + d * D.rows_per)
        cols.append(ix[d, :k])
        vals.append(vl[d, :k])
    m = D.shape[0]
    R = sps.csr_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(D.ndev * D.rows_per, D.shape[1]))[:m]
    R.sort_indices()
    return R


def phase_dist(sm: Smoke, ndev=4):
    if len(jax.devices()) < ndev:
        raise RuntimeError(f"--devices {ndev}: only {len(jax.devices())}")
    g = sm.graph("kron")
    A = g.matrix(np.float32)
    mesh = par.make_mesh(ndev)
    D, tm = sm.timed(lambda: par.DistMatrix.from_matrix(A, mesh))
    sm.check("dist", "placement", _shards_ok(
        (D.indptr, D.indices, D.values, D.nnz), ndev), 0,
        "one shard per card", tm,
        devices=[str(d) for d in mesh.devices.flat])
    rng = np.random.default_rng(sm.cfg.seed)
    x = rng.random(g.n).astype(np.float32)
    u = gb.Vector.from_dense(x)
    ip = _np(A.to_format(gb.SPARSE, gb.ROW).indptr)
    present = np.diff(ip) > 0

    w = gb.mxv(A, u, SR.PLUS_TIMES)
    y1 = np.where(present, _np(w.to_dense_1d()[0]), 0)
    for overlap in (False, True):
        y, tm = sm.timed(lambda: par.dist_mxv(D, x, overlap=overlap))
        sm.check("dist", f"dist_mxv/overlap={overlap}", _rel(_np(y), y1),
                 FP32_TOL, FP32_WHY, tm)

    wv = gb.vxm(u, A, SR.PLUS_TIMES)
    v, p = (_np(a) for a in wv.to_dense_1d())
    y, tm = sm.timed(lambda: par.dist_vxm(D, x))
    sm.check("dist", "dist_vxm", _rel(_np(y), np.where(p, v, 0)), FP32_TOL,
             FP32_WHY, tm)

    deg = np.diff(ip)
    src = int(np.random.default_rng(sm.cfg.seed).permutation(g.n)[0])
    src = src if deg[src] else int(np.argmax(deg))
    lev1 = _np(alg.bfs_levels_fused(A, src))
    lev, tm = sm.timed(lambda: par.dist_bfs_levels(D, src))
    sm.check("dist", "dist_bfs_levels", np.count_nonzero(_np(lev) != lev1),
             0, "exact", tm, source=src)

    iters = sm.cfg.pagerank_iters
    r1, _ = alg.pagerank_fused(A, tol=0.0, max_iter=iters)
    r, tm = sm.timed(lambda: par.dist_pagerank(D, tol=0.0, max_iter=iters))
    sm.check("dist", "dist_pagerank", np.abs(_np(r) - _np(r1)).sum(), 1e-5,
             "L1: fp32 sums in another order", tm)

    mesh2 = par.make_mesh_2d(2, ndev // 2)
    D2 = par.DistMatrix2D.from_matrix(A, mesh2)
    bad = _shards_ok((D2.indptr, D2.indices, D2.values, D2.nnz), ndev)
    y, tm = sm.timed(lambda: par.dist_mxv_2d(D2, x))
    err = _rel(_np(y), y1) if not bad else float("inf")
    sm.check("dist", "dist_mxv_2d", err, FP32_TOL, FP32_WHY, tm)

    gt = sm.graph("dist_mxm")
    At = gt.matrix(np.float32)
    Dt = par.DistMatrix.from_matrix(At, mesh)
    C1 = gb.mxm(At, At, SR.PLUS_TIMES)
    ip1, ix1, v1 = _csr(C1)
    R1 = sps.csr_matrix((v1.astype(np.float64), ix1, ip1), C1.shape)
    DC, tm = sm.timed(lambda: par.dist_mxm(Dt, Dt))
    R = _dist_to_csr(DC)
    err = _csr_mismatch((R.indptr, R.indices, R.data), R1, False)
    sm.check("dist", f"dist_mxm/urand{sm.cfg.tc_scale}", err, FP32_TOL, FP32_WHY, tm,
             nvals=int(R1.nnz))


PHASES = {"build": phase_build, "mxv": phase_mxv,
          "algorithms": phase_algorithms, "spgemm": phase_spgemm,
          "tc": phase_tc, "ops": phase_ops, "dense": phase_dense}


def run(cfg: Config, phases, emit=None):
    """Run the named phases; returns the records (a phase that raises is
    recorded as failed and the next one runs)."""
    fns = dict(PHASES, dist=phase_dist)
    sm = Smoke(cfg, emit)
    for name in phases:
        try:
            fns[name](sm)
        except Exception:
            traceback.print_exc()
            sm.fail(name, traceback.format_exc(limit=1).strip()[-500:])
    return sm.records


def gpu_info():
    """name and power limit of the card as nvidia-smi reports them (a child
    process that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the sharded path on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    from graphblas_tpu.utils import native
    gb.init()

    def emit(rec):
        print(json.dumps(rec), flush=True)

    print(gpu_info(), flush=True)
    emit({"gpu": gpu_info(), "jax": jax.__version__,
          "xla_flags": os.environ.get("XLA_FLAGS", ""),
          "native_library": native.available(),
          "compilation_cache_dir": jax.config.jax_compilation_cache_dir})
    cfg = dataclasses.replace(Config(), seed=args.seed)
    phases = ["dist"] if args.devices == 4 else list(PHASES)
    t0 = time.perf_counter()
    recs = run(cfg, phases, emit)
    ok = bool(recs) and all(r["ok"] for r in recs)
    emit({"summary": True, "checks": len(recs),
          "failed": [f"{r['phase']}/{r['case']}" for r in recs
                     if not r["ok"]],
          "wall_s": time.perf_counter() - t0, "gpu": gpu_info()})
    if not ok:
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
