"""Graph algorithms on the GraphBLAS op layer (LAGraph-style drivers;
BASELINE.json configs: BFS lor-land mxv, PageRank plus-times SpMV iteration,
triangle counting as masked plus-pair SpGEMM C<L>=L*U).

Two tiers per algorithm:
  * GrB tier — composed from public ops (mxv/vxm/select/reduce), proving
    the framework expresses the reference's idioms.
  * fused tier — one jax.jit'ed lax.while_loop over the raw CSR arrays
    using the same kernel substrate; the production path (no
    per-iteration host dispatch), used by chip_smoke.py and
    __graft_entry__.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import monoid as MON
from ..core import semiring as SR
from ..core import types as T
from ..core.descriptor import Descriptor
from ..core.matrix import BITMAP, COL, FULL, ROW, SPARSE, Matrix, Vector
from ..kernels import segment as K

# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------

def bfs_levels(A: Matrix, source: int) -> Vector:
    """Level-synchronous BFS via masked lor-land vxm (reference workload:
    BASELINE.json config 1).  Returns int32 levels (source=0), absent =
    unreached."""
    import graphblas_tpu as gb
    n = A.nrows
    levels = Vector.new(T.INT32, n, fmt=BITMAP)
    frontier = Vector.new(T.BOOL, n, fmt=BITMAP)
    frontier.bitmap = frontier.bitmap.at[source, 0].set(True)
    frontier.values = frontier.values.at[source, 0].set(True)
    depth = 0
    nvisited = 0
    while True:
        # levels<frontier> = depth
        lv, lp = levels.to_dense_pair()
        fb = frontier.bitmap[:, 0] & (frontier.values[:, 0] != 0)
        lv = jnp.where(fb[:, None], jnp.int32(depth), lv)
        lp = lp | fb[:, None]
        levels.values, levels.bitmap = lv, lp
        levels._nvals_cache = None
        now = int(jnp.sum(lp))
        if now == nvisited:
            break
        nvisited = now
        # frontier = (frontier' lor.land A) masked by !visited
        frontier = gb.vxm(frontier, A, SR.LOR_LAND, mask=levels,
                          desc=Descriptor(mask_complement=True,
                                          mask_structure=True, replace=True))
        depth += 1
    return levels


def bfs_parents(A: Matrix, source: int) -> Vector:
    """BFS parent tree via MIN_FIRSTJ vxm (positional semiring — the
    reference's GxB_MIN_FIRSTJ_INT64 BFS idiom)."""
    import graphblas_tpu as gb
    n = A.nrows
    parents = Vector.new(T.INT64, n, fmt=BITMAP)
    parents.bitmap = parents.bitmap.at[source, 0].set(True)
    parents.values = parents.values.at[source, 0].set(source)
    frontier = Vector.new(T.INT64, n, fmt=BITMAP)
    frontier.bitmap = frontier.bitmap.at[source, 0].set(True)
    frontier.values = frontier.values.at[source, 0].set(source)
    while True:
        frontier = gb.vxm(frontier, A, SR.MIN_FIRSTJ, mask=parents,
                          desc=Descriptor(mask_complement=True,
                                          mask_structure=True, replace=True))
        newf = int(jnp.sum(frontier.bitmap)) if frontier.fmt == BITMAP \
            else frontier.nvals
        if newf == 0:
            break
        parents = gb.ewise_add(parents, frontier, gb.operators.SECOND,
                               out_dtype=T.INT64)
    return parents


@functools.partial(jax.jit, static_argnums=(3,))
def _bfs_fused_kernel(indptr, indices, source, n):
    nnz = indices.shape[0]
    rows = K.expand_rowids(indptr, nnz, n)
    levels = jnp.full((n,), jnp.int32(-1)).at[source].set(0)
    frontier = jnp.zeros((n,), bool).at[source].set(True)

    def cond(state):
        _, frontier, depth = state
        return jnp.any(frontier)

    def body(state):
        levels, frontier, depth = state
        # next[j] = OR over edges (i,j) of frontier[i]  — scatter-or
        hits = frontier[rows]
        nxt = jnp.zeros((n,), bool).at[indices].max(hits)
        nxt = nxt & (levels < 0)
        levels = jnp.where(nxt, depth + 1, levels)
        return levels, nxt, depth + 1

    levels, _, _ = jax.lax.while_loop(cond, body,
                                      (levels, frontier, jnp.int32(0)))
    return levels


def bfs_levels_fused(A: Matrix, source: int):
    """One compiled while_loop; dense bool frontier (iso-bool frontier
    analog — SURVEY.md §7 'BFS frontiers are iso-bool').  Returns int32
    levels with -1 for unreached vertices."""
    Ar = A.to_format(SPARSE, ROW)
    return _bfs_fused_kernel(Ar.indptr, Ar.indices, jnp.int32(source),
                             A.nrows)


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------

def pagerank(A: Matrix, damping=0.85, tol=1e-6, max_iter=100):
    """PageRank via the GrB op layer (plus-times SpMV iteration;
    BASELINE.json config 2).  Returns a dense FP32/FP64 Vector."""
    import graphblas_tpu as gb
    n = A.nrows
    outdeg = gb.reduce(gb.apply(A, gb.operators.ONE, out_dtype=T.FP64),
                       MON.PLUS)
    dv, dp = outdeg.to_dense_1d()
    dv = jnp.where(dp, dv, 1.0)  # dangling: avoid div0 (handled via teleport)
    r = Vector.from_dense(jnp.full((n,), 1.0 / n))
    teleport = (1.0 - damping) / n
    for _ in range(max_iter):
        w = Vector.from_dense(r.values[:, 0] / dv)
        rn = gb.vxm(w, A, SR.PLUS_TIMES)
        rv, rp = rn.to_dense_1d()
        rv = damping * jnp.where(rp, rv, 0.0) + teleport
        # dangling mass redistributed uniformly
        dangling = jnp.sum(jnp.where(dp, 0.0, r.values[:, 0]))
        rv = rv + damping * dangling / n
        delta = float(jnp.sum(jnp.abs(rv - r.values[:, 0])))
        r = Vector.from_dense(rv)
        if delta < tol:
            break
    return r


@functools.partial(jax.jit, static_argnums=(3, 6))
def _pagerank_fused_kernel(indptr_t, indices_t, outdeg, n, damping, tol,
                           max_iter):
    """CSC-gather SpMV iteration: pr[j] = sum_i pr[i]/deg[i] over edges
    i->j; indptr_t/indices_t is A' in CSR (== A in CSC)."""
    nnz = indices_t.shape[0]
    segs = K.expand_rowids(indptr_t, nnz, n)  # destination-major segments
    srcs = indices_t
    r = jnp.full((n,), 1.0 / n, jnp.float32)
    teleport = jnp.float32((1.0 - damping) / n)
    safe_deg = jnp.where(outdeg > 0, outdeg, 1.0).astype(jnp.float32)

    def body(state):
        r, it, delta = state
        w = r / safe_deg
        contrib = w[srcs]
        rn = jax.ops.segment_sum(contrib, segs, n, indices_are_sorted=True)
        dangling = jnp.sum(jnp.where(outdeg > 0, 0.0, r))
        rn = damping * (rn + dangling / n) + teleport
        return rn, it + 1, jnp.sum(jnp.abs(rn - r))

    def cond(state):
        _, it, delta = state
        return (it < max_iter) & (delta > tol)

    r, iters, _ = jax.lax.while_loop(cond, body, (r, jnp.int32(0),
                                                  jnp.float32(np.inf)))
    return r, iters


def pagerank_fused(A: Matrix, damping=0.85, tol=1e-6, max_iter=100):
    """PageRank as one compiled while_loop over A in CSC (fp32).  Returns
    (ranks, iterations run)."""
    Ar = A.to_format(SPARSE, ROW)
    outdeg = jnp.diff(Ar.indptr).astype(jnp.float32)
    At = A.to_format(SPARSE, COL)  # A in CSC == A' in CSR
    return _pagerank_fused_kernel(At.indptr, At.indices, outdeg, A.nrows,
                                  jnp.float32(damping), jnp.float32(tol),
                                  max_iter)


# ---------------------------------------------------------------------------
# Triangle counting
# ---------------------------------------------------------------------------

def triangle_count(A: Matrix) -> int:
    """Sandia-style: ntri = sum(C) where C<L> = L*L' with plus_pair and L =
    tril(A) (BASELINE.json config 3; reference idiom: masked dot3 SpGEMM
    followed by GrB_reduce)."""
    import graphblas_tpu as gb
    from ..ops.transpose import logical_transpose
    # derived-structure cache per input pattern (the hyper-hash idiom,
    # reference GB_hyper_hash_build.c: build once, reuse while the
    # pattern lives): repeat counts skip the select + reorient entirely.
    # NOTE (ADVICE r4): the key is PATTERN identity only, so the cached
    # L/LT may carry the first-seen VALUES — valid here because PLUS_PAIR
    # is structural (values ignored); do not reuse this cache for any
    # value-dependent computation without adding id(A.values) to the key.
    ck = (id(A.indptr), id(A.indices))
    ent = _tc_cache.get(ck)
    if ent is not None and ent[0] is A.indptr and ent[1] is A.indices:
        L, LT = ent[2], ent[3]
    else:
        L = gb.select(A, gb.operators.TRIL, -1)
        LT = logical_transpose(L).to_format(SPARSE, ROW)   # L' materialized
        if len(_tc_cache) > 4:
            _tc_cache.clear()
        _tc_cache[ck] = (A.indptr, A.indices, L, LT)
    d = Descriptor(mask_structure=True)
    C = gb.mxm(L, LT, SR.PLUS_PAIR, mask=L, desc=d, out_dtype=T.INT64)
    return int(gb.reduce_scalar(C, MON.PLUS, out_dtype=T.INT64))


_tc_cache: dict = {}


# ---------------------------------------------------------------------------
# Connected components (FastSV) and SSSP (Bellman-Ford)
# ---------------------------------------------------------------------------

def connected_components(A: Matrix):
    """Connected components via FastSV (LAGraph algorithm; reference
    workload class: min_second semiring iteration).  Returns int32 labels
    (the minimum vertex id of each component).  A is treated as
    undirected: both edge directions are used."""
    Ar = A.to_format(SPARSE, ROW)
    n = A.nrows
    nnz = int(Ar.indices.shape[0])
    rows = K.expand_rowids(Ar.indptr, nnz, n)
    cols = Ar.indices
    return _cc_fused(rows, cols, n)


@functools.partial(jax.jit, static_argnums=(2,))
def _cc_fused(rows, cols, n):
    f = jnp.arange(n, dtype=jnp.int32)  # parent vector

    def body(state):
        f, changed = state
        # hook: f[u] = min over neighbors v of f[f[v]]  (grandparent hook)
        gf = f[f]
        cand_r = jnp.minimum(gf[rows], gf[cols])
        # scatter-min both directions
        fn_ = f.at[f[rows]].min(cand_r)
        fn_ = fn_.at[f[cols]].min(cand_r)
        fn_ = fn_.at[rows].min(cand_r)
        fn_ = fn_.at[cols].min(cand_r)
        # shortcut (pointer jumping)
        fn_ = fn_[fn_]
        return fn_, jnp.any(fn_ != f)

    def cond(state):
        return state[1]

    f, _ = jax.lax.while_loop(cond, body, (f, jnp.bool_(True)))
    return f


def sssp(A: Matrix, source: int, max_iter: int | None = None):
    """Single-source shortest paths via Bellman-Ford over the min-plus
    semiring (reference idiom: GrB_vxm with GrB_MIN_PLUS_SEMIRING in a
    loop).  Returns fp64 distances, inf where unreachable."""
    Ar = A.to_format(SPARSE, ROW)
    n = A.nrows
    nnz = int(Ar.indices.shape[0])
    rows = K.expand_rowids(Ar.indptr, nnz, n)
    return _sssp_fused(rows, Ar.indices, Ar._vals_expanded(), jnp.int32(source),
                       n, max_iter or n)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _sssp_fused(rows, cols, w, source, n, max_iter):
    dist = jnp.full((n,), jnp.inf, jnp.float64).at[source].set(0.0)
    w = w.astype(jnp.float64)

    def body(state):
        dist, it, changed = state
        relax = dist[rows] + w
        nd = dist.at[cols].min(relax)
        return nd, it + 1, jnp.any(nd < dist)

    def cond(state):
        _, it, changed = state
        return changed & (it < max_iter)

    dist, _, _ = jax.lax.while_loop(
        cond, body, (dist, jnp.int32(0), jnp.bool_(True)))
    return dist


def sssp_grb(A: Matrix, source: int):
    """GrB-tier SSSP: min-plus vxm iteration through the public op layer
    (proves the reference idiom composes; the fused tier is the fast
    path)."""
    import graphblas_tpu as gb
    n = A.nrows
    d = Vector.from_dense_masked(np.zeros(n), np.arange(n) == source)
    d = gb.apply(d, gb.operators.IDENTITY, out_dtype=T.FP64)
    while True:
        relaxed = gb.vxm(d, A, SR.MIN_PLUS, out_dtype=T.FP64)
        nd = gb.ewise_add(d, relaxed, gb.operators.MIN)
        if nd.isequal(d):
            break
        d = nd
    return d
