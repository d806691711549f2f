"""Vectorized sparse primitives: this package's counterpart of the reference's
task-slicing + template-kernel machinery.

The reference parallelizes with coarse/fine task lists over OpenMP threads
(Source/GB_ek_slice.c, Source/Template/GB_task_struct.h).  Here the same
work-items become fully vectorized array programs: rowid expansion replaces
ek_slice, segmented reduction (native jax.ops.segment_* fast paths + a
generic associative-scan path for arbitrary monoids) replaces the reduction
templates, and a stable-sort union-merge replaces the GB_add/GB_emult
3-phase merge (Source/GB_add.h:34-94).  XLA compiles these for the
device.

Ops with data-dependent output sizes follow the reference's own two-phase
(symbolic count / numeric fill) structure, with a single host sync of the
count in between — see ``unique_count`` / ``compact``.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core import monoid as M
from ..core.monoid import Monoid

KEY = jnp.int64  # combined (i, j) sort key: i * ncols + j


def expand_rowids(indptr, nnz: int, nvec: int):
    """Vector id of each stored entry, from the CSR/CSC pointer array.
    (reference: implicit in every ek_slice'd kernel).

    Marks+cumsum formulation: +1 at each interior row start, inclusive
    scan (chosen over jnp.repeat; scatter positions collide only at
    empty-row runs, bounded by nvec not nnz)."""
    if nnz == 0:
        return jnp.zeros(0, indptr.dtype)
    if nvec == 0:
        return jnp.zeros(nnz, indptr.dtype)
    marks = jnp.zeros((nnz,), jnp.int32).at[indptr[1:-1]].add(
        1, mode="drop")
    return jnp.cumsum(marks).astype(indptr.dtype)


def indptr_from_sorted(vec_ids, nvec: int, dtype=jnp.int32):
    """Build an indptr array from sorted vector ids (the cumsum step of
    GB_builder, reference: Source/GB_builder.c step 4).  Sorted
    segment-sum histogram, chosen over a random scatter-add whose
    colliding updates serialize."""
    counts = histogram_sorted(vec_ids, nvec)
    return jnp.concatenate([jnp.zeros(1, jnp.int64),
                            jnp.cumsum(counts)]).astype(dtype)


def histogram_sorted(vec_ids, nvec: int, weights=None):
    """Per-id counts for SORTED ids via segment_sum(indices_are_sorted).
    Ids beyond nvec-1 (sentinels at the tail) clip to an extra bucket
    that is sliced off, preserving sortedness."""
    w = weights if weights is not None \
        else jnp.ones(vec_ids.shape[0], jnp.int32)
    ids = jnp.minimum(vec_ids, nvec)
    return jax.ops.segment_sum(w, ids, nvec + 1,
                               indices_are_sorted=True)[:nvec] \
        .astype(jnp.int64)


def combined_key(rows, cols, ncols: int, by_row: bool = True):
    """Lexicographic (vec, idx) key packed into int64."""
    r = rows.astype(KEY)
    c = cols.astype(KEY)
    return r * ncols + c if by_row else c * 0  # caller passes pre-swapped


def make_key(vec_ids, idx, veclen: int):
    return vec_ids.astype(KEY) * veclen + idx.astype(KEY)


def key_split(keys, veclen: int):
    return (keys // veclen).astype(jnp.int32), (keys % veclen).astype(jnp.int32)


# ---------------------------------------------------------------------------
# segmented reduction
# ---------------------------------------------------------------------------

_NATIVE = {
    "GrB_PLUS": jax.ops.segment_sum,
    "GrB_TIMES": jax.ops.segment_prod,
    "GrB_MIN": jax.ops.segment_min,
    "GrB_MAX": jax.ops.segment_max,
}


def segment_reduce(vals, seg_ids, num_segments: int, monoid: Monoid,
                   indices_are_sorted: bool = True):
    """Reduce ``vals`` by segment under an arbitrary monoid.

    Fast path: XLA-native segment ops for PLUS/TIMES/MIN/MAX and the boolean
    monoids (reference analog: factory kernels for built-in monoids).
    Generic path: inclusive segmented associative scan — works for ANY
    associative operator, replacing the reference's "generic" function-
    pointer kernels (reference: Source/GB_reduce_to_scalar.c:326) at full
    vector speed.

    Empty segments get the monoid identity.
    """
    dt = vals.dtype
    n = vals.shape[0]
    tail = vals.shape[1:]
    ident = jnp.asarray(monoid.identity_for(dt), dt)
    if n == 0:
        return jnp.full((num_segments,) + tail, ident)
    name = monoid.op.name
    if dt == jnp.bool_ and name in ("GrB_PLUS", "GrB_MAX"):
        # boolean arithmetic collapses: plus == max == lor on bool
        # (reference: GB_ops.c boolean monoid renames)
        name = "GrB_LOR"
    elif dt == jnp.bool_ and name in ("GrB_TIMES", "GrB_MIN"):
        name = "GrB_LAND"
    if name in _NATIVE:
        if name in ("GrB_MIN", "GrB_MAX") and np.issubdtype(dt, np.floating):
            # native segment_min/max propagate NaN; GraphBLAS MIN/MAX are
            # omitnan — substitute identity for NaN inputs first.
            vals = jnp.where(jnp.isnan(vals), ident, vals)
        out = _NATIVE[name](vals, seg_ids, num_segments,
                            indices_are_sorted=indices_are_sorted)
        if name in ("GrB_MIN", "GrB_MAX"):
            # empty segments: segment_min yields +huge; that equals identity
            # already for MIN; for MAX likewise. Nothing to fix.
            pass
        return out.astype(dt)
    if name == "GrB_LOR":
        out = jax.ops.segment_max((vals != 0).astype(jnp.int32), seg_ids,
                                  num_segments,
                                  indices_are_sorted=indices_are_sorted)
        return (out > 0).astype(dt) if dt != jnp.bool_ else out > 0
    if name == "GrB_LAND":
        out = jax.ops.segment_min((vals != 0).astype(jnp.int32), seg_ids,
                                  num_segments,
                                  indices_are_sorted=indices_are_sorted)
        has = jax.ops.segment_sum(jnp.ones(vals.shape[0], jnp.int32), seg_ids,
                                  num_segments,
                                  indices_are_sorted=indices_are_sorted)
        out = jnp.where(has > 0, out, 1)  # empty segment -> identity (true)
        return (out > 0).astype(dt) if dt != jnp.bool_ else out > 0
    if name == "GrB_LXOR":
        out = jax.ops.segment_sum((vals != 0).astype(jnp.int32), seg_ids,
                                  num_segments,
                                  indices_are_sorted=indices_are_sorted) % 2
        return (out > 0).astype(dt) if dt != jnp.bool_ else out > 0
    if name == "GxB_ANY":
        # deterministic "any": take the max for reproducibility
        if np.issubdtype(dt, np.bool_):
            out = jax.ops.segment_max(vals.astype(jnp.int32), seg_ids,
                                      num_segments,
                                      indices_are_sorted=indices_are_sorted)
            return out > 0
        return jax.ops.segment_max(vals, seg_ids, num_segments,
                                   indices_are_sorted=indices_are_sorted)
    # ---- generic path: segmented associative scan -------------------------
    if not indices_are_sorted:
        order = jnp.argsort(seg_ids, stable=True)
        seg_ids, vals = seg_ids[order], vals[order]
    flags = jnp.concatenate([jnp.ones(1, bool), seg_ids[1:] != seg_ids[:-1]])
    op = monoid.op
    expand = (Ellipsis,) + (None,) * (vals.ndim - 1)

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return (fa | fb, jnp.where(fb[expand], vb, op(va, vb).astype(dt)))

    _, scanned = jax.lax.associative_scan(combine, (flags, vals))
    is_last = jnp.concatenate([seg_ids[1:] != seg_ids[:-1],
                               jnp.ones(1, bool)])
    out = jnp.full((num_segments,) + tail, ident)
    tgt = jnp.where(is_last, seg_ids, num_segments)  # dropped when not last
    return out.at[tgt].set(scanned, mode="drop")


def full_reduce(vals, monoid: Monoid, dtype=None, field_ndim: int = 0):
    """Reduce a whole array under a monoid (GrB_reduce to scalar).
    ``field_ndim`` > 0: the trailing dims are struct fields — reduce over
    the entry axes only (user-defined struct types)."""
    dt = dtype or vals.dtype
    if field_ndim:
        ts = vals.shape[vals.ndim - field_ndim:]
        flat = vals.reshape((-1,) + ts).astype(dt)
        if flat.shape[0] == 0:
            return jnp.broadcast_to(
                jnp.asarray(monoid.identity_for(dt), dt), ts)
        seg = jnp.zeros(flat.shape[0], jnp.int32)
        return segment_reduce(flat, seg, 1, monoid)[0]
    vals = vals.reshape(-1).astype(dt)
    ident = jnp.asarray(monoid.identity_for(dt), dt)
    if vals.shape[0] == 0:
        return ident
    name = monoid.op.name
    if name == "GrB_PLUS":
        return jnp.sum(vals)
    if name == "GrB_TIMES":
        return jnp.prod(vals)
    if name == "GrB_MIN":
        if np.issubdtype(np.dtype(dt), np.floating):
            vals = jnp.where(jnp.isnan(vals), ident, vals)
        return jnp.min(vals)
    if name == "GrB_MAX":
        if np.issubdtype(np.dtype(dt), np.floating):
            vals = jnp.where(jnp.isnan(vals), ident, vals)
        return jnp.max(vals)
    if name == "GrB_LOR":
        return jnp.any(vals != 0).astype(dt)
    if name == "GrB_LAND":
        return jnp.all(vals != 0).astype(dt)
    if name == "GrB_LXOR":
        return (jnp.sum((vals != 0).astype(jnp.int32)) % 2).astype(dt)
    if name == "GxB_ANY":
        return jnp.max(vals)
    # generic log-depth tree reduction via associative scan
    seg = jnp.zeros(vals.shape[0], jnp.int32)
    return segment_reduce(vals, seg, 1, monoid)[0]


# ---------------------------------------------------------------------------
# sorting / building
# ---------------------------------------------------------------------------

def sort_coo(vec_ids, idx, veclen: int):
    """Stable sort of COO entries by (vec, idx); returns (order, sorted_vec,
    sorted_idx).  The parallel-sort step of GB_builder (reference:
    Source/GB_builder.c step 2, GB_msort_2)."""
    keys = make_key(vec_ids, idx, veclen)
    order = jnp.argsort(keys, stable=True)
    skeys = keys[order]
    return order, skeys


def sort_with_payload(keys, vals):
    """(sorted keys, correspondingly-permuted vals) via ONE fused
    lax.sort with the value bits riding as a payload operand — avoids the
    random post-sort gather.  Falls back
    to argsort + gather for payloads that cannot bit-ride (structs)."""
    bits, _w = _ride_encode(vals)
    if bits is not None:
        skeys, sbits = jax.lax.sort((keys, bits), num_keys=1)
        return skeys, _ride_decode(sbits, vals.dtype)
    order = jnp.argsort(keys, stable=True)
    return keys[order], vals[order]


# ---------------------------------------------------------------------------
# two-phase (symbolic/numeric) helpers — host syncs the count
# ---------------------------------------------------------------------------

@jax.jit
def _group_ids(sorted_keys):
    if sorted_keys.shape[0] == 0:
        return sorted_keys.astype(jnp.int32), jnp.zeros((), jnp.int32)
    is_new = jnp.concatenate([jnp.ones(1, bool),
                              sorted_keys[1:] != sorted_keys[:-1]])
    gid = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    return gid, gid[-1] + 1


def group_ids(sorted_keys):
    """(group_id per element, num_groups host int)."""
    gid, n = _group_ids(sorted_keys)
    return gid, int(n)


@functools.partial(jax.jit, static_argnums=(1,))
def _compact_gather(mask, out_n):
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    src = jnp.full((out_n,), -1, jnp.int32)
    tgt = jnp.where(mask, pos, out_n)
    n = mask.shape[0]
    src = src.at[tgt].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    return src


def compact(mask, *arrays):
    """Keep elements where mask; returns (count, gathered arrays).  The
    zombie-free deletion path: reference kills zombies with GB_selector
    (Source/GB_wait.c), we compact."""
    cnt = int(jnp.sum(mask))
    if cnt == 0:
        return 0, tuple(a[:0] for a in arrays)
    src = _compact_gather(mask, cnt)
    return cnt, tuple(a[src] for a in arrays)


def lookup_sorted(sorted_keys, queries):
    """(found, pos) of each query in a sorted key array — the hyper-hash /
    binary-search lookup (reference: Source/Shared/GB_hyper_hash_lookup.h)."""
    n = sorted_keys.shape[0]
    if n == 0:
        return jnp.zeros(queries.shape, bool), jnp.zeros(queries.shape, jnp.int32)
    pos = jnp.searchsorted(sorted_keys, queries).astype(jnp.int32)
    safe = jnp.minimum(pos, n - 1)
    found = (pos < n) & (sorted_keys[safe] == queries)
    return found, safe


# ---------------------------------------------------------------------------
# union merge — the engine behind eWiseAdd / eWiseMult / eWiseUnion / masker
# ---------------------------------------------------------------------------

@jax.jit
def _merge_phase1(keysA, keysB):
    # one argsort of nA+nB int64 keys merges two sorted patterns; a
    # searchsorted-based rank merge was far slower on the previous
    # accelerator (binary-search gathers)
    nA = keysA.shape[0]
    keys = jnp.concatenate([keysA, keysB])
    order = jnp.argsort(keys, stable=True)
    skeys = keys[order]
    tag_b = order >= nA
    if skeys.shape[0] == 0:
        return order, skeys, tag_b, jnp.zeros(0, jnp.int32), jnp.zeros((), jnp.int32)
    is_new = jnp.concatenate([jnp.ones(1, bool), skeys[1:] != skeys[:-1]])
    gid = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    return order, skeys, tag_b, gid, gid[-1] + 1


@functools.partial(jax.jit, static_argnums=(6,))
def _merge_phase2(order, skeys, tag_b, gid, valsA, valsB, ng):
    nA = valsA.shape[0]
    # gather each element's value from its source array
    posA = jnp.clip(order, 0, max(nA - 1, 0))
    posB = jnp.clip(order - nA, 0, max(valsB.shape[0] - 1, 0))
    trailA = valsA.shape[1:]       # struct-type trailing field dims
    trailB = valsB.shape[1:]
    va = valsA[posA] if nA else jnp.zeros(order.shape + trailA,
                                          valsA.dtype)
    vb = valsB[posB] if valsB.shape[0] else jnp.zeros(
        order.shape + trailB, valsB.dtype)
    drop = ng  # out-of-range target -> dropped
    tgtA = jnp.where(~tag_b, gid, drop)
    tgtB = jnp.where(tag_b, gid, drop)
    outA = jnp.zeros((ng,) + trailA, valsA.dtype).at[tgtA].set(
        va, mode="drop")
    outB = jnp.zeros((ng,) + trailB, valsB.dtype).at[tgtB].set(
        vb, mode="drop")
    inA = jnp.zeros((ng,), bool).at[tgtA].set(True, mode="drop")
    inB = jnp.zeros((ng,), bool).at[tgtB].set(True, mode="drop")
    # duplicate writes carry equal keys, so write order is immaterial
    ukeys = jnp.zeros((ng,), skeys.dtype).at[gid].set(skeys, mode="drop")
    return ukeys, outA, outB, inA, inB


def _ride_encode(v):
    """Encode values as a sort-payload int plane (pattern- or value-
    preserving, reversible by _ride_decode).  Returns (bits, width) or
    (None, 0) for dtypes that cannot ride (struct/complex)."""
    dt = v.dtype
    if v.ndim != 1:
        return None, 0
    if dt == jnp.float32:
        return jax.lax.bitcast_convert_type(v, jnp.int32), 32
    if dt in (jnp.dtype(jnp.int32), jnp.dtype(jnp.uint32)):
        return jax.lax.bitcast_convert_type(v, jnp.int32), 32
    if dt in (jnp.dtype(jnp.bool_), jnp.dtype(jnp.int8),
              jnp.dtype(jnp.uint8), jnp.dtype(jnp.int16),
              jnp.dtype(jnp.uint16)):
        return v.astype(jnp.int32), 32
    if dt == jnp.float64:
        return jax.lax.bitcast_convert_type(v, jnp.int64), 64
    if dt in (jnp.dtype(jnp.int64), jnp.dtype(jnp.uint64)):
        return jax.lax.bitcast_convert_type(v, jnp.int64), 64
    return None, 0


def _ride_decode(bits, dt):
    dt = jnp.dtype(dt)
    if dt == jnp.float32:
        return jax.lax.bitcast_convert_type(bits.astype(jnp.int32),
                                            jnp.float32)
    if dt in (jnp.dtype(jnp.int32), jnp.dtype(jnp.uint32)):
        return jax.lax.bitcast_convert_type(bits.astype(jnp.int32), dt)
    if dt == jnp.bool_:
        return bits.astype(jnp.int32) != 0
    if dt in (jnp.dtype(jnp.int8), jnp.dtype(jnp.uint8),
              jnp.dtype(jnp.int16), jnp.dtype(jnp.uint16)):
        return bits.astype(jnp.int32).astype(dt)
    if dt == jnp.float64:
        return jax.lax.bitcast_convert_type(bits, jnp.float64)
    return jax.lax.bitcast_convert_type(bits, dt)      # (u)int64


@functools.partial(jax.jit, static_argnums=(4,))
def _merge_ride_phase1(keysA, bitsA, keysB, bitsB, w):
    """Sort-riding merge: ONE fused lax.sort carries (tagged key, value
    bits); groups have <= 2 members so presence/values resolve with
    neighbor rolls — no random gathers or scatters."""
    nA = keysA.shape[0]
    tk = jnp.concatenate([keysA << 1, (keysB << 1) | 1])
    vb = jnp.concatenate([bitsA, bitsB])
    stk, svb = jax.lax.sort((tk, vb), num_keys=1)
    key = stk >> 1
    tag = (stk & 1) == 1
    is_new = jnp.concatenate([jnp.ones(1, bool), key[1:] != key[:-1]])
    pair = jnp.concatenate([key[1:] == key[:-1], jnp.zeros(1, bool)])
    vb_next = jnp.roll(svb, -1)
    a_in = is_new & ~tag
    b_in = is_new & (pair | tag)
    uav = jnp.where(a_in, svb, 0)
    ubv = jnp.where(b_in, jnp.where(pair, vb_next, svb), 0)
    cnt = jnp.cumsum(is_new.astype(jnp.int32))
    ng = cnt[-1] if key.shape[0] else jnp.zeros((), jnp.int32)
    # compact the run starts with a second fused sort: flags pack into
    # the key's low bits, both value planes into one int64 when 32-bit
    flags = a_in.astype(jnp.int64) | (b_in.astype(jnp.int64) << 1)
    k2 = jnp.where(is_new, (key << 2) | flags, jnp.int64(2**63 - 1))
    if w == 32:
        LOW = jnp.int64((1 << 32) - 1)
        packed = (uav.astype(jnp.int64) & LOW) | (ubv.astype(jnp.int64)
                                                  << 32)
        sk, sp = jax.lax.sort((k2, packed), num_keys=1)
        return ng, sk, sp, sp
    sk, sa, sb = jax.lax.sort((k2, uav, ubv), num_keys=1)
    return ng, sk, sa, sb


_umr_jits: dict = {}


def union_merge_raw(keysA, valsA, keysB, valsB, key_bound=None):
    """Phase-1-only union merge: returns (ng, sk, sa, sb, w) with the
    SORTED raw planes (sk packs key<<2 | a_in | b_in<<1; entries past ng
    carry the int64 sentinel).  Callers fuse their own decode+algebra
    into one jitted finisher (one dispatch instead of an eager decode
    tail).  Returns None
    when the payload cannot bit-ride (struct/complex) — use
    ``union_merge``.  The ride-encode runs INSIDE the jit (one
    dispatch for the whole phase)."""
    # dtype probe only (no device work: _ride_encode on a 0-d slice)
    bA, wA = _ride_encode(valsA[:0])
    bB, wB = _ride_encode(valsB[:0])
    if bA is None or bB is None \
            or (key_bound is not None and key_bound >= (1 << 61)):
        return None
    w = max(wA, wB)
    jk = (w, jnp.dtype(valsA.dtype), jnp.dtype(valsB.dtype))
    fn = _umr_jits.get(jk)
    if fn is None:
        def run(ka, va, kb, vb):
            ba, _ = _ride_encode(va)
            bb, _ = _ride_encode(vb)
            if w == 64:
                ba = ba.astype(jnp.int64)
                bb = bb.astype(jnp.int64)
            return _merge_ride_phase1(ka, ba, kb, bb, w)

        fn = jax.jit(run)
        if len(_umr_jits) > 32:
            _umr_jits.clear()
        _umr_jits[jk] = fn
    ng, sk, sa, sb = fn(keysA, valsA, keysB, valsB)
    return int(ng), sk, sa, sb, w


def union_merge(keysA, valsA, keysB, valsB, key_bound=None):
    """Merge two sorted sparse patterns (each side duplicate-free).
    Returns (unique_keys, a_vals, b_vals, a_present, b_present) of length
    nnz(union).  One engine for eWiseAdd (union), eWiseMult (filter both),
    eWiseUnion (union with fill scalars) and the masker truth table
    (reference: Source/GB_add.h, GB_emult.h, GB_masker.c:20-27).

    ``key_bound``: exclusive upper bound on key values when the caller
    knows it (veclen * nvec); the fast engine packs tag+presence flags
    into the key's low bits and needs keys < 2^61."""
    bitsA, wA = _ride_encode(valsA)
    bitsB, wB = _ride_encode(valsB)
    if bitsA is not None and bitsB is not None \
            and (key_bound is None or key_bound < (1 << 61)):
        w = max(wA, wB)
        if w == 64:
            bitsA = bitsA.astype(jnp.int64)
            bitsB = bitsB.astype(jnp.int64)
        ng, sk, sa, sb = _merge_ride_phase1(keysA, bitsA, keysB, bitsB, w)
        ng = int(ng)
        if ng == 0:
            z = jnp.zeros(0, KEY)
            return (z, valsA[:0], valsB[:0], jnp.zeros(0, bool),
                    jnp.zeros(0, bool))
        sk = sk[:ng]
        ukeys = sk >> 2
        a_in = (sk & 1) == 1
        b_in = (sk & 2) == 2
        if w == 32:
            LOW = jnp.int64((1 << 32) - 1)
            pk = sa[:ng]
            ua_bits = pk & LOW
            ub_bits = pk >> 32
        else:
            ua_bits = sa[:ng]
            ub_bits = sb[:ng]
        uav = _ride_decode(ua_bits, valsA.dtype)
        ubv = _ride_decode(ub_bits, valsB.dtype)
        return ukeys, uav, ubv, a_in, b_in
    # legacy engine (struct/complex payloads): argsort + gather/scatter
    order, skeys, tag_b, gid, ng = _merge_phase1(keysA, keysB)
    ng = int(ng)
    if ng == 0:
        z = jnp.zeros(0, KEY)
        return (z, valsA[:0], valsB[:0], jnp.zeros(0, bool), jnp.zeros(0, bool))
    return _merge_phase2(order, skeys, tag_b, gid, valsA, valsB, ng)
