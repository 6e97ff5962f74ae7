"""Vectorized lockstep alpha-terminating random walks.

The reference runs one walk at a time with SFMT and per-step stop coins
[R: algo.h random_walk — reconstruction, SURVEY.md Sec. 3.1 HOT LOOP 2].
Batched formulation (SURVEY.md Sec. 7.1):

  * all walks advance one hop per step in lockstep, dead lanes masked;
  * the per-step alpha-coin is replaced by a pre-sampled geometric walk
    length (identical distribution, one RNG draw per walk instead of per
    hop);
  * neighbor choice is a uniform randint into the CSR row (the reference
    samples uniformly too); an alias-table variant supports weighted
    graphs with one extra gather + compare;
  * RNG is counter-based ``jax.random`` (threefry) keyed per (query, hop)
    — deterministic and splittable, no SFMT state to carry.

Dangling convention: a walk at an out-degree-0 node is absorbed — it ends
there regardless of remaining length — consistent with push/oracle and,
crucially, source-independent (the FORA+ index precomputes these walks).

Layout is walk-major [W, B]: W static walk lanes, B queries.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..graph.csr import DeviceGraph


class WalkAllocation(NamedTuple):
    """Lane -> (start node, contribution weight) mapping for the combine
    phase: node v gets omega_v = ceil(r_v * omega_unit) walks, each carrying
    weight r_v / omega_v (FORA estimator, SURVEY.md Sec. 2.2)."""

    start: jnp.ndarray    # [W, B] i32 — start node per lane
    walk_idx: jnp.ndarray  # [W, B] i32 — walk number within its start node
    weight: jnp.ndarray   # [W, B] f32 — contribution of this walk's endpoint
    valid: jnp.ndarray    # [W, B] bool — lane < total walks for this query
    total: jnp.ndarray    # [B] i32 — walks actually demanded
    overflow: jnp.ndarray  # [B] bool — demanded more than W lanes


def allocate_walks(r: jnp.ndarray, omega_unit: float, num_lanes: int
                   ) -> WalkAllocation:
    """Map ``num_lanes`` static lanes onto the per-node walk demand.

    r: [n, B] residue after push. Lane i of query b serves the node whose
    cumulative walk count first exceeds i (searchsorted over the int32
    cumsum — exact, no f32 rounding).
    """
    n, B = r.shape
    omega_v = jnp.ceil(r * jnp.float32(omega_unit)).astype(jnp.int32)  # [n, B]
    omega_v = jnp.where(r > 0, omega_v, 0)
    cum = jnp.cumsum(omega_v, axis=0)                                  # [n, B]
    total = cum[-1]                                                    # [B]
    lanes = jnp.arange(num_lanes, dtype=jnp.int32)

    # Lane -> node via scatter + cummax (O(W); searchsorted's binary scan
    # is a chain of dependent per-element gathers): node v with omega_v > 0
    # owns lanes
    # [cum[v-1], cum[v]); drop a marker v at its first lane and fill
    # forward.  Markers collide only for omega_v == 0 nodes (excluded).
    first = jnp.where(omega_v > 0, cum - omega_v, num_lanes)           # [n, B]
    first_c = jnp.minimum(first, num_lanes - 1)
    marks = jnp.zeros((num_lanes, B), jnp.int32)
    node_ids = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None],
                                (n, B))
    put = jnp.where(jnp.logical_and(omega_v > 0, first < num_lanes),
                    node_ids, 0)
    marks = marks.at[first_c, jnp.arange(B)[None, :]].max(put)
    start = jax.lax.cummax(marks, axis=0)                              # [W, B]

    valid = lanes[:, None] < jnp.minimum(total, num_lanes)[None, :]
    r_v = jnp.take_along_axis(r, start, axis=0)
    w_v = jnp.take_along_axis(omega_v, start, axis=0)
    weight = jnp.where(valid, r_v / jnp.maximum(w_v, 1).astype(jnp.float32), 0.0)
    # walk number within its node: lane - (walks demanded by earlier nodes)
    first_lane = jnp.take_along_axis(cum - omega_v, start, axis=0)
    walk_idx = lanes[:, None] - first_lane
    return WalkAllocation(start=start, walk_idx=walk_idx, weight=weight,
                          valid=valid, total=total,
                          overflow=total > num_lanes)


def geometric_lengths(key: jax.Array, shape, alpha: float,
                      max_hops: int) -> jnp.ndarray:
    """Number of hops before the alpha-coin stops the walk.

    len = floor(log(u) / log(1-alpha)) ~ Geometric(alpha), P(len=0)=alpha.
    Capping at max_hops truncates a (1-alpha)^max_hops tail (2e-7 for
    alpha=.2, 64 hops).
    """
    u = jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny)
    len_f = jnp.floor(jnp.log(u) * (1.0 / math.log1p(-alpha)))
    return jnp.minimum(len_f, max_hops).astype(jnp.int32)


def run_walks(graph: DeviceGraph, start: jnp.ndarray, key: jax.Array, *,
              alpha: float, max_hops: int = 64,
              alias_prob: Optional[jnp.ndarray] = None,
              alias_other: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Advance all walks to termination; returns endpoints [W, B] i32.

    start: [W, B] start node per lane.  With ``alias_prob``/``alias_other``
    (per-edge-slot tables aligned with out-CSR), hops sample the weighted
    distribution; otherwise uniform out-neighbor, like the reference.
    A weighted DeviceGraph carries its own alias tables — they are picked
    up automatically, so every walk consumer (FORA, Monte Carlo, the index
    builder) samples the weighted kernel without plumbing.
    """
    if alias_prob is None and graph.alias_prob is not None:
        alias_prob, alias_other = graph.alias_prob, graph.alias_other
    W, B = start.shape
    length = geometric_lengths(jax.random.fold_in(key, 0), (W, B), alpha,
                               max_hops)
    deg = graph.out_deg

    def hop(h, cur):
        u = jax.random.uniform(jax.random.fold_in(key, h + 1), (W, B))
        d = deg[cur]                                          # [W, B] i32
        alive = jnp.logical_and(h < length, d > 0)  # dangling absorbs
        j = jnp.minimum((u * d.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(d - 1, 0))
        slot = graph.out_indptr[cur] + j
        nxt = graph.out_indices[slot]
        if alias_prob is not None:
            u2 = jax.random.uniform(jax.random.fold_in(key, -(h + 1)), (W, B))
            nxt = jnp.where(u2 < alias_prob[slot], nxt, alias_other[slot])
        return jnp.where(alive, nxt, cur)

    return jax.lax.fori_loop(0, max_hops, hop, start)


def hop_widths(n_lanes: int, alpha: float, max_hops: int,
               slack: float = 1.05, margin: int = 4096) -> list:
    """Static per-hop processed-prefix widths for the scheduled walk.

    Hop h only concerns lanes with length > h; with i.i.d. geometric
    lengths their count concentrates at n_lanes * (1-alpha)^h (binomial
    std <= sqrt(count)), so a 5% + 4096-lane margin covers hundreds of
    standard deviations at every hop.  Widths are multiples of 128,
    non-increasing, capped at n_lanes.  The kernel VERIFIES the bound per
    chunk and callers fall back to the plain lockstep walk on the
    (astronomically unlikely) overflow."""
    widths = []
    w_prev = n_lanes
    for h in range(max_hops):
        s = n_lanes * (1.0 - alpha) ** h * slack + margin
        w = min(n_lanes, -(-int(s) // 128) * 128, w_prev)
        widths.append(w)
        w_prev = w
    return widths


def run_walks_scheduled(graph: DeviceGraph, start: jnp.ndarray,
                        key: jax.Array, *, alpha: float, max_hops: int = 64,
                        alias_prob: Optional[jnp.ndarray] = None,
                        alias_other: Optional[jnp.ndarray] = None,
                        slack: float = 1.05, margin: int = 4096):
    """``run_walks`` with length-scheduled lane compaction — the index
    builder's hot kernel (SURVEY.md Sec. 3.3 HOT).

    The lockstep walk pays max_hops gathers per lane although the mean
    alpha-terminated length is 1/alpha (5 hops): ~92% of all hop-gather
    elements are dead-lane padding.  Since lengths are PRE-SAMPLED
    (one geometric draw per lane) and the per-hop uniforms are drawn by
    lane position — independent of the lengths — lanes can be sorted by
    length descending before stepping: the lanes alive at hop h then form
    a prefix, and hop h runs on the static prefix ``hop_widths()[h]``
    (~(1-alpha)^h of the lanes).  Total gather elements drop from
    W * max_hops to ~W / alpha (~13x fewer at alpha=0.2, 64 max hops).
    Each lane's uniform sequence is still i.i.d. (positions are fixed
    before any stepping), so endpoints are distribution-identical to
    ``run_walks`` — not bit-identical: the builder records which kernel
    built an index via its own chunk keying, and single-device and
    sharded builds remain bit-identical to EACH OTHER (both use the
    same schedule; index/build_sharded.py).

    start: [W] flat start nodes.  Returns (endpoints [W] i32, ok bool) —
    ``ok`` False means some hop's live-lane count exceeded its scheduled
    width (re-run the chunk with ``run_walks``)."""
    if alias_prob is None and graph.alias_prob is not None:
        alias_prob, alias_other = graph.alias_prob, graph.alias_other
    W = start.shape[0]
    widths = hop_widths(W, alpha, max_hops, slack=slack, margin=margin)
    length = geometric_lengths(jax.random.fold_in(key, 0), (W,), alpha,
                               max_hops)
    order = jnp.argsort(-length)                     # stable, descending
    cur = start[order]
    slen = length[order]
    # live-lane count at hop h = #(length > h); verify against the schedule
    hist = jnp.bincount(length, length=max_hops + 1)
    live = W - jnp.cumsum(hist)                      # [max_hops+1]; live[h] = #(len > h)
    ok = jnp.all(live[: max_hops] <= jnp.asarray(widths))
    deg = graph.out_deg

    for h in range(max_hops):
        S = widths[h]
        pre = jax.lax.dynamic_slice_in_dim(cur, 0, S)
        u = jax.random.uniform(jax.random.fold_in(key, h + 1), (S,))
        d = deg[pre]
        alive = jnp.logical_and(h < jax.lax.dynamic_slice_in_dim(slen, 0, S),
                                d > 0)               # dangling absorbs
        j = jnp.minimum((u * d.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(d - 1, 0))
        slot = graph.out_indptr[pre] + j
        nxt = graph.out_indices[slot]
        if alias_prob is not None:
            # h is a Python int here (unrolled loop): wrap the negative
            # fold-in data as int32 (a bare negative literal overflows
            # fold_in's uint32 coercion; the fori-loop kernels trace it)
            u2 = jax.random.uniform(
                jax.random.fold_in(key, jnp.int32(-(h + 1))), (S,))
            nxt = jnp.where(u2 < alias_prob[slot], nxt, alias_other[slot])
        cur = jax.lax.dynamic_update_slice_in_dim(
            cur, jnp.where(alive, nxt, pre), 0, axis=0)
    endpoints = jnp.zeros((W,), start.dtype).at[order].set(cur)
    return endpoints, ok


def sharded_lockstep_walk(cur: jnp.ndarray, key: jax.Array,
                          indptr_loc: jnp.ndarray, indices_loc: jnp.ndarray,
                          deg_loc: jnp.ndarray, alias_p, alias_o, *,
                          alpha: float, max_hops: int, n_loc: int,
                          use_alias: bool, axis_name: str) -> jnp.ndarray:
    """Lockstep walk with the out-CSR ROW-SHARDED over ``axis_name``
    (SURVEY.md Sec. 5.7): lane state ``cur`` is replicated (identical on
    every shard), each shard holds only its rows' CSR slice
    (``indptr_loc`` localized, [n_loc+1]), and each hop the owner of a
    lane's current row samples its next node while non-owners contribute
    0 — ONE psum per hop combines (each lane has exactly one owner).

    The uniform stream, hop order, and update rule mirror ``run_walks``
    hop-for-hop and draw-for-draw, so for equal keys the endpoint stream
    is bit-identical to an unsharded walk — the property the sharded
    index builder's bit-identity test pins (index/build_sharded.py).
    """
    shape = cur.shape
    g_id = jax.lax.axis_index(axis_name)
    row0 = g_id * n_loc
    length = geometric_lengths(jax.random.fold_in(key, 0), shape, alpha,
                               max_hops)

    def hop(h, cur):
        u = jax.random.uniform(jax.random.fold_in(key, h + 1), shape)
        local = cur - row0
        own = jnp.logical_and(local >= 0, local < n_loc)
        li = jnp.clip(local, 0, n_loc - 1)
        d = deg_loc[li]                               # valid on owner only
        alive = jnp.logical_and(h < length, d > 0)    # dangling absorbs
        j = jnp.minimum((u * d.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(d - 1, 0))
        slot = indptr_loc[li] + j
        nxt = indices_loc[slot]
        if use_alias:
            u2 = jax.random.uniform(jax.random.fold_in(key, -(h + 1)),
                                    shape)
            nxt = jnp.where(u2 < alias_p[slot], nxt, alias_o[slot])
        upd = jnp.where(own, jnp.where(alive, nxt, cur), 0)
        return jax.lax.psum(upd, axis_name)           # one owner per lane

    return jax.lax.fori_loop(0, max_hops, hop, cur)


def sharded_lockstep_walk_scheduled(start: jnp.ndarray, key: jax.Array,
                                    indptr_loc: jnp.ndarray,
                                    indices_loc: jnp.ndarray,
                                    deg_loc: jnp.ndarray, alias_p, alias_o,
                                    *, alpha: float, max_hops: int,
                                    n_loc: int, use_alias: bool,
                                    axis_name: str,
                                    slack: float = 1.05,
                                    margin: int = 4096):
    """``run_walks_scheduled``'s row-sharded twin (one psum per hop, CSR
    sharded as in ``sharded_lockstep_walk``).  Lengths, sort order, and
    uniforms are generated identically on every shard from the replicated
    key, and identically to the single-device scheduled kernel — so for
    equal (key, chunk) the endpoint stream is BIT-IDENTICAL to
    ``run_walks_scheduled`` (the sharded-builder equality contract,
    index/build_sharded.py).  Returns (endpoints [W], ok)."""
    W = start.shape[0]
    widths = hop_widths(W, alpha, max_hops, slack=slack, margin=margin)
    length = geometric_lengths(jax.random.fold_in(key, 0), (W,), alpha,
                               max_hops)
    order = jnp.argsort(-length)
    cur = start[order]
    slen = length[order]
    hist = jnp.bincount(length, length=max_hops + 1)
    live = W - jnp.cumsum(hist)
    ok = jnp.all(live[: max_hops] <= jnp.asarray(widths))
    g_id = jax.lax.axis_index(axis_name)
    row0 = g_id * n_loc

    for h in range(max_hops):
        S = widths[h]
        pre = jax.lax.dynamic_slice_in_dim(cur, 0, S)
        u = jax.random.uniform(jax.random.fold_in(key, h + 1), (S,))
        local = pre - row0
        own = jnp.logical_and(local >= 0, local < n_loc)
        li = jnp.clip(local, 0, n_loc - 1)
        d = deg_loc[li]                               # valid on owner only
        alive = jnp.logical_and(
            h < jax.lax.dynamic_slice_in_dim(slen, 0, S), d > 0)
        j = jnp.minimum((u * d.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(d - 1, 0))
        slot = indptr_loc[li] + j
        nxt = indices_loc[slot]
        if use_alias:
            u2 = jax.random.uniform(
                jax.random.fold_in(key, jnp.int32(-(h + 1))), (S,))
            nxt = jnp.where(u2 < alias_p[slot], nxt, alias_o[slot])
        upd = jnp.where(own, jnp.where(alive, nxt, pre), 0)
        cur = jax.lax.dynamic_update_slice_in_dim(
            cur, jax.lax.psum(upd, axis_name), 0, axis=0)
    endpoints = jnp.zeros((W,), start.dtype).at[order].set(cur)
    return endpoints, ok


def accumulate_endpoints(endpoints: jnp.ndarray, weight: jnp.ndarray,
                         n: int) -> jnp.ndarray:
    """segment-sum walk weights into a [n, B] PPR contribution."""
    def one(e, w):
        return jax.ops.segment_sum(w, e, num_segments=n)
    return jax.vmap(one, in_axes=1, out_axes=1)(endpoints, weight)


def walk_lane_budget(omega_unit: float, rmax: float, m: int, n: int,
                     cap: Optional[int] = None, slack: float = 1.10,
                     lane_multiple: int = 1024) -> int:
    """Static lane count for a (config, graph) pair.

    After push, rsum <= min(1, rmax * m) (each edge holds at most rmax
    residue per unit out-degree), and the ceil() in the per-node demand adds
    at most one walk per touched node; n bounds touched nodes.
    """
    rsum_bound = min(1.0, rmax * m)
    w = int(slack * omega_unit * rsum_bound) + min(n, int(omega_unit))
    w = -(-w // lane_multiple) * lane_multiple
    if cap is not None:
        w = min(w, cap)
    return max(w, lane_multiple)
