"""Sharded FORA pipeline: shard_map over the ('graph', 'query') mesh.

Parallel decomposition (SURVEY.md Sec. 2.3):

  * 'query' axis — data parallelism over batched sources (embarrassingly
    parallel; replaces the reference's sequential batch loop).
  * 'graph' axis — rows (nodes) sharded; the push superstep is a local
    gather + segment_sum over the shard's in-edges, preceded by a frontier
    exchange of the per-row contribution vector between devices.  Walk lanes run
    shard-local from the shard's own residues (so FORA+ index lookups never
    leave the shard — the Ulysses/EP-style locality trick), and endpoint
    mass is combined with one psum_scatter back to row owners.
  * top-k — per-shard top-k of owned rows, then an all_gather of k
    candidates per shard and a final top-k of G*k (k is small).

Frontier exchange modes (``exchange=``), SURVEY.md Sec. 2.3 EP row /
Sec. 7.3:

  * ``dense``   — all_gather the full [n_loc, Bq] contribution block.
  * ``compact`` — all_gather <= cap compacted (id, row) pairs: cheaper once
    the frontier decays, but still a broadcast (every shard receives every
    active row, needed or not).
  * ``routed``  — the EP dispatch pattern: per-destination compaction
    against a precomputed ``needed`` mask (which of my rows shard t's
    in-edges reference), then a fixed-capacity ``jax.lax.all_to_all`` so
    each active row travels only to shards that will gather it.
  * ``hier``    — hierarchical two-tier staging (SURVEY.md Sec. 5.8, the
    multi-host shape): per-destination-HOST compaction, one cross-host
    all_to_all among same-chip-position shards (a row needed by several
    chips of a host crosses the slow inter-host link once), then an
    intra-host all_gather fan-out.  Host topology is ``chips_per_host``
    static subgroups of the flat graph axis (axis_index_groups — no extra
    mesh axes).

All supersteps whose frontier exceeds the static capacity fall back to the
dense exchange via a pmax-agreed lax.cond, so every shard takes the same
collective.

``ShardedTopkRunner`` (bottom) gives the sharded path refinement parity
with the single-chip ``TopkRunner``: the same delta-halving pool loop
(incremental push state, per-depth index slices, adaptive widths,
threshold + confidence-bound acceptance) driving a shard_mapped level
step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..algo.topk import TopkRunner
from ..config import ResolvedConfig
from ..graph.csr import CSRGraph, DeviceGraph
from ..ops import walk as walk_ops
from . import partition as part
from .mesh import GRAPH_AXIS, QUERY_AXIS, shard_map

P = jax.sharding.PartitionSpec

EXCHANGE_MODES = ("dense", "compact", "routed", "hier")


class ShardedTopkResult(NamedTuple):
    values: jnp.ndarray    # [B, k] f32, descending
    node_ids: jnp.ndarray  # [B, k] i32, global ids
    push_iters: jnp.ndarray  # [] i32
    walk_overflow: jnp.ndarray  # [B] bool


# --------------------------------------------------------------------------
# kernel building blocks (run inside shard_map; one shard's view)
# --------------------------------------------------------------------------


def _dense_all_gather(v):
    return jax.lax.all_gather(v, GRAPH_AXIS, axis=0, tiled=True)


def _frontier_exchange(contrib, *, mode, needed, cap, n_loc, n_pad, G,
                       host_groups=None):
    """One frontier exchange: local [n_loc, Bq] contributions in, full
    [n_pad, Bq] contribution vector out (see module docstring for modes).

    ``host_groups`` (hier mode): (cross_host_groups, intra_host_groups)
    from partition.host_groups — static shard-id subgroups of the flat
    graph axis, so the hierarchy needs no extra mesh axes."""
    dense = _dense_all_gather
    if mode == "dense" or cap <= 0:
        return dense(contrib)

    Bq = contrib.shape[1]
    g_id = jax.lax.axis_index(GRAPH_AXIS)
    row0 = g_id * n_loc
    row_active = jnp.any(contrib != 0.0, axis=1)               # [n_loc]

    if mode == "hier":
        # two-stage EP routing: one inter-host copy per NEEDING HOST
        # (all_to_all among same-chip-position shards), then intra-host
        # fan-out (all_gather among the host's chips).  A row needed by
        # several chips of a remote host crosses the slow link once.
        cross, intra = host_groups
        H = len(intra)
        act = jnp.logical_and(needed, row_active[None, :])     # [H, n_loc]
        cnt = jnp.sum(act.astype(jnp.int32), axis=1)           # [H]
        cnt_max = jax.lax.pmax(jnp.max(cnt), GRAPH_AXIS)

        def hier(c):
            idx = jax.vmap(
                lambda a: jnp.nonzero(a, size=cap, fill_value=n_loc)[0])(act)
            c_pad = jnp.concatenate([c, jnp.zeros((1, Bq), c.dtype)],
                                    axis=0)
            send_vals = c_pad[idx]                             # [H, cap, Bq]
            send_ids = jnp.where(idx < n_loc, idx + row0,
                                 n_pad).astype(jnp.int32)      # [H, cap]
            # stage A (inter-host): route to the needing host, same chip
            # position
            recv_ids = jax.lax.all_to_all(
                send_ids, GRAPH_AXIS, 0, 0, axis_index_groups=cross)
            recv_vals = jax.lax.all_to_all(
                send_vals, GRAPH_AXIS, 0, 0, axis_index_groups=cross)
            # stage B (intra-host): share what my host's chips received
            all_ids = jax.lax.all_gather(
                recv_ids.reshape(-1), GRAPH_AXIS, axis=0, tiled=True,
                axis_index_groups=intra)                       # [C*H*cap]
            all_vals = jax.lax.all_gather(
                recv_vals.reshape(-1, Bq), GRAPH_AXIS, axis=0, tiled=True,
                axis_index_groups=intra)                       # [C*H*cap, Bq]
            full = jnp.zeros((n_pad + 1, Bq), c.dtype)
            full = full.at[all_ids].add(all_vals)
            return full[:n_pad]

        return jax.lax.cond(cnt_max <= cap, hier, dense, contrib)

    if mode == "compact":
        # broadcast compaction: <= cap (global id, row) pairs all-gathered
        cnt = jnp.sum(row_active.astype(jnp.int32))
        cnt_max = jax.lax.pmax(cnt, GRAPH_AXIS)

        def compact(c):
            idx = jnp.nonzero(row_active, size=cap, fill_value=n_loc)[0]
            c_pad = jnp.concatenate(
                [c, jnp.zeros((1, Bq), c.dtype)], axis=0)
            vals = c_pad[idx]                                   # [cap, Bq]
            gids = jnp.where(idx < n_loc, idx + row0, n_pad)    # pad slot
            all_ids = jax.lax.all_gather(gids, GRAPH_AXIS, axis=0,
                                         tiled=True)            # [G*cap]
            all_vals = jax.lax.all_gather(vals, GRAPH_AXIS, axis=0,
                                          tiled=True)           # [G*cap, Bq]
            full = jnp.zeros((n_pad + 1, Bq), c.dtype)
            full = full.at[all_ids].add(all_vals)
            return full[:n_pad]

        return jax.lax.cond(cnt_max <= cap, compact, dense, contrib)

    # routed: per-destination compaction against the needed mask
    act = jnp.logical_and(needed, row_active[None, :])          # [G, n_loc]
    cnt = jnp.sum(act.astype(jnp.int32), axis=1)                # [G]
    cnt_max = jax.lax.pmax(jnp.max(cnt), GRAPH_AXIS)

    def routed(c):
        idx = jax.vmap(
            lambda a: jnp.nonzero(a, size=cap, fill_value=n_loc)[0])(act)
        c_pad = jnp.concatenate([c, jnp.zeros((1, Bq), c.dtype)], axis=0)
        send_vals = c_pad[idx]                                  # [G, cap, Bq]
        send_ids = jnp.where(idx < n_loc, idx + row0,
                             n_pad).astype(jnp.int32)           # [G, cap]
        recv_ids = jax.lax.all_to_all(send_ids, GRAPH_AXIS, 0, 0).reshape(-1)
        recv_vals = jax.lax.all_to_all(
            send_vals, GRAPH_AXIS, 0, 0).reshape(G * cap, Bq)
        full = jnp.zeros((n_pad + 1, Bq), c.dtype)
        full = full.at[recv_ids.reshape(-1)].add(recv_vals)
        return full[:n_pad]

    return jax.lax.cond(cnt_max <= cap, routed, dense, contrib)


def exchange_bytes_model(mode: str, *, n_loc: int, batch: int, G: int,
                         cap: int = 0, chips_per_host: int = 1) -> int:
    """Bytes leaving ONE shard per superstep under each exchange mode
    (f32 rows + i32 ids; capacity-padded for the static-shape modes).
    For "hier" this returns the CROSS-HOST bytes — the scaling-limiting
    term; the intra-host fan-out adds (C-1)*H*cap rows on the fast links
    (hier_ici_bytes_model)."""
    row = batch * 4
    if mode == "dense":
        return (G - 1) * n_loc * row
    if mode == "compact":
        return (G - 1) * cap * (row + 4)
    if mode == "routed":
        return (G - 1) * cap * (row + 4)
    if mode == "hier":
        H = G // chips_per_host
        return (H - 1) * cap * (row + 4)
    raise ValueError(mode)


def hier_ici_bytes_model(*, batch: int, G: int, cap: int,
                         chips_per_host: int) -> int:
    """Intra-host bytes per shard for the hier exchange's fan-out
    stage: all_gather of the [H, cap] received blocks among C chips."""
    H = G // chips_per_host
    return (chips_per_host - 1) * H * cap * (batch * 4 + 4)


def _push_loop(p0, r0, thr, deg_f, dangling, in_src, in_dst, *,
               alpha, max_iters, n_loc, exchange_fn,
               in_w=None, wsum=None, hub=None):
    """Sharded push supersteps from (p0, r0) until r <= thr everywhere.
    thr: [n_loc, 1] per-node termination threshold.  Weighted graphs pass
    per-in-edge weights ``in_w`` [m_loc] and per-row out-weight totals
    ``wsum`` [n_loc, 1] (the propagated fraction is w/W, see ops/push.py).

    ``hub`` (optional): (hub_ids [H], hub_src_slot [mh_loc],
    hub_dst_local [mh_loc], hub_w or None) — the per-shard hub partition
    (partition_rows(hub_rows=...)): its edges gather from the compact
    [H, Bq] slice of the exchanged contribution vector instead of
    hammering the full [n_pad, Bq] table with the degree-skewed sources
    (see to_device's hub docs).
    """
    div = jnp.maximum(deg_f, 1.0) if wsum is None else jnp.maximum(wsum,
                                                                   1e-30)

    def frontier_count(r):
        return jax.lax.psum(jnp.sum((r > thr).astype(jnp.int32)),
                            GRAPH_AXIS)

    def cond(st):
        p, r, it, flag = st
        return jnp.logical_and(it < max_iters, flag > 0)

    def body(st):
        p, r, it, _ = st
        active = r > thr
        ar = jnp.where(active, r, 0.0)
        p = p + jnp.where(dangling, ar, alpha * ar)
        contrib = jnp.where(dangling, 0.0, (1.0 - alpha) * ar / div)
        contrib_full = exchange_fn(contrib)                   # [n_pad, Bq]
        vals = contrib_full[in_src]                           # [m_loc, Bq]
        if in_w is not None:
            vals = vals * in_w[:, None]
        delta = jax.ops.segment_sum(vals, in_dst, num_segments=n_loc + 1,
                                    indices_are_sorted=True)[:n_loc]
        if hub is not None:
            hub_ids, hub_slot, hub_dst, hub_w = hub
            hub_op = contrib_full[hub_ids]                    # [H, Bq]
            hvals = hub_op[hub_slot]                          # [mh_loc, Bq]
            if hub_w is not None:
                hvals = hvals * hub_w[:, None]
            delta = delta + jax.ops.segment_sum(
                hvals, hub_dst, num_segments=n_loc + 1,
                indices_are_sorted=True)[:n_loc]
        r = jnp.where(active, 0.0, r) + delta
        return (p, r, it + 1, frontier_count(r))

    p, r, iters, _ = jax.lax.while_loop(
        cond, body, (p0, r0, jnp.zeros((), jnp.int32), frontier_count(r0)))
    return p, r, iters


def _indexed_contrib(r, idx_edge_src, idx_edge_dst, idx_edge_mult,
                     counts_col, *, depth, bucket_offsets, has_mult, n_pad):
    """Walk-phase endpoint mass: SpMV over the shard's depth-``depth``
    index-edge slice.  Returns [n_pad, Bq] (to be psum_scattered)."""
    from ..index.build import NUM_BUCKETS
    Bq = r.shape[1]
    inv_cnt = 1.0 / jnp.maximum(counts_col, 1).astype(jnp.float32)
    rw = r * inv_cnt[:, None]                                 # [n_loc, Bq]
    rw_pad = jnp.concatenate([rw, jnp.zeros((1, Bq), rw.dtype)], axis=0)
    contrib_all = jnp.zeros((n_pad + 1, Bq), jnp.float32)
    for q in range(depth, NUM_BUCKETS):
        lo = int(bucket_offsets[q])
        hi = int(bucket_offsets[q + 1])
        if hi == lo:
            continue
        vals = rw_pad[idx_edge_src[lo:hi]]                    # [E_q, Bq]
        if has_mult:
            vals = vals * idx_edge_mult[lo:hi][:, None]
        contrib_all = contrib_all + jax.ops.segment_sum(
            vals, idx_edge_dst[lo:hi], num_segments=n_pad + 1,
            indices_are_sorted=True)
    return contrib_all[:n_pad]


# --------------------------------------------------------------------------
# one-shot fused top-k kernel (ShardedForaEngine.topk)
# --------------------------------------------------------------------------


def _shard_fora_topk(
    # dynamic args (order matters; see in_specs in ShardedForaEngine)
    sources,          # [Bq] i32, sharded over 'query'
    key,              # key, replicated
    in_src,           # [m_loc] i32 (global, padded-src=0)
    in_dst,           # [m_loc] i32 (local, pad=n_loc)
    deg_loc,          # [n_loc] i32
    in_w_loc,         # [m_loc] f32 edge weights, pad=0 (dummy if unweighted)
    wsum_loc,         # [n_loc] f32 out-weight totals (dummy if unweighted)
    needed,           # [G, n_loc] bool routing mask (dummy unless routed)
    walk_indptr,      # [n_loc+1] i32 localized out-CSR slice (or dummy)
    walk_indices,     # [mo_loc] i32 this shard's out-edges (or dummy)
    walk_alias_p,     # [mo_loc] f32 alias slice (dummy if unweighted)
    walk_alias_o,     # [mo_loc] i32 alias slice (dummy if unweighted)
    idx_edge_src,     # [e_loc_total] i32 local src, pad=n_loc (or dummy)
    idx_edge_dst,     # [e_loc_total] i32 global dst, pad=n_pad (or dummy)
    idx_counts_cum,   # [n_loc, Q] i32 (or dummy)
    idx_edge_mult,    # [e_loc_total] f32 duplicate-merge multiplicity,
    #                   pad=0 (or dummy; see index/build.py)
    hub_ids,          # [H] i32 global hub node ids, replicated (or dummy)
    hub_src_slot,     # [mh_loc] i32 position in hub_ids, pad=0 (or dummy)
    hub_dst_loc,      # [mh_loc] i32 local dst, pad=n_loc (or dummy)
    hub_w,            # [mh_loc] f32 weights, pad=0 (or dummy)
    *, rcfg: ResolvedConfig, n_loc: int, num_lanes_loc: int, k: int,
    use_index: bool, index_has_mult: bool = False, index_depth: int = 0,
    index_bucket_offsets=None, n_graph_shards: int = 1,
    exchange: str = "dense", exchange_cap: int = 0, weighted: bool = False,
    host_groups=None, hub_split: bool = False,
):
    G = n_graph_shards
    g_id = jax.lax.axis_index(GRAPH_AXIS)
    Bq = sources.shape[0]
    row0 = g_id * n_loc
    n_pad_g = n_loc * G

    deg_f = deg_loc.astype(jnp.float32)[:, None]              # [n_loc, 1]
    dangling = deg_f == 0.0
    rmax, alpha = rcfg.rmax, rcfg.alpha
    if use_index:
        # per-node coverage threshold (see ops/push.py forward_push_from):
        # the index supplies counts_cum[:, depth] samples per owned row, so
        # push may stop at r_v <= count_v/omega — never tighter than
        # rmax*deg_v, looser on the low-degree tail.
        thr = (idx_counts_cum[:, index_depth].astype(jnp.float32)
               / jnp.float32(rcfg.omega_unit))[:, None]
    else:
        thr = rmax * deg_f

    # --- init: one-hot residue on the owning shard ---
    local = sources - row0
    own = jnp.logical_and(local >= 0, local < n_loc)
    r0 = jnp.zeros((n_loc, Bq), jnp.float32).at[
        jnp.where(own, local, 0), jnp.arange(Bq)].add(
        jnp.where(own, 1.0, 0.0))
    p0 = jnp.zeros((n_loc, Bq), jnp.float32)

    exchange_fn = functools.partial(
        _frontier_exchange, mode=exchange, needed=needed, cap=exchange_cap,
        n_loc=n_loc, n_pad=n_pad_g, G=G, host_groups=host_groups)
    hub = ((hub_ids, hub_src_slot, hub_dst_loc,
            hub_w if weighted else None) if hub_split else None)
    p, r, iters = _push_loop(p0, r0, thr, deg_f, dangling, in_src, in_dst,
                             alpha=alpha, max_iters=rcfg.max_push_iters,
                             n_loc=n_loc, exchange_fn=exchange_fn,
                             in_w=in_w_loc if weighted else None,
                             wsum=wsum_loc[:, None] if weighted else None,
                             hub=hub)

    # --- walk phase: shard-local residues feed either the local slice of
    # the multi-resolution index (SpMV over index edges, endpoint mass
    # psum_scattered to row owners) or shard-local raw walk lanes ---
    n_pad = n_pad_g      # == out_deg.shape[0] when the walk side is real;
    #                      indexed mode gets dummy walk args (never read)
    overflow = jnp.zeros((Bq,), bool)
    if use_index:
        contrib_all = _indexed_contrib(
            r, idx_edge_src, idx_edge_dst, idx_edge_mult,
            idx_counts_cum[:, index_depth], depth=index_depth,
            bucket_offsets=index_bucket_offsets, has_mult=index_has_mult,
            n_pad=n_pad)
    else:
        # row-sharded raw walks (SURVEY.md Sec. 5.7): each shard allocates
        # lanes from ITS residues, lane state is replicated by one
        # all_gather, and the cooperative lockstep walk advances with one
        # psum per hop against the shard-local CSR slices — no replicated
        # out-CSR or alias tables anywhere.  Wire volume is G*W_loc*Bq*4 B
        # per hop; this is the un-indexed competitor mode, where the
        # memory wall (not wire) is the binding constraint.
        alloc = walk_ops.allocate_walks(r, rcfg.omega_unit, num_lanes_loc)
        W_loc = alloc.start.shape[0]
        start_g = jax.lax.all_gather(alloc.start + row0, GRAPH_AXIS,
                                     axis=0, tiled=True)  # [G*W_loc, Bq]
        endpoints_g = walk_ops.sharded_lockstep_walk(
            start_g, key, walk_indptr, walk_indices, deg_loc,
            walk_alias_p, walk_alias_o, alpha=alpha,
            max_hops=rcfg.max_walk_hops, n_loc=n_loc, use_alias=weighted,
            axis_name=GRAPH_AXIS)
        endpoints = jax.lax.dynamic_slice_in_dim(endpoints_g, g_id * W_loc,
                                                 W_loc, axis=0)
        contrib_all = walk_ops.accumulate_endpoints(endpoints, alloc.weight,
                                                    n_pad)  # [n_pad, Bq]
        overflow = alloc.overflow

    walk_loc = jax.lax.psum_scatter(contrib_all, GRAPH_AXIS,
                                    scatter_dimension=0, tiled=True)
    ppr_loc = p + walk_loc                                    # [n_loc, Bq]

    # --- top-k merge: k local candidates -> all_gather -> global top-k ---
    from ..ops.topk import topk_rows_chunked
    lvals, lids = topk_rows_chunked(ppr_loc, k)               # [Bq, k]
    gids = lids + row0
    cand_v = jax.lax.all_gather(lvals, GRAPH_AXIS, axis=1, tiled=True)
    cand_i = jax.lax.all_gather(gids, GRAPH_AXIS, axis=1, tiled=True)
    fvals, sel = jax.lax.top_k(cand_v, k)
    fids = jnp.take_along_axis(cand_i, sel, axis=1)

    overflow = jax.lax.psum(overflow.astype(jnp.int32), GRAPH_AXIS) > 0
    return fvals, fids, iters, overflow


# --------------------------------------------------------------------------
# refinement level step (ShardedTopkRunner)
# --------------------------------------------------------------------------


def _shard_level_step(
    p0,               # [n_loc, Bq] f32 — resumed push state
    r0,               # [n_loc, Bq] f32
    key,              # unused (indexed mode is deterministic)
    rmax,             # [] f32 runtime scalar
    omega_unit,       # [] f32 runtime scalar
    in_src, in_dst, deg_loc, in_w_loc, wsum_loc, needed,
    idx_edge_src, idx_edge_dst, idx_counts_cum, idx_edge_mult,
    hub_ids, hub_src_slot, hub_dst_loc, hub_w,
    *, rcfg: ResolvedConfig, n_loc: int, k: int, index_depth: int,
    index_bucket_offsets, index_has_mult: bool, n_graph_shards: int,
    exchange: str, exchange_cap: int, t_bound: float,
    weighted: bool = False, host_groups=None, hub_split: bool = False,
):
    """One delta level of the sharded refinement pool: resume push from
    (p0, r0) to the level's per-node coverage threshold, indexed walk
    phase at the level's depth, global top-(k+1) merge, and the same
    threshold/confidence-bound acceptance inputs the single-chip
    ``TopkRunner._level_step`` produces (fora/algo/bounds.py)."""
    from ..algo import bounds as bounds_mod

    del key
    G = n_graph_shards
    g_id = jax.lax.axis_index(GRAPH_AXIS)
    row0 = g_id * n_loc
    n_pad = n_loc * G

    deg_f = deg_loc.astype(jnp.float32)[:, None]
    dangling = deg_f == 0.0
    counts_col = idx_counts_cum[:, index_depth]
    thr = (counts_col.astype(jnp.float32) / omega_unit)[:, None]

    exchange_fn = functools.partial(
        _frontier_exchange, mode=exchange, needed=needed, cap=exchange_cap,
        n_loc=n_loc, n_pad=n_pad, G=G, host_groups=host_groups)
    hub = ((hub_ids, hub_src_slot, hub_dst_loc,
            hub_w if weighted else None) if hub_split else None)
    p, r, _ = _push_loop(p0, r0, thr, deg_f, dangling, in_src, in_dst,
                         alpha=rcfg.alpha, max_iters=rcfg.max_push_iters,
                         n_loc=n_loc, exchange_fn=exchange_fn,
                         in_w=in_w_loc if weighted else None,
                         wsum=wsum_loc[:, None] if weighted else None,
                         hub=hub)

    contrib_all = _indexed_contrib(
        r, idx_edge_src, idx_edge_dst, idx_edge_mult, counts_col,
        depth=index_depth, bucket_offsets=index_bucket_offsets,
        has_mult=index_has_mult, n_pad=n_pad)
    walk_loc = jax.lax.psum_scatter(contrib_all, GRAPH_AXIS,
                                    scatter_dimension=0, tiled=True)
    ppr_loc = p + walk_loc                                    # [n_loc, Bq]

    # --- global top-(k+1) with per-node settled mass, then the same
    # Bernstein UB/LB acceptance math as bounds._topk_with_bounds ---
    from ..ops.topk import topk_rows_chunked
    # Mirror bounds._topk_with_bounds' clamp: a shard holds only n_loc
    # candidates, and with k >= n_pad nothing is excluded (small graphs /
    # many shards) — vals[:, k] would otherwise index out of range.
    kk_loc = min(k + 1, n_loc)
    lv, li, lp = topk_rows_chunked(ppr_loc, kk_loc, p)        # [Bq, kk_loc]
    gi = li + row0
    cand_v = jax.lax.all_gather(lv, GRAPH_AXIS, axis=1, tiled=True)
    cand_p = jax.lax.all_gather(lp, GRAPH_AXIS, axis=1, tiled=True)
    cand_i = jax.lax.all_gather(gi, GRAPH_AXIS, axis=1, tiled=True)
    kk = min(k + 1, G * kk_loc)
    vals, sel = jax.lax.top_k(cand_v, kk)                     # [Bq, kk]
    idx = jnp.take_along_axis(cand_i, sel, axis=1)
    p_at = jnp.take_along_axis(cand_p, sel, axis=1)

    c = 1.0 / omega_unit
    mu_hat = jnp.maximum(vals[:, :k] - p_at[:, :k], 0.0)
    ub_mu = bounds_mod.bernstein_ub(mu_hat, c, t_bound)
    lb = p_at[:, :k] + bounds_mod.bernstein_lb(mu_hat, c, t_bound, ub=ub_mu)
    ub = p_at[:, :k] + ub_mu
    lbk = jnp.min(lb, axis=1)
    if kk > k:
        ub_excluded = bounds_mod.bernstein_ub(vals[:, k], c, t_bound)
    else:  # k >= n_pad: nothing is excluded
        ub_excluded = jnp.zeros(vals.shape[:1], vals.dtype)
    bacc = lbk * (1.0 + rcfg.epsilon) >= ub_excluded
    return vals[:, :k], idx[:, :k], lb, ub, bacc, p, r


# --------------------------------------------------------------------------
# host-side drivers
# --------------------------------------------------------------------------


def _resolve_exchange(exchange, ragged_exchange=False):
    if exchange is None:
        exchange = "compact" if ragged_exchange else "dense"
    if exchange not in EXCHANGE_MODES:
        raise ValueError(f"exchange must be one of {EXCHANGE_MODES}")
    return exchange


def _array_from_shards(mesh, store, key: str, shape, dtype, transform=None):
    """Assemble a P('graph')-sharded global array by serving each device's
    slice from its shard's on-disk file (ShardedIndexStore /
    ShardedGraphStore ``.shard`` mmap views).
    ``jax.make_array_from_callback`` only invokes the callback for
    ADDRESSABLE devices, so on a multi-host mesh each host touches only the
    files of the shards it owns — per-host load is ~1/H of the data.
    ``transform`` (optional): applied to the raw shard array before dtype
    conversion (e.g. deriving the per-host routing mask from the per-chip
    one)."""
    sharding = jax.sharding.NamedSharding(mesh, P(GRAPH_AXIS))
    per = shape[0] // store.n_shards
    cache = {}

    def cb(idx):
        s = (idx[0].start or 0) // per
        if s not in cache:   # query-axis replicas share one file read
            a = store.shard(s)[key]
            if transform is not None:
                a = transform(a)
            cache[s] = np.ascontiguousarray(a).astype(dtype, copy=False)
        return cache[s]

    out = jax.make_array_from_callback(shape, sharding, cb)
    cache.clear()
    return out


class _StorePlacementMeta(NamedTuple):
    """The few PartitionedGraph fields the engine reads when the graph is
    served from a ShardedGraphStore (no global arrays exist)."""
    n_shards: int
    n_loc: int
    m_loc: int
    weighted: bool

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.n_loc


class _ShardedPlacement:
    """Partitions graph (+ index) rows over the mesh's 'graph' axis and
    places every per-shard array; shared by the one-shot engine and the
    pool runner."""

    def __init__(self, g, mesh, index=None, *,
                 exchange: str = "dense", exchange_capacity_frac: float = 0.125,
                 with_walk_side: bool = True,
                 chips_per_host: Optional[int] = None,
                 hub_rows: int = 0):
        from .graph_store import ShardedGraphStore
        self.mesh = mesh
        G = mesh.shape[GRAPH_AXIS]
        self.G = G
        from_store = isinstance(g, ShardedGraphStore)
        if from_store:
            # shard-aware graph store (SURVEY.md Sec. 5.4): each shard's
            # arrays stream from its own mmap files straight onto its
            # device — no process materializes the full CSR or runs the
            # O(m) partition pass; on a multi-host mesh each host reads
            # only its rows' files (make_array_from_callback invokes the
            # callback for addressable devices only).
            if g.n_shards != G:
                raise ValueError(
                    f"graph store is {g.n_shards}-way, mesh graph axis is "
                    f"{G}; re-save with save_sharded_graph(..., {G})")
            if hub_rows:
                raise ValueError(
                    "hub_rows is not supported with a ShardedGraphStore "
                    "yet: deriving the per-shard hub partition needs a "
                    "global max over shard hub-edge counts, which would "
                    "break the ~1/G-bytes-per-host load contract; "
                    "partition in RAM (hub split) or store without it")
            pg = _StorePlacementMeta(n_shards=G, n_loc=g.n_loc,
                                     m_loc=g.m_loc, weighted=g.weighted)
        else:
            pg = part.partition_rows(g, G, hub_rows=hub_rows)
        self.pg = pg
        self.exchange = exchange
        self.exchange_cap = (
            max(64, int(pg.n_loc * exchange_capacity_frac) // 8 * 8)
            if exchange in ("compact", "routed", "hier") else 0)
        self.host_groups = None
        if exchange == "hier":
            if chips_per_host is None or G % chips_per_host:
                raise ValueError(
                    "exchange='hier' needs chips_per_host dividing the "
                    f"graph-axis size {G}")
            self.host_groups = part.host_groups(G, chips_per_host)

        def put(x, spec):
            return jax.device_put(x, jax.sharding.NamedSharding(mesh, spec))

        self.gspec, self.rep = P(GRAPH_AXIS), P()
        gspec = self.gspec
        self.weighted = pg.weighted
        n_loc = pg.n_loc
        if from_store:
            fs = functools.partial(_array_from_shards, mesh, g)
            if exchange == "routed":
                needed = fs("needed", (G * G, n_loc), bool)
            elif exchange == "hier":
                H = G // chips_per_host
                C = chips_per_host
                needed = fs("needed", (G * H, n_loc), bool,
                            transform=lambda a: a.reshape(
                                H, C, n_loc).any(axis=1))
            else:
                needed = put(np.zeros((G, 1), dtype=bool), gspec)
            m_loc = pg.m_loc
            in_w = (fs("in_w", (G * m_loc,), np.float32) if self.weighted
                    else put(np.zeros(G, dtype=np.float32), gspec))
            wsum = (fs("out_wsum", (G * n_loc,), np.float32)
                    if self.weighted
                    else put(np.zeros(G, dtype=np.float32), gspec))
            self.push_args = [
                fs("in_src_global", (G * m_loc,), np.int32),
                fs("in_dst_local", (G * m_loc,), np.int32),
                fs("out_deg", (G * n_loc,), np.int32),
                in_w, wsum, needed,
            ]
            self.hub_split = False
            self.hub_args = [put(np.zeros(1, np.int32), self.rep),
                             put(np.zeros(G, np.int32), gspec),
                             put(np.full(G, n_loc, np.int32), gspec),
                             put(np.zeros(G, np.float32), gspec)]
            if with_walk_side:
                if not g.with_walk_side:
                    raise ValueError(
                        "graph store was saved without the walk-side CSR; "
                        "re-save with with_walk_side=True for raw-walk mode")
                mo = g.mo_loc
                self.walk_args = [
                    fs("walk_indptr", (G * (n_loc + 1),), np.int32),
                    fs("walk_indices", (G * mo,), np.int32),
                    (fs("alias_prob", (G * mo,), np.float32)
                     if self.weighted
                     else put(np.zeros(G, dtype=np.float32), gspec)),
                    (fs("alias_other", (G * mo,), np.int32)
                     if self.weighted
                     else put(np.zeros(G, dtype=np.int32), gspec))]
            else:
                self.walk_args = []
            self._place_index(index, put, gspec, n_loc)
            return

        if exchange == "routed":
            needed = part.needed_masks(pg)                  # [G*G, n_loc]
        elif exchange == "hier":
            needed = part.needed_host_masks(pg, chips_per_host)
        else:
            needed = np.zeros((G, 1), dtype=bool)           # dummy
        in_w = (pg.in_w_sharded if self.weighted
                else np.zeros(G, dtype=np.float32))         # dummy
        wsum = (pg.out_wsum_sharded if self.weighted
                else np.zeros(G, dtype=np.float32))         # dummy
        self.push_args = [
            put(pg.in_src_global, gspec), put(pg.in_dst_local, gspec),
            put(pg.out_deg_sharded, gspec),
            put(in_w, gspec), put(wsum, gspec), put(needed, gspec),
        ]
        # per-shard hub split (partition_rows(hub_rows=...)): hub_ids
        # replicated, hub edge arrays row-sharded like the tail
        self.hub_split = pg.hub_split
        if self.hub_split:
            self.hub_args = [
                put(pg.hub_ids, self.rep),
                put(pg.hub_src_slot_sharded, gspec),
                put(pg.hub_dst_local_sharded, gspec),
                put(pg.hub_w_sharded if pg.hub_w_sharded is not None
                    else np.zeros(G, np.float32), gspec)]
        else:
            self.hub_args = [put(np.zeros(1, np.int32), self.rep),
                             put(np.zeros(G, np.int32), gspec),
                             put(np.full(G, pg.n_loc, np.int32), gspec),
                             put(np.zeros(G, np.float32), gspec)]
        if with_walk_side:
            # raw-walk mode: out-CSR row-sharded like everything else
            # (SURVEY.md Sec. 5.7 — retires the v1 replicated walk CSR);
            # walks run cooperatively with one psum per hop
            # (ops/walk.sharded_lockstep_walk), so no O(m) array is
            # replicated anywhere in the query path.
            from ..index.build_sharded import _shard_csr
            n_loc_w, indptr_loc, indices_loc, _deg, ap, ao = _shard_csr(g, G)
            if n_loc_w != pg.n_loc:
                raise AssertionError(
                    f"walk CSR n_loc={n_loc_w} != partition {pg.n_loc}")

            def flat(a):
                return a.reshape(G * a.shape[1], *a.shape[2:])

            self.walk_args = [
                put(flat(indptr_loc), gspec), put(flat(indices_loc), gspec),
                put(flat(ap) if self.weighted
                    else np.zeros(G, dtype=np.float32), gspec),
                put(flat(ao) if self.weighted
                    else np.zeros(G, dtype=np.int32), gspec)]
        else:
            self.walk_args = []
        self._place_index(index, put, gspec, pg.n_loc)

    def _place_index(self, index, put, gspec, n_loc):
        """Device-place the FORA+ index (monolithic, sharded store, or
        none) — shared by both the in-RAM and store-backed graph paths."""
        G, mesh = self.G, self.mesh
        self.use_index = index is not None
        self.index_bucket_offsets = None
        self.index_has_mult = False
        from ..index.store import ShardedIndexStore
        if isinstance(index, ShardedIndexStore):
            # shard-aware store: each shard's arrays stream from its own
            # mmap-backed files straight onto its device — no global edge
            # array is ever materialized in host RAM (SURVEY.md Sec. 5.4;
            # on a multi-host mesh each host reads only its rows' files)
            if index.n_shards != G:
                raise ValueError(
                    f"sharded index is {index.n_shards}-way, mesh graph "
                    f"axis is {G}; re-save with save_sharded(..., {G})")
            if index.n_loc != n_loc:
                raise ValueError(
                    f"sharded index n_loc={index.n_loc} != partition "
                    f"n_loc={n_loc} (row_multiple mismatch)")
            self.index_bucket_offsets = index.bucket_local_offsets
            self.index_has_mult = index.has_mult
            e = index.e_loc_total
            nQ = index.shard(0)["counts_cum"].shape[1]
            self.index_args = [
                _array_from_shards(mesh, index, "edge_src_local",
                                   (G * e,), np.int32),
                _array_from_shards(mesh, index, "edge_dst",
                                   (G * e,), np.int32),
                _array_from_shards(mesh, index, "counts_cum",
                                   (G * n_loc, nQ), np.int32),
                (_array_from_shards(mesh, index, "edge_mult",
                                    (G * e,), np.float32)
                 if index.has_mult
                 else put(np.zeros(G, dtype=np.float32), gspec)),
            ]
        elif self.use_index:
            pi = part.partition_index(index, G, n_loc)
            self.index_bucket_offsets = pi.bucket_local_offsets
            self.index_has_mult = pi.edge_mult is not None
            self.index_args = [put(pi.edge_src_local, gspec),
                               put(pi.edge_dst, gspec),
                               put(pi.counts_cum, gspec),
                               put(pi.edge_mult if self.index_has_mult
                                   else np.zeros(G, dtype=np.float32),
                                   gspec)]
        else:
            dummy = np.zeros(G, dtype=np.int32)
            self.index_args = [put(dummy, gspec)] * 2 + [
                put(np.zeros((G, 1), dtype=np.int32), gspec),
                put(np.zeros(G, dtype=np.float32), gspec)]

    @property
    def n_loc(self):
        return self.pg.n_loc


class ShardedForaEngine:
    """Holds device-placed sharded graph (+ index) and the jitted topk fn.

    ``batch`` is the global batch; it must divide evenly by the mesh's
    'query' axis.
    """

    def __init__(self, g: CSRGraph, mesh: jax.sharding.Mesh,
                 rcfg: ResolvedConfig, *, k: Optional[int] = None,
                 index=None, num_lanes: Optional[int] = None,
                 max_lanes: int = 1 << 23, lane_slack: float = 2.0,
                 exchange: Optional[str] = None,
                 ragged_exchange: bool = False,
                 ragged_capacity_frac: float = 0.125,
                 chips_per_host: Optional[int] = None,
                 hub_rows: int = 0):
        exchange = _resolve_exchange(exchange, ragged_exchange)
        self.mesh = mesh
        self.rcfg = rcfg
        self.k = k if k is not None else rcfg.k
        G = mesh.shape[GRAPH_AXIS]
        self.use_index = index is not None
        # indexed mode never reads the walk side — don't spend HBM
        # replicating the out-CSR (~m*4 B/shard); pass tiny dummies
        data = _ShardedPlacement(
            g, mesh, index, exchange=exchange,
            exchange_capacity_frac=ragged_capacity_frac,
            with_walk_side=not self.use_index,
            chips_per_host=chips_per_host, hub_rows=hub_rows)
        self.pg = data.pg

        if num_lanes is None:
            num_lanes = walk_ops.walk_lane_budget(
                rcfg.omega_unit, rcfg.rmax, rcfg.m, rcfg.n, cap=max_lanes)
        # per-shard lanes: balanced share plus slack for row skew
        self.num_lanes_loc = max(
            1024, int(num_lanes * lane_slack / G) // 1024 * 1024)

        index_depth = (index.depth_for(rcfg.omega_unit, rcfg.rmax)
                       if self.use_index else 0)
        if self.use_index:
            g_sh = jax.sharding.NamedSharding(mesh, P(GRAPH_AXIS))
            walk_args = [
                jax.device_put(np.zeros(G, np.int32), g_sh),   # indptr
                jax.device_put(np.zeros(G, np.int32), g_sh),   # indices
                jax.device_put(np.zeros(G, np.float32), g_sh),  # alias_p
                jax.device_put(np.zeros(G, np.int32), g_sh),   # alias_o
            ]
        else:
            walk_args = data.walk_args
        self._args = (data.push_args + walk_args + data.index_args
                      + data.hub_args)

        fn = functools.partial(
            _shard_fora_topk, rcfg=rcfg, n_loc=data.n_loc,
            num_lanes_loc=self.num_lanes_loc, k=self.k,
            use_index=self.use_index,
            index_has_mult=data.index_has_mult, index_depth=index_depth,
            index_bucket_offsets=data.index_bucket_offsets,
            n_graph_shards=G, exchange=exchange,
            exchange_cap=data.exchange_cap, weighted=data.weighted,
            host_groups=data.host_groups, hub_split=data.hub_split)
        gspec, rep = data.gspec, data.rep
        mapped = shard_map(
            fn, mesh,
            in_specs=(P(QUERY_AXIS), P(),
                      gspec, gspec, gspec, gspec, gspec, gspec,
                      gspec, gspec, gspec, gspec,
                      gspec, gspec, gspec, gspec,
                      rep, gspec, gspec, gspec),
            out_specs=(P(QUERY_AXIS), P(QUERY_AXIS), P(), P(QUERY_AXIS)))
        self._jitted = jax.jit(mapped)
        self._src_sharding = jax.sharding.NamedSharding(mesh, P(QUERY_AXIS))

    def topk(self, sources, key) -> ShardedTopkResult:
        sources = jax.device_put(jnp.asarray(sources, jnp.int32),
                                 self._src_sharding)
        v, i, it, ov = self._jitted(sources, key, *self._args)
        return ShardedTopkResult(values=v, node_ids=i, push_iters=it,
                                 walk_overflow=ov)


class ShardedTopkRunner(TopkRunner):
    """Delta-halving refinement pool over the sharded engine.

    Same host-side loop as the single-chip ``TopkRunner.query_pool``
    (incremental push state, per-depth index slices, adaptive widths,
    acceptance = threshold rule OR confidence-bound separation) — the
    level step runs shard_mapped over the ('graph', 'query') mesh with
    the push state row-sharded.  Requires a FORA+ index (the raw-walk
    pool path stays single-chip; SURVEY.md Sec. 2.3).
    """

    def __init__(self, g: CSRGraph, mesh: jax.sharding.Mesh,
                 rcfg: ResolvedConfig, index, *, k: Optional[int] = None,
                 delta_stride: float = 2.0, accept_slack: float = 1.0,
                 exchange: Optional[str] = None,
                 exchange_capacity_frac: float = 0.125,
                 chips_per_host: Optional[int] = None,
                 hub_rows: int = 0):
        if index is None:
            raise ValueError("ShardedTopkRunner requires a walk index")
        exchange = _resolve_exchange(exchange)
        super().__init__(None, rcfg, k=k, index=index,
                         delta_stride=delta_stride,
                         accept_slack=accept_slack)
        self.mesh = mesh
        self.G = mesh.shape[GRAPH_AXIS]
        nq = mesh.shape[QUERY_AXIS]
        self.WIDTH_FLOOR = max(128, nq)
        self._data = _ShardedPlacement(
            g, mesh, index, exchange=exchange,
            exchange_capacity_frac=exchange_capacity_frac,
            with_walk_side=False, chips_per_host=chips_per_host,
            hub_rows=hub_rows)
        self._exchange = exchange
        from ..algo import bounds as bounds_mod
        self._t_bound = bounds_mod.union_bound_t(
            rcfg.n, len(self.deltas), rcfg.pfail)
        self._state_sharding = jax.sharding.NamedSharding(
            mesh, P(GRAPH_AXIS, QUERY_AXIS))
        self._shard_args = (self._data.push_args + self._data.index_args
                            + self._data.hub_args)

    def _init_pool_state(self, src_pad):
        n_pad, C = self.G * self._data.n_loc, src_pad.shape[0]
        sh = self._state_sharding

        @functools.partial(jax.jit, out_shardings=(sh, sh))
        def init(src):
            p = jnp.zeros((n_pad, C), jnp.float32)
            r = jnp.zeros((n_pad, C), jnp.float32).at[
                src, jnp.arange(C)].set(1.0)
            return p, r

        return init(src_pad)

    def _level_step(self, ckey: int):
        # ckey is the index depth (base __init__, index branch)
        if ckey not in self._lsteps:
            data = self._data
            fn = functools.partial(
                _shard_level_step, rcfg=self.rcfg, n_loc=data.n_loc,
                k=self.k, index_depth=ckey,
                index_bucket_offsets=data.index_bucket_offsets,
                index_has_mult=data.index_has_mult,
                n_graph_shards=self.G, exchange=self._exchange,
                exchange_cap=data.exchange_cap, t_bound=self._t_bound,
                weighted=data.weighted, host_groups=data.host_groups,
                hub_split=data.hub_split)
            gspec = data.gspec
            st = P(GRAPH_AXIS, QUERY_AXIS)
            q = P(QUERY_AXIS)
            mapped = shard_map(
                fn, self.mesh,
                in_specs=(st, st, P(), P(), P(),
                          gspec, gspec, gspec, gspec, gspec, gspec,
                          gspec, gspec, gspec, gspec,
                          P(), gspec, gspec, gspec),
                out_specs=(q, q, q, q, q, st, st))
            # donate the row-sharded (p, r) block — query_pool rebinds the
            # block slot to the outputs, so aliasing state-in onto
            # state-out is safe and halves per-level state HBM
            jitted = jax.jit(mapped, donate_argnums=(0, 1))
            args = self._shard_args

            def step(p, r, key, rmax, omega_unit):
                return jitted(p, r, key, rmax, omega_unit, *args)

            self._lsteps[ckey] = step
        return self._lsteps[ckey]
