"""Forward-push propagation as batched masked SpMV supersteps.

The reference implements push as a sequential frontier queue with
pointer-chasing over adjacency lists [R: algo.h forward_local_update_linear —
reconstruction, SURVEY.md Sec. 3.1 HOT LOOP 1].  The batched formulation
replaces the queue with a *mask*: every superstep processes all currently
over-threshold nodes at once (Jacobi relaxation instead of the reference's
Gauss-Seidel queue — both terminate at the same fixed point
``r[v] <= rmax * out_deg[v]`` and preserve the FORA invariant
``pi_s = p + sum_v r[v] * pi_v`` at every step).

Superstep (node-major layout [n, B], B = query batch):
    active  = r > rmax * out_deg            (dangling: active iff r > 0)
    p      += alpha * r * active
    contrib = (1 - alpha) * r * active / out_deg
    r'      = r * !active + gather-sum_{u->v} contrib[u] + dangling_mass * e_s

Dangling convention: out-degree-0 nodes are absorbing (self-loop), so their
entire residue settles in place in one superstep (the geometric series of
the self-loop, summed exactly) — consistent with the oracle and walk phases
(see fora/algo/exact.py docstring).

Iterated under ``lax.while_loop`` until no row is active (or max_iters).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..graph.csr import DeviceGraph


class PushState(NamedTuple):
    p: jnp.ndarray      # [n, B] f32 — settled probability mass
    r: jnp.ndarray      # [n, B] f32 — residue
    iters: jnp.ndarray  # [] i32


def init_state(n: int, sources: jnp.ndarray) -> PushState:
    """One-hot residue at each query's source. sources: [B] i32."""
    B = sources.shape[0]
    r0 = jnp.zeros((n, B), jnp.float32).at[sources, jnp.arange(B)].set(1.0)
    return PushState(p=jnp.zeros((n, B), jnp.float32), r=r0,
                     iters=jnp.zeros((), jnp.int32))


def _gather_narrow(values, s, out_dtype, col=None):
    """Gather rows of ``values`` at ``s`` and widen to ``out_dtype``, with
    the widening PINNED after the gather.

    Without the pin, XLA rewrites convert(gather(x)) -> gather(convert(x))
    and hoists the operand convert out of the chunk loop — materializing a
    full-width f32 copy of the whole operand (4.3 GB at LiveJournal scale
    B=256) and making the hot gather read f32 rows, silently un-doing the
    narrow-operand bandwidth saving (seen in the optimized HLO; a
    multiply-by-opaque-1 in between is defeated too — XLA's
    precision-increasing simplifications pull the convert through any
    elementwise op).  ``optimization_barrier`` on the gathered chunk is
    the one fence the simplifier cannot cross; it costs materializing the
    narrow [chunk, B] gather result, which the scatter/segment consumer
    needed anyway.

    ``col`` ((c0, w), optional): gather only columns [c0, c0+w) of each
    row — one XLA gather with narrowed slice sizes, never a column-sliced
    COPY of the operand (at LiveJournal scale B=256 that copy is 2.1 GB;
    the half-walk path relies on this).
    """
    vals = values[s, col[0]:col[0] + col[1]] if col is not None \
        else values[s]
    if values.dtype != out_dtype:
        vals = jax.lax.optimization_barrier(vals)
        vals = vals.astype(out_dtype)
    return vals


def gather_segment_sum(values: jnp.ndarray, src: jnp.ndarray,
                       dst: jnp.ndarray, n: int,
                       max_chunk: int = 1 << 23,
                       gather_dtype=None,
                       edge_w: jnp.ndarray = None,
                       src_w: jnp.ndarray = None) -> jnp.ndarray:
    """out[t] += sum over edges e with dst[e]==t of values[src[e]].

    The [E, B] gathered intermediate is materialized by XLA; for large
    edge sets it is processed in chunks under lax.scan so peak memory is
    [max_chunk, B].  Edges must be dst-sorted (sorted segment_sum).

    ``gather_dtype`` (e.g. jnp.bfloat16): cast values to this dtype BEFORE
    the gather, halving the bytes moved through the random-access gather —
    the hot-path bandwidth budget — and accumulate the segment sum in the
    original dtype.  Opt-in: ~0.4% relative error per contribution.

    ``edge_w`` ([E] f32, optional): per-edge multiplier applied to the
    gathered rows (the FORA+ index's duplicate-merge multiplicity) — an
    elementwise VPU op on the already-materialized intermediate, cheap
    next to the gather it shrinks.

    ``src_w`` ([n] f32, optional): per-SOURCE-row multiplier, gathered
    alongside the rows ([chunk] f32 — 4 extra bytes per edge).  Folding a
    row scaling in here instead of pre-scaling ``values`` avoids
    materializing a second [n, B] operand — at LiveJournal scale (4.2M
    nodes, B=128) that buffer is 2.1 GB of HBM the refinement loop can't
    spare (see StagedForaPrograms).
    """
    E = src.shape[0]
    out_dtype = values.dtype
    if gather_dtype is not None:
        values = values.astype(gather_dtype)

    def scaled(s, w):
        vals = _gather_narrow(values, s, out_dtype)
        if src_w is not None:
            vals = vals * src_w[s][:, None]
        if w is not None:
            vals = vals * w[:, None]
        return vals

    if E <= max_chunk:
        return jax.ops.segment_sum(scaled(src, edge_w), dst, num_segments=n,
                                   indices_are_sorted=True)
    # pad entries land in dropped segment n, so no [n+1, B] zero-padded
    # copy of ``values`` is ever materialized (see _chunked_edges)
    src_p, dst_p, w_p = _chunked_edges(src, dst, edge_w, n, max_chunk)

    def body(acc, chunk):
        s, d, w = chunk
        acc = acc + jax.ops.segment_sum(scaled(s, w), d, num_segments=n + 1,
                                        indices_are_sorted=True)
        return acc, None

    acc0 = jnp.zeros((n + 1, values.shape[1]), out_dtype)
    acc, _ = jax.lax.scan(body, acc0, (src_p, dst_p, w_p))
    return acc[:n]


def gather_scatter_add(acc: jnp.ndarray, values: jnp.ndarray,
                       src: jnp.ndarray, dst: jnp.ndarray,
                       max_chunk: int = 1 << 23,
                       gather_dtype=None,
                       edge_w: jnp.ndarray = None,
                       src_w: jnp.ndarray = None,
                       col=None) -> jnp.ndarray:
    """acc[t] += sum over edges e with dst[e]==t of (scaled) values[src[e]],
    scatter-added into the caller's accumulator.

    The accumulator twin of :func:`gather_segment_sum`, for callers that
    already own a [n, B] buffer the result lands in (the push superstep's
    residue carry, the staged bucket-SpMV's contrib accumulator).  The
    sorted scatter-add updates ``acc`` directly, so XLA aliases it in
    place when the input is otherwise dead — eliminating the separate
    [n+1, B] segment-sum accumulator (4.3 GB at LiveJournal scale, 4.2M
    nodes, B=256; see _superstep).

    Chunk-padding entries carry ``dst = acc.shape[0]`` — out of range, so
    the scatter's drop mode discards them; no padded row, no [n+1, B]
    copy.  Scale semantics (``gather_dtype``/``edge_w``/``src_w``) match
    gather_segment_sum exactly.  ``col`` ((c0, w), optional): gather only
    that column window of each ``values`` row (half-walk mode; see
    _gather_narrow) — ``acc`` is then [n, w].
    """
    E = src.shape[0]
    n = acc.shape[0]
    out_dtype = acc.dtype
    if gather_dtype is not None:
        values = values.astype(gather_dtype)

    def add_chunk(a, s, d, w):
        vals = _gather_narrow(values, s, out_dtype, col=col)
        if src_w is not None:
            vals = vals * src_w[s][:, None]
        if w is not None:
            vals = vals * w[:, None]
        return a.at[d].add(vals, indices_are_sorted=True, mode="drop")

    if E <= max_chunk:
        return add_chunk(acc, src, dst, edge_w)
    src_p, dst_p, w_p = _chunked_edges(src, dst, edge_w, n, max_chunk)

    def body(a, chunk):
        s, d, w = chunk
        return add_chunk(a, s, d, w), None

    acc, _ = jax.lax.scan(body, acc, (src_p, dst_p, w_p))
    return acc


def _chunked_edges(src, dst, edge_w, n, max_chunk):
    """Edge arrays reshaped to [n_chunks, max_chunk] for the chunk scan.

    When the edge count is already a multiple of ``max_chunk`` (the
    pre-padded layout ``pad_edge_arrays`` produces), the reshape is a
    free view.  Otherwise pads are appended IN-PROGRAM — a full copy of
    the edge arrays as program temps every call (~2 GB per superstep for
    the judged-scale tail + largest index bucket) — so big-graph callers
    pre-pad.
    Pad entries: src 0 (any valid row), dst n (out of range -> dropped by
    scatter drop-mode / the n+1 dump segment), weight 0.
    """
    E = src.shape[0]
    n_chunks = -(-E // max_chunk)
    pad = n_chunks * max_chunk - E
    if pad == 0:
        return (src.reshape(n_chunks, max_chunk),
                dst.reshape(n_chunks, max_chunk),
                edge_w.reshape(n_chunks, max_chunk)
                if edge_w is not None else None)
    src_p = jnp.concatenate(
        [src, jnp.zeros((pad,), src.dtype)]).reshape(n_chunks, max_chunk)
    dst_p = jnp.concatenate(
        [dst, jnp.full((pad,), n, dst.dtype)]).reshape(n_chunks, max_chunk)
    w_p = (jnp.concatenate([edge_w, jnp.zeros((pad,), edge_w.dtype)])
           .reshape(n_chunks, max_chunk) if edge_w is not None else None)
    return src_p, dst_p, w_p


def pad_edge_arrays(n: int, max_chunk: int, src, dst, w=None):
    """Host-side edge padding to a multiple of ``max_chunk`` (numpy in,
    numpy out) so every chunked gather kernel reshapes for free instead
    of materializing padded copies as program temps (see _chunked_edges).
    Pads: src 0, dst n (dropped), w 0."""
    import numpy as np
    E = len(src)
    if E == 0 or E % max_chunk == 0 or E <= max_chunk:
        return src, dst, w
    pad = -(-E // max_chunk) * max_chunk - E
    src = np.concatenate([src, np.zeros(pad, src.dtype)])
    dst = np.concatenate([dst, np.full(pad, n, dst.dtype)])
    if w is not None:
        w = np.concatenate([w, np.zeros(pad, w.dtype)])
    return src, dst, w


def gather_scatter_add_pair(acc_a: jnp.ndarray, acc_b: jnp.ndarray,
                            values: jnp.ndarray,
                            src: jnp.ndarray, dst: jnp.ndarray,
                            max_chunk: int = 1 << 23,
                            edge_w: jnp.ndarray = None):
    """gather_scatter_add with ONE wide gather feeding TWO half-width
    accumulators: ``values`` is [n, 2w] (the concatenated contributions of
    a block pair), each gathered chunk's column halves scatter-add into
    ``acc_a``/``acc_b`` ([n, w] each).

    This is the paired-push superstep's core trade (SURVEY.md Sec. 7.1
    batching stance): the random row-gather is row-rate-bound, so rows at
    the PAIRED width serve two query blocks per gathered row — while the
    residue carries stay per-block buffers that donate/alias cleanly and
    keep the walk/accept phases at the block width that fits HBM.
    """
    E = src.shape[0]
    n = acc_a.shape[0]
    w = acc_a.shape[1]
    out_dtype = acc_a.dtype

    def add_chunk(a, b, s, d, ew):
        vals = _gather_narrow(values, s, out_dtype)
        if ew is not None:
            vals = vals * ew[:, None]
        a = a.at[d].add(vals[:, :w], indices_are_sorted=True, mode="drop")
        b = b.at[d].add(vals[:, w:], indices_are_sorted=True, mode="drop")
        return a, b

    if E <= max_chunk:
        return add_chunk(acc_a, acc_b, src, dst, edge_w)
    src_p, dst_p, w_p = _chunked_edges(src, dst, edge_w, n, max_chunk)

    def body(carry, chunk):
        a, b = carry
        s, d, ew = chunk
        return add_chunk(a, b, s, d, ew), None

    (acc_a, acc_b), _ = jax.lax.scan(body, (acc_a, acc_b),
                                     (src_p, dst_p, w_p))
    return acc_a, acc_b


def active_edge_segment_sum(values: jnp.ndarray, src: jnp.ndarray,
                            dst: jnp.ndarray, n: int,
                            row_active: jnp.ndarray, e_cap: int,
                            max_chunk: int = 1 << 23) -> jnp.ndarray:
    """gather_segment_sum restricted to edges whose src row is active.

    The reference's frontier queue only touches edges out of active nodes
    [R: algo.h forward_local_update_linear]; the dense masked-SpMV superstep
    touches all m. This recovers the frontier sparsity in batched form: an O(m)
    cheap pass (1-byte mask gather + compaction) selects the <= e_cap active
    in-edges, whose positions stay dst-sorted under compaction, so the main
    O(E_act * B) gather + sorted segment_sum runs only on live edges.
    Supersteps whose active edge count exceeds e_cap take the dense path.
    """
    m = src.shape[0]
    edge_act = row_active.astype(jnp.int8)[src] > 0           # [m]
    cnt = jnp.sum(edge_act.astype(jnp.int32))

    def compact(_):
        sel = jnp.nonzero(edge_act, size=e_cap, fill_value=m)[0]
        src_pad = jnp.concatenate([src, jnp.zeros((1,), src.dtype)])
        dst_pad = jnp.concatenate([dst, jnp.full((1,), n, dst.dtype)])
        # fill slot: src 0 (any valid row), dst n (dropped by segment_sum)
        return gather_segment_sum(values, src_pad[sel], dst_pad[sel], n,
                                  max_chunk=max_chunk)

    def dense(_):
        return gather_segment_sum(values, src, dst, n, max_chunk=max_chunk)

    return jax.lax.cond(cnt <= e_cap, compact, dense, None)


def _superstep(graph: DeviceGraph, rmax: float, alpha: float,
               state: PushState, max_chunk: int = 1 << 23,
               e_cap: int = 0, gather_dtype=None,
               thr=None) -> PushState:
    n = graph.n
    deg = graph.out_deg.astype(jnp.float32)[:, None]          # [n, 1]
    dangling = deg == 0.0
    if thr is None:
        thr = rmax * deg
    active = state.r > thr                                    # [n, B]
    ar = jnp.where(active, state.r, 0.0)
    # dangling absorbs its full residue (self-loop geometric series)
    p = state.p + jnp.where(dangling, ar, alpha * ar)
    # weighted graphs: the propagated fraction down edge (v, u) is
    # w(v,u)/W(v) — in_w carries w, out_wsum carries W (unweighted: the
    # multiplicity/out_deg pair reduces to the same kernel)
    wsum = deg if graph.out_wsum is None else graph.out_wsum[:, None]
    contrib = jnp.where(dangling, 0.0,
                        (1.0 - alpha) * ar / jnp.maximum(wsum, 1e-30))

    if e_cap > 0 and graph.in_w is None and not graph.hub_split:
        row_active = jnp.any(contrib != 0.0, axis=1)
        delta = active_edge_segment_sum(contrib, graph.in_src, graph.in_dst,
                                        n, row_active, e_cap,
                                        max_chunk=max_chunk)
        r = jnp.where(active, 0.0, state.r) + delta
    else:
        # scatter-add the gathered contributions straight into the new
        # residue carry: the retained sub-threshold residue seeds the
        # accumulator, so no separate [n+1, B] segment-sum buffer exists
        # (4.3 GB at 4.2M nodes x B=256)
        r = jnp.where(active, 0.0, state.r)
        r = gather_scatter_add(r, contrib, graph.in_src, graph.in_dst,
                               max_chunk=max_chunk,
                               gather_dtype=gather_dtype,
                               edge_w=graph.in_w)
        if graph.hub_split:
            # hub edges gather from the compact [H, B] operand instead of
            # the full table under hub-skewed indices (the [H, B] take is
            # one cheap shared-index row gather)
            r = gather_scatter_add(
                r, contrib[graph.hub_ids], graph.hub_src_local,
                graph.hub_dst, max_chunk=max_chunk,
                gather_dtype=gather_dtype, edge_w=graph.hub_w)
    return PushState(p=p, r=r, iters=state.iters + 1)


def default_edge_cap(m: int, frac: float = 0.25,
                     min_edges: int = 1 << 16) -> int:
    """Compaction capacity for the frontier-sparse push path; 0 (disabled)
    for graphs small enough that the dense superstep is already trivial."""
    if m <= min_edges:
        return 0
    return max(min_edges, int(m * frac) // 8 * 8)


def forward_push(graph: DeviceGraph, sources: jnp.ndarray, *, rmax: float,
                 alpha: float, max_iters: int = 200) -> PushState:
    """Run supersteps until every node satisfies r <= rmax * out_deg.

    Jit-safe: data-dependent termination via ``lax.while_loop`` on the
    frontier predicate; no host round-trips (SURVEY.md Sec. 7.3).
    """
    return forward_push_from(graph, init_state(graph.n, sources),
                             rmax=rmax, alpha=alpha, max_iters=max_iters)


def forward_push_from(graph: DeviceGraph, state0: PushState, *, rmax: float,
                      alpha: float, max_iters: int = 200,
                      compact_edges: int = 0, max_chunk: int = 1 << 23,
                      gather_dtype=None, thr=None) -> PushState:
    """Continue pushing from an existing (p, r) state to a tighter rmax.

    The FORA invariant pi = p + sum_v r[v] pi_v holds at every superstep,
    so a finer delta level may resume from the previous level's state —
    total push work across a refinement schedule collapses to roughly the
    deepest level's (SURVEY.md Sec. 3.2 refinement loop, incrementalized).

    ``thr`` ([n] or [n, 1] f32, optional): per-node termination threshold
    overriding ``rmax * out_deg``.  The guarantee only needs the per-walk
    weight bound r_v / omega_v <= 1/omega_unit; with the FORA+ index the
    available sample count per node is known exactly (counts at the query
    depth), so push may stop at r_v <= count_v/omega_unit — never tighter
    than rmax*deg_v (counts are sized as ceil(rmax*deg*omega)+1), and much
    looser for low-degree rows, which dominate the superstep tail.
    Sub-threshold residue on dangling rows is served exactly by the
    index's self-edge (absorbing convention).

    ``max_chunk``: edges per gather/segment_sum chunk — peak memory of a
    superstep is the [max_chunk, B] gathered intermediate, so wider query
    batches need a smaller chunk in a fixed memory budget.

    ``compact_edges``: capacity for the frontier-compacted superstep path
    (0 = always dense, the default; -1 = auto via default_edge_cap).
    The [m] per-edge activity mask is a per-element random gather with no
    batch amortization, which can cost more than the dense path saves at
    realistic frontier sizes; an opt-in for very sparse frontiers (B=1
    tails, huge graphs), not measured on the current accelerator.
    Incompatible with merged duplicate edges: on a graph with ``in_w`` set,
    the superstep always takes the dense path (active_edge_segment_sum does
    not thread the per-edge multiplicity), so a requested ``compact_edges``
    is ignored.
    """
    deg = graph.out_deg.astype(jnp.float32)[:, None]
    state0 = state0._replace(iters=jnp.zeros((), jnp.int32))  # per-call cap
    m = graph.m_in
    e_cap = default_edge_cap(m) if compact_edges < 0 else compact_edges
    if e_cap >= m:
        e_cap = 0   # capacity covers everything: dense is strictly cheaper
    if thr is not None and thr.ndim == 1:
        thr = thr[:, None]
    thr_eff = rmax * deg if thr is None else thr

    def cond(s: PushState):
        return jnp.logical_and(s.iters < max_iters,
                               jnp.any(s.r > thr_eff))

    def body(s: PushState):
        return _superstep(graph, rmax, alpha, s, e_cap=e_cap,
                          max_chunk=max_chunk,
                          gather_dtype=gather_dtype, thr=thr)

    return jax.lax.while_loop(cond, body, state0)


def push_only_estimate(graph: DeviceGraph, sources: jnp.ndarray, *,
                       rmax: float, alpha: float,
                       max_iters: int = 200) -> jnp.ndarray:
    """Plain forward-push baseline (reference ``--algo fwdpush``): the
    settled mass p alone, no walk refinement. Returns [n, B]."""
    return forward_push(graph, sources, rmax=rmax, alpha=alpha,
                        max_iters=max_iters).p
