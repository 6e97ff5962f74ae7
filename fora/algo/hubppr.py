"""HubPPR — hub-indexed PPR competitor (reference ``--algo hubppr`` hook
[R: fora.cpp / algo.h — SURVEY.md Sec. 2.1 "(possibly) HubPPR hooks";
presence upstream unverifiable with the empty reference mount, so this
implements the published algorithm the hook would dispatch to: Wang et
al., "HubPPR: Effective Indexing for Approximate Personalized PageRank",
VLDB 2016 — the same group's prior system].

HubPPR accelerates Monte-Carlo PPR estimation with a **forward hub
index**: for a small set of high-centrality hub nodes, endpoint samples
of alpha-terminating walks are precomputed; any query-time walk that
*arrives* at a hub is finished immediately by drawing one stored
endpoint.  On power-law graphs random walks hit a hub within a couple of
hops, so expected query-time hop count collapses.

Correctness: a walk currently at node v (termination coin not yet
flipped at v) has endpoint distribution exactly pi(v, .), and the pool
of v stores i.i.d. samples of pi(v, .) — substituting a uniformly drawn
pool entry on arrival leaves the walk's endpoint distribution unchanged
(memorylessness of the geometric stopping time).  Walks never substitute
at hop 0, so distinct lanes decorrelate across first-hop neighborhoods.

Caveat carried over from the paper's index design: pool entries are
shared across query walks, so two walks finishing at the same hub reuse
samples.  With U hub hits against a pool of P entries the effective
variance inflates by at most a (1 + U/P) factor; size ``pool_size``
at or above the per-hub walk demand (the builder default scales with
omega) to keep the (eps, delta, p_f) analysis intact.

Batched formulation: the hub pool is a dense [H, P] endpoint table
(one row gather per superstep), hub membership is an O(1) [n] slot map,
and hub substitution folds into the lockstep hop loop as one extra
gather + select — no per-walk branching, no host control flow.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops import walk as walk_ops


class HubIndex(NamedTuple):
    """Forward hub index (device arrays).

    ``hub_id[v]`` is v's row in ``pool`` or -1; ``pool[h, j]`` is the
    endpoint of the j-th precomputed alpha-walk from hub h.
    """

    hub_nodes: jnp.ndarray   # [H] i32 — node id of each hub
    hub_id: jnp.ndarray      # [n] i32 — hub slot of node v, or -1
    pool: jnp.ndarray        # [H, P] i32 — precomputed walk endpoints

    @property
    def num_hubs(self) -> int:
        return self.pool.shape[0]

    @property
    def pool_size(self) -> int:
        return self.pool.shape[1]


def select_hubs(out_deg: np.ndarray, in_deg: np.ndarray,
                num_hubs: int) -> np.ndarray:
    """Hub selection: top-H nodes by total degree.

    The paper selects hubs by estimated benefit (hit frequency x saved
    work); on the graphs in scope, random-walk hit frequency is
    proportional to in-degree and saved work grows with out-degree, so
    total degree is the standard proxy.  Dangling nodes are excluded
    (a walk arriving there is already finished by the absorbing rule).
    """
    score = out_deg.astype(np.int64) + in_deg.astype(np.int64)
    score = np.where(out_deg > 0, score, -1)
    h = min(num_hubs, int((out_deg > 0).sum()))
    hubs = np.argpartition(-score, h - 1)[:h]
    return np.sort(hubs).astype(np.int32)


def build_hub_index(graph: DeviceGraph, key: jax.Array, *, alpha: float,
                    num_hubs: int = 256, pool_size: int = 4096,
                    max_hops: int = 64,
                    in_deg: Optional[np.ndarray] = None) -> HubIndex:
    """Run ``pool_size`` plain alpha-walks from each hub (lockstep, one
    [P, H] batch) and freeze their endpoints as the pool."""
    out_deg = np.asarray(graph.out_deg)
    if in_deg is None:
        # on a merged DeviceGraph (in_w set) in_dst holds UNIQUE pairs;
        # weight the count by the multiplicity so hub selection sees the
        # true multigraph in-degree (hub-split graphs: tail + hub parts)
        w = (np.asarray(graph.in_w) if graph.in_w is not None else None)
        in_deg = np.bincount(np.asarray(graph.in_dst), weights=w,
                             minlength=graph.n).astype(np.int64)
        if graph.hub_split:
            hw = (np.asarray(graph.hub_w) if graph.hub_w is not None
                  else None)
            in_deg += np.bincount(np.asarray(graph.hub_dst), weights=hw,
                                  minlength=graph.n).astype(np.int64)
    hubs = select_hubs(out_deg, np.asarray(in_deg), num_hubs)
    H = len(hubs)
    hub_id = np.full(graph.n, -1, np.int32)
    hub_id[hubs] = np.arange(H, dtype=np.int32)
    # chunk the pool build over hubs with the length-scheduled kernel:
    # at production sizes (H=4096, P=2^15) one monolithic run_walks
    # program is 134M lanes of walk state at once; chunks of <= 2^22
    # lanes bound that memory.
    hub_chunk = max(1, (1 << 22) // max(pool_size, 1))
    ends = np.empty((pool_size, H), np.int32)
    run = jax.jit(functools.partial(walk_ops.run_walks_scheduled,
                                    alpha=alpha, max_hops=max_hops))
    fallback = jax.jit(functools.partial(walk_ops.run_walks, alpha=alpha,
                                         max_hops=max_hops))
    hubs_dev = jnp.asarray(hubs)
    for ci, lo in enumerate(range(0, H, hub_chunk)):
        hs = hubs_dev[lo: lo + hub_chunk]
        c = hs.shape[0]
        start = jnp.broadcast_to(hs[None, :], (pool_size, c)).reshape(-1)
        ck = jax.random.fold_in(key, ci)
        ep, ok = run(graph, start, ck)
        if not bool(np.asarray(ok)):   # width-bound overflow: plain kernel
            ep = fallback(graph, start.reshape(pool_size, c),
                          ck).reshape(-1)
        ends[:, lo: lo + c] = np.asarray(ep).reshape(pool_size, c)
    return HubIndex(hub_nodes=jnp.asarray(hubs), hub_id=jnp.asarray(hub_id),
                    pool=jnp.asarray(ends.T))              # [H, P]


def default_pool_size(rcfg: ResolvedConfig, num_walks: int,
                      cap: int = 1 << 15) -> int:
    """Pool sized so the variance inflation (1 + U/P) stays below ~2 even
    if every query walk finished at one hub: P >= num_walks, capped."""
    return max(1024, min(cap, 1 << math.ceil(math.log2(max(num_walks, 2)))))


def hub_walks(graph: DeviceGraph, start: jnp.ndarray, key: jax.Array,
              hub: HubIndex, *, alpha: float,
              max_hops: int = 64) -> jnp.ndarray:
    """Lockstep alpha-walks with hub short-circuit; endpoints [W, B] i32.

    Identical endpoint distribution to ``walk_ops.run_walks`` (tested
    against the exact oracle); expected hops per walk drops from
    (1-alpha)/alpha to the hub hitting time.
    """
    W, B = start.shape
    P = hub.pool_size
    length = walk_ops.geometric_lengths(jax.random.fold_in(key, 0), (W, B),
                                        alpha, max_hops)
    deg = graph.out_deg

    def hop(h, carry):
        cur, done = carry
        u = jax.random.uniform(jax.random.fold_in(key, h + 1), (W, B))
        d = deg[cur]
        alive = jnp.logical_and(jnp.logical_not(done),
                                jnp.logical_and(h < length, d > 0))
        j = jnp.minimum((u * d.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(d - 1, 0))
        nxt = graph.out_indices[graph.out_indptr[cur] + j]
        nxt = jnp.where(alive, nxt, cur)
        # arrival at a hub finishes the walk with one pool draw
        hid = hub.hub_id[nxt]
        at_hub = jnp.logical_and(alive, hid >= 0)
        u2 = jax.random.uniform(
            jax.random.fold_in(key, max_hops + h + 1), (W, B))
        pj = jnp.minimum((u2 * P).astype(jnp.int32), P - 1)
        pooled = hub.pool[jnp.maximum(hid, 0), pj]
        return (jnp.where(at_hub, pooled, nxt),
                jnp.logical_or(done, at_hub))

    cur, _ = jax.lax.fori_loop(0, max_hops, hop,
                               (start, jnp.zeros((W, B), bool)))
    return cur


def hubppr_query(graph: DeviceGraph, sources: jnp.ndarray, key: jax.Array,
                 hub: HubIndex, *, rcfg: ResolvedConfig,
                 num_walks: int) -> jnp.ndarray:
    """Hub-accelerated Monte-Carlo SSPPR: [n, B] endpoint frequencies of
    ``num_walks`` hub-short-circuited walks per source."""
    B = sources.shape[0]
    start = jnp.broadcast_to(sources[None, :], (num_walks, B))
    ends = hub_walks(graph, start, key, hub, alpha=rcfg.alpha,
                     max_hops=rcfg.max_walk_hops)
    w = jnp.full((num_walks, B), 1.0 / num_walks, jnp.float32)
    return walk_ops.accumulate_endpoints(ends, w, graph.n)


def hubppr_pairs(graph: DeviceGraph, sources: jnp.ndarray,
                 targets: jnp.ndarray, key: jax.Array, hub: HubIndex, *,
                 rcfg: ResolvedConfig, rmax_b: float,
                 num_walks: int) -> jnp.ndarray:
    """Pairwise pi(s_i, t_j) for all (source, target) pairs: [S, T].

    The paper's bidirectional estimator (backward push from each target
    + forward walks from each source, as in BiPPR) with the forward
    phase served by the hub index.
    """
    from .bippr import backward_push
    st = backward_push(graph, targets, rmax_b=rmax_b, alpha=rcfg.alpha)
    S = sources.shape[0]
    start = jnp.broadcast_to(sources[None, :], (num_walks, S))
    ends = hub_walks(graph, start, key, hub, alpha=rcfg.alpha,
                     max_hops=rcfg.max_walk_hops)          # [W, S]
    walk_term = jnp.mean(st.r[ends, :], axis=0)            # [S, T]
    return st.p[sources, :].reshape(S, -1) + walk_term


def make_hubppr_fn(graph: DeviceGraph, rcfg: ResolvedConfig, key: jax.Array,
                   *, num_hubs: int = 256, max_walks: int = 1 << 22,
                   pool_size: Optional[int] = None):
    """CLI entry: build the hub index once, return a jitted
    (sources, key) -> [n, B] SSPPR estimator at the config's guarantee."""
    num_walks = min(int(rcfg.omega_unit) + 1, max_walks)
    if pool_size is None:
        pool_size = default_pool_size(rcfg, num_walks)
    hub = build_hub_index(graph, jax.random.fold_in(key, 0x48554250),
                          alpha=rcfg.alpha, num_hubs=num_hubs,
                          pool_size=pool_size)
    impl = jax.jit(functools.partial(hubppr_query, rcfg=rcfg,
                                     num_walks=num_walks))

    def fn(sources, k):
        return impl(graph, sources, k, hub)

    fn.hub_index = hub
    return fn
