"""BiPPR — bidirectional PPR competitor (reference ``--algo bippr``
[R: algo.h bippr_query — reconstruction, SURVEY.md Sec. 2.1]).

Identity (Lofgren et al.):  pi(s, t) = p_t(s) + sum_v pi(s, v) * r_t(v)
where (p_t, r_t) come from *backward* push from target t to threshold
rmax_b, and pi(s, .) is estimated by W forward walk endpoints:

  pi_hat(s, t) = p_t(s) + (1/W) * sum_w r_t(endpoint_w).

Batched backward push: same masked-superstep pattern as the forward
engine, but mass flows along reversed edges with the *receiver's*
out-degree as the divisor — per-edge values are segment-summed in out-CSR
(src-sorted) order, so no extra edge permutation is needed.

Absorbing-dangling convention: a walk reaching a dangling node v ends
there with certainty, so  pi(s, v) = [s == v] + ((1-a)/a) *
sum_{u->v} pi(s, u)/dout(u).  Backward push at dangling v therefore settles
its FULL residual into p[v] and spreads with factor (1-a)/a (instead of
alpha / (1-a) at ordinary nodes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops import walk as walk_ops


class BackwardPushState(NamedTuple):
    p: jnp.ndarray      # [n, T] f32 — settled pi(., t) lower estimates
    r: jnp.ndarray      # [n, T] f32 — backward residues
    iters: jnp.ndarray  # [] i32


def backward_push(graph: DeviceGraph, targets: jnp.ndarray, *, rmax_b: float,
                  alpha: float, max_iters: int = 500) -> BackwardPushState:
    """Batched reverse push from each target; invariant
    pi(s,t) = p_t(s) + sum_v pi(s,v) r_t(v) holds at every superstep."""
    n = graph.n
    T = targets.shape[0]
    deg = graph.out_deg.astype(jnp.float32)          # [n]
    # per-edge back-propagation factor, out-CSR order: w(u,v)/W(u) on
    # weighted graphs, 1/dout(u) otherwise
    src_of_edge = jnp.repeat(jnp.arange(n), graph.out_deg, axis=0,
                             total_repeat_length=graph.m)
    if graph.weighted:
        inv_deg_edge = graph.out_w / jnp.maximum(
            graph.out_wsum[src_of_edge], 1e-30)              # [m]
    else:
        inv_deg_edge = 1.0 / jnp.maximum(deg[src_of_edge], 1.0)  # [m]

    dangling = (deg == 0.0)[:, None]                  # [n, 1]

    r0 = jnp.zeros((n, T), jnp.float32).at[targets, jnp.arange(T)].set(1.0)
    p0 = jnp.zeros((n, T), jnp.float32)

    def cond(st):
        return jnp.logical_and(st.iters < max_iters,
                               jnp.any(st.r > rmax_b))

    def body(st):
        active = st.r > rmax_b
        ar = jnp.where(active, st.r, 0.0)
        # dangling: settle full residual, spread with (1-a)/a (see docstring)
        p = st.p + jnp.where(dangling, ar, alpha * ar)
        spread = jnp.where(dangling, (1.0 - alpha) / alpha * ar,
                           (1.0 - alpha) * ar)
        # edge u->v carries spread[v] / dout(u) back to u
        edge_vals = spread[graph.out_indices] * inv_deg_edge[:, None]  # [m,T]
        delta = jax.ops.segment_sum(edge_vals, src_of_edge,
                                    num_segments=n, indices_are_sorted=True)
        r = jnp.where(active, 0.0, st.r) + delta
        return BackwardPushState(p=p, r=r, iters=st.iters + 1)

    return jax.lax.while_loop(cond, body,
                              BackwardPushState(p0, r0,
                                                jnp.zeros((), jnp.int32)))


def default_bippr_params(rcfg: ResolvedConfig) -> tuple:
    """Balanced (rmax_b, num_walks), mirroring the forward derivation
    (config.py): backward-push cost per target ~ (m/n)/rmax_b, walk cost
    ~ W = c0 * rmax_b / (eps^2 delta) (each walk's contribution is bounded
    by rmax_b, so W plays omega's role with rsum -> rmax_b); equating the
    two gives rmax_b = eps * sqrt(delta * m / (n * c0))."""
    import math
    c0 = (2.0 * rcfg.epsilon / 3.0 + 2.0) * math.log(2.0 / rcfg.pfail)
    rmax_b = rcfg.epsilon * math.sqrt(
        rcfg.delta * rcfg.m / (rcfg.n * c0))
    num_walks = max(64, int(c0 * rmax_b /
                            (rcfg.epsilon ** 2 * rcfg.delta)))
    return rmax_b, num_walks


def make_bippr_fn(graph: DeviceGraph, rcfg: ResolvedConfig,
                  targets: jnp.ndarray, rmax_b: float = None,
                  num_walks: int = None, lane_cap: int = 1 << 22):
    """Jitted ``(sources, key) -> [S, T]`` pair estimates against a fixed
    target set — the reference's ``--algo bippr`` competitor surface
    [R: algo.h bippr_query].  BiPPR is inherently pairwise; for SSPPR
    evaluation pass targets = all nodes (small graphs) or a candidate set."""
    import functools
    if rmax_b is None or num_walks is None:
        d_rmax_b, d_walks = default_bippr_params(rcfg)
        rmax_b = d_rmax_b if rmax_b is None else rmax_b
        num_walks = d_walks if num_walks is None else num_walks
    num_walks = min(num_walks, lane_cap)
    impl = jax.jit(functools.partial(bippr_pairs, rcfg=rcfg, rmax_b=rmax_b,
                                     num_walks=num_walks))

    def fn(sources, key):
        return impl(graph, sources, targets, key)

    fn.rmax_b, fn.num_walks = rmax_b, num_walks
    return fn


def bippr_pairs(graph: DeviceGraph, sources: jnp.ndarray,
                targets: jnp.ndarray, key: jax.Array, *,
                rcfg: ResolvedConfig, rmax_b: float,
                num_walks: int) -> jnp.ndarray:
    """Estimate pi(s_i, t_j) for all source/target pairs: [S, T]."""
    st = backward_push(graph, targets, rmax_b=rmax_b, alpha=rcfg.alpha)
    S = sources.shape[0]
    start = jnp.broadcast_to(sources[None, :], (num_walks, S))
    ends = walk_ops.run_walks(graph, start, key, alpha=rcfg.alpha,
                              max_hops=rcfg.max_walk_hops)   # [W, S]
    walk_term = jnp.mean(st.r[ends, :], axis=0)              # [S, T]
    return st.p[sources, :].reshape(S, -1) + walk_term
