"""Pure Monte-Carlo SSPPR — competitor baseline (reference ``--algo
montecarlo`` [R: algo.h montecarlo_query — reconstruction, SURVEY.md
Sec. 2.1]).

omega = (2 eps/3 + 2) ln(2/p_f) / (eps^2 delta) walks from the source
itself (rsum = 1 case of the FORA bound); estimate = endpoint frequencies.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops import walk as walk_ops


def montecarlo_query(graph: DeviceGraph, sources: jnp.ndarray, key: jax.Array,
                     *, rcfg: ResolvedConfig,
                     num_walks: int) -> jnp.ndarray:
    """[n, B] estimate from ``num_walks`` source-rooted walks per query
    (plain lockstep kernel — the scheduled variant below is the default
    query path)."""
    B = sources.shape[0]
    start = jnp.broadcast_to(sources[None, :], (num_walks, B))
    endpoints = walk_ops.run_walks(graph, start, key,
                                   alpha=rcfg.alpha,
                                   max_hops=rcfg.max_walk_hops)
    w = jnp.full((num_walks, B), 1.0 / num_walks, jnp.float32)
    return walk_ops.accumulate_endpoints(endpoints, w, graph.n)


def montecarlo_query_scheduled(graph: DeviceGraph, sources: jnp.ndarray,
                               key: jax.Array, *, rcfg: ResolvedConfig,
                               num_walks: int):
    """montecarlo_query on the length-scheduled walk kernel (~10x fewer
    hop-gather elements; ops/walk.run_walks_scheduled).  The scheduled
    kernel returns endpoints in original lane order, so the flat [W*B]
    lanes reshape straight back to [W, B].  Returns (estimate, ok)."""
    B = sources.shape[0]
    start = jnp.broadcast_to(sources[None, :],
                             (num_walks, B)).reshape(-1)
    ep, ok = walk_ops.run_walks_scheduled(graph, start, key,
                                          alpha=rcfg.alpha,
                                          max_hops=rcfg.max_walk_hops)
    w = jnp.full((num_walks, B), 1.0 / num_walks, jnp.float32)
    return walk_ops.accumulate_endpoints(ep.reshape(num_walks, B), w,
                                         graph.n), ok


def make_montecarlo_fn(graph: DeviceGraph, rcfg: ResolvedConfig,
                       max_walks: int = 1 << 22,
                       max_lanes_per_program: int = 1 << 22):
    """Chunked MC query closure.  One monolithic program over
    num_walks*B lanes holds per-lane walk state for all of them at once
    — dispatch in <= ``max_lanes_per_program``-lane chunks (the same
    memory bound build_hub_index uses) and average the per-chunk
    estimates.
    The plain-kernel fallback on schedule overflow then also re-runs only
    the overflowing chunk, not the whole query."""
    import functools

    import numpy as np
    num_walks = min(int(rcfg.omega_unit) + 1, max_walks)

    def walks_per_chunk(B: int) -> int:
        return max(1, max_lanes_per_program // max(1, B))

    # graph passes as a jit argument, not a closure constant (see
    # make_fora_param_fn docstring).  num_walks as a static kwarg keeps one
    # compiled shape per (chunk size, B).
    impl = jax.jit(functools.partial(montecarlo_query_scheduled, rcfg=rcfg),
                   static_argnames=("num_walks",))
    plain = jax.jit(functools.partial(montecarlo_query, rcfg=rcfg),
                    static_argnames=("num_walks",))

    def fn(sources, key):
        B = int(sources.shape[0])
        wpc = walks_per_chunk(B)
        est = None
        done = 0
        i = 0
        while done < num_walks:
            w = min(wpc, num_walks - done)
            # keep at most two compiled shapes: full chunks + one remainder
            ck = jax.random.fold_in(key, i)
            e, ok = impl(graph, sources, ck, num_walks=w)
            if not bool(np.asarray(ok)):   # schedule overflow: plain kernel
                e = plain(graph, sources, ck, num_walks=w)
            est = e * (w / num_walks) if est is None \
                else est + e * (w / num_walks)
            done += w
            i += 1
        return est

    return fn
