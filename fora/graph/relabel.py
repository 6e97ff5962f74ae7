"""Node relabeling for gather locality on the push superstep.

The push superstep's cost is the random row-gather ``contrib[in_src]``
over the dst-sorted edge list (ops/push.py gather_segment_sum) — far
below the device-memory roofline because the per-element row lookups
land anywhere in the [n, B] operand.  PPR itself is label-invariant, so we
are free to renumber nodes to cluster the HOT rows (the ones gathered most
often = high out-degree on a power-law graph: the top ~1% of nodes cover
~25% of edges) into a compact region of the operand, and/or to make
consecutive gathers (edges adjacent in dst order) hit nearby rows.

Orders provided:

  * ``degree_order``  — out-degree descending: all hub rows land in the
    first few MB of the operand (page/row-buffer locality for the skewed
    25% of gathers).
  * ``bfs_order``     — breadth-first over the undirected adjacency from
    the highest-degree node: neighbors get nearby labels, so the src rows
    gathered for one dst block cluster (community locality).

The transform relabels the edge list and repacks CSR (``relabel_graph``);
query sources map forward with ``perm`` and results map back with the
inverse (``invert``).  The FORA+ index must be built on (or relabeled to)
the same order — index edges are (node -> endpoint) pairs, both sides
relabel (``relabel_index``).

No counterpart in the reference: its frontier queue chases per-node
pointers and is label-indifferent [R: algo.h forward_local_update_linear —
reconstruction, SURVEY.md Sec. 3.1]; label choice only matters once push
is a batched gather over a flat operand, which is a device-layout concern.
"""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def invert(perm: np.ndarray) -> np.ndarray:
    """inv[new] = old for perm[old] = new."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def degree_order(g: CSRGraph) -> np.ndarray:
    """perm[old] = new with nodes numbered by out-degree descending
    (ties: old id ascending, so the order is deterministic)."""
    old_by_rank = np.argsort(-g.out_deg.astype(np.int64), kind="stable")
    return invert(old_by_rank.astype(np.int32))


def bfs_order(g: CSRGraph) -> np.ndarray:
    """perm[old] = new in breadth-first order over the undirected
    adjacency, starting from the highest-out-degree node; remaining
    components start from their highest-degree unvisited node.  Level
    frontiers are expanded vectorized (one gather over the concatenated
    CSR rows per level) — O(m) numpy per level, no Python per-node loop.
    """
    n = g.n
    # undirected adjacency = out-edges + reversed in-edges, CSR-packed
    src = np.concatenate([
        np.repeat(np.arange(n, dtype=np.int64),
                  g.out_deg.astype(np.int64)),
        g.in_dst.astype(np.int64)])
    dst = np.concatenate([g.out_indices.astype(np.int64),
                          g.in_src.astype(np.int64)])
    order = np.argsort(src, kind="stable")
    adj = dst[order]
    deg = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    visited = np.zeros(n, dtype=bool)
    new_of_old = np.empty(n, dtype=np.int32)
    next_label = 0
    by_degree = np.argsort(-g.out_deg.astype(np.int64), kind="stable")
    unseen_ptr = 0
    while next_label < n:
        while unseen_ptr < n and visited[by_degree[unseen_ptr]]:
            unseen_ptr += 1
        frontier = np.asarray([by_degree[unseen_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            new_of_old[frontier] = np.arange(
                next_label, next_label + frontier.size, dtype=np.int32)
            next_label += frontier.size
            # expand every frontier row at once
            starts, ends = indptr[frontier], indptr[frontier + 1]
            total = int((ends - starts).sum())
            if total == 0:
                break
            idx = np.repeat(starts, ends - starts) + (
                np.arange(total) -
                np.repeat(np.cumsum(ends - starts) - (ends - starts),
                          ends - starts))
            nxt = adj[idx]
            nxt = nxt[~visited[nxt]]
            if nxt.size == 0:
                break
            nxt = np.unique(nxt)
            visited[nxt] = True
            frontier = nxt
    return new_of_old


def relabel_graph(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Repack the graph with node ids mapped through ``perm`` (old -> new).
    Exact same multigraph (edges, weights, multiplicities) under new
    names; from_edges re-sorts both edge orders."""
    n = g.n
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.array_equal(
            np.sort(perm), np.arange(n, dtype=perm.dtype)):
        raise ValueError("perm must be a permutation of [0, n)")
    src = np.repeat(np.arange(n, dtype=np.int64),
                    g.out_deg.astype(np.int64))
    return from_edges(perm[src], perm[g.out_indices.astype(np.int64)], n,
                      w=g.out_w)


def relabel_index(index, perm: np.ndarray):
    """Relabel a FORA+ walk index built on the OLD labels to the new ones.

    Index edges are (source node -> walk endpoint) pairs bucketed by
    per-node prefix fraction with a dst-sorted-per-bucket contract
    (index/build.py); both endpoints map through ``perm`` and each bucket
    re-sorts by (dst, src).  counts_cum rows permute to the new node ids.
    Per-node walk COUNTS ride along unchanged, so the accuracy contract
    (coverage thresholds, omega_unit) is untouched.
    """
    import jax.numpy as jnp

    from ..index.build import WalkIndex
    perm = np.asarray(perm, dtype=np.int64)
    src = perm[np.asarray(index.edge_src, dtype=np.int64)]
    dst = perm[np.asarray(index.edge_dst, dtype=np.int64)]
    mult = (None if index.edge_mult is None
            else np.asarray(index.edge_mult))
    offs = np.asarray(index.bucket_offsets, dtype=np.int64)
    bucket = np.zeros(src.shape[0], dtype=np.int64)
    for b, lo in enumerate(offs[:-1]):
        bucket[lo:] = b
    # same (bucket, dst, src) sort as pack_index/_merge_bucket_duplicates:
    # bucket partition preserved, dst-ascending within bucket (the sorted
    # segment_sum contract)
    order = np.lexsort((src, dst, bucket))
    counts_cum = np.asarray(index.counts_cum)
    inv = invert(perm.astype(np.int32)).astype(np.int64)
    return WalkIndex(
        edge_src=jnp.asarray(src[order].astype(np.int32)),
        edge_dst=jnp.asarray(dst[order].astype(np.int32)),
        bucket_offsets=index.bucket_offsets,
        counts_cum=jnp.asarray(counts_cum[inv]),
        omega_unit_built=index.omega_unit_built,
        rmax_built=index.rmax_built,
        edge_mult=None if mult is None else jnp.asarray(mult[order]),
    )
