"""Synthetic graph generators and deterministic fixtures.

The sandbox has no network, so the paper's datasets (DBLP, LiveJournal,
Twitter, Friendster) are stood in for by generators at matching scales:
Erdos-Renyi for uniform-degree sanity, RMAT for the power-law degree skew
that stresses the hub-splitting ELL path, plus tiny analytic fixtures whose
exact PPR is checkable in closed form (SURVEY.md Sec. 4).
"""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def cycle_graph(n: int) -> CSRGraph:
    """Directed n-cycle: PPR from s is analytic: pi(s, s+j) = a*(1-a)^j / norm."""
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    return from_edges(src, dst, n)


def star_graph(n: int) -> CSRGraph:
    """Node 0 -> {1..n-1}; leaves are dangling (exercise dangling->source)."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    return from_edges(src, dst, n)


def complete_graph(n: int) -> CSRGraph:
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return from_edges(src, dst, n)


def karate_club() -> CSRGraph:
    """Zachary's karate club (34 nodes, 78 undirected edges), as a symmetric
    directed graph — the standard tiny community-structure fixture."""
    und = [
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
        (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
        (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21),
        (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
        (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
        (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
        (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33),
        (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29),
        (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
        (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32),
        (30, 33), (31, 32), (31, 33), (32, 33),
    ]
    e = np.array(und, dtype=np.int64)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return from_edges(src, dst, 34)


def erdos_renyi(n: int, m: int, seed: int = 0,
                ensure_no_self_loops: bool = True) -> CSRGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    if ensure_no_self_loops:
        loop = src == dst
        dst[loop] = (dst[loop] + 1) % n
    return from_edges(src, dst, n)


def rmat(n_log2: int, m: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRGraph:
    """RMAT (Graph500-style) power-law generator.

    n = 2**n_log2 nodes; each edge drops one bit at a time through the
    (a, b, c, d) quadrant distribution.  Produces the heavy-tailed in/out
    degree skew that LiveJournal/Twitter-scale benchmarks exercise.
    """
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    q = np.empty(m, dtype=np.int64)
    for bit in range(n_log2):
        u = rng.random(m)
        # quadrant: 0->(0,0) 1->(0,1) 2->(1,0) 3->(1,1) — the number of
        # cumulative thresholds a, a+b, a+b+c that u reaches
        np.greater_equal(u, a, out=q, casting="unsafe")
        q += u >= a + b
        q += u >= a + b + c
        src <<= 1
        src |= q >> 1
        dst <<= 1
        dst |= q & 1
    # permute node ids to break the bit-prefix locality RMAT induces
    perm = rng.permutation(1 << n_log2)
    src, dst = perm[src], perm[dst]
    loop = src == dst
    dst[loop] = (dst[loop] + 1) % (1 << n_log2)
    return from_edges(src, dst, 1 << n_log2)
