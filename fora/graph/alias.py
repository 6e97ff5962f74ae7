"""Alias tables for O(1) categorical sampling of (weighted) out-neighbors.

The reference samples a *uniform* out-neighbor per walk hop with SFMT
[R: algo.h random_walk — reconstruction, SURVEY.md Sec. 2.1], so a plain
``randint`` into the CSR row is equivalent for unweighted graphs.  Alias
tables (Walker/Vose) are built anyway per the north star so weighted graphs
sample in one gather + one compare — the vectorized O(1) form.

Layout: per-edge-slot tables aligned with the out-CSR, so a hop is
  j    = randint(deg[cur])
  slot = out_indptr[cur] + j
  take = u < alias_prob[slot] ? out_indices[slot] : alias_other[slot]
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .csr import CSRGraph


class AliasTables(NamedTuple):
    prob: np.ndarray   # [m] f32, acceptance probability of the slot's own edge
    other: np.ndarray  # [m] i32, alternative destination node id


def build_alias(g: CSRGraph, weights: Optional[np.ndarray] = None) -> AliasTables:
    """Vose alias construction per CSR row. ``weights`` is per-edge (out-CSR
    order); None means uniform (prob=1 everywhere, other=self).

    The native C++ builder (fora/_native, O(m), no Python per-row loop)
    is used when available — required at LiveJournal+ scale; this Python
    loop is the tested fallback (same distribution; tables may differ in
    stack order, which sampling is insensitive to)."""
    m = g.m
    prob = np.ones(m, dtype=np.float32)
    other = np.asarray(g.out_indices, dtype=np.int32).copy()
    if weights is None:
        return AliasTables(prob=prob, other=other)

    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (m,):
        raise ValueError("weights must be per-edge, out-CSR order")

    from .._native import native_build_alias
    if native_build_alias is not None:
        p, o = native_build_alias(np.asarray(g.out_indptr, np.int64),
                                  g.out_indices,
                                  np.asarray(weights, np.float32))
        return AliasTables(prob=p, other=o)
    indptr = np.asarray(g.out_indptr, dtype=np.int64)
    cols = np.asarray(g.out_indices, dtype=np.int64)
    for v in range(g.n):
        lo, hi = indptr[v], indptr[v + 1]
        d = hi - lo
        if d == 0:
            continue
        p = w[lo:hi] / w[lo:hi].sum() * d  # scaled to mean 1
        small = [i for i in range(d) if p[i] < 1.0]
        large = [i for i in range(d) if p[i] >= 1.0]
        pp = p.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            prob[lo + s] = pp[s]
            other[lo + s] = cols[lo + l]
            pp[l] = (pp[l] + pp[s]) - 1.0
            (small if pp[l] < 1.0 else large).append(l)
        for i in large + small:
            prob[lo + i] = 1.0
            other[lo + i] = cols[lo + i]
    return AliasTables(prob=prob, other=other)
