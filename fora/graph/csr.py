"""Graph substrate: CSR packing and the on-device graph pytree.

The reference keeps the graph as ``vector<vector<int>>`` adjacency lists
[R: graph.h — reconstruction, SURVEY.md Sec. 2.1].  The device layout is
flat, static-shaped arrays:

  * out-CSR  (``out_indptr``, ``out_indices``)  — walk-phase neighbor sampling
  * in-edge list sorted by destination (``in_src``, ``in_dst``) — push phase
    as a gather + sorted ``segment_sum`` (a dense masked SpMV superstep)
  * degrees — the push threshold is ``r[v] > rmax * out_deg[v]``

All index arrays are int32 (graphs up to 2^31 edges per shard); values f32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

try:  # jax is optional at build time (the CSR packer is pure numpy)
    import jax.numpy as jnp
except Exception:  # pragma: no cover
    jnp = None


class CSRGraph(NamedTuple):
    """Host-side (numpy) packed graph. Static shapes; device copy via to_device().

    ``n`` and ``m`` are derivable from array shapes, so the device pytree
    carries no static metadata.

    Weighted graphs (optional third column in graph.txt, SURVEY.md Sec. 2.1
    checklist item 2) carry per-edge weights in BOTH edge orders:
    ``out_w`` aligned with ``out_indices`` (walk-phase alias sampling) and
    ``in_w`` aligned with ``in_src``/``in_dst`` (push-phase SpMV).  Random
    walks step v -> u with probability w(v,u) / W(v), W(v) = sum of v's
    out-weights; unweighted graphs (both None) keep uniform transitions.
    """

    out_indptr: np.ndarray   # [n+1] int32, CSR row pointers over out-edges
    out_indices: np.ndarray  # [m]   int32, destination of each out-edge (sorted by src)
    in_src: np.ndarray       # [m]   int32, source of each in-edge (sorted by dst)
    in_dst: np.ndarray       # [m]   int32, destination of each in-edge (ascending)
    out_deg: np.ndarray      # [n]   int32
    in_deg: np.ndarray       # [n]   int32
    out_w: np.ndarray = None  # [m] f32 edge weights (out-CSR order), or None
    in_w: np.ndarray = None   # [m] f32 edge weights (in-edge order), or None

    @property
    def n(self) -> int:
        return int(self.out_indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.out_indices.shape[0])

    @property
    def weighted(self) -> bool:
        return self.out_w is not None


class DeviceGraph(NamedTuple):
    """Device-side graph pytree (all jnp arrays; no static fields).

    ``in_w`` (optional, [m_u] f32): per-in-edge multiplier on the push
    SpMV.  Two producers share this channel (they compose — both are "how
    much of src's unit contribution flows down this edge"):

      * duplicate-edge MULTIPLICITIES: ``in_src``/``in_dst`` hold UNIQUE
        (src, dst) pairs and in_w counts the merged parallel edges — the
        same lossless merge the FORA+ index uses (multigraph semantics
        preserved exactly; out-CSR keeps full multiplicity for walks).
        Shrinks the hot random row-gather by the parallel-edge fraction.
      * edge WEIGHTS (weighted graphs): in_w = w(src, dst) (summed over
        merged parallels) and ``out_wsum`` = per-node total out-weight;
        the superstep divides by out_wsum instead of out_deg, so the
        propagated fraction is w/W — the weighted transition kernel.

    ``alias_prob``/``alias_other`` (optional, [m] aligned with out-CSR):
    Walker alias tables; when set, walk hops sample out-neighbors
    proportionally to weight in O(1) (one extra gather + compare).
    """

    out_indptr: "jnp.ndarray"   # [n+1] i32
    out_indices: "jnp.ndarray"  # [m] i32
    in_src: "jnp.ndarray"       # [m or m_u or m_tail] i32
    in_dst: "jnp.ndarray"       # [m or m_u or m_tail] i32
    out_deg: "jnp.ndarray"      # [n] i32
    in_w: "jnp.ndarray" = None      # [m_u] f32 multiplier, or None
    out_wsum: "jnp.ndarray" = None  # [n] f32 total out-weight, or None
    alias_prob: "jnp.ndarray" = None   # [m] f32, or None
    alias_other: "jnp.ndarray" = None  # [m] i32, or None
    out_w: "jnp.ndarray" = None     # [m] f32 weights, out-CSR order
    #                                 (backward push needs w(u,v)/W(u) in
    #                                 src-sorted order), or None
    # hub-split in-edges (to_device(hub_rows=H); see _superstep): edges
    # whose SOURCE is a top-H out-degree node live here, gathered from a
    # compact [H, B] operand instead of the full [n, B] table the
    # degree-skewed sources would hammer (scripts/hub_split_probe.py
    # measures the split).  When set, in_src/in_dst/in_w hold only the
    # TAIL edges.
    hub_ids: "jnp.ndarray" = None        # [H] i32 hub node ids
    hub_src_local: "jnp.ndarray" = None  # [m_hub] i32 position in hub_ids
    hub_dst: "jnp.ndarray" = None        # [m_hub] i32, dst-sorted
    hub_w: "jnp.ndarray" = None          # [m_hub] f32 multiplier, or None

    @property
    def n(self) -> int:
        return self.out_indptr.shape[0] - 1

    @property
    def m(self) -> int:
        return self.out_indices.shape[0]

    @property
    def weighted(self) -> bool:
        return self.out_wsum is not None

    @property
    def hub_split(self) -> bool:
        return self.hub_ids is not None

    @property
    def m_in(self) -> int:
        """In-edges across both the tail and hub partitions, as the push
        kernels process them: the merged-unique count plus any chunk
        padding from ``to_device(pad_edges=...)`` (use instead of
        in_src.shape[0])."""
        m = self.in_src.shape[0]
        if self.hub_src_local is not None:
            m += self.hub_src_local.shape[0]
        return m


def from_edges(src: np.ndarray, dst: np.ndarray, n: int,
               dedup: bool = False, w: np.ndarray = None) -> CSRGraph:
    """Pack an edge list into CSR + dst-sorted in-edge form.

    Self-loops and parallel edges are kept (the reference treats graph.txt
    verbatim); set ``dedup`` to drop exact duplicate edges.  ``w``
    (optional, [m] positive): per-edge weights, carried into both edge
    orders (see CSRGraph).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    if src.size and (src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n):
        raise ValueError("edge endpoint out of range")
    if w is not None:
        w = np.asarray(w, dtype=np.float32)
        if w.shape != src.shape:
            raise ValueError("w must be per-edge")
        if w.size and w.min() <= 0:
            raise ValueError("edge weights must be positive")
    if dedup and src.size:
        key = src * n + dst
        _, keep = np.unique(key, return_index=True)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]

    m = src.size
    # sort by src for out-CSR
    order = np.argsort(src, kind="stable")
    s_src, s_dst = src[order], dst[order]
    out_deg = np.bincount(s_src, minlength=n).astype(np.int64)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_deg, out=out_indptr[1:])
    # sort by dst for the push-phase segment_sum
    order_in = np.argsort(dst, kind="stable")
    in_src, in_dst = src[order_in], dst[order_in]
    in_deg = np.bincount(dst, minlength=n).astype(np.int64)

    if m >= 2**31:
        raise ValueError("graph shard exceeds int32 index range; shard first")
    return CSRGraph(
        out_indptr=out_indptr.astype(np.int32),
        out_indices=s_dst.astype(np.int32),
        in_src=in_src.astype(np.int32),
        in_dst=in_dst.astype(np.int32),
        out_deg=out_deg.astype(np.int32),
        in_deg=in_deg.astype(np.int32),
        out_w=None if w is None else w[order],
        in_w=None if w is None else w[order_in],
    )


def to_device(g: CSRGraph, merge_duplicate_edges: bool = False,
              hub_rows: int = 0, pad_edges: int = 0) -> DeviceGraph:
    """Copy to device.  ``merge_duplicate_edges`` collapses parallel in-edges
    into unique (src, dst) pairs with an ``in_w`` multiplier column (see
    DeviceGraph) — only worthwhile for multigraphs (e.g. raw RMAT output);
    simple graphs get ``in_w=None`` and the unmodified edge list.

    Weighted graphs (g.out_w set) get the full weighted kernel: push
    multipliers in_w = w (parallel edges merged by SUMMING weights —
    exactly the weight of the combined edge), per-node out-weight totals
    ``out_wsum``, and Walker alias tables for O(1) weighted hop sampling.

    ``hub_rows`` > 0 splits the in-edges by source out-degree: edges from
    the top-``hub_rows`` sources move to the hub partition (gathered from
    a compact [H, B] operand in the push superstep — see DeviceGraph hub
    fields).  Exactness is unchanged (same edges, same weights, two
    dst-sorted segment sums instead of one).

    ``pad_edges`` > 0: pad each in-edge partition to a multiple of this
    (the push gather chunk size) with src 0 / dst n / weight 0 sentinels,
    so the chunked kernels reshape for free instead of materializing
    padded copies as per-call program temps (~0.7 GB per superstep at
    LiveJournal scale; ops/push._chunked_edges).  Semantically inert:
    dst = n is dropped by every consumer.
    """
    in_src, in_dst = g.in_src, g.in_dst
    in_w = None if g.in_w is None else g.in_w.astype(np.float32)
    out_wsum = alias = None
    if g.weighted:
        src = np.repeat(np.arange(g.n, dtype=np.int64),
                        np.asarray(g.out_deg, dtype=np.int64))
        out_wsum = np.bincount(src, weights=np.asarray(g.out_w, np.float64),
                               minlength=g.n).astype(np.float32)
        from .alias import build_alias   # function-level: alias imports csr
        alias = build_alias(g, weights=g.out_w)
    if merge_duplicate_edges and g.m:
        # in-edges are dst-sorted; a stable (dst, src) sort keeps dst order,
        # so the merged list still satisfies sorted-segment_sum's contract
        key = g.in_dst.astype(np.int64) * g.n + g.in_src
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.ones(ks.size, bool)
        first[1:] = ks[1:] != ks[:-1]
        if not first.all():
            starts = np.nonzero(first)[0]
            seg = np.cumsum(first) - 1          # merged-edge id per position
            in_src = g.in_src[order][starts]
            in_dst = g.in_dst[order][starts]
            if g.weighted:
                in_w = np.bincount(
                    seg, weights=g.in_w[order].astype(np.float64),
                    minlength=len(starts)).astype(np.float32)
            else:
                counts = np.diff(np.append(starts, ks.size))
                in_w = counts.astype(np.float32)
    hub_ids = hub_sl = hub_dst = hub_w = None
    if hub_rows > 0 and g.n > hub_rows and len(in_src):
        deg = np.asarray(g.out_deg, np.int64)
        hub_ids = np.sort(np.argsort(-deg, kind="stable")[:hub_rows]
                          ).astype(np.int32)
        hub_slot = np.full(g.n, -1, np.int32)
        hub_slot[hub_ids] = np.arange(hub_rows, dtype=np.int32)
        is_hub = hub_slot[in_src] >= 0
        # stable partition keeps each subset dst-sorted (sorted
        # segment_sum contract)
        hub_sl = hub_slot[in_src[is_hub]]
        hub_dst = in_dst[is_hub]
        if in_w is not None:
            hub_w = in_w[is_hub]
            in_w = in_w[~is_hub]
        in_src = in_src[~is_hub]
        in_dst = in_dst[~is_hub]
    if pad_edges > 0:
        from ..ops.push import pad_edge_arrays
        in_src, in_dst, in_w = pad_edge_arrays(
            g.n, pad_edges, np.asarray(in_src, np.int32),
            np.asarray(in_dst, np.int32), in_w)
        if hub_dst is not None:
            hub_sl, hub_dst, hub_w = pad_edge_arrays(
                g.n, pad_edges, np.asarray(hub_sl, np.int32),
                np.asarray(hub_dst, np.int32), hub_w)
    return DeviceGraph(
        out_indptr=jnp.asarray(g.out_indptr),
        out_indices=jnp.asarray(g.out_indices),
        in_src=jnp.asarray(in_src),
        in_dst=jnp.asarray(in_dst),
        out_deg=jnp.asarray(g.out_deg),
        in_w=None if in_w is None else jnp.asarray(in_w),
        out_wsum=None if out_wsum is None else jnp.asarray(out_wsum),
        alias_prob=None if alias is None else jnp.asarray(alias.prob),
        alias_other=None if alias is None else jnp.asarray(alias.other),
        out_w=None if not g.weighted else jnp.asarray(
            g.out_w.astype(np.float32)),
        hub_ids=None if hub_ids is None else jnp.asarray(hub_ids),
        hub_src_local=None if hub_sl is None else jnp.asarray(hub_sl),
        hub_dst=None if hub_dst is None else jnp.asarray(hub_dst),
        hub_w=None if hub_w is None else jnp.asarray(hub_w),
    )


# An ELL-packed Pallas push kernel was retired (ARCHITECTURE.md "Pallas
# push kernel: retired"): XLA's random row-gather beat it, so the
# padded-ELL packer that existed solely to feed that kernel went with it.
