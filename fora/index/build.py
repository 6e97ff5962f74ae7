"""FORA+ precomputed walk index: offline builder.

Reproduces the reference's ``build`` action [R: build.h — reconstruction,
SURVEY.md Sec. 3.3]: for every node v, pre-run K_v alpha-terminating walks
and store their endpoints so the query-time walk phase becomes lookups.

Sizing contract (SURVEY.md Sec. 2.2): at push termination
r[v] <= rmax * out_deg[v], so a query at the index's guarantee level
demands at most ceil(rmax * out_deg[v] * omega_unit) + 1 walks from v;
K_v covers that.  The index is built for the smallest delta it must serve
(default 1/n), which covers every coarser top-k refinement level.

Device layout — the pool is materialized as a *multi-resolution
weighted SpMV operand* instead of a lane-sampled table:

  * every pool entry is an "index edge" (v -> endpoint);
  * edges are split into buckets by their prefix position within v's pool:
    bucket q holds entries j with ceil(K_v * 4^-(q+1)) <= j <
    ceil(K_v * 4^-q) (bucket 0 = the outermost full pool);  a query at a
    coarser guarantee level uses only the deepest buckets — work scales
    with omega(level), like the reference's omega scaling;
  * within each bucket, edges are sorted by endpoint, so the walk phase is
    one gather + one sorted segment_sum per bucket (identical memory
    pattern to the push superstep; no RNG, no per-hop chasing);
  * ``counts_cum[v, q]`` = number of v's edges in buckets >= q (i.e. in
    the prefix used at depth q) supplies the estimator weight r_v / count.

Using the full per-node prefix instead of sampling omega_v <= count entries
is unbiased with no higher variance, so the (eps, delta, p_f) guarantee is
preserved (more i.i.d. endpoint samples per unit residue, never fewer than
the demanded omega_v).

Dangling nodes get a single self-edge in the deepest bucket (absorbing
convention) rather than pool walks.

Duplicate (v, endpoint) pairs within a bucket are merged into one edge with
an integer multiplicity (``edge_mult``): every duplicate carries the same
weight r[v]/count_v, so c copies == one edge scaled by c — bitwise-lossless
up to float association.  Walk endpoints concentrate (each walk ends at its
own source w.p. alpha = 0.2; hub nodes absorb much of the rest), so the
merge removes a large fraction of index edges, directly cutting the
walk-phase gather element count.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops import walk as walk_ops

NUM_BUCKETS = 8          # prefix fractions 4^0 .. 4^-(NUM_BUCKETS-1)
BUCKET_BASE = 4


class WalkIndex(NamedTuple):
    """Multi-resolution endpoint index (device arrays).

    Depth q serves queries whose omega_unit is <= omega_unit_built * 4^-q;
    they read buckets q..NUM_BUCKETS-1 (``edge_*`` slices via
    ``bucket_offsets``) and weight edges by 1/counts_cum[src, q].
    """

    edge_src: jnp.ndarray        # [E] i32, source node of each index edge
    edge_dst: jnp.ndarray        # [E] i32, walk endpoint
    bucket_offsets: np.ndarray   # [NUM_BUCKETS+1] host i64: bucket q =
    #                              edges [bucket_offsets[q], bucket_offsets[q+1])
    #                              buckets stored deepest-last:
    #                              slice [bucket_offsets[q]:] = depth-q prefix? no:
    #                              see layout note in build_walk_index
    counts_cum: jnp.ndarray      # [n, NUM_BUCKETS] i32 — pool entries of v
    #                              visible at depth q (PRE-merge sample
    #                              counts: the estimator weight is
    #                              1/counts_cum regardless of merging)
    omega_unit_built: float
    rmax_built: float
    edge_mult: Optional[jnp.ndarray] = None  # [E] f32 multiplicity of each
    #                              merged edge (None = all ones, legacy)

    @property
    def total_edges(self) -> int:
        return self.edge_src.shape[0]

    def depth_for(self, omega_unit_query: float,
                  rmax_query: Optional[float] = None) -> int:
        """Deepest (cheapest) bucket depth whose coverage fraction 4^-q
        still supplies the query's per-node sample demand.

        The guarantee demands omega_v = r_v * omega_unit walks from node v,
        and after push r_v <= rmax * deg_v, so demand scales with
        rmax * omega_unit — NOT omega_unit alone.  K_v was sized for
        rmax_built * omega_unit_built; a coarser refinement level has a
        smaller omega_unit but a LARGER rmax (rmax ~ sqrt(delta),
        omega ~ 1/delta), so its demand ratio is
        sqrt(delta_built/delta_q), not delta_built/delta_q.  Pass the
        level's rmax to get a depth whose prefix covers the worst-case
        demand; omitting it preserves the omega-only rule (callers that
        push to rmax_built regardless of level)."""
        ratio = omega_unit_query / self.omega_unit_built
        if rmax_query is not None:
            ratio *= rmax_query / self.rmax_built
        if ratio > 1.0 + 1e-9:
            raise ValueError(
                f"index too coarse: built rmax*omega_unit covers "
                f"{self.rmax_built * self.omega_unit_built:.3g} < query "
                f"demand ratio {ratio:.3g}x")
        q = int(-math.log(max(ratio, 1e-300)) // math.log(BUCKET_BASE))
        return min(max(q, 0), NUM_BUCKETS - 1)

    def edges_at_depth(self, q: int):
        """Static slice of (src, dst, mult-or-None) used at depth q
        (buckets q..deepest are stored contiguously at the tail)."""
        lo = int(self.bucket_offsets[q])
        mult = self.edge_mult[lo:] if self.edge_mult is not None else None
        return self.edge_src[lo:], self.edge_dst[lo:], mult


def index_counts(out_deg: np.ndarray, rcfg: ResolvedConfig,
                 max_per_node: Optional[int] = None) -> np.ndarray:
    """K_v = ceil(rmax * deg_v * omega_unit) + 1 walks per node (0 for
    dangling nodes — served by an analytic self-edge)."""
    deg = np.asarray(out_deg, dtype=np.float64)
    k = np.ceil(rcfg.rmax * deg * rcfg.omega_unit).astype(np.int64) + 1
    k[deg == 0] = 0
    if max_per_node is not None:
        k = np.minimum(k, max_per_node)
    return k


def run_walk_chunks(run, counts: np.ndarray, total: int, key: jax.Array, *,
                    chunk: int, checkpoint_dir: Optional[str],
                    fingerprint: dict, progress=None,
                    run_fallback=None, pipeline_depth: int = 2
                    ) -> np.ndarray:
    """Shared chunk loop for index builders: drive ``run(starts_chunk,
    chunk_key) -> endpoints | (endpoints, ok)`` over lane-chunks with
    optional crash-resume checkpoints.

    ``checkpoint_dir``: persist each completed lane-chunk's endpoints
    (atomic rename) so an interrupted build resumes where it stopped —
    the per-chunk RNG is keyed by the chunk number (fold_in), so a
    resumed build is bit-identical to an uninterrupted one.  A manifest
    guards against resuming with a different graph/config/key/chunking
    (SURVEY.md Sec. 5.4: the index is the engine's persistent artifact;
    at billion-edge scale the build is the long job worth preempting).

    ``run`` may return a second ``ok`` flag (the scheduled walk kernel's
    width-bound check); a False flag re-runs the chunk via
    ``run_fallback`` — both decisions are deterministic in (key, chunk),
    so resume stays bit-identical.

    ``pipeline_depth``: chunks dispatched ahead of the host sync — jax
    dispatch is async, so chunk i+1 executes on device while chunk i's
    endpoints transfer/convert and its checkpoint writes (the host-side
    work that round-3 builds paid serially per chunk).
    """
    import hashlib
    import json
    from pathlib import Path

    n = counts.shape[0]
    starts = np.repeat(np.arange(n, dtype=np.int32), counts)
    endpoints = np.empty(total, dtype=np.int32)
    chunk = -(-chunk // 128) * 128
    n_chunks = max(1, math.ceil(total / chunk))

    ckpt = None
    if checkpoint_dir is not None:
        ckpt = Path(checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        fp = dict(fingerprint)
        fp.update({
            "counts_sha": hashlib.sha1(counts.tobytes()).hexdigest(),
            "key_sha": hashlib.sha1(
                np.asarray(jax.random.key_data(key)).tobytes()).hexdigest(),
            "chunk": chunk, "total": total, "n": n,
        })
        mf = ckpt / "manifest.json"
        if mf.exists():
            if json.loads(mf.read_text()) != fp:
                raise ValueError(
                    f"index-build checkpoint at {ckpt} belongs to a "
                    "different graph/config/key/chunking; remove it or "
                    "point checkpoint_dir elsewhere")
        else:
            mf.write_text(json.dumps(fp))

    inflight = []   # [(i, lo, hi, s_dev, out)]

    def drain_one():
        i, lo, hi, s_dev, out = inflight.pop(0)
        ok = None
        if isinstance(out, tuple):
            out, ok = out
        if ok is not None and not bool(np.asarray(ok)):
            if run_fallback is None:
                raise RuntimeError("scheduled walk width bound exceeded "
                                   "and no fallback kernel provided")
            out = run_fallback(s_dev, jax.random.fold_in(key, i))
            if isinstance(out, tuple):
                out = out[0]
        endpoints[lo:hi] = np.asarray(out)[: hi - lo]
        if ckpt is not None:
            tmp = ckpt / f".chunk_{i:06d}.npy.tmp"
            with open(tmp, "wb") as fh:  # np.save(path) would append .npy
                np.save(fh, endpoints[lo:hi])
            tmp.rename(ckpt / f"chunk_{i:06d}.npy")
        if progress is not None:
            progress(i, n_chunks, False)

    try:
        for i in range(n_chunks):
            lo, hi = i * chunk, min((i + 1) * chunk, total)
            if ckpt is not None:
                f = ckpt / f"chunk_{i:06d}.npy"
                if f.exists():
                    endpoints[lo:hi] = np.load(f)
                    if progress is not None:
                        progress(i, n_chunks, True)
                    continue
            pad = chunk - (hi - lo)
            s_dev = jnp.asarray(np.pad(starts[lo:hi], (0, pad)))
            inflight.append((i, lo, hi, s_dev,
                             run(s_dev, jax.random.fold_in(key, i))))
            if len(inflight) >= max(1, pipeline_depth):
                drain_one()
        while inflight:
            drain_one()
    except BaseException:
        # preemption mid-build: best-effort drain of already-dispatched
        # chunks so their checkpoints persist (resume skips them).  With no
        # checkpoint_dir the drained results would be discarded — don't make
        # a Ctrl-C block on device work for nothing.
        if ckpt is not None:
            try:
                while inflight:
                    drain_one()
            except Exception:
                pass
        raise
    return endpoints


def build_walk_index(graph: DeviceGraph, rcfg: ResolvedConfig,
                     key: jax.Array, *, max_per_node: Optional[int] = None,
                     chunk: int = 1 << 23,
                     checkpoint_dir: Optional[str] = None,
                     progress=None) -> WalkIndex:
    """Run all index walks on device in lane-chunks, then pack the
    multi-resolution bucketed SpMV layout on the host.  Crash-resume via
    ``checkpoint_dir`` (see run_walk_chunks).  For graphs whose full CSR
    exceeds one device's HBM, use
    fora.index.build_sharded.build_walk_index_sharded — bit-identical
    output with the out-CSR row-sharded over the mesh."""
    n = graph.n
    deg = np.asarray(graph.out_deg)
    counts = index_counts(deg, rcfg, max_per_node)
    total = int(counts.sum())
    if total + n >= 2**31:
        raise ValueError(
            f"walk index ({total} endpoints) exceeds int32 range; shard the "
            "graph rows first (fora.parallel) or cap max_per_node")

    # length-scheduled walk kernel (walk_ops.run_walks_scheduled): lanes
    # sorted by pre-sampled length, each hop processes a shrinking static
    # prefix — ~max_hops*alpha times fewer gather elements than the plain
    # lockstep walk.  The plain kernel remains the (deterministic,
    # never-in-practice) fallback for the width-bound check.  The graph is
    # a jit ARGUMENT (closure constants embed into the HLO and overflow
    # the remote-compile transport at scale).
    run = jax.jit(
        lambda gr, s, k: walk_ops.run_walks_scheduled(
            gr, s, k, alpha=rcfg.alpha, max_hops=rcfg.max_walk_hops))
    run = functools.partial(run, graph)
    fb = jax.jit(
        lambda gr, s, k: walk_ops.run_walks(
            gr, s.reshape(-1, 128), k, alpha=rcfg.alpha,
            max_hops=rcfg.max_walk_hops).reshape(-1))
    from .store import graph_fingerprint
    endpoints = run_walk_chunks(
        run, counts, total, key, chunk=chunk,
        checkpoint_dir=checkpoint_dir, progress=progress,
        run_fallback=functools.partial(fb, graph),
        # graph content hash: resuming against a rewired same-shape graph
        # must refuse, not silently mix endpoint chunks from two graphs.
        # kernel id: a checkpoint from the pre-scheduled kernel must not
        # mix with scheduled chunks (different endpoint streams).
        fingerprint={"alpha": rcfg.alpha, "max_hops": rcfg.max_walk_hops,
                     "kernel": "scheduled-v1",
                     "graph_sha": graph_fingerprint(graph)})
    return pack_index(endpoints, counts, deg, rcfg)


def _merge_bucket_duplicates(src: np.ndarray, dst: np.ndarray,
                             bucket: np.ndarray):
    """Merge identical (src, dst) pairs within a bucket into one edge with a
    multiplicity.  Input order is irrelevant; output is (bucket, dst, src)-
    sorted, so each bucket stays dst-ascending (sorted segment_sum
    contract).  Returns (src, dst, bucket, mult)."""
    if len(src) == 0:
        return src, dst, bucket, np.ones(0, np.float32)
    order = np.lexsort((src, dst, bucket))
    src, dst, bucket = src[order], dst[order], bucket[order]
    first = np.empty(len(src), dtype=bool)
    first[0] = True
    first[1:] = ((src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
                 | (bucket[1:] != bucket[:-1]))
    group = np.cumsum(first) - 1
    mult = np.bincount(group).astype(np.float32)
    return src[first], dst[first], bucket[first], mult


def dedup_index(index: WalkIndex) -> WalkIndex:
    """Upgrade a legacy (unmerged) index to the multiplicity-merged layout.
    Lossless; counts_cum (the estimator's sample counts) is unchanged."""
    if index.edge_mult is not None:
        return index
    src = np.asarray(index.edge_src, dtype=np.int64)
    dst = np.asarray(index.edge_dst, dtype=np.int64)
    boff = np.asarray(index.bucket_offsets, dtype=np.int64)
    bucket = np.repeat(np.arange(NUM_BUCKETS, dtype=np.int8), np.diff(boff))
    src, dst, bucket, mult = _merge_bucket_duplicates(src, dst, bucket)
    sizes = np.bincount(bucket, minlength=NUM_BUCKETS)
    new_off = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
    np.cumsum(sizes, out=new_off[1:])
    return index._replace(edge_src=jnp.asarray(src.astype(np.int32)),
                          edge_dst=jnp.asarray(dst.astype(np.int32)),
                          bucket_offsets=new_off,
                          edge_mult=jnp.asarray(mult))


def _bucket_per_entry(counts, offsets, cut, total, src32):
    """Per-entry bucket, vectorized: entries of a node are laid out
    j-ascending, so bucket starts at NUM_BUCKETS-1 and drops by one at
    each within-node boundary off_v + cut[v, q] (cutoffs strictly inside
    the pool).  One bincount of boundary positions + one global prefix
    sum, rebased per node."""
    if not total:
        return np.empty(0, np.int64)
    pos = [offsets[sel] + cut[sel, q]
           for q in range(1, NUM_BUCKETS)
           for sel in (cut[:, q] < counts,)]
    dec = np.bincount(np.concatenate(pos) if pos else
                      np.empty(0, np.int64), minlength=total)
    dinc = np.cumsum(dec, dtype=np.int64)
    # trailing zero-count nodes have offsets == total; their base is
    # never read (src32 only covers nodes with entries) — clip
    off_c = np.minimum(offsets, total - 1)
    base = dinc[off_c] - dec[off_c]
    return (NUM_BUCKETS - 1) - (dinc - base[src32])


def pack_index(endpoints: np.ndarray, counts: np.ndarray, out_deg: np.ndarray,
               rcfg: ResolvedConfig, dedup: bool = True) -> WalkIndex:
    """Host-side packing of raw pools into the bucketed layout.

    Entry j of node v lands in bucket q = the deepest depth with
    j < ceil(K_v * 4^-q)  (cutoffs shrink as q grows, so the depth-q
    prefix {j < ceil(K_v * 4^-q)} is exactly the union of buckets
    q..NUM_BUCKETS-1).  Buckets are stored ascending, each sorted by
    endpoint, so a depth-q query reads the contiguous tail
    ``[bucket_offsets[q]:]`` bucket by bucket.  Dangling nodes contribute
    one self-edge in the deepest bucket (visible at every depth).
    """
    n = counts.shape[0]
    total = int(counts.sum())
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    dang = np.nonzero(np.asarray(out_deg) == 0)[0].astype(np.int64)

    # Per-node cutoff table: cut[v, q] = ceil(K_v * 4^-q) (cut[:, 0] =
    # K_v).  Entry j of node v has bucket(j) = #{q >= 1 : j < cut[v, q]},
    # and the per-depth visibility counts are the cutoffs THEMSELVES:
    # counts_cum[v, q] = #entries with bucket >= q = cut[v, q] (+1 at
    # every depth for a dangling node's self-edge, which lives in the
    # deepest bucket).  This replaces the round-4 per-EDGE chain (f64
    # cutoff recompute x 7 passes + a bucket*n+src bincount over 8n bins)
    # whose [E]-sized temporaries were ~60% of the 134 s judged-scale
    # pack — all the per-edge work left is one boundary-prefix-sum.
    cut = np.ceil(counts[:, None].astype(np.float64)
                  * float(BUCKET_BASE) ** -np.arange(NUM_BUCKETS,
                                                     dtype=np.float64)
                  ).astype(np.int64)                           # [n, Q]
    cut[:, 0] = counts
    counts_cum = cut.astype(np.int32)
    if len(dang):
        counts_cum[dang] += 1
    counts_cum = np.ascontiguousarray(counts_cum)

    nd = len(dang)
    nb = max(int(n - 1).bit_length(), 1)
    mult = None
    from .. import _native
    use_native = (dedup and 2 * nb + 4 <= 63
                  and _native.native_sort_unique_u64 is not None
                  and _native.native_pack_keys is not None
                  and total + nd > 0)
    if use_native:
        # fully native fast path (the host-side build bottleneck at
        # scale): ONE parallel pass writes every entry's packed
        # (bucket, dst, src) key (bucket via a per-node descending
        # cutoff pointer), a parallel radix sort + run-length merge
        # orders and dedups, one more pass unpacks — replacing a numpy
        # chain (argsort + per-edge prefix sums + int64 shift/mask
        # passes) that took 134 s for 208M entries on a 2-core host
        # (13.6 s sort + ~60 s of [E]-sized int64 temporaries).
        # Bit-identical to the legacy two-lexsort pipeline: sorted order
        # of a key multiset and its run-length merge are
        # algorithm-independent.
        key = np.empty(total + nd, dtype=np.uint64)
        ep32 = np.ascontiguousarray(endpoints, dtype=np.int32)
        _native.native_pack_keys(offsets, counts, cut, ep32, nb,
                                 key[:total])
        key[total:] = (((np.uint64(NUM_BUCKETS - 1)) << np.uint64(2 * nb))
                       | (dang.astype(np.uint64) << np.uint64(nb))
                       | dang.astype(np.uint64))
        ukeys, mult = _native.native_sort_unique_u64(
            key, key_bits=2 * nb + 4)
        src, dst, bucket = _native.native_unpack_keys(ukeys, nb)
        bucket_sizes = np.bincount(bucket, minlength=NUM_BUCKETS)
        bucket_offsets = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
        np.cumsum(bucket_sizes, out=bucket_offsets[1:])
    elif dedup and 2 * nb + 4 <= 63:
        # numpy fast path (native lib unavailable): same packed-key
        # pipeline, one np.sort + run-length merge
        src32 = np.repeat(np.arange(n, dtype=np.int32), counts)
        bucket = _bucket_per_entry(counts, offsets, cut, total, src32)
        key = np.empty(total + nd, dtype=np.int64)
        km = key[:total]
        np.left_shift(bucket, 2 * nb, out=km)
        np.bitwise_or(km, endpoints.astype(np.int64) << nb, out=km)
        np.bitwise_or(km, src32.astype(np.int64), out=km)
        key[total:] = ((np.int64(NUM_BUCKETS - 1) << (2 * nb))
                       | (dang << nb) | dang)
        del bucket, src32
        key = np.sort(key)
        first = np.empty(len(key), dtype=bool)
        if len(key):
            first[0] = True
            first[1:] = key[1:] != key[:-1]
        group = np.cumsum(first) - 1
        mult = np.bincount(group).astype(np.float32)
        key = key[first]
        src = key & ((1 << nb) - 1)
        dst = (key >> nb) & ((1 << nb) - 1)
        bucket = (key >> (2 * nb)).astype(np.int8)
        bucket_sizes = np.bincount(bucket, minlength=NUM_BUCKETS)
        bucket_offsets = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
        np.cumsum(bucket_sizes, out=bucket_offsets[1:])
    else:
        # legacy path: (bucket, dst) sort, optional merge
        src32 = np.repeat(np.arange(n, dtype=np.int32), counts)
        bucket = _bucket_per_entry(counts, offsets, cut, total, src32)
        src = np.concatenate([src32.astype(np.int64), dang])
        dst = np.concatenate([endpoints.astype(np.int64), dang])
        bucket = np.concatenate([bucket,
                                 np.full(nd, NUM_BUCKETS - 1)])
        order = np.lexsort((dst, bucket))
        src, dst, bucket = src[order], dst[order], bucket[order]
        if dedup:
            src, dst, bucket, mult = _merge_bucket_duplicates(src, dst,
                                                              bucket)
        bucket_sizes = np.bincount(bucket, minlength=NUM_BUCKETS)
        bucket_offsets = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
        np.cumsum(bucket_sizes, out=bucket_offsets[1:])

    return WalkIndex(
        edge_src=jnp.asarray(src.astype(np.int32)),
        edge_dst=jnp.asarray(dst.astype(np.int32)),
        bucket_offsets=bucket_offsets,
        counts_cum=jnp.asarray(counts_cum),
        omega_unit_built=rcfg.omega_unit,
        rmax_built=rcfg.rmax,
        edge_mult=jnp.asarray(mult) if mult is not None else None,
    )


def index_nbytes(index: WalkIndex) -> int:
    return index.total_edges * 8 + index.counts_cum.size * 4


def index_slices(index: WalkIndex, depth: int):
    """Device-array views used by a depth-``depth`` query, suitable for
    passing as jit ARGUMENTS (never close big arrays into a jitted fn: the
    tracer embeds them as HLO constants, which breaks the compile cache
    and overflows the remote-compile transport)."""
    buckets = []
    for q in range(depth, NUM_BUCKETS):
        lo, hi = int(index.bucket_offsets[q]), int(index.bucket_offsets[q + 1])
        if hi > lo:
            mult = (index.edge_mult[lo:hi]
                    if index.edge_mult is not None else None)
            buckets.append((index.edge_src[lo:hi], index.edge_dst[lo:hi],
                            mult))
    counts_col = index.counts_cum[:, depth]
    return tuple(buckets), counts_col


def indexed_walk_contrib_from_slices(buckets, counts_col, r: jnp.ndarray
                                     ) -> jnp.ndarray:
    """Walk-phase estimate as a weighted SpMV over pre-sliced bucket edges.

    r: [n, B] post-push residue.  Returns [n, B] endpoint mass:
      contrib[t] = sum over index edges (v -> t) at depth q of
                   mult * r[v] / counts_col[v].
    One gather + one sorted segment_sum per bucket — same memory pattern
    as a push superstep, no RNG.
    """
    from ..ops.push import gather_segment_sum
    n = r.shape[0]
    inv_cnt = 1.0 / jnp.maximum(counts_col, 1).astype(jnp.float32)
    rw = r * inv_cnt[:, None]                             # [n, B]
    contrib = jnp.zeros_like(r)
    for src, dst, mult in buckets:
        contrib = contrib + gather_segment_sum(rw, src, dst, n, edge_w=mult)
    return contrib


def indexed_walk_contrib(index: WalkIndex, r: jnp.ndarray, depth: int
                         ) -> jnp.ndarray:
    """Convenience wrapper over index_slices + *_from_slices."""
    buckets, counts_col = index_slices(index, depth)
    return indexed_walk_contrib_from_slices(buckets, counts_col, r)
