"""FORA two-phase SSPPR queries, batched over sources.

The estimator contract [R: algo.h fora_query_basic / compute_ppr_with_fwdidx
— reconstruction; paper-backed per SURVEY.md Sec. 2.2]:

  1. forward push to ``r[v] <= rmax * out_deg[v]``, yielding settled mass p
     and residue r with invariant  pi_s = p + sum_v r[v] * pi_v;
  2. for each v with r[v] > 0, run omega_v = ceil(r[v] * omega_unit)
     alpha-terminating walks from v, each adding r[v]/omega_v to its
     endpoint's estimate;
  3. pi_hat = p + walk contributions.

This yields the (eps, delta, p_f) relative-error guarantee with
omega_unit = (2 eps/3 + 2) ln(2/p_f) / (eps^2 delta).

Everything here is jit-compiled with a leading query-batch axis; arrays are
node-major [n, B] internally.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops import push as push_ops
from ..ops import walk as walk_ops


class ForaResult(NamedTuple):
    ppr: jnp.ndarray        # [n, B] f32 estimate
    push_iters: jnp.ndarray  # [] i32
    rsum: jnp.ndarray       # [B] f32 residue mass after push
    walk_total: jnp.ndarray  # [B] i32 walks demanded
    walk_overflow: jnp.ndarray  # [B] bool static-lane budget exceeded


def fora_query(graph: DeviceGraph, sources: jnp.ndarray, key: jax.Array, *,
               rcfg: ResolvedConfig, num_lanes: int = 0,
               rmax=None, omega_unit=None,
               index=None, index_depth: int = 0) -> ForaResult:
    """Batched FORA estimate. sources: [B] i32; returns node-major ppr.

    ``rmax``/``omega_unit`` may be traced scalars (they enter elementwise
    math only), so one compiled program serves every delta level of the
    top-k refinement — only ``num_lanes`` (raw-walk mode) or
    ``index_depth`` (FORA+ mode) is shape-defining.

    With ``index`` (FORA+ multi-resolution walk index, SURVEY.md Sec. 2.1),
    the walk phase is a weighted SpMV over the depth-``index_depth`` slice
    of precomputed endpoint edges — no sampling, no lane allocation; see
    fora/index/build.py.
    """
    if rmax is None:
        rmax = rcfg.rmax
    if omega_unit is None:
        omega_unit = rcfg.omega_unit
    if index is not None:
        from ..index.build import index_slices
        buckets, counts_col = index_slices(index, index_depth)
        return _fora_indexed_impl(graph, buckets, counts_col, sources, rmax,
                                  omega_unit, alpha=rcfg.alpha,
                                  max_push_iters=rcfg.max_push_iters)
    return _fora_walk_impl(graph, sources, key, rmax, omega_unit,
                           alpha=rcfg.alpha,
                           max_push_iters=rcfg.max_push_iters,
                           max_walk_hops=rcfg.max_walk_hops,
                           num_lanes=num_lanes)


def _fora_indexed_impl(graph, buckets, counts_col, sources, rmax,
                       omega_unit=None, *, alpha, max_push_iters):
    st0 = push_ops.init_state(graph.n, sources)
    res, _, _ = _fora_indexed_state_impl(graph, buckets, counts_col,
                                         st0.p, st0.r, rmax, omega_unit,
                                         alpha=alpha,
                                         max_push_iters=max_push_iters)
    return res


def _fora_indexed_state_impl(graph, buckets, counts_col, p0, r0, rmax,
                             omega_unit=None, *, alpha, max_push_iters):
    """Indexed FORA resuming push from (p0, r0); also returns the new state
    so the next (finer) delta level continues instead of re-pushing.

    With ``omega_unit``, push stops at the per-node coverage threshold
    count_v/omega_unit (see forward_push_from thr docstring)."""
    from ..index.build import indexed_walk_contrib_from_slices
    thr = (counts_col.astype(jnp.float32) / omega_unit
           if omega_unit is not None else None)
    st = push_ops.forward_push_from(
        graph, push_ops.PushState(p=p0, r=r0, iters=jnp.zeros((), jnp.int32)),
        rmax=rmax, alpha=alpha, max_iters=max_push_iters, thr=thr)
    contrib = indexed_walk_contrib_from_slices(buckets, counts_col, st.r)
    zero = jnp.zeros(st.r.shape[1], jnp.int32)
    res = ForaResult(ppr=st.p + contrib, push_iters=st.iters,
                     rsum=jnp.sum(st.r, axis=0), walk_total=zero,
                     walk_overflow=zero.astype(bool))
    return res, st.p, st.r


def _fora_walk_impl(graph, sources, key, rmax, omega_unit, *,
                    alpha, max_push_iters, max_walk_hops, num_lanes):
    st0 = push_ops.init_state(graph.n, sources)
    res, _, _ = _fora_walk_state_impl(
        graph, st0.p, st0.r, key, rmax, omega_unit, alpha=alpha,
        max_push_iters=max_push_iters, max_walk_hops=max_walk_hops,
        num_lanes=num_lanes)
    return res


def _fora_walk_state_impl(graph, p0, r0, key, rmax, omega_unit, *,
                          alpha, max_push_iters, max_walk_hops, num_lanes):
    st = push_ops.forward_push_from(
        graph, push_ops.PushState(p=p0, r=r0, iters=jnp.zeros((), jnp.int32)),
        rmax=rmax, alpha=alpha, max_iters=max_push_iters)
    alloc = walk_ops.allocate_walks(st.r, omega_unit, num_lanes)
    endpoints = walk_ops.run_walks(graph, alloc.start, key, alpha=alpha,
                                   max_hops=max_walk_hops)
    contrib = walk_ops.accumulate_endpoints(endpoints, alloc.weight, graph.n)
    res = ForaResult(ppr=st.p + contrib, push_iters=st.iters,
                     rsum=jnp.sum(st.r, axis=0), walk_total=alloc.total,
                     walk_overflow=alloc.overflow)
    return res, st.p, st.r


def make_fora_fn(graph: DeviceGraph, rcfg: ResolvedConfig,
                 num_lanes: Optional[int] = None, max_lanes: int = 1 << 23,
                 index=None):
    """Build a jitted ``(sources, key) -> ForaResult`` for one config."""
    if index is not None:
        depth = index.depth_for(rcfg.omega_unit, rcfg.rmax)
        param = make_fora_param_fn(graph, rcfg, 0, index=index,
                                   index_depth=depth)
    else:
        if num_lanes is None:
            num_lanes = walk_ops.walk_lane_budget(
                rcfg.omega_unit, rcfg.rmax, rcfg.m, rcfg.n, cap=max_lanes)
        param = make_fora_param_fn(graph, rcfg, num_lanes)

    def fn(sources, key):
        return param(sources, key, jnp.float32(rcfg.rmax),
                     jnp.float32(rcfg.omega_unit))

    return fn


def make_fora_param_fn(graph: DeviceGraph, rcfg: ResolvedConfig,
                       num_lanes: int, index=None, index_depth: int = 0):
    """Jitted ``(sources, key, rmax, omega_unit) -> ForaResult`` with the
    guarantee parameters as runtime scalars (one compile per lane bucket /
    index depth).

    All graph/index arrays enter the jitted program as ARGUMENTS (pytree
    leaves), never closure constants — closure-captured arrays are embedded
    into the HLO, which defeats the compile cache and bloats every
    compile at scale.
    """
    if index is not None:
        from ..index.build import index_slices
        buckets, counts_col = index_slices(index, index_depth)
        impl = jax.jit(functools.partial(
            _fora_indexed_impl, alpha=rcfg.alpha,
            max_push_iters=rcfg.max_push_iters))

        def fn(sources, key, rmax, omega_unit):
            del key  # indexed mode is deterministic
            return impl(graph, buckets, counts_col, sources, rmax,
                        jnp.float32(omega_unit))

        return fn

    impl = jax.jit(functools.partial(
        _fora_walk_impl, alpha=rcfg.alpha,
        max_push_iters=rcfg.max_push_iters,
        max_walk_hops=rcfg.max_walk_hops, num_lanes=num_lanes))

    def fn(sources, key, rmax, omega_unit):
        return impl(graph, sources, key, rmax, omega_unit)

    return fn


class StagedForaPrograms:
    """Shared compiled pieces for the indexed refinement loop.

    Fusing push + index-SpMV per depth compiles one large program per
    level, and compile time dominates warmup.  Staging instead compiles
      * ONE push-from-state program (rmax is a runtime scalar), and
      * one small SpMV program PER BUCKET (shapes fixed by the index),
    and every delta level is a composition — adding levels adds zero
    compilations.
    """

    def __init__(self, graph: DeviceGraph, rcfg: ResolvedConfig, index,
                 gather_dtype=None, gather_chunk: int = 1 << 23,
                 stepped_push=None):
        """``stepped_push``: True runs the host-stepped split superstep
        (see _push_stepped); False or None (default) runs each push as one
        while_loop program."""
        from ..index import build as ib
        self.graph, self.rcfg, self.index = graph, rcfg, index
        # Buffer DONATION throughout: the refinement pool's (p, r) state is
        # [n, B] f32 per buffer — 2.1 GB each at LiveJournal scale (4.2M
        # nodes, B=128).  Donating lets XLA alias the state arguments onto
        # the outputs; without it the push program holds input AND output
        # copies of the state.  Each push is ONE while_loop program;
        # max_iters enters it as a runtime scalar so every level shares
        # the compilation.
        self._push = jax.jit(functools.partial(
            push_ops.forward_push_from, alpha=rcfg.alpha,
            max_chunk=gather_chunk,
            gather_dtype=gather_dtype), donate_argnums=(1,))

        # Host-stepped superstep for LARGE states (_push_stepped): inside
        # one program XLA cannot alias the new residue onto the old (r has
        # other readers in the fused body), so the while-loop push holds
        # TWO extra [n, B] temps.  Splitting the superstep at a jit
        # boundary makes each half's donation alias cleanly:
        #   A (donate p):        p' = p + absorbed mass;  contrib out
        #   B (donate r):        r  = masked residue, scatter-added from
        #                        contrib in place; convergence flag out
        # contrib is THREADED through the stepped loop as a donated
        # buffer (step_a writes into the previous iteration's, step_b
        # only reads): with the lagged convergence polls up to three
        # steps are enqueued before the first executes, and since PJRT
        # allocates non-aliased outputs at enqueue, a fresh contrib per
        # step would briefly hold THREE [n, B] contrib generations.  The
        # single device stream executes FIFO, so step_a(i+1)'s in-place
        # write cannot precede step_b(i)'s read.
        def step_a(g, p, r, thr, contrib_buf):
            del contrib_buf  # donated slot: output aliases it
            deg = g.out_deg.astype(jnp.float32)[:, None]
            dangling = deg == 0.0
            active = r > thr[:, None]
            ar = jnp.where(active, r, 0.0)
            p = p + jnp.where(dangling, ar, rcfg.alpha * ar)
            wsum = deg if g.out_wsum is None else g.out_wsum[:, None]
            contrib = jnp.where(
                dangling, 0.0,
                (1.0 - rcfg.alpha) * ar / jnp.maximum(wsum, 1e-30))
            if gather_dtype is not None:
                contrib = contrib.astype(gather_dtype)
            return p, contrib

        def step_b(g, r, contrib, thr):
            r = jnp.where(r > thr[:, None], 0.0, r)
            r = push_ops.gather_scatter_add(
                r, contrib, g.in_src, g.in_dst, max_chunk=gather_chunk,
                edge_w=g.in_w)
            if g.hub_split:
                r = push_ops.gather_scatter_add(
                    r, contrib[g.hub_ids], g.hub_src_local, g.hub_dst,
                    max_chunk=gather_chunk, edge_w=g.hub_w)
            return r, jnp.any(r > thr[:, None])

        self._step_a = jax.jit(step_a, donate_argnums=(1, 4))
        self._step_b = jax.jit(step_b, donate_argnums=(1,))
        self._contrib_dtype = (gather_dtype if gather_dtype is not None
                               else jnp.float32)

        # PAIRED superstep (push_pair_stepped): the gather runs at the
        # concatenated width of TWO query blocks (row-rate-bound: two
        # blocks per gathered row) while state stays per-block [n, w]
        # buffers — the concatenated contrib is the only paired-width
        # array, cast to gather_dtype BEFORE the concat so the full-width
        # f32 version never exists.
        def step_a_pair(g, pA, pB, rA, rB, thr):
            deg = g.out_deg.astype(jnp.float32)[:, None]
            dangling = deg == 0.0
            wsum = deg if g.out_wsum is None else g.out_wsum[:, None]
            thr2 = thr[:, None]

            def half(p, r):
                active = r > thr2
                ar = jnp.where(active, r, 0.0)
                p = p + jnp.where(dangling, ar, rcfg.alpha * ar)
                c = jnp.where(dangling, 0.0,
                              (1.0 - rcfg.alpha) * ar
                              / jnp.maximum(wsum, 1e-30))
                if gather_dtype is not None:
                    c = c.astype(gather_dtype)
                return p, c

            pA, cA = half(pA, rA)
            pB, cB = half(pB, rB)
            # paired contrib assembled via in-place dynamic-update-slices
            # (a plain concatenate materializes BOTH halves as separate
            # temps before the copy)
            w = rA.shape[1]
            contrib = jnp.zeros((rA.shape[0], 2 * w), cA.dtype)
            contrib = jax.lax.dynamic_update_slice(contrib, cA, (0, 0))
            contrib = jax.lax.dynamic_update_slice(contrib, cB, (0, w))
            return pA, pB, contrib

        def step_b_pair(g, rA, rB, contrib, thr):
            thr2 = thr[:, None]
            rA = jnp.where(rA > thr2, 0.0, rA)
            rB = jnp.where(rB > thr2, 0.0, rB)
            rA, rB = push_ops.gather_scatter_add_pair(
                rA, rB, contrib, g.in_src, g.in_dst,
                max_chunk=gather_chunk, edge_w=g.in_w)
            if g.hub_split:
                rA, rB = push_ops.gather_scatter_add_pair(
                    rA, rB, contrib[g.hub_ids], g.hub_src_local, g.hub_dst,
                    max_chunk=gather_chunk, edge_w=g.hub_w)
            cont = jnp.logical_or(jnp.any(rA > thr2), jnp.any(rB > thr2))
            return rA, rB, cont

        self._step_a_pair = jax.jit(step_a_pair, donate_argnums=(1, 2))
        self._step_b_pair = jax.jit(step_b_pair, donate_argnums=(1, 2, 3))
        # stepped_push default (None) = off: the split superstep exists to
        # buy query width in a fixed memory budget and costs a host poll
        # per superstep that the while-loop program never pays.
        self._stepped_force = stepped_push

        def bucket_spmv(src, dst, mult, r, inv_cnt, contrib):
            # inv_cnt folded into the gather (src_w) so the weighted
            # residue rw = r * inv_cnt is never materialized as a second
            # [n, B] operand; scatter-add lands in the DONATED contrib
            # accumulator directly (no separate [n+1, B] segment-sum
            # buffer — see gather_scatter_add)
            return push_ops.gather_scatter_add(
                contrib, r, src, dst, max_chunk=gather_chunk,
                gather_dtype=gather_dtype, edge_w=mult, src_w=inv_cnt)

        self._bucket = jax.jit(bucket_spmv, donate_argnums=(5,))

        def _dev(a):
            # numpy/mmap-backed index (store.load(mmap=True)): ONE device
            # transfer per slice here; device-backed index: slice on
            # device (NB the monolithic originals then stay resident too
            # — prefer mmap loads at scale, see store.load)
            import numpy as np
            return None if a is None else (
                a if isinstance(a, jnp.ndarray) else
                jax.device_put(np.ascontiguousarray(a)))

        def bucket_spmv_cols(src, dst, mult, r, inv_cnt, contrib, c0, w):
            # half-walk variant: gather only columns [c0, c0+w) of each r
            # row (one narrowed XLA gather — never a 2.1 GB column-sliced
            # operand copy) into the [n, w] accumulator.  Lets the walk
            # SpMV + accept run at half width while the push runs the
            # full block — the piece that makes a single 256-wide block
            # fit a small memory budget (the [n, 256] f32 walk accumulator
            # sits alongside p and r).
            return push_ops.gather_scatter_add(
                contrib, r, src, dst, max_chunk=gather_chunk,
                edge_w=mult, src_w=inv_cnt, col=(c0, w))

        self._bucket_cols = jax.jit(bucket_spmv_cols, donate_argnums=(5,),
                                    static_argnums=(6, 7))
        self._buckets = []          # [(src, dst, mult-or-None)] per bucket q
        for q in range(ib.NUM_BUCKETS):
            lo = int(index.bucket_offsets[q])
            hi = int(index.bucket_offsets[q + 1])
            if hi <= lo:
                self._buckets.append(None)
                continue
            src = index.edge_src[lo:hi]
            dst = index.edge_dst[lo:hi]
            mult = (index.edge_mult[lo:hi]
                    if index.edge_mult is not None else None)
            if not isinstance(src, jnp.ndarray):
                # numpy/mmap-backed: pre-pad to the chunk multiple so the
                # chunked SpMV reshapes for free — the in-program pad
                # copies were ~1.4 GB of temps per call on the largest
                # judged-scale bucket (push_ops._chunked_edges)
                import numpy as np
                src, dst, mult = push_ops.pad_edge_arrays(
                    rcfg.n, gather_chunk, np.asarray(src),
                    np.asarray(dst),
                    None if mult is None else np.asarray(mult))
            self._buckets.append((_dev(src), _dev(dst), _dev(mult)))
        # counts_cum is consumed column-wise per depth as a jit argument —
        # cache it on device once (an mmap-backed column would otherwise
        # re-transfer per level call)
        self._counts_dev = _dev(self.index.counts_cum)

        def finish(p, contrib, r, iters):
            zero = jnp.zeros(r.shape[1], jnp.int32)
            return ForaResult(ppr=p + contrib, push_iters=iters,
                              rsum=jnp.sum(r, axis=0), walk_total=zero,
                              walk_overflow=zero.astype(bool))

        self._finish = jax.jit(finish, donate_argnums=(1,))
        self._inv = {}              # per-depth 1/counts_col, cached

    def _inv_cnt(self, depth: int):
        if depth not in self._inv:
            cc = self._counts_dev[:, depth]
            self._inv[depth] = 1.0 / jnp.maximum(cc, 1).astype(jnp.float32)
        return self._inv[depth]

    def push(self, p0, r0, rmax, thr):
        """Push from the DONATED state (p0, r0) until r <= thr (per node)
        or rmax*deg: one while_loop program, or the host-stepped split
        superstep when ``stepped_push`` is on."""
        if thr is not None and self._stepped_force:
            return self._push_stepped(p0, r0, thr)
        st = push_ops.PushState(p=p0, r=r0, iters=jnp.zeros((), jnp.int32))
        return self._push(self.graph, st, rmax=jnp.float32(rmax), thr=thr,
                          max_iters=jnp.int32(self.rcfg.max_push_iters))

    # The host-stepped loops poll convergence LAGGED: the flag of
    # superstep i is read only after steps i+1..i+POLL_LAG have been
    # dispatched, so the device->host readback overlaps their execution
    # instead of leaving the device idle while the host waits and then
    # enqueues the next step.  On convergence the lagged steps were
    # identity supersteps (empty active set: p and r provably unchanged),
    # so state stays exact; the only cost is up to POLL_LAG no-op gathers
    # per push call.
    POLL_LAG = 2

    def push_pair_stepped(self, pA, pB, rA, rB, thr):
        """Paired host-stepped push: blocks A and B advance through shared
        supersteps whose gather runs at the concatenated width (see
        _step_a_pair/_step_b_pair).  Returns (pA, pB, rA, rB, iters)."""
        import collections

        import numpy as np
        iters = 0
        pending = collections.deque()
        while iters < self.rcfg.max_push_iters:
            pA, pB, contrib = self._step_a_pair(self.graph, pA, pB, rA, rB,
                                                thr)
            rA, rB, cont = self._step_b_pair(self.graph, rA, rB, contrib,
                                             thr)
            pending.append(cont)
            iters += 1
            if len(pending) > self.POLL_LAG and \
                    not bool(np.asarray(pending.popleft())):
                break
        return pA, pB, rA, rB, iters

    def _push_stepped(self, p, r, thr):
        """Two jitted programs per superstep (see _step_a/_step_b), state
        donated across each boundary; termination is the per-node
        coverage threshold ``thr`` alone (the staged caller always
        supplies it — it is never tighter than rmax*deg).  Convergence
        polls are lagged (POLL_LAG) to keep the device queue fed."""
        import collections

        import numpy as np
        iters = 0
        pending = collections.deque()
        # single contrib slot threaded through every step (see _step_a)
        contrib = jnp.zeros(r.shape, self._contrib_dtype)
        while iters < self.rcfg.max_push_iters:
            p, contrib = self._step_a(self.graph, p, r, thr, contrib)
            r, cont = self._step_b(self.graph, r, contrib, thr)
            pending.append(cont)
            iters += 1
            if len(pending) > self.POLL_LAG and \
                    not bool(np.asarray(pending.popleft())):
                break
        return push_ops.PushState(p=p, r=r, iters=jnp.int32(iters))

    def coverage_thr(self, index_depth: int, omega_unit):
        """Per-node coverage threshold: the guarantee needs the per-walk
        weight bound r_v/omega_v <= 1/omega_unit, and the index supplies
        exactly counts_col samples at this depth — so push may stop at
        r_v <= count_v/omega_unit, never tighter than rmax*deg_v and much
        looser on low-degree tail rows."""
        counts_col = self._counts_dev[:, index_depth]
        return counts_col.astype(jnp.float32) / jnp.float32(omega_unit)

    def walk_contrib(self, r, index_depth: int):
        """Index walk-phase SpMV: depth-``index_depth`` tail buckets
        scatter-added into a fresh contrib accumulator (one compiled
        program per bucket shape, shared across levels/widths)."""
        from ..index import build as ib
        inv = self._inv_cnt(index_depth)
        # accumulate in f32 ALWAYS: hot destination nodes receive millions
        # of index-edge contributions, and a narrow accumulator's
        # per-add rounding compounds (bf16: ~eps*sqrt(M) relative error —
        # garbage at M~1e6).  A bf16 r OPERAND is fine: each gathered
        # value is rounded once, summed in f32 (narrow_r mode).
        contrib = jnp.zeros(r.shape, jnp.float32)
        for q in range(index_depth, ib.NUM_BUCKETS):
            if self._buckets[q] is None:
                continue
            src, dst, mult = self._buckets[q]
            contrib = self._bucket(src, dst, mult, r, inv, contrib)
        return contrib

    def walk_contrib_cols(self, r, index_depth: int, c0: int, w: int):
        """walk_contrib for query columns [c0, c0+w) only — [n, w]
        accumulator, column-windowed gathers (see bucket_spmv_cols)."""
        from ..index import build as ib
        inv = self._inv_cnt(index_depth)
        contrib = jnp.zeros((r.shape[0], w), r.dtype)
        for q in range(index_depth, ib.NUM_BUCKETS):
            if self._buckets[q] is None:
                continue
            src, dst, mult = self._buckets[q]
            contrib = self._bucket_cols(src, dst, mult, r, inv, contrib,
                                        c0, w)
        return contrib

    def lean_state_fn(self, index_depth: int):
        """``(p0, r0, rmax, omega_unit) -> (p, r, contrib, iters)``: push +
        index SpMV WITHOUT materializing ppr = p + contrib — the caller
        (TopkRunner's fused accept, bounds.make_topk_bounds_split_fn) sums
        the two per node-slab inside the chunked top-k.  At LiveJournal
        scale B=256 the skipped [n, B] f32 ppr buffer is 4.3 GB."""

        def fn(p0, r0, rmax, omega_unit):
            thr = self.coverage_thr(index_depth, omega_unit)
            # p0/r0 are DONATED — callers must not reuse them (query_pool
            # rebinds its state blocks to the outputs)
            st = self.push(p0, r0, rmax, thr)
            contrib = self.walk_contrib(st.r, index_depth)
            return st.p, st.r, contrib, st.iters

        return fn

    def state_fn(self, index_depth: int):
        lean = self.lean_state_fn(index_depth)

        def fn(p0, r0, key, rmax, omega_unit):
            del key
            p, r, contrib, iters = lean(p0, r0, rmax, omega_unit)
            return self._finish(p, contrib, r, iters), p, r

        return fn


def make_fora_state_fn(graph: DeviceGraph, rcfg: ResolvedConfig,
                       num_lanes: int, index=None, index_depth: int = 0,
                       staged=None):
    """Jitted ``(p0, r0, key, rmax, omega_unit) -> (ForaResult, p, r)``:
    push resumes from the given state (incremental refinement across delta
    levels — see forward_push_from).  With ``staged`` (a
    StagedForaPrograms), indexed mode composes shared compiled pieces."""
    if staged is not None:
        return staged.state_fn(index_depth)
    if index is not None:
        from ..index.build import index_slices
        buckets, counts_col = index_slices(index, index_depth)
        impl = jax.jit(functools.partial(
            _fora_indexed_state_impl, alpha=rcfg.alpha,
            max_push_iters=rcfg.max_push_iters))

        def fn(p0, r0, key, rmax, omega_unit):
            del key
            return impl(graph, buckets, counts_col, p0, r0, rmax,
                        jnp.float32(omega_unit))

        return fn

    impl = jax.jit(functools.partial(
        _fora_walk_state_impl, alpha=rcfg.alpha,
        max_push_iters=rcfg.max_push_iters,
        max_walk_hops=rcfg.max_walk_hops, num_lanes=num_lanes))

    def fn(p0, r0, key, rmax, omega_unit):
        return impl(graph, p0, r0, key, rmax, omega_unit)

    return fn
