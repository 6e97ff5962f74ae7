"""Top-k PPR with iterative guarantee refinement.

Reproduces the reference's trial-and-error delta-halving loop [R:
query.h/algo.h topk — reconstruction; TODS'19 Sec. 5 per SURVEY.md Sec. 2.2]:
start with a coarse guarantee threshold delta_0 ~ 1/k, run FORA, and accept
once the k-th largest estimate clears the current threshold — at that point
every top-k node sits in the region where the (eps, delta_i) relative-error
guarantee applies.  Otherwise halve delta (tightening rmax and omega) and
rerun.

Acceptance is the union of two sound tests (either suffices):

  * threshold rule: kth_ppr >= (1 + eps) * delta_i.  Then pi_k >=
    pi_hat_k/(1+eps) >= delta_i, so all of the top-k carry relative error
    <= eps w.p. 1 - p_f.
  * confidence-bound separation (TODS'19 Sec. 5, [R: query.h topk bounds —
    reconstruction]): per-node Bernstein UB/LB on the walk-phase estimate;
    accept when the smallest lower bound over the returned set clears the
    best excluded upper bound within (1+eps) — fires on queries with a
    clear gap at rank k even when kth_ppr sits below (1+eps) delta_i.
    See fora/algo/bounds.py for the derivation and the exact guarantee.

The delta schedule is static (delta_0 / 2^i, bounded by 1/n), so each level
compiles once and is reused across queries; a whole batch advances levels
together, with per-query acceptance masking (finished queries keep their
accepted result).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops import topk as topk_ops
from . import fora


class TopkResult(NamedTuple):
    node_ids: np.ndarray    # [B, k] i32, descending by estimate
    values: np.ndarray      # [B, k] f32
    levels_used: int        # delta-halving rounds executed
    accepted: np.ndarray    # [B] bool — guarantee test passed (vs maxed out)
    # per-node guarantee statement: w.p. >= 1 - pfail the true PPR of every
    # returned node lies in [lower_bounds, upper_bounds] (None on paths
    # that don't compute bounds)
    lower_bounds: Optional[np.ndarray] = None   # [B, k] f32
    upper_bounds: Optional[np.ndarray] = None   # [B, k] f32
    # queries handed to the runner's deferred-straggler stash instead of
    # being refined here (query_pool(defer_below=...)); their rows above
    # are placeholders until flush_deferred() resolves them
    deferred: Optional[np.ndarray] = None       # [B] bool


def delta_schedule(rcfg: ResolvedConfig, k: int, stride: float = 2.0) -> list:
    """delta_0 = 1/k, divided by ``stride`` per level down to the final
    guarantee delta (>= 1/n).  The reference halves (stride 2); stride 4
    matches the index bucket granularity and halves the level count at the
    cost of at most one over-fine level."""
    floor_delta = max(rcfg.delta, 1.0 / rcfg.n)
    deltas = []
    d = 1.0 / max(k, 2)
    # stop early enough that the final step to floor_delta is a real jump:
    # resumed push converges in far fewer supersteps for one stride-S step
    # than for several small ones (measured: two ~1.6x rmax steps cost
    # 55+88 supersteps where one 3-4x step costs ~20), so a trailing
    # sliver level (gap < sqrt(stride)) is merged into the floor level.
    while d > floor_delta * math.sqrt(stride):
        deltas.append(d)
        d /= stride
    deltas.append(floor_delta)
    return deltas


class TopkRunner:
    """Drives the delta-halving refinement loop over jitted FORA calls.

    The guarantee parameters (rmax, omega_unit) enter the compiled program
    as runtime scalars, so levels share compilations; only the walk-lane
    count is shape-defining and is bucketed to powers of four — a ~14-level
    schedule compiles 3-4 programs, not 14.
    """

    LANE_BUCKETS = (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22)
    PROBE_EVERY = 8   # pools between one-level-shallower start probes
    WIDTH_FLOOR = 128  # below this the shared row-gather stops amortizing

    def __init__(self, graph: DeviceGraph, rcfg: ResolvedConfig,
                 k: Optional[int] = None, max_lanes: int = 1 << 23,
                 index=None, delta_stride: float = 2.0,
                 accept_slack: float = 1.0, gather_dtype=None,
                 gather_chunk: int = 1 << 23, bound_accept: bool = True,
                 push_pair: bool = False, stepped_push=None,
                 walk_half: bool = False, narrow_r: bool = False):
        """accept_slack > 1 tightens the threshold stopping rule (accept
        only when kth_ppr >= accept_slack * (1+eps) * delta): one level
        deeper on borderline queries, better final precision at extra cost.

        bound_accept: enable the confidence-bound separation test as a
        second acceptance path (see module docstring / bounds.py); the
        threshold rule is always active.

        gather_dtype (e.g. jnp.bfloat16) halves the bytes of the hot
        SpMV gathers (push + index walk phase); see gather_segment_sum.

        gather_chunk caps the [chunk, B] gathered intermediate — lower it
        to run wider query batches in fixed HBM (see forward_push_from).

        push_pair (indexed mode only): process pool blocks in PAIRS whose
        push supersteps gather at the concatenated width while per-block
        state stays at the block width (gather_scatter_add_pair).  An
        opt-in alternative to a single wide block, with exactness tests;
        its speed on the current accelerator is not measured.

        walk_half (indexed mode only): run the walk SpMV + accept in TWO
        column halves per block (column-WINDOWED gathers, [n, B/2] f32
        accumulator) while push runs the full block width.  An opt-in
        memory lever with exactness tests; the default runs the
        FULL-width walk and frees the walk-side out-CSR (see bench.py)."""
        from . import bounds as bounds_mod
        self.graph = graph
        self.gather_dtype = gather_dtype
        self.gather_chunk = gather_chunk
        self.k = k if k is not None else rcfg.k
        self.accept_slack = accept_slack
        self.rcfg = rcfg
        self.deltas = delta_schedule(rcfg, self.k, stride=delta_stride)
        self.bound_accept = bound_accept
        # jit caches per input shape, so one fn serves every batch width
        _t = bounds_mod.union_bound_t(rcfg.n, len(self.deltas), rcfg.pfail)
        self._accept = bounds_mod.make_topk_bounds_fn(
            self.k, _t, rcfg.epsilon)
        # fused accept for the staged/indexed path: takes (p, contrib)
        # split, sums per slab — full ppr never materialized (4.3 GB at
        # LiveJournal scale B=256; bounds.make_topk_bounds_split_fn)
        self._accept_split = bounds_mod.make_topk_bounds_split_fn(
            self.k, _t, rcfg.epsilon)
        # start level for the next pool: the first level whose acceptances
        # changed the last pool's downstream work (_update_start_level);
        # later pools skip the levels above it
        self.auto_start_level = 0
        self._pools_since_probe = 0
        # cross-pool straggler stash (query_pool(defer_below=...) /
        # flush_deferred): list of dicts {sources, p, r, level}
        self._deferred = []
        self._sfns = {}
        self._lsteps = {}
        self._psteps = {}
        self.push_pair = bool(push_pair) and index is not None
        self.walk_half = bool(walk_half) and index is not None
        # narrow_r: store the residue as bf16 BETWEEN the push and walk
        # phases (and between delta levels).  One rounding per level —
        # a ~0.2% one-time perturbation of the residues, NOT a
        # per-superstep accumulation (push always runs f32) — frees a
        # whole [n, B] half-buffer exactly where the [n, B] f32 walk
        # accumulator needs it.  The per-walk weight bound behind the
        # (eps, delta) guarantee inherits the 0.2% slack.
        self.narrow_r = bool(narrow_r) and index is not None
        if self.narrow_r and self.push_pair:
            # the pair level step would scatter-accumulate into a bf16
            # residue (per-add rounding compounds on hot rows); narrow_r
            # is only wired through the single-block staged path
            raise ValueError("narrow_r and push_pair are incompatible")
        self._stepped_push = stepped_push
        self._staged = None
        if self.narrow_r:
            import jax as _jax
            self._narrow = _jax.jit(lambda x: x.astype(jnp.bfloat16),
                                    donate_argnums=(0,))
            self._widen = _jax.jit(lambda x: x.astype(jnp.float32),
                                   donate_argnums=(0,))
        self._accept_split_cols = (
            bounds_mod.make_topk_bounds_split_cols_fn(
                self.k, _t, rcfg.epsilon) if self.walk_half else None)
        self._max_lanes = max_lanes
        self._index = index
        # per level: (compile key, rmax, omega_unit); the compile key is the
        # index depth (FORA+ mode) or the walk-lane bucket (raw-walk mode)
        self._levels = []
        for d in self.deltas:
            rc = rcfg.with_delta(d)
            if index is not None:
                key = index.depth_for(rc.omega_unit, rc.rmax)
            else:
                from ..ops.walk import walk_lane_budget
                need = walk_lane_budget(rc.omega_unit, rc.rmax, rc.m, rc.n,
                                        cap=max_lanes)
                key = min(next((b for b in self.LANE_BUCKETS if b >= need),
                               max_lanes), max_lanes)
            self._levels.append((key, rc.rmax, rc.omega_unit))

    def query(self, sources: jnp.ndarray, key: jax.Array) -> TopkResult:
        """Whole-batch refinement: every query advances levels together
        until all accept (vs ``query_pool``, where accepted queries exit).

        Runs on the same incremental state path as the pool — each level
        RESUMES push from the previous level's (p, r) and feeds the REAL
        settled mass p to the bounds fn, so the confidence-bound acceptance
        is exactly as tight here as in ``query_pool`` (zeros-as-p was
        sound but strictly wider, costing borderline queries extra
        levels)."""
        B, k, eps = sources.shape[0], self.k, self.rcfg.epsilon
        best_vals = jnp.zeros((B, k), jnp.float32)
        best_idx = jnp.zeros((B, k), jnp.int32)
        best_lb = jnp.zeros((B, k), jnp.float32)
        best_ub = jnp.full((B, k), jnp.inf, jnp.float32)
        accepted = jnp.zeros((B,), bool)
        levels = 0
        p, r = self._init_pool_state(jnp.asarray(sources, jnp.int32))
        for level, d in enumerate(self.deltas):
            levels = level + 1
            ckey, rmax, omega_unit = self._levels[level]
            vals, idx, lb, ub, bacc, p, r = self._level_step(ckey)(
                p, r, jax.random.fold_in(key, level),
                jnp.float32(rmax), jnp.float32(omega_unit))
            newly = vals[:, -1] >= self.accept_slack * (1 + eps) * d
            if self.bound_accept:
                newly = jnp.logical_or(newly, bacc)
            newly = jnp.logical_and(~accepted, newly)
            take = jnp.logical_or(newly, jnp.logical_and(~accepted,
                                                         level == len(self.deltas) - 1))
            best_vals = jnp.where(take[:, None], vals, best_vals)
            best_idx = jnp.where(take[:, None], idx, best_idx)
            best_lb = jnp.where(take[:, None], lb, best_lb)
            best_ub = jnp.where(take[:, None], ub, best_ub)
            accepted = jnp.logical_or(accepted, newly)
            if bool(jnp.all(accepted)):
                break
        return TopkResult(node_ids=np.asarray(best_idx),
                          values=np.asarray(best_vals),
                          levels_used=levels,
                          accepted=np.asarray(accepted),
                          lower_bounds=np.asarray(best_lb),
                          upper_bounds=np.asarray(best_ub))

    def _state_fn(self, key: int):
        if key not in self._sfns:
            if self._index is not None:
                if self._staged is None:
                    self._staged = fora.StagedForaPrograms(
                        self.graph, self.rcfg, self._index,
                        gather_dtype=self.gather_dtype,
                        gather_chunk=self.gather_chunk,
                        stepped_push=self._stepped_push)
                self._sfns[key] = self._staged.state_fn(key)
            else:
                self._sfns[key] = fora.make_fora_state_fn(
                    self.graph, self.rcfg, key)
        return self._sfns[key]

    # --- pool-runner extension points (overridden by the sharded runner,
    # fora/parallel/sharded.py ShardedTopkRunner) ---

    def _init_pool_state(self, src_pad: jnp.ndarray):
        """(p, r) state for one width-wide block of sources: one-hot
        residue.  Pool state lives as a LIST of such column blocks (not one
        concatenated buffer) so each level step can DONATE its block's
        buffers — see query_pool."""
        n, C = self.rcfg.n, src_pad.shape[0]
        p = jnp.zeros((n, C), jnp.float32)
        r = jnp.zeros((n, C), jnp.float32).at[
            src_pad, jnp.arange(C)].set(1.0)
        return p, r

    def _level_step(self, ckey: int):
        """``(p, r, key, rmax, omega_unit) -> (vals, idx, lb, ub, bacc,
        p', r')``: one refinement level resumed from (p, r), returning the
        per-query top-k with confidence bounds and the advanced state."""
        if ckey not in self._lsteps:
            if self._index is not None:
                # staged/indexed: the lean state fn returns (p, r, contrib)
                # and the split accept ranks p + contrib per slab — the
                # [n, B] ppr buffer of the old composition never exists
                self._state_fn(ckey)   # ensures self._staged
                staged = self._staged
                lean = staged.lean_state_fn(ckey)

                def fn(p, r, key, rmax, omega_unit):
                    del key  # indexed mode is deterministic
                    if self.narrow_r:
                        if r.dtype != jnp.float32:
                            r = self._widen(r)
                        thr = staged.coverage_thr(ckey, omega_unit)
                        st = staged.push(p, r, rmax, thr)
                        rn = self._narrow(st.r)
                        contrib = staged.walk_contrib(rn, ckey)
                        vals, idx, lb, ub, _, _, bacc = self._accept_split(
                            st.p, contrib, omega_unit)
                        return vals, idx, lb, ub, bacc, st.p, rn
                    B = r.shape[1]
                    if self.walk_half and B >= 256 and B % 2 == 0:
                        # wide block: full-width push, column-halved walk
                        # SpMV + accept (see walk_half docstring)
                        thr = staged.coverage_thr(ckey, omega_unit)
                        st = staged.push(p, r, rmax, thr)
                        outs = []
                        w = B // 2
                        for c0 in (0, w):
                            contrib = staged.walk_contrib_cols(
                                st.r, ckey, c0, w)
                            vals, idx, lb, ub, _, _, bacc = \
                                self._accept_split_cols(
                                    st.p, contrib, omega_unit, c0, w)
                            outs.append((vals, idx, lb, ub, bacc))
                        cat = [jnp.concatenate([o[i] for o in outs],
                                               axis=0) for i in range(5)]
                        return (*cat, st.p, st.r)
                    p2, r2, contrib, _ = lean(p, r, rmax, omega_unit)
                    vals, idx, lb, ub, _, _, bacc = self._accept_split(
                        p2, contrib, omega_unit)
                    return vals, idx, lb, ub, bacc, p2, r2
            else:
                sfn = self._state_fn(ckey)

                def fn(p, r, key, rmax, omega_unit):
                    res, p2, r2 = sfn(p, r, key, rmax, omega_unit)
                    vals, idx, lb, ub, _, _, bacc = self._accept(
                        res.ppr, p2, omega_unit)
                    return vals, idx, lb, ub, bacc, p2, r2

            self._lsteps[ckey] = fn
        return self._lsteps[ckey]

    def _level_step_pair(self, ckey: int):
        """Paired level step (push_pair): ``(pA, rA, pB, rB, rmax,
        omega_unit) -> ([two (vals, idx, lb, ub, bacc) tuples],
        (pA', rA'), (pB', rB'))``.  The push phase advances both blocks
        through shared supersteps at the concatenated gather width
        (StagedForaPrograms.push_pair_stepped); the walk SpMV and fused
        accept then run per block, INTERLEAVED (contrib A is accepted —
        and its buffer donated away — before contrib B is built), so at
        most one [n, w] f32 walk accumulator exists at a time."""
        if ckey not in self._psteps:
            self._state_fn(ckey)   # ensures self._staged
            staged = self._staged

            def fn(pA, rA, pB, rB, rmax, omega_unit):
                del rmax  # per-node coverage threshold supersedes it
                thr = staged.coverage_thr(ckey, omega_unit)
                pA, pB, rA, rB, _ = staged.push_pair_stepped(
                    pA, pB, rA, rB, thr)
                outs = []
                for ph, rh in ((pA, rA), (pB, rB)):
                    contrib = staged.walk_contrib(rh, ckey)
                    vals, idx, lb, ub, _, _, bacc = self._accept_split(
                        ph, contrib, omega_unit)
                    outs.append((vals, idx, lb, ub, bacc))
                return outs, (pA, rA), (pB, rB)

            self._psteps[ckey] = fn
        return self._psteps[ckey]

    def query_pool(self, sources: np.ndarray, key: jax.Array,
                   batch: int, start_level: Optional[int] = None,
                   defer_below: int = 0, _state=None) -> TopkResult:
        """Level-pipelined batching over a pool of queries with incremental
        push.

        ``query`` advances a whole batch to deeper levels until EVERY query
        accepts, so one straggler drags the full batch through the most
        expensive levels, and every level re-pushes from scratch.  Here

          * accepted queries exit at their level; only stragglers re-batch
            deeper (amortized cost sum_l P(reach l) * cost_l),
          * each level RESUMES push from the previous level's (p, r) state
            (forward_push_from), so total push work across the schedule
            collapses to about the deepest level reached, and
          * the batch WIDTH adapts per level: full ``batch`` while the
            pool is large, halving (down to 128 — below that the shared
            row-gather stops amortizing) once stragglers thin out, so the
            deep-level tail doesn't pay for padding lanes.  Each distinct
            width is one extra set of compiled shapes (cached), and
          * the START level adapts across pools (``_update_start_level``):
            the next pool starts at the first level whose acceptances
            actually changed this pool's downstream work — levels that
            accept nobody, or whose acceptances leave the later batch
            shapes unchanged (width-floor pools), are skipped: their push
            work the resumed deeper push redoes more cheaply as one merged
            rmax step (``start_level`` overrides; see the method docstring
            for why a fancier argmin cost model was removed).  Starting
            deeper never weakens the guarantee — each level's acceptance
            test is self-contained — it only hands early-acceptable
            queries a finer-than-required answer, and
          * with ``defer_below > 0``, once the pool's stragglers thin out
            to <= defer_below (and the schedule isn't exhausted) they are
            STASHED — state columns extracted, marked ``deferred`` in the
            result — instead of dragging a width-floor batch through the
            expensive deep levels once per pool; ``flush_deferred`` then
            refines all pools' stragglers together in one shared batch
            (at judged scale ~1 straggler per 128-query pool would
            otherwise pay a full-width level-4/5 pass per pool).

        ``_state`` (internal, used by flush_deferred): resume from the
        given [n, |sources|] (p, r) instead of fresh one-hot state.
        """
        import time as _time
        sources = np.asarray(sources)
        n_q = len(sources)
        self.last_level_stats = []   # [{level, delta, batches, pending, secs}]
        k, eps = self.k, self.rcfg.epsilon
        out_ids = np.zeros((n_q, k), np.int32)
        out_vals = np.zeros((n_q, k), np.float32)
        out_lb = np.zeros((n_q, k), np.float32)
        out_ub = np.full((n_q, k), np.inf, np.float32)
        max_level = 0
        accepted = np.zeros(n_q, bool)
        deferred_mask = np.zeros(n_q, bool)
        pending = np.arange(n_q)

        def pick_width(n_pending: int) -> int:
            w = batch
            while w // 2 >= max(n_pending, 1) and w // 2 >= self.WIDTH_FLOOR:
                w //= 2
            return w

        # pool state = list of [n, width] column blocks.  Block-granular
        # state (instead of one [n, pool] buffer) keeps the level step
        # donation-safe: each step consumes exactly one block's buffers and
        # the slot is rebound to the outputs, so XLA aliases state-in onto
        # state-out and peak HBM is one block's working set, not two.
        width = pick_width(n_q)
        pad0 = (-n_q) % width
        cols = np.concatenate([pending, np.zeros(pad0, np.int64)])
        if _state is None:
            blocks = [self._init_pool_state(
                jnp.asarray(sources[cols[lo: lo + width]], jnp.int32))
                for lo in range(0, len(cols), width)]
        else:
            # resume from caller-provided state columns (flush_deferred);
            # pad by repeating the last column — padding rows g >=
            # len(pending) are skipped at acceptance time
            p_all, r_all = _state
            idx = np.concatenate(
                [np.arange(n_q), np.full(pad0, n_q - 1, np.int64)])
            blocks = [(jnp.take(p_all, jnp.asarray(idx[lo: lo + width]),
                                axis=1),
                       jnp.take(r_all, jnp.asarray(idx[lo: lo + width]),
                                axis=1))
                      for lo in range(0, len(idx), width)]
            del p_all, r_all, _state

        start = self.auto_start_level
        if start_level is None and start > 0 \
                and self._pools_since_probe >= self.PROBE_EVERY:
            # periodic probe one level shallower: the cost model can only
            # rank levels it has stats for, so occasionally pay one extra
            # level to learn whether the workload shifted shallower
            start -= 1
            self._pools_since_probe = 0
        elif start_level is not None:
            start = start_level
        start = max(0, min(start, len(self.deltas) - 1))

        for level, d in enumerate(self.deltas):
            if level < start or len(pending) == 0:
                continue
            max_level = level + 1
            _t0 = _time.time()
            _n_pending = len(pending)
            ckey, rmax, omega_unit = self._levels[level]
            fn = self._level_step(ckey)
            last = level == len(self.deltas) - 1
            keep_cols = []
            n_ok = 0
            n_ok_bound = 0   # accepted by the bound test alone
            # dispatch every batch of the level before the first host sync:
            # jax dispatch is async, so batch i+1's push overlaps batch i's
            # walk/top-k and the host-side acceptance bookkeeping.  fn
            # DONATES each block's buffers; the slot is rebound to the
            # outputs immediately, so no stale reference survives.
            inflight = []
            bi = 0
            while bi < len(blocks):
                if self.push_pair and bi + 1 < len(blocks):
                    pa, ra = blocks[bi]
                    pb, rb = blocks[bi + 1]
                    outs, sa, sb = self._level_step_pair(ckey)(
                        pa, ra, pb, rb, jnp.float32(rmax),
                        jnp.float32(omega_unit))
                    blocks[bi], blocks[bi + 1] = sa, sb
                    inflight.append((bi * width,) + outs[0])
                    inflight.append(((bi + 1) * width,) + outs[1])
                    bi += 2
                    continue
                pc, rc = blocks[bi]
                lo = bi * width
                vals, idx, lb, ub, bacc, pc, rc = fn(
                    pc, rc, jax.random.fold_in(key, level * 10007 + lo),
                    jnp.float32(rmax), jnp.float32(omega_unit))
                blocks[bi] = (pc, rc)
                inflight.append((lo, vals, idx, lb, ub, bacc))
                bi += 1
            for lo, vals, idx, lb, ub, bacc in inflight:
                vals, idx = np.asarray(vals), np.asarray(idx)
                lb, ub = np.asarray(lb), np.asarray(ub)
                bacc = np.asarray(bacc)
                for b in range(width):
                    g = lo + b
                    if g >= len(pending):
                        continue
                    q = pending[g]
                    ok_thr = bool(vals[b, -1] >=
                                  self.accept_slack * (1 + eps) * d)
                    ok = ok_thr or (self.bound_accept and bool(bacc[b]))
                    n_ok += ok
                    n_ok_bound += ok and not ok_thr
                    if ok or last:
                        out_ids[q] = idx[b]
                        out_vals[q] = vals[b]
                        out_lb[q] = lb[b]
                        out_ub[q] = ub[b]
                        accepted[q] = ok
                    else:
                        keep_cols.append(g)
            self.last_level_stats.append(dict(
                level=level, delta=d, width=width,
                batches=len(blocks),
                pending=_n_pending, accepted=n_ok,
                accepted_bound_only=n_ok_bound,
                secs=round(_time.time() - _t0, 3)))
            if not keep_cols:
                pending = pending[:0]
                break
            keep = np.asarray(keep_cols)
            if defer_below and len(keep) <= defer_below and not last:
                # stragglers too few to fill a batch: stash their state
                # columns for a shared flush across pools instead of
                # paying the deep levels at full width here
                p_cols, r_cols = self._extract_cols(blocks, width, keep)
                q_ids = pending[keep]
                self._deferred.append(dict(
                    sources=np.asarray(sources[q_ids]).copy(),
                    p=p_cols, r=r_cols, level=level + 1))
                deferred_mask[q_ids] = True
                pending = pending[:0]
                break
            pending = pending[keep]
            new_width = pick_width(len(keep))
            take = np.concatenate(
                [keep, np.repeat(keep[-1:], (-len(keep)) % new_width)])
            blocks = self._reblock(blocks, width, take, new_width)
            width = new_width

        if start_level is None:
            self._update_start_level(n_q)
            self._pools_since_probe += 1
        return TopkResult(node_ids=out_ids, values=out_vals,
                          levels_used=max_level, accepted=accepted,
                          lower_bounds=out_lb, upper_bounds=out_ub,
                          deferred=deferred_mask)

    def flush_deferred(self, key: jax.Array, batch: int):
        """Refine every stashed straggler (query_pool ``defer_below``) in
        one shared pool per distinct stashed level, resumed from the
        stashed push state.  Returns ``(sources, TopkResult)`` — rows align
        with ``sources`` — or ``(empty, None)`` if nothing was stashed.
        Flushing per distinct level (not from the minimum) keeps the trial
        count behind ``union_bound_t`` exact: no group re-runs a level it
        already attempted with fresh randomness.  In practice all pools
        defer at the same level, so this is still one pool."""
        if not self._deferred:
            return np.empty(0, np.int64), None
        groups, self._deferred = self._deferred, []
        by_level: dict = {}
        for g in groups:
            by_level.setdefault(g["level"], []).append(g)
        all_srcs, parts = [], []
        for li, (start, gs) in enumerate(sorted(by_level.items())):
            srcs = np.concatenate([g["sources"] for g in gs])
            p = (gs[0]["p"] if len(gs) == 1 else
                 jnp.concatenate([g["p"] for g in gs], axis=1))
            r = (gs[0]["r"] if len(gs) == 1 else
                 jnp.concatenate([g["r"] for g in gs], axis=1))
            for g in gs:
                g.clear()   # release stashed buffers
            parts.append(self.query_pool(
                srcs, jax.random.fold_in(key, li), batch=batch,
                start_level=start, _state=(p, r)))
            all_srcs.append(srcs)
        if len(parts) == 1:
            return all_srcs[0], parts[0]
        cat = lambda f: np.concatenate([getattr(r, f) for r in parts])
        return np.concatenate(all_srcs), TopkResult(
            node_ids=cat("node_ids"), values=cat("values"),
            levels_used=max(r.levels_used for r in parts),
            accepted=cat("accepted"), lower_bounds=cat("lower_bounds"),
            upper_bounds=cat("upper_bounds"), deferred=cat("deferred"))

    @staticmethod
    def _extract_cols(blocks, width, keep):
        """Concatenate the pool columns at positions ``keep`` (old block
        layout, as in _reblock) into one [n, len(keep)] (p, r) pair."""
        pieces_p, pieces_r = [], []
        for bi, (pc, rc) in enumerate(blocks):
            sel = keep[(keep >= bi * width) & (keep < (bi + 1) * width)]
            if len(sel):
                s = jnp.asarray(sel - bi * width)
                pieces_p.append(jnp.take(pc, s, axis=1))
                pieces_r.append(jnp.take(rc, s, axis=1))
        p = (pieces_p[0] if len(pieces_p) == 1
             else jnp.concatenate(pieces_p, axis=1))
        r = (pieces_r[0] if len(pieces_r) == 1
             else jnp.concatenate(pieces_r, axis=1))
        return p, r

    # --- persisted level stats (cold-start tax) -------------------------
    #
    # At judged scale the shallow delta levels accept NOBODY (levels 0-1:
    # ~67 s of push that the resumed deeper push redoes more cheaply as one
    # merged rmax step) and every cold process re-learned that by paying
    # them once.  The first-accepting start level is a property of
    # (graph content, config), so it is persisted beside the index and
    # versioned the same way: stale entries (different graph sha or
    # derivation inputs) are ignored, never trusted.

    # v2: start level is "first level whose acceptances changed downstream
    # work" (was "first accepting level") — v1 records are refused so a
    # stale shallower start is never inherited
    LEVEL_STATS_VERSION = 2

    def _stats_fingerprint(self, graph_sha: Optional[str]) -> dict:
        return {
            "version": self.LEVEL_STATS_VERSION,
            "graph_sha": graph_sha,
            "n": self.rcfg.n, "m": self.rcfg.m,
            "alpha": self.rcfg.alpha, "epsilon": self.rcfg.epsilon,
            "delta": self.rcfg.delta, "pfail": self.rcfg.pfail,
            "k": self.k, "accept_slack": self.accept_slack,
            "deltas": [float(d) for d in self.deltas],
            "indexed": self._index is not None,
        }

    def save_level_stats(self, path, graph_sha: Optional[str] = None) -> None:
        """Persist the learned start level (+ the last pool's per-level
        stats, for observability) keyed by graph content and the full
        (eps, delta, pfail, k, schedule) derivation."""
        import json
        from pathlib import Path
        rec = self._stats_fingerprint(graph_sha)
        rec["start_level"] = int(self.auto_start_level)
        rec["last_level_stats"] = getattr(self, "last_level_stats", [])
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(rec, indent=1))
        tmp.rename(p)

    def load_level_stats(self, path, graph_sha: Optional[str] = None) -> bool:
        """Adopt a persisted start level if it matches this (graph, config);
        returns whether it did.  Starting deeper never weakens the
        guarantee (each level's acceptance test is self-contained), and
        the periodic shallow probe still corrects drift."""
        import json
        from pathlib import Path
        p = Path(path)
        if not p.exists():
            return False
        try:
            rec = json.loads(p.read_text())
        except (OSError, ValueError):
            return False
        want = self._stats_fingerprint(graph_sha)
        if {k: rec.get(k) for k in want} != want:
            return False
        self.auto_start_level = max(
            0, min(int(rec["start_level"]), len(self.deltas) - 1))
        return True

    @staticmethod
    def _reblock(blocks, width, take, new_width):
        """Regroup the surviving pool columns into [n, new_width] blocks.

        ``take``: sorted positions (old layout: block bi holds columns
        [bi*width, (bi+1)*width)), padded to a multiple of new_width by
        repeating the last survivor.  Old blocks are released as their
        columns are extracted; peak extra memory is the survivor set only.
        """
        pieces_p, pieces_r = [], []
        for bi in range(len(blocks)):
            pc, rc = blocks[bi]
            sel = take[(take >= bi * width) & (take < (bi + 1) * width)]
            if len(sel):
                sel = jnp.asarray(sel - bi * width)
                pieces_p.append(jnp.take(pc, sel, axis=1))
                pieces_r.append(jnp.take(rc, sel, axis=1))
            blocks[bi] = None   # release the old block's buffers
        p_all = (pieces_p[0] if len(pieces_p) == 1
                 else jnp.concatenate(pieces_p, axis=1))
        r_all = (pieces_r[0] if len(pieces_r) == 1
                 else jnp.concatenate(pieces_r, axis=1))
        return [(p_all[:, lo: lo + new_width], r_all[:, lo: lo + new_width])
                for lo in range(0, p_all.shape[1], new_width)]

    def _update_start_level(self, n_total: int) -> None:
        """Pick the next pool's start level: the first level whose
        acceptances CHANGED the pool's downstream work.

        A level earns its place in the schedule only if, per the last
        pool's stats, it either (a) (nearly) terminated the pool — fewer
        than max(2, pool/32) survivors — or (b) thinned the survivors
        enough that later levels re-batched into fewer total columns
        (batches x width, the cost unit of a level at fixed depth).
        Levels that accept a minority while the width floor keeps the
        batch shape unchanged are pure overhead: their push work is redone
        more cheaply by the next level's RESUMED push as one merged rmax
        step (one 3-4x rmax step converges in fewer supersteps than two
        smaller ones — see delta_schedule), and their walk/bound work
        serves queries that get a finer answer for free at the next level
        anyway (at judged scale level 2 accepted ~25% of each 128-pool
        while the 128-wide floor left level 3's batch identical).

        A per-level argmin cost model was tried here and REMOVED: it
        extrapolated each level's measured cost — a resumed push over
        stragglers — to a from-scratch start at that level; at LiveJournal
        scale (4.2M nodes) it chose the deepest level, whose from-scratch
        push made pools 10x slower (262 s vs ~25 s per 128 queries), with
        warmup compile time poisoning the shallow levels' stats on top.
        This rule uses only STRUCTURAL facts (survivor counts and batch
        shapes), never extrapolated timings, and the near-termination
        guard keeps it off the expensive deep levels.  Starting deeper
        never weakens the guarantee (each level's acceptance test is
        self-contained); the periodic probe in query_pool re-checks one
        level shallower in case the workload drifts.
        """
        stats = self.last_level_stats
        if not stats:
            return
        near_term = max(2, n_total // 32)
        start = stats[0]["level"]
        for i, st in enumerate(stats):
            survivors = st["pending"] - st["accepted"]
            if survivors < near_term:
                break   # this level (nearly) terminates pools: keep it
            nxt = stats[i + 1] if i + 1 < len(stats) else None
            if nxt is None:
                break   # schedule exhausted here: nothing deeper to merge
            if nxt["batches"] * nxt["width"] < st["batches"] * st["width"]:
                break   # acceptances shrank downstream batches: keep it
            if nxt["level"] >= len(self.deltas) - 1:
                # never ratchet INTO the final schedule level without a
                # near-termination signal: a trickle workload (every level
                # accepts a few, shapes pinned at the width floor) would
                # otherwise walk the start to the deepest level, whose
                # from-scratch push is the regression the removed argmin
                # model hit, and the shallow probe only
                # recovers one level per PROBE_EVERY pools
                break
            start = nxt["level"]
        self.auto_start_level = start
