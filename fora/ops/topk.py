"""On-device top-k selection.

Replaces the reference's host-side indexed binary heap [R: heap.h —
reconstruction, SURVEY.md Sec. 2.1 native-code checklist item 5] with
``jax.lax.top_k``; the sharded variant (fora/parallel) merges per-shard
candidates with one all_gather of 2k entries per shard.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def topk_nodes(ppr: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ppr: [n, B] node-major -> (values [B, k] desc, node ids [B, k])."""
    vals, idx = topk_rows_chunked(ppr, k)
    return vals, idx


def local_topk_candidates(ppr_shard: jnp.ndarray, k: int, row_offset: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-shard candidates with globalized node ids (for the sharded merge)."""
    vals, idx = jax.lax.top_k(ppr_shard.T, k)
    return vals, idx + row_offset


def topk_rows_chunked(ppr: jnp.ndarray, k: int, *extra,
                      chunk: int = 1 << 19, addend: jnp.ndarray = None,
                      cols=None):
    """Node-chunked top-k over a node-major [n, B] estimate.

    ``lax.top_k(ppr.T, k)`` materializes the full [B, n] transpose plus
    key/value sort buffers — at LiveJournal scale (n=4.2M, B=128) that is
    ~2 GB per copy on top of the refinement loop's state.  Instead:
    top-k per
    ``chunk``-row slab (the same candidates-then-merge pattern as the
    sharded engine's per-shard top-k), so peak extra memory is one
    [B, chunk] transpose.

    ``extra``: additional [n, B] arrays gathered at the winning rows
    (e.g. the settled push mass p for the confidence bounds) — gathered
    per slab, so their [B, n] transposes are never built either.

    ``addend`` (optional [n, B] — or [n, w] under ``cols``): ranking
    proceeds over ``ppr + addend``, summed PER SLAB — so a split estimate
    (settled mass p + walk contrib) is ranked without ever materializing
    the full [n, B] sum (4.3 GB at LiveJournal scale B=256; see
    bounds.make_topk_bounds_split_fn).

    ``cols`` ((c0, w), optional): rank only query columns [c0, c0+w) of
    ``ppr``/``extra`` (the half-walk path: addend is the [n, w]
    half-width walk accumulator).  Column windows are sliced per slab
    inside the fused scoring, so no column-sliced copy of the full
    arrays exists.

    Returns (vals [B, k] desc, global row ids [B, k], *extra_at [B, k]);
    B is the column-window width under ``cols``.
    """
    n = ppr.shape[0]
    c0, cw = cols if cols is not None else (0, ppr.shape[1])

    def win(a, lo, hi):
        return a[lo:hi, c0:c0 + cw] if cols is not None else a[lo:hi]

    def scored(lo, hi):
        s = win(ppr, lo, hi)
        if addend is not None:
            s = s + addend[lo:hi].astype(s.dtype)
        return s

    if n <= chunk:
        vals, idx = jax.lax.top_k(scored(0, n).T, min(k, n))
        outs = [jnp.take_along_axis(win(e, 0, n).T, idx, axis=1)
                for e in extra]
        return (vals, idx, *outs)
    kk = min(k, chunk)
    # full slabs run under lax.scan: a statically unrolled slab loop lets
    # XLA schedule the (independent) slab top_ks concurrently, keeping
    # EVERY [B, chunk] transpose live at once — 4.0 GB of temp at
    # LiveJournal scale B=256 where one slab is 0.5 GB.  scan forces
    # sequential temp reuse: one slab in flight.
    n_slabs = n // chunk
    n_full = n_slabs * chunk

    def body(_, xs):
        p_s = xs[0][:, c0:c0 + cw] if cols is not None else xs[0]
        off = xs[1]
        pos = 2
        if addend is not None:
            s = p_s + xs[pos].astype(p_s.dtype)
            pos += 1
        else:
            s = p_s
        v, i = jax.lax.top_k(s.T, kk)
        outs = tuple(jnp.take_along_axis(
            (e[:, c0:c0 + cw] if cols is not None else e).T, i, axis=1)
            for e in xs[pos:])
        return None, (v, i + off, *outs)

    xs = [ppr[:n_full].reshape(n_slabs, chunk, -1),
          jnp.arange(n_slabs, dtype=jnp.int32) * chunk]
    if addend is not None:
        xs.append(addend[:n_full].reshape(n_slabs, chunk, -1))
    xs.extend(e[:n_full].reshape(n_slabs, chunk, -1) for e in extra)
    _, stacked = jax.lax.scan(body, None, tuple(xs))
    # [n_slabs, B, kk] -> [B, n_slabs * kk]
    cand_v = [stacked[0].transpose(1, 0, 2).reshape(stacked[0].shape[1], -1)]
    cand_i = [stacked[1].transpose(1, 0, 2).reshape(stacked[1].shape[1], -1)]
    cand_e = [[s.transpose(1, 0, 2).reshape(s.shape[1], -1)]
              for s in stacked[2:]]
    if n_full < n:                                # remainder slab
        v, i = jax.lax.top_k(scored(n_full, n).T, min(kk, n - n_full))
        cand_v.append(v)
        cand_i.append(i + n_full)
        for j, e in enumerate(extra):
            cand_e[j].append(jnp.take_along_axis(win(e, n_full, n).T, i,
                                                 axis=1))
    cv = jnp.concatenate(cand_v, axis=1)          # [B, ~n_slabs * kk]
    ci = jnp.concatenate(cand_i, axis=1)
    vals, sel = jax.lax.top_k(cv, k)
    idx = jnp.take_along_axis(ci, sel, axis=1)
    outs = [jnp.take_along_axis(jnp.concatenate(ce, axis=1), sel, axis=1)
            for ce in cand_e]
    return (vals, idx, *outs)
