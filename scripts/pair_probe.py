"""Paired-superstep microprobe: where does push_pair lose time?

Times (jax.block_until_ready):
  a. single fused while-loop superstep at B=128 and B=256 (max_iters=1)
  b. the split stepped superstep (_step_a + _step_b) at B=128 and B=256
  c. the PAIRED stepped superstep (step_a_pair + step_b_pair) at w=128
  d. gather-only and scatter-only isolates at both widths

Usage: python scripts/pair_probe.py [--nlog2 19] [--bf16] [--reps 4]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=19)
    ap.add_argument("--edgef", type=int, default=16)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--chunk-log2", type=int, default=20)
    ap.add_argument("--hub", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()

    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from fora.config import ForaConfig
    from fora.graph import to_device
    from fora.graph.csr import CSRGraph
    from fora.ops import push as push_ops

    z = np.load(ROOT / "bench_data" / f"rmat{args.nlog2}x{args.edgef}s7.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=args.hub)
    rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
    n = g.n
    chunk = 1 << args.chunk_log2
    gd = jnp.bfloat16 if args.bf16 else None
    cd = jnp.bfloat16 if args.bf16 else jnp.float32

    def timeit(tag, fn, *xs):
        jax.block_until_ready(fn(*xs))      # compile + warm
        ts = []
        for _ in range(args.reps):
            t0 = time.time()
            out = fn(*xs)
            jax.block_until_ready(out)
            ts.append(time.time() - t0)
        print(f"{tag}: {min(ts)*1e3:.1f} ms (min of {args.reps})",
              flush=True)
        return min(ts)

    rng = np.random.default_rng(0)

    def state(B):
        # dense-ish residues so every row is active (worst-case superstep)
        r = jnp.asarray(rng.random((n, B), np.float32) * 1e-3)
        p = jnp.zeros((n, B), jnp.float32)
        return p, r

    thr = jnp.zeros((n,), jnp.float32)

    # a. fused while-loop superstep
    def one(dgx, p, r, B):
        st = push_ops.forward_push_from(
            dgx, push_ops.PushState(p=p, r=r, iters=jnp.zeros((), jnp.int32)),
            rmax=jnp.float32(0), alpha=rcfg.alpha, max_iters=jnp.int32(1),
            max_chunk=chunk, gather_dtype=gd, thr=thr)
        return st.r
    onej = jax.jit(one, static_argnames=("B",))
    for B in (128, 192, 256):
        p, r = state(B)
        timeit(f"while1 B={B}", lambda p=p, r=r, B=B: onej(dg, p, r, B))

    # b/c. split + paired steps via a StagedForaPrograms-shaped pair
    from fora.algo.fora import StagedForaPrograms

    class _FakeIndex:
        bucket_offsets = np.zeros(9, np.int64)
        edge_mult = None
        edge_src = np.zeros(0, np.int32)
        edge_dst = np.zeros(0, np.int32)
        counts_cum = np.zeros((n, 8), np.int32)

    staged = StagedForaPrograms(dg, rcfg, _FakeIndex(), gather_dtype=gd,
                                gather_chunk=chunk)

    def timeit_chain(tag, step, st, k=6):
        # the split/pair steps DONATE their state — chain k steps, state
        # threaded through, block once; report per-step time
        st = step(st)                     # compile+warm
        jax.block_until_ready(st)
        t0 = time.time()
        for _ in range(k):
            st = step(st)
        jax.block_until_ready(st)
        dt = (time.time() - t0) / k
        print(f"{tag}: {dt*1e3:.1f} ms/step (chained x{k})", flush=True)
        return dt

    for B in (128, 192, 256):
        def split_step(st):
            p, r = st
            p2, contrib = staged._step_a(dg, p, r, thr)
            r2, cont = staged._step_b(dg, r, contrib, thr)
            return p2, r2
        timeit_chain(f"splitAB B={B}", split_step, state(B))

    def pair_step(st):
        pA, pB, rA, rB = st
        pA2, pB2, contrib = staged._step_a_pair(dg, pA, pB, rA, rB, thr)
        rA2, rB2, cont = staged._step_b_pair(dg, rA, rB, contrib, thr)
        return pA2, pB2, rA2, rB2

    pA, rA = state(128)
    pB, rB = state(128)
    timeit_chain("pair w=128 (gather@256)", pair_step, (pA, pB, rA, rB))

    # d. isolates: gather+scatter_add only (no p update)
    for B in (128, 192, 256):
        vals = jnp.asarray(rng.random((n, B), np.float32).astype(
            np.float32)).astype(cd)
        acc = jnp.zeros((n, B), jnp.float32)

        def gsa(acc, vals):
            return push_ops.gather_scatter_add(
                acc, vals, dg.in_src, dg.in_dst, max_chunk=chunk,
                edge_w=dg.in_w)
        timeit(f"gather_scatter_add B={B}", jax.jit(gsa), acc, vals)

    # paired scatter halves from a 256-wide operand
    vals = jnp.asarray(rng.random((n, 256), np.float32)).astype(cd)
    accA = jnp.zeros((n, 128), jnp.float32)
    accB = jnp.zeros((n, 128), jnp.float32)

    def gsap(a, b, v):
        return push_ops.gather_scatter_add_pair(
            a, b, v, dg.in_src, dg.in_dst, max_chunk=chunk, edge_w=dg.in_w)
    timeit("gather_scatter_add_pair w=128", jax.jit(gsap), accA, accB, vals)


if __name__ == "__main__":
    main()
