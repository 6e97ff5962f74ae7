"""Hub-split superstep probe — an element-count/locality lever on the
push gather.

Hypothesis: gathering a hub edge's contribution from a compact [H, B]
operand (top-H sources by out-degree; H=64K covers 64% of judged-scale
RMAT edges at 65x less operand bytes) is faster per element than from
the full [n, B] table, because the random-access footprint shrinks.

Two stages:

1. ``--micro``: operand-size sensitivity of the raw gather+segment_sum —
   fixed edge count E, operand rows R swept 2^14..2^22.  If the rate is
   flat in R, the hub split is dead on arrival (the relabel retirement
   already showed zero sensitivity to row ORDER at fixed size; this
   tests SIZE).
2. full superstep A/B at bench/judged scale: dense vs hub-split (tail
   edges through the normal path + hub edges through the compact
   operand), sweeping H.

Timing through utils.profiling.measure (jax.block_until_ready).  Run on
the accelerator; numbers count only with the card's name and power limit
beside them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def micro(args):
    import jax
    import jax.numpy as jnp
    from fora.ops.push import gather_segment_sum
    from fora.utils import profiling

    E = args.edges
    B = args.batch
    chunk = 1 << args.chunk_log2
    key = jax.random.key(0)
    rows = []
    for rlog in range(14, 23):
        R = 1 << rlog
        operand = jax.random.normal(key, (R, B), jnp.float32)
        idx = jax.random.randint(jax.random.fold_in(key, rlog), (E,), 0, R,
                                 jnp.int32)
        # dst-sorted segment ids over n segments (like the real superstep)
        dst = jnp.sort(jax.random.randint(jax.random.fold_in(key, 99 + rlog),
                                          (E,), 0, args.segments, jnp.int32))

        # chunked exactly like the real superstep (the [chunk, B]
        # intermediate is the memory cap)
        fn = jax.jit(lambda op, ix, d: gather_segment_sum(
            op, ix, d, args.segments, max_chunk=chunk))
        secs = profiling.measure(lambda: fn(operand, idx, dst),
                                 reps=3, warmup=1)
        rate = E / secs / 1e6
        rows.append({"operand_rows": R, "operand_mb": R * B * 4 / 1e6,
                     "secs": round(secs, 4),
                     "melem_per_s": round(rate, 1)})
        print(f"[micro] R=2^{rlog} ({R*B*4/1e6:.0f} MB): {secs*1e3:.1f} ms "
              f"-> {rate:.0f} M elem/s", file=sys.stderr, flush=True)
    print(json.dumps({"mode": "micro", "edges": E, "batch": B,
                      "rows": rows}))


def superstep_ab(args):
    import jax
    import jax.numpy as jnp
    from fora.graph.csr import CSRGraph
    from fora.graph import to_device
    from fora.ops import push as push_ops
    from fora.utils import profiling
    from fora.eval import queries as qio

    z = np.load(f"bench_data/{args.tag}.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    dg = to_device(g, merge_duplicate_edges=True)
    B = args.batch
    chunk = 1 << args.chunk_log2
    srcs = jnp.asarray(qio.generate_sources(g, B, seed=8), jnp.int32)
    m_eff = int(dg.in_src.shape[0])

    def one_superstep(dgx, s):
        st0 = push_ops.init_state(dgx.n, s)
        return push_ops.forward_push_from(
            dgx, st0, rmax=0.0, alpha=0.2, max_iters=1,
            max_chunk=chunk).r

    dense_secs = profiling.measure(
        lambda f=jax.jit(one_superstep): f(dg, srcs), reps=3, warmup=1)
    print(f"[ab] dense superstep: {dense_secs*1e3:.1f} ms "
          f"({m_eff} edges)", file=sys.stderr, flush=True)

    in_src = np.asarray(dg.in_src)
    in_dst = np.asarray(dg.in_dst)
    in_w = np.asarray(dg.in_w) if dg.in_w is not None else None
    deg = np.asarray(g.out_deg, np.int64)
    order = np.argsort(-deg, kind="stable")
    results = []
    for hlog in args.h_log2s:
        H = 1 << hlog
        hub_ids = np.sort(order[:H]).astype(np.int32)
        hub_slot = np.full(g.n, -1, np.int32)
        hub_slot[hub_ids] = np.arange(H, dtype=np.int32)
        is_hub = hub_slot[in_src] >= 0
        cov = is_hub.mean()
        # stable partition keeps each subset dst-sorted
        hub_src_local = hub_slot[in_src[is_hub]]
        hub_dst = in_dst[is_hub]
        tail_src = in_src[~is_hub]
        tail_dst = in_dst[~is_hub]
        d_hub_ids = jnp.asarray(hub_ids)
        d_hs = jnp.asarray(hub_src_local)
        d_hd = jnp.asarray(hub_dst)
        d_ts = jnp.asarray(tail_src)
        d_td = jnp.asarray(tail_dst)
        d_hw = jnp.asarray(in_w[is_hub]) if in_w is not None else None
        d_tw = jnp.asarray(in_w[~is_hub]) if in_w is not None else None

        def split_superstep(dgx, s, hub_ids_, hs, hd, hw, ts, td, tw):
            st0 = push_ops.init_state(dgx.n, s)
            r = st0.r
            degf = dgx.out_deg.astype(jnp.float32)[:, None]
            dang = degf == 0.0
            contrib = jnp.where(dang, 0.0,
                                0.8 * r / jnp.maximum(degf, 1e-30))
            hub_vals = contrib[hub_ids_]                     # [H, B]
            d1 = push_ops.gather_segment_sum(
                hub_vals, hs, hd, dgx.n, max_chunk=chunk, edge_w=hw)
            d2 = push_ops.gather_segment_sum(
                contrib, ts, td, dgx.n, max_chunk=chunk, edge_w=tw)
            return d1 + d2

        fn = jax.jit(split_superstep)
        secs = profiling.measure(
            lambda: fn(dg, srcs, d_hub_ids, d_hs, d_hd, d_hw,
                       d_ts, d_td, d_tw), reps=3, warmup=1)
        print(f"[ab] H=2^{hlog} (coverage {cov:.3f}): {secs*1e3:.1f} ms "
              f"vs dense {dense_secs*1e3:.1f} ms", file=sys.stderr,
              flush=True)
        results.append({"H": H, "coverage": round(float(cov), 4),
                        "secs": round(secs, 4),
                        "vs_dense": round(secs / dense_secs, 3)})
        del d_hs, d_hd, d_ts, d_td, d_hw, d_tw
    print(json.dumps({"mode": "ab", "tag": args.tag, "batch": B,
                      "edges": m_eff,
                      "dense_secs": round(dense_secs, 4),
                      "rows": results}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--edges", type=int, default=1 << 24)
    ap.add_argument("--segments", type=int, default=1 << 19)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--tag", default="rmat19x16s7")
    ap.add_argument("--chunk-log2", type=int, default=21)
    ap.add_argument("--h-log2s", type=int, nargs="+",
                    default=[14, 16, 18])
    args = ap.parse_args()
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.micro:
        micro(args)
    else:
        superstep_ab(args)


if __name__ == "__main__":
    main()
