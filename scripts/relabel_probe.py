"""Measure the dense push superstep under node relabelings (gather
locality experiment — round-2 verdict "next" #1).

The superstep's random row-gather is far below the device-memory
roofline; node labels choose WHERE in the [n, B] operand each gather
lands, so orders that cluster hot rows (degree-descending) or give
neighbors nearby labels (BFS) may help a cache-backed gather.

Usage (on the accelerator):
    python scripts/relabel_probe.py --nlog2 19 --orders identity,degree,bfs,random
    python scripts/relabel_probe.py --nlog2 22 --batch 128

Prints one JSON line per (order, batch): superstep seconds + effective
GB/s.  Relabeled graphs are cached in bench_data/ next to the base RMAT.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=19)
    ap.add_argument("--edgef", type=int, default=16)
    ap.add_argument("--batch", default="128")
    ap.add_argument("--orders", default="identity,degree,bfs,random")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cache", default="bench_data")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from fora.graph import generators, relabel, to_device
    from fora.graph.csr import CSRGraph
    from fora.ops import push as push_ops
    from fora.utils import profiling

    cache = Path(args.cache)
    cache.mkdir(parents=True, exist_ok=True)
    tag = f"rmat{args.nlog2}x{args.edgef}s{args.seed}"

    def load_or(f, make):
        if f.exists():
            z = np.load(f)
            return CSRGraph(**{k: z[k] for k in CSRGraph._fields
                               if k in z.files})
        g = make()
        np.savez(f, **{k: v for k, v in g._asdict().items()
                       if v is not None})
        return g

    base = load_or(cache / f"{tag}.npz",
                   lambda: generators.rmat(
                       args.nlog2, (1 << args.nlog2) * args.edgef,
                       seed=args.seed))
    print(f"[probe] graph n={base.n} m={base.m}", file=sys.stderr)

    def make_order(name):
        t0 = time.time()
        if name == "identity":
            g = base
        else:
            if name == "degree":
                perm = relabel.degree_order(base)
            elif name == "bfs":
                perm = relabel.bfs_order(base)
            elif name == "random":
                perm = np.random.default_rng(0).permutation(base.n).astype(
                    np.int32)
            else:
                raise ValueError(name)
            g = load_or(cache / f"{tag}.{name}.npz",
                        lambda: relabel.relabel_graph(base, perm))
        print(f"[probe] order {name} ready in {time.time()-t0:.1f}s",
              file=sys.stderr)
        return g

    for name in args.orders.split(","):
        g = make_order(name)
        dg = to_device(g, merge_duplicate_edges=True)
        m_eff = int(dg.in_src.shape[0])
        for b in [int(x) for x in args.batch.split(",")]:
            def one_superstep(dgx, srcs):
                st0 = push_ops.init_state(dgx.n, srcs)
                return push_ops.forward_push_from(
                    dgx, st0, rmax=0.0, alpha=0.2, max_iters=1,
                    max_chunk=1 << 21).r

            step = jax.jit(one_superstep)
            srcs = jnp.arange(b, dtype=jnp.int32)
            secs = profiling.measure(lambda: step(dg, srcs),
                                     reps=args.reps, warmup=1)
            roof = profiling.SpmvRoofline(edges=m_eff, batch=b, nodes=g.n)
            print(json.dumps({
                "order": name, "batch": b, "n": g.n, "m_eff": m_eff,
                "superstep_secs": round(secs, 5),
                "eff_gbps": round(roof.bytes_moved / secs / 1e9, 2),
                "roofline": round(roof.efficiency(secs), 4),
            }), flush=True)
        del dg


if __name__ == "__main__":
    main()
