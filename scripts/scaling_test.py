"""Scaling-efficiency harness (BASELINE north star: >= 0.7 at 4 hosts).

Runs the sharded batched top-k pipeline over increasing 'graph'-axis mesh
sizes with the graph row-sharded, and reports throughput + efficiency
relative to the smallest mesh (strong scaling at fixed batch, since the
graph is the scaled resource) PLUS the modeled frontier-exchange wire
volume per superstep for each exchange mode (dense all_gather vs compact
broadcast vs routed all-to-all) — the comm term the mesh can't hide
(SURVEY.md Sec. 2.3 EP row).

Across hosts this is run per-host via jax.distributed (see
fora/parallel/multihost.py); by default it runs on a virtual CPU mesh,
which validates the code path and the collective volume but NOT real link
bandwidth — CPU numbers are functional, not performance claims.

Usage:
  python scripts/scaling_test.py [--nlog2 16] [--edgef 8] [--batch 32]
                                 [--meshes 1,2,4,8] [--indexed]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=14)
    ap.add_argument("--edgef", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--meshes", default="1,2,4,8")
    ap.add_argument("--indexed", action="store_true")
    ap.add_argument("--exchange", default="dense",
                    choices=["dense", "compact", "routed", "hier"])
    ap.add_argument("--chips-per-host", type=int, default=2,
                    help="host grouping for the hier exchange / its "
                         "bytes model")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu-devices", type=int, default=8,
                    help="virtual CPU devices (0 = use real devices)")
    args = ap.parse_args()

    import jax
    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    import jax.numpy as jnp
    import numpy as np
    from fora.config import ForaConfig
    from fora.graph import generators, to_device
    from fora import index as widx
    from fora.parallel import (ShardedForaEngine, exchange_bytes_model,
                                   make_mesh)

    g = generators.rmat(args.nlog2, (1 << args.nlog2) * args.edgef, seed=7)
    rcfg = ForaConfig(epsilon=0.5, k=args.k).resolved(g.n, g.m)
    index = None
    if args.indexed:
        index = widx.build_walk_index(to_device(g), rcfg, jax.random.key(0))

    sources = jnp.arange(args.batch, dtype=jnp.int32)
    base_qps = None
    for gshards in [int(x) for x in args.meshes.split(",")]:
        if gshards > len(jax.devices()):
            break
        mesh = make_mesh(gshards, 1, devices=jax.devices()[:gshards])
        cph = (args.chips_per_host
               if args.exchange == "hier" and gshards % args.chips_per_host == 0
               else None)
        eng = ShardedForaEngine(g, mesh, rcfg, k=args.k, index=index,
                                exchange=("dense" if args.exchange == "hier"
                                          and cph is None else args.exchange),
                                chips_per_host=cph)
        eng.topk(sources, jax.random.key(1)).values.block_until_ready()
        t0 = time.time()
        for i in range(args.reps):
            r = eng.topk(sources, jax.random.fold_in(jax.random.key(2), i))
            r.values.block_until_ready()
        dt = (time.time() - t0) / args.reps
        qps = args.batch / dt
        if base_qps is None:
            base_qps = qps
        eff = qps / base_qps  # strong scaling: ideal = 1.0 (graph sharded)
        # per-superstep wire bytes leaving ONE shard, per exchange mode
        # (model; the routed/compact capacity is the engine's default)
        n_loc = eng.pg.n_loc
        cap = max(64, int(n_loc * 0.125) // 8 * 8)
        bw = {mode: exchange_bytes_model(
            mode, n_loc=n_loc, batch=args.batch, G=gshards,
            cap=cap) for mode in ("dense", "compact", "routed")}
        if gshards % args.chips_per_host == 0:
            bw["hier_dcn"] = exchange_bytes_model(
                "hier", n_loc=n_loc, batch=args.batch, G=gshards, cap=cap,
                chips_per_host=args.chips_per_host)
        print(json.dumps({"graph_shards": gshards, "qps": round(qps, 2),
                          "ms_per_batch": round(dt * 1e3, 1),
                          "efficiency_vs_1shard": round(eff, 3),
                          "push_iters": int(r.push_iters),
                          "exchange": args.exchange,
                          "exchange_mb_per_superstep_per_shard": {
                              k: round(v / 1e6, 2) for k, v in bw.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
