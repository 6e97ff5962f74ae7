"""Record the config-5 serving numbers (one JSON document).

BASELINE config 5: sustained QPS at a fixed precision SLO.  This drives
the REAL server loop (fora/serve.ForaServer — TCP, micro-batching,
bounded admission) on the accelerator at judged scale (RMAT 4.2M/67M,
FORA+ indexed pool runner) with an in-process closed-loop load generator
for >= 10 sustained minutes, and records:

  sustained qps (generator window, warmup excluded), p50/p95/p99 ms,
  shed rate, rolling precision@k from the server's SLO sampler
  (fora/serve.py slo_exact), plus client-side precision@50/@100
  over every scorable answered query.

k defaults to 100 (config 5 is a precision@100 SLO); the exact oracle
for the eval sources is computed once and cached (bench.get_exact).

Usage:
  FORA_BENCH_K=100 python scripts/record_serve.py [--duration 660]
"""

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


async def client(port, sources, rng_seed, stop_at, tally, exact100):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    rng = np.random.default_rng(rng_seed)
    while time.monotonic() < stop_at:
        s = int(sources[rng.integers(len(sources))])
        writer.write((json.dumps({"id": 0, "source": s}) + "\n").encode())
        await writer.drain()
        resp = json.loads(await reader.readline())
        now = time.monotonic()
        if "nodes" in resp:
            tally["done"].append(now)
            ex = exact100.get(s)
            if ex is not None:
                ids = np.asarray(resp["nodes"])
                tally["p50"].append(
                    len(np.intersect1d(ids[:50], ex[:50])) / 50)
                if len(ids) >= 100 and len(ex) >= 100:
                    tally["p100"].append(
                        len(np.intersect1d(ids[:100], ex[:100])) / 100)
        elif resp.get("error") == "overloaded":
            tally["shed"] += 1
            await asyncio.sleep(0.5)
        elif "error" in resp:
            tally["errors"] += 1
            await asyncio.sleep(0.5)
    writer.close()


async def get_stats(port):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b'{"cmd": "stats"}\n')
    await writer.drain()
    resp = json.loads(await reader.readline())
    writer.close()
    return resp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="serve.json")
    ap.add_argument("--duration", type=float, default=660.0,
                    help="sustained-load window secs (>=600 for config 5)")
    ap.add_argument("--clients", type=int, default=256)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    import bench
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    from fora.algo import topk as topk_algo
    from fora.config import ForaConfig
    from fora.graph import to_device
    from fora import index as widx

    K = bench.K
    g = bench.get_graph()
    sources = bench.get_sources(g)
    exact_ids = bench.get_exact(g, sources)     # [EVAL, K] (cached per K)
    exact_map = {int(s): exact_ids[i]
                 for i, s in enumerate(sources[:bench.EVAL_N])}
    print(f"[serve] graph n={g.n} m={g.m} k={K} "
          f"scorable={len(exact_map)}", file=sys.stderr, flush=True)

    cfg = ForaConfig(epsilon=bench.EPS, k=K)
    rcfg = cfg.resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True)
    idx_dir = bench.CACHE / f"{bench.TAG}.idx.e{bench.EPS}"
    index = widx.load(str(idx_dir), rcfg, graph=g)
    runner = topk_algo.TopkRunner(dg, rcfg, k=K, index=index,
                                  delta_stride=bench.DSTRIDE,
                                  gather_chunk=bench.CHUNK)
    stats_path = bench.CACHE / f"{bench.TAG}.levelstats.e{bench.EPS}.k{K}.json"
    graph_sha = widx.graph_fingerprint(g)
    if runner.load_level_stats(stats_path, graph_sha):
        print(f"[serve] start level {runner.auto_start_level} (persisted)",
              file=sys.stderr, flush=True)

    key = jax.random.key(11)

    def query_fn(srcs, seed):
        res = runner.query_pool(np.asarray(srcs),
                                jax.random.fold_in(key, seed),
                                batch=args.batch)
        return res.node_ids, res.values

    t0 = time.time()
    print("[serve] warmup (compile + level-stat learn) ...",
          file=sys.stderr, flush=True)
    query_fn(sources[: args.batch], 999)
    warmup_secs = time.time() - t0
    runner.save_level_stats(stats_path, graph_sha)
    print(f"[serve] warmup done in {warmup_secs:.1f}s "
          f"(start level {runner.auto_start_level})",
          file=sys.stderr, flush=True)

    from fora.serve import ForaServer

    async def run():
        # inflight=1: a query_pool batch holds ~4 [n, 128] f32 buffers
        # (~8.6 GB at 4.2M nodes) and TopkRunner's pool state is not
        # thread-safe.  The device is serial; batch-level pipelining buys
        # nothing here.
        srv = ForaServer(query_fn, batch=args.batch, k=K,
                         max_wait_ms=200.0, inflight=1,
                         max_pending=2 * args.clients,
                         admission_timeout_ms=10000.0,
                         slo_exact=exact_map, slo_sample_every=4)
        port = await srv.start(port=0)
        print(f"[serve] serving on :{port}; driving {args.clients} "
              f"closed-loop clients for {args.duration:.0f}s",
              file=sys.stderr, flush=True)
        tally = {"done": [], "p50": [], "p100": [], "shed": 0,
                 "errors": 0}
        stop_at = time.monotonic() + args.duration
        t_open = time.monotonic()

        async def reporter():
            while time.monotonic() < stop_at:
                await asyncio.sleep(60)
                print(f"[serve] t+{time.monotonic()-t_open:.0f}s: "
                      f"{len(tally['done'])} answered, "
                      f"{tally['shed']} shed, {tally['errors']} errors",
                      file=sys.stderr, flush=True)

        rep = asyncio.create_task(reporter())
        await asyncio.gather(*[
            client(port, sources, 1000 + c, stop_at, tally, exact_map)
            for c in range(args.clients)])
        rep.cancel()
        t_close = time.monotonic()
        stats = await get_stats(port)
        await srv.stop()

        # sustained window: exclude the ramp (first batch round) — count
        # completions in the second half vs the full window for honesty
        done = np.asarray(tally["done"])
        window = t_close - t_open
        half = t_open + window / 2
        qps_full = len(done) / window
        qps_2nd_half = float((done >= half).sum()) / (t_close - half)
        return {
            "duration_secs": round(window, 1),
            "queries_answered": len(done),
            "sustained_qps": round(qps_full, 2),
            "second_half_qps": round(qps_2nd_half, 2),
            "shed": tally["shed"] + stats.get("shed", 0),
            "latency_ms_p50": stats["latency_ms_p50"],
            "latency_ms_p95": stats["latency_ms_p95"],
            "latency_ms_p99": stats["latency_ms_p99"],
            "server_precision_at_k": stats["precision_at_k"],
            "server_slo_samples": stats["slo_samples"],
            "client_precision_at_50": (
                round(float(np.mean(tally["p50"])), 4)
                if tally["p50"] else None),
            "client_precision_at_100": (
                round(float(np.mean(tally["p100"])), 4)
                if tally["p100"] else None),
            "scored_queries": len(tally["p50"]),
        }

    row = asyncio.run(run())
    rec = {
        "config": 5,
        "note": "judged-scale stand-in for Friendster serving (BASELINE "
                "config 5): real TCP server loop + closed-loop load, "
                "sustained window excludes warmup; precision SLO sampled "
                "server-side every 4th scorable answer",
        "graph": bench.TAG, "n": g.n, "m": g.m, "k": K,
        "epsilon": bench.EPS, "batch": args.batch,
        "clients": args.clients, "indexed": True,
        "warmup_secs": round(warmup_secs, 1),
        **row,
    }
    (ROOT / args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({"wrote": args.out,
                      "sustained_qps": rec["sustained_qps"],
                      "precision_at_k": rec["server_precision_at_k"]}))


if __name__ == "__main__":
    main()
