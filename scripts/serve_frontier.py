"""Serving latency-throughput frontier at judged scale.

Round-4's SERVE artifact measured one closed-loop config (256 clients,
batch 128) whose ~30 s p50 was queueing delay by construction.  This
script measures the actual frontier (round-4 verdict directive 2):

  * OPEN-LOOP arrivals: a Poisson client at several offered rates x
    several (batch, max_wait) server configs, each over a fixed window —
    per config: answered qps, p50/p95/p99 latency, shed rate, rolling
    precision@k SLO vs the exact oracle.
  * single-query latency: the reference's native mode — one isolated
    source through the refinement pool, no batch amortization
    (closed-loop, N reps, p50/p95) at the pool's narrowest width.
  * headline: max sustained qps among configs with p95 <= SLA_MS and
    zero shed.

Reuses bench.py's cached graph/index/exact artifacts (FORA_BENCH_* env).
Writes one JSON document to --out (default serve_frontier.json).

Run (judged scale, on the chip):
  python scripts/serve_frontier.py --rates 2,5,8,11 --batches 32,64,128 \
      --window 120 --out serve_frontier.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_runner():
    import bench
    import jax
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from fora import index as widx
    from fora.algo import topk as topk_algo
    from fora.config import ForaConfig
    from fora.graph import to_device

    g = bench.get_graph()
    sources = bench.get_sources(g)
    exact_ids = bench.get_exact(g, sources)
    cfg = ForaConfig(epsilon=bench.EPS, k=bench.K, rmax_scale=bench.RMAXS)
    rcfg = cfg.resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=bench.HUB,
                   pad_edges=bench.CHUNK)
    idx_dir = bench.CACHE / (f"{bench.TAG}.idx.e{bench.EPS}" +
                             (f".rs{bench.RMAXS:g}"
                              if bench.RMAXS != 1 else ""))
    if not (idx_dir / "meta.json").exists():
        raise SystemExit(f"no index at {idx_dir}; run bench.py first")
    index = widx.load(str(idx_dir), rcfg, graph=g, mmap=True)
    gdtype = jnp.bfloat16 if bench.env_int("FORA_BENCH_BF16", 0) else None
    if index is not None:
        # indexed serving never touches the walk-side out-CSR (bench.py
        # does the same at judged scale)
        dg = dg._replace(out_indices=jnp.zeros((1,), jnp.int32))
    stepped = {-1: None, 0: False,
               1: True}[bench.env_int("FORA_BENCH_STEPPED", -1)]
    runner = topk_algo.TopkRunner(
        dg, rcfg, k=bench.K, index=index, delta_stride=bench.DSTRIDE,
        accept_slack=bench.ACCEPT, gather_dtype=gdtype,
        gather_chunk=bench.CHUNK, push_pair=bool(bench.PAIR),
        stepped_push=stepped)
    stats_path = bench.CACHE / (f"{bench.TAG}.levelstats.e{bench.EPS}"
                                f".k{bench.K}" +
                                (f".rs{bench.RMAXS:g}"
                                 if bench.RMAXS != 1 else "") + ".json")
    graph_sha = widx.graph_fingerprint(g)
    runner.load_level_stats(stats_path, graph_sha)
    slo_exact = {int(s): exact_ids[i] for i, s in
                 enumerate(sources[:len(exact_ids)])}
    return runner, np.asarray(sources), slo_exact, jax


def warm(runner, sources, batch, jax):
    t0 = time.time()
    runner.query_pool(sources[:batch], jax.random.key(999), batch=batch)
    return time.time() - t0


async def drive_open_loop(server_port, sources, rate_qps, window_s,
                          n_conns=256, seed=0):
    """Poisson arrivals at ``rate_qps`` over ``window_s`` seconds, cycled
    over ``sources``; returns per-request (latency_s or None-if-shed).

    One in-flight request per connection (the lock spans write+read for
    response matching), so ``n_conns`` bounds client concurrency — it
    must exceed rate x worst-case latency or the CLIENT becomes the
    bottleneck (the first frontier attempt measured its own 8-connection
    cap: 0.36 q/s served at 5 offered)."""
    rng = np.random.default_rng(seed)
    results = []
    conns = []
    for _ in range(n_conns):
        conns.append(await asyncio.open_connection("127.0.0.1", server_port))
    locks = [asyncio.Lock() for _ in conns]

    async def one(i, t_sched):
        ci = i % len(conns)
        r, w = conns[ci]
        src = int(sources[i % len(sources)])
        t0 = time.monotonic()
        async with locks[ci]:
            w.write((json.dumps({"id": i, "source": src}) + "\n").encode())
            await w.drain()
            line = await r.readline()
        lat = time.monotonic() - t0
        rsp = json.loads(line)
        results.append((t_sched, None if "error" in rsp else lat,
                        rsp.get("error")))

    tasks = []
    t = 0.0
    i = 0
    t_start = time.monotonic()
    while t < window_s:
        t += float(rng.exponential(1.0 / rate_qps))
        now = time.monotonic() - t_start
        if t > now:
            await asyncio.sleep(t - now)
        tasks.append(asyncio.create_task(one(i, t)))
        i += 1
    await asyncio.gather(*tasks)
    for r, w in conns:
        w.close()
    return results


def pct(lat, q):
    if not lat:
        return None
    lat = sorted(lat)
    return round(lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3, 1)


async def run_config(runner, sources, slo_exact, jax, batch, max_wait_ms,
                     rate, window_s, k):
    from fora.serve import ForaServer

    def query_fn(srcs, seed):
        res = runner.query_pool(np.asarray(srcs), jax.random.key(seed),
                                batch=batch)
        return res.node_ids, res.values

    srv = ForaServer(query_fn, batch=batch, k=k, max_wait_ms=max_wait_ms,
                     inflight=1, slo_exact=slo_exact, slo_sample_every=4,
                     admission_timeout_ms=30000.0,
                     max_pending=4 * batch)
    port = await srv.start(port=0)
    t0 = time.time()
    res = await drive_open_loop(port, sources, rate, window_s)
    elapsed = time.time() - t0
    await srv.stop()
    lat = [x[1] for x in res if x[1] is not None]
    shed = sum(1 for x in res if x[1] is None)
    scores = list(srv.slo_scores)
    return {
        "batch": batch, "max_wait_ms": max_wait_ms,
        "offered_qps": rate, "window_s": round(elapsed, 1),
        "offered": len(res), "answered": len(lat), "shed": shed,
        "qps": round(len(lat) / elapsed, 2),
        "p50_ms": pct(lat, 0.5), "p95_ms": pct(lat, 0.95),
        "p99_ms": pct(lat, 0.99),
        "precision_at_k": (round(float(np.mean(scores)), 4)
                           if scores else None),
        "slo_samples": len(scores),
    }


def single_query_latency(runner, sources, jax, reps, width):
    lats = []
    for i in range(reps):
        s = np.asarray([sources[i % len(sources)]])
        t0 = time.time()
        runner.query_pool(s, jax.random.key(10_000 + i), batch=width)
        lats.append(time.time() - t0)
    return {"reps": reps, "pool_width": width,
            "p50_ms": pct(lats, 0.5), "p95_ms": pct(lats, 0.95),
            "mean_ms": round(float(np.mean(lats)) * 1e3, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", default="2,5,8,11")
    ap.add_argument("--batches", default="32,64,128")
    ap.add_argument("--max-wait-ms", type=float, default=100.0)
    ap.add_argument("--window", type=float, default=120.0)
    ap.add_argument("--single-reps", type=int, default=8)
    ap.add_argument("--single-width", type=int, default=32)
    ap.add_argument("--sla-ms", type=float, default=20000.0)
    ap.add_argument("--out", default="serve_frontier.json")
    args = ap.parse_args()

    runner, sources, slo_exact, jax = build_runner()
    import bench
    rates = [float(x) for x in args.rates.split(",")]
    batches = [int(x) for x in args.batches.split(",")]

    configs = []
    warmed = set()
    for b in sorted(batches):
        ws = warm(runner, sources, b, jax)
        warmed.add(b)
        print(f"[frontier] warm batch={b}: {ws:.1f}s", flush=True)
        for rate in rates:
            row = asyncio.run(run_config(
                runner, sources, slo_exact, jax, b, args.max_wait_ms,
                rate, args.window, bench.K))
            print(f"[frontier] {row}", flush=True)
            configs.append(row)
            # past saturation (answered < 70% of offered): higher rates
            # only grow the queue — skip them for this batch
            if row["qps"] < 0.7 * rate:
                print(f"[frontier] batch={b} saturated at {rate} q/s",
                      flush=True)
                break

    single = single_query_latency(runner, sources, jax, args.single_reps,
                                  args.single_width)
    print(f"[frontier] single-query: {single}", flush=True)

    ok = [c for c in configs
          if c["shed"] == 0 and c["p95_ms"] is not None
          and c["p95_ms"] <= args.sla_ms
          and c["qps"] >= 0.9 * c["offered_qps"]]
    headline = max(ok, key=lambda c: c["qps"]) if ok else None
    out = {
        "scale": {"graph": bench.TAG, "k": bench.K, "eps": bench.EPS,
                  "pair": bool(bench.PAIR), "batch_knobs": batches},
        "sla_ms": args.sla_ms,
        "configs": configs,
        "single_query": single,
        "headline_max_qps_under_sla": headline,
    }
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"headline": headline, "single": single}), flush=True)


if __name__ == "__main__":
    main()
