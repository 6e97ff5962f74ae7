"""Record the BASELINE config-1 numbers (one JSON document).

Config 1 (BASELINE.md): "DBLP single-source top-50, push+walks, eps=0.5
(CPU-runnable) — correctness slice: precision@50, query time".  Real DBLP
(317K nodes, ~1.05M edges) is unreachable (network blackholed; SURVEY.md
header), so the accepted stand-in is RMAT at matched scale: n=2^18=262K,
m=4n=1.05M.

Runs the NON-indexed FORA path (push + on-the-fly lockstep walks — the
config explicitly exercises the two-phase algorithm, not FORA+) one
batch of sources at a time on the CPU backend, scores precision@50
against the exact oracle, and also records the C++ baseline on the same
graph/queries for context.

Usage: python scripts/record_config1.py [--out config1.json]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="config1.json")
    ap.add_argument("--nlog2", type=int, default=18)
    ap.add_argument("--edgef", type=int, default=4)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--eps", type=float, default=0.5)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")   # config 1 is CPU-runnable
    import jax.numpy as jnp
    from fora.algo import exact, topk as topk_algo
    from fora.config import ForaConfig
    from fora.eval import metrics, queries as qio
    from fora.graph import generators, to_device

    g = generators.rmat(args.nlog2, (1 << args.nlog2) * args.edgef, seed=7)
    rcfg = ForaConfig(epsilon=args.eps, k=args.k).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True)
    sources = qio.generate_sources(g, args.queries, seed=8)

    runner = topk_algo.TopkRunner(dg, rcfg, k=args.k, index=None,
                                  delta_stride=4.0)
    key = jax.random.key(3)
    # single-source protocol: one source per query call (the reference's
    # config-1 shape), timed per query after a one-query warmup
    _ = runner.query(jnp.asarray(sources[:1], jnp.int32), key)
    ids = np.zeros((args.queries, args.k), np.int64)
    per_q = []
    for i, s in enumerate(sources):
        t0 = time.perf_counter()
        res = runner.query(jnp.asarray([s], jnp.int32),
                           jax.random.fold_in(key, i))
        per_q.append(time.perf_counter() - t0)
        ids[i] = res.node_ids[0]

    print(f"[config1] {args.queries} queries, avg "
          f"{np.mean(per_q)*1e3:.1f} ms/query", file=sys.stderr, flush=True)
    t0 = time.time()
    exact_ids = exact.exact_topk_batch(g, sources, args.k)
    print(f"[config1] exact oracle in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)
    prec = float(metrics.batch_precision_at_k(ids, exact_ids))

    # C++ baseline on the same graph/queries (context row)
    cpp = None
    try:
        subprocess.run(["make", "-C", str(ROOT / "baselines" / "cpp")],
                       capture_output=True, check=True)
        tmp = ROOT / "bench_data" / "config1"
        tmp.mkdir(parents=True, exist_ok=True)
        gbin = tmp / "graph.bin"
        if not gbin.exists():
            with open(gbin, "wb") as fh:
                np.array([g.n, g.m], dtype=np.int64).tofile(fh)
                np.asarray(g.out_indptr, dtype=np.int64).tofile(fh)
                np.asarray(g.out_indices, dtype=np.int32).tofile(fh)
        qf = tmp / "q.txt"
        qf.write_text("".join(f"{int(s)}\n" for s in sources))
        out = tmp / "out.txt"
        r = subprocess.run(
            [str(ROOT / "baselines" / "cpp" / "fora_baseline"), str(gbin),
             str(qf), str(args.eps), str(args.k), str(out)],
            capture_output=True, text=True, timeout=7200, check=True)
        cpp_qps = float(r.stdout.split("qps=")[1])
        cpp_ids = [list(map(int, l.split()[1:]))
                   for l in out.read_text().splitlines()]
        cpp_ids = np.array([row + [-1] * (args.k - len(row))
                            for row in cpp_ids])
        cpp = {"avg_query_ms": round(1e3 / cpp_qps, 1),
               "precision_at_k": float(metrics.batch_precision_at_k(
                   cpp_ids, exact_ids))}
        print(f"[config1] C++ baseline {cpp}", file=sys.stderr, flush=True)
    except Exception as e:   # baseline is context, not the artifact's core
        print(f"[config1] C++ baseline skipped: {e}", file=sys.stderr)

    rec = {
        "config": 1,
        "note": "DBLP-scale stand-in (RMAT, matched n/m; real datasets "
                "unreachable per SURVEY.md header); single-source "
                "non-indexed FORA (push + lockstep walks) on the CPU "
                "backend — the correctness slice of BASELINE.md",
        "graph": f"rmat{args.nlog2}x{args.edgef}s7",
        "n": g.n, "m": g.m, "epsilon": args.eps, "k": args.k,
        "queries": args.queries,
        "avg_query_ms": round(float(np.mean(per_q)) * 1e3, 1),
        "p95_query_ms": round(float(np.percentile(per_q, 95)) * 1e3, 1),
        "precision_at_k": round(prec, 4),
        "cpp_baseline": cpp,
        "device": "cpu",
    }
    (ROOT / args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({"wrote": args.out, "avg_query_ms": rec["avg_query_ms"],
                      "precision_at_k": rec["precision_at_k"]}))


if __name__ == "__main__":
    main()
