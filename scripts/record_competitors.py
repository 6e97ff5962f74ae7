"""Record competitor rows at bench scale (one JSON document).

The reference's experimental section is comparative [R: SURVEY.md Sec. 2.1
competitors]; this records one bench pass per competitor on the SAME
graph / queries / oracle as the FORA bench (RMAT 524K/8.4M, eps=0.5,
k=50, 32 eval sources):

  montecarlo  omega source-rooted walks (capped; cap noted — the full
              1/n-guarantee omega is ~64M walks/query at this scale,
              which is the paper's point about MC)
  fwdpush     push-only at rmax/omega (the same total-cost budget the
              reference's fwdpush competitor uses), segmented supersteps
  hubppr      hub-indexed Monte Carlo (forward hub pool), same walk cap
  bippr       its native PAIRWISE protocol: (s, t) estimates with t from
              the exact top-50 of s (mass > delta_topk), mean relative
              error + pairs/sec — BiPPR answers pair queries, not top-k

Usage: python scripts/record_competitors.py [--out competitors.json]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TAG = "rmat19x16s7"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="competitors.json")
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--walk-batch", type=int, default=8)
    ap.add_argument("--max-walks", type=int, default=1 << 22)
    ap.add_argument("--only", default=None,
                    help="comma list of algos to run (merges rows into an "
                         "existing --out artifact)")
    ap.add_argument("--hub-walk-batch", type=int, default=4,
                    help="hubppr device batch: its per-hop hub-pool "
                         "gathers make a walk program ~2x MC's")
    ap.add_argument("--hub-max-walks", type=int, default=1 << 21)
    args = ap.parse_args()

    import bench
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from fora.algo import exact
    from fora.config import ForaConfig
    from fora.eval import metrics, queries as qio
    from fora.graph import to_device
    from fora.graph.csr import CSRGraph
    from fora.ops import push as push_ops, topk as topk_ops
    from fora.utils import profiling

    z = np.load(ROOT / "bench_data" / f"{TAG}.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    rcfg = ForaConfig(epsilon=args.eps, k=args.k).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True)
    # the bench's own sources/oracle (cached): QUERIES=512 prefix
    sources = qio.generate_sources(g, 512, seed=8)[: args.queries]
    import hashlib
    h = hashlib.sha1(np.asarray(sources).tobytes()).hexdigest()[:10]
    exact_f = ROOT / "bench_data" / f"{TAG}.exact32.{h}.k{args.k}.npz"
    if exact_f.exists():
        exact_ids = np.load(exact_f)["ids"]
    else:
        print("[comp] computing exact oracle ...", file=sys.stderr,
              flush=True)
        exact_ids = exact.exact_topk_batch(g, sources, args.k)
        np.savez(exact_f, ids=exact_ids)
    rows = []

    def eval_topk(name, run_batch, B, extra=None):
        """run_batch(sources_i32[B], key) -> [n, B] estimate (completed by
        the np.asarray of the top-k below)."""
        key = jax.random.key(17)
        ids = np.zeros((args.queries, args.k), np.int64)
        # warmup on the first batch (compile excluded from timing)
        _ = run_batch(jnp.asarray(sources[:B], jnp.int32), key)
        _ = np.asarray(_[1] if isinstance(_, tuple) else _)
        t0 = time.time()
        for lo in range(0, args.queries, B):
            chunk = sources[lo: lo + B]
            pad = B - len(chunk)
            src = jnp.asarray(
                np.concatenate([chunk, np.repeat(chunk[-1:], pad)]),
                jnp.int32)
            ppr = run_batch(src, jax.random.fold_in(key, lo))
            vals, nids = topk_ops.topk_nodes(ppr, args.k)
            nids = np.asarray(nids)          # wait for the device
            ids[lo: lo + len(chunk)] = nids[: len(chunk)]
        secs = time.time() - t0
        prec = float(metrics.batch_precision_at_k(ids, exact_ids))
        row = {"algo": name, "queries": args.queries,
               "qps": round(args.queries / secs, 3),
               "secs": round(secs, 1),
               "precision_at_k": round(prec, 4), **(extra or {})}
        rows.append(row)
        print(f"[comp] {name}: {row['qps']} q/s, precision {prec:.4f}",
              file=sys.stderr, flush=True)

    only = set(args.only.split(",")) if args.only else None

    def want(name):
        return only is None or name in only

    # --- montecarlo ---
    num_walks = min(int(rcfg.omega_unit) + 1, args.max_walks)
    if want("montecarlo"):
        from fora.algo import montecarlo as mc_algo
        mc_fn = mc_algo.make_montecarlo_fn(dg, rcfg,
                                           max_walks=args.max_walks)
        eval_topk("montecarlo", mc_fn, args.walk_batch,
                  extra={"walks_per_query": num_walks,
                         "walks_capped":
                             num_walks < int(rcfg.omega_unit) + 1,
                         "guarantee_omega": int(rcfg.omega_unit) + 1})

    # --- fwdpush (segmented supersteps; push-only at rmax/omega) ---
    rmax_pp = rcfg.rmax / max(rcfg.omega_unit, 1.0)
    seg_iters, max_total = 32, 512

    def fwdpush_run(src, key):
        del key
        st = push_ops.init_state(dg.n, src)
        for _ in range(max_total // seg_iters):
            st = push_ops.forward_push_from(
                dg, st, rmax=rmax_pp, alpha=rcfg.alpha,
                max_iters=seg_iters, max_chunk=bench.CHUNK)
            st = push_ops.PushState(st.p, st.r,
                                    jnp.zeros((), jnp.int32))
            deg = np.asarray(dg.out_deg, np.float32)
            # host check every segment (np.asarray waits for the device)
            if not bool(np.asarray(
                    (st.r > rmax_pp * jnp.asarray(deg)[:, None]).any())):
                break
        return st.p

    if want("fwdpush"):
        eval_topk("fwdpush", fwdpush_run, 32,
                  extra={"rmax": rmax_pp, "max_supersteps": max_total})

    # --- hubppr ---
    if want("hubppr"):
        from fora.algo import hubppr as hub_algo
        hub_walks = min(int(rcfg.omega_unit) + 1, args.hub_max_walks)
        t0 = time.time()
        hub_fn = hub_algo.make_hubppr_fn(dg, rcfg, jax.random.key(5),
                                         num_hubs=4096,
                                         max_walks=args.hub_max_walks)
        hub_build = time.time() - t0
        eval_topk("hubppr", hub_fn, args.hub_walk_batch,
                  extra={"num_hubs": 4096,
                         "hub_index_build_secs": round(hub_build, 1),
                         "walks_per_query": hub_walks})

    # --- bippr (pairwise protocol) ---
    from fora.algo import bippr as bippr_algo
    # pairs: (s, t) with t the exact rank-1/10/25 node of s — mass known
    # to clear the top-k threshold, BiPPR's intended regime
    pair_rank = [0, 9, 24]
    targets = np.unique(exact_ids[:, pair_rank].reshape(-1))
    if not want("bippr"):
        targets = targets[:0]
    tgt = jnp.asarray(targets, jnp.int32)
    t0 = time.time()
    bfn = bippr_algo.make_bippr_fn(dg, rcfg, tgt) if want("bippr") else None
    if want("bippr"):
        est = np.asarray(bfn(jnp.asarray(sources, jnp.int32),
                             jax.random.key(23)))      # [S, T] warm + wait
        t0 = time.time()
        est = np.asarray(bfn(jnp.asarray(sources, jnp.int32),
                             jax.random.fold_in(jax.random.key(23), 1)))
        bippr_secs = time.time() - t0
        tpos = {int(t): i for i, t in enumerate(targets)}
        rels = []
        print("[comp] bippr exact pair values ...", file=sys.stderr,
              flush=True)
        X = exact.exact_ppr_power_batch(g, sources[:8], tol=1e-10)
        for si in range(8):
            for r in pair_rank:
                t = int(exact_ids[si, r])
                true = X[t, si]
                if true > 0:
                    rels.append(abs(est[si, tpos[t]] - true) / true)
        row = {"algo": "bippr", "protocol": "pairwise",
               "sources": args.queries, "targets": len(targets),
               "pairs_per_sec": round(
                   args.queries * len(targets) / bippr_secs, 1),
               "secs": round(bippr_secs, 1),
               "mean_rel_err_checked_pairs": round(float(np.mean(rels)), 4),
               "checked_pairs": len(rels),
               "rmax_b": float(bfn.rmax_b), "walks": int(bfn.num_walks)}
        rows.append(row)
        print(f"[comp] bippr: {row['pairs_per_sec']} pairs/s, rel err "
              f"{row['mean_rel_err_checked_pairs']}", file=sys.stderr,
              flush=True)

    # merge with an existing artifact when running a subset (--only)
    outp = ROOT / args.out
    if only is not None and outp.exists():
        old = json.loads(outp.read_text())
        have = {r["algo"] for r in rows}
        rows = [r for r in old.get("rows", [])
                if r["algo"] not in have] + rows
    rec = {"graph": TAG, "n": g.n, "m": g.m, "epsilon": args.eps,
           "k": args.k, "eval_queries": args.queries,
           "note": "same graph/queries/oracle as the FORA bench rows "
                   "; montecarlo+hubppr walk "
                   "counts capped at 2^22/query (the 1/n-guarantee "
                   "omega is ~64M at this scale — the paper's MC "
                   "impracticality point), precision reported as "
                   "achieved",
           "rows": rows}
    (ROOT / args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({"wrote": args.out,
                      "rows": [(r["algo"], r.get("qps"),
                                r.get("precision_at_k")) for r in rows]}))


if __name__ == "__main__":
    main()
