"""Benchmark driver: batched top-k PPR queries/sec on one GPU.

Refuses to run without a GPU (a CPU number is never reported as a device
number).  Prints the card's name and power limit on stderr and ONE JSON
line on stdout:
  {"metric": "topk_queries_per_sec_per_chip", "value": N,
   "unit": "queries/s", "vs_baseline": N, ...extras}

``vs_baseline`` compares against the single-threaded C++ FORA baseline
(baselines/cpp) run on this machine over the same graph/queries/config —
standing in for the upstream reference binary, whose mount shipped empty
(SURVEY.md header) and whose BASELINE.json has no published numbers.

The benchmark graph is RMAT (power-law, LiveJournal-like skew); the default
scale matches BASELINE.md config 3 (LiveJournal-class: 4.2M nodes, 67M
edges).  Scale via env:
  FORA_BENCH_NLOG2   log2(nodes)          default 22   (4.2M nodes)
  FORA_BENCH_EDGEF   edges per node       default 16
  FORA_BENCH_BATCH   max sources per batch, default 128 (straggler levels
                     re-batch narrower automatically, floor 128)
  FORA_BENCH_QUERIES total queries        default 512
  FORA_BENCH_POOL    queries per resident pool, default 128 — the pool
                     runner keeps [n, pool] f32 push state (p and r) on
                     device: 2.15 GB per buffer at 4.2M nodes and
                     pool 128, a few buffers live at once
  FORA_BENCH_K       top-k                default 50
  FORA_BENCH_EPS     epsilon              default 0.5
  FORA_BENCH_EVAL    queries scored vs exact oracle, default 128
  FORA_BENCH_CPPQ    queries for the C++ baseline, default 32
  FORA_BENCH_CACHE   cache dir            default bench_data
  FORA_BENCH_INDEX   1 = FORA+ indexed walks (default 1)
  FORA_BENCH_BF16    1 = bf16 hot-path gathers (default 0)
  FORA_BENCH_RMAXS   rmax_scale: push/walk balance; >1 = less push,
                     bigger index (default 1)
  FORA_BENCH_DEFER   defer stragglers to one shared cross-pool flush once
                     a pool's pending count drops to this value or below
                     (default 64 = half the width floor; 0 disables) —
                     at judged scale each 128-query pool otherwise drags
                     ~1 straggler through a full-width level-4/5 pass
  FORA_BENCH_CHUNK   log2 edges per gather chunk (peak mem is the
                     [chunk, B] intermediate; default 21)
  FORA_BENCH_HUB     hub-split rows: in-edges from the top-H out-degree
                     sources gather from a compact [H, B] operand
                     (default 131072, a 64 MB f32 operand at B=128;
                     0 disables)
  FORA_BENCH_PAIR    1 = paired push (opt-in; measured slower than a
                     single wide block — TopkRunner push_pair docstring)
  FORA_BENCH_STEPPED -1 auto (= off) / 0 off / 1 on: host-stepped split
                     superstep (StagedForaPrograms stepped_push)
  FORA_BENCH_WALKHALF 1 = column-halved walk (TopkRunner walk_half)
  FORA_BENCH_NARROWR 1 = bf16 residue between push and walk (frees half
                     a state buffer; ~0.2% one-time perturbation/level)
  FORA_BENCH_WEIGHTED 1 = weighted RMAT (log-uniform [0.25,4) weights):
                     alias-table walks, w/W push, weighted oracle;
                     C++ baseline row omitted (unweighted binary)
Everything heavy (graph, ground truth, C++ run) is cached in
FORA_BENCH_CACHE keyed by the scale parameters.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def env_int(k, d):
    return int(os.environ.get(k, d))


NLOG2 = env_int("FORA_BENCH_NLOG2", 22)
EDGEF = env_int("FORA_BENCH_EDGEF", 16)
BATCH = env_int("FORA_BENCH_BATCH", 128)
QUERIES = env_int("FORA_BENCH_QUERIES", 512)
POOL = env_int("FORA_BENCH_POOL", 128)
DSTRIDE = float(os.environ.get("FORA_BENCH_DSTRIDE", "8"))
ACCEPT = float(os.environ.get("FORA_BENCH_ACCEPT", "1"))
K = env_int("FORA_BENCH_K", 50)
EPS = float(os.environ.get("FORA_BENCH_EPS", "0.5"))
EVAL_N = env_int("FORA_BENCH_EVAL", 128)
CPPQ = env_int("FORA_BENCH_CPPQ", 32)
CACHE = Path(os.environ.get("FORA_BENCH_CACHE", "bench_data"))
USE_INDEX = env_int("FORA_BENCH_INDEX", 1)
RMAXS = float(os.environ.get("FORA_BENCH_RMAXS", "1"))
DEFER = env_int("FORA_BENCH_DEFER", 64)
CHUNK = 1 << env_int("FORA_BENCH_CHUNK", 21)
HUB = env_int("FORA_BENCH_HUB", 131072)
PAIR = env_int("FORA_BENCH_PAIR", 0)
WEIGHTED = env_int("FORA_BENCH_WEIGHTED", 0)
SEED = 7

TAG = f"rmat{NLOG2}x{EDGEF}s{SEED}" + ("w" if WEIGHTED else "")


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def get_graph():
    from fora.graph import generators
    from fora.graph.csr import CSRGraph
    f = CACHE / f"{TAG}.npz"
    if f.exists():
        z = np.load(f)
        return CSRGraph(**{k: z[k] for k in CSRGraph._fields
                           if k in z.files})
    log(f"generating RMAT n=2^{NLOG2}, m={EDGEF}*n"
        + (" (weighted)" if WEIGHTED else "") + " ...")
    t0 = time.time()
    g = generators.rmat(NLOG2, (1 << NLOG2) * EDGEF, seed=SEED)
    if WEIGHTED:
        # log-uniform weights in [0.25, 4): the full weighted kernel
        # (alias-table walks, w/W push, weighted oracle) on the same
        # topology as the unweighted headline row
        from fora.graph.csr import from_edges
        rng = np.random.default_rng(SEED + 31)
        src = np.repeat(np.arange(g.n, dtype=np.int64),
                        np.asarray(g.out_deg, np.int64))
        w = np.exp2(rng.uniform(-2, 2, g.m)).astype(np.float32)
        g = from_edges(src, np.asarray(g.out_indices, np.int64), g.n, w=w)
    CACHE.mkdir(parents=True, exist_ok=True)
    np.savez(f, **{k: v for k, v in g._asdict().items() if v is not None})
    log(f"generated in {time.time()-t0:.1f}s")
    return g


def get_sources(g):
    from fora.eval import queries as qio
    return qio.generate_sources(g, QUERIES, seed=SEED + 1)


def get_exact(g, sources):
    """Exact top-K ids for the first EVAL_N sources (cached, keyed by the
    actual eval sources — QUERIES changes which sources land in the eval
    prefix)."""
    from fora.algo import exact
    h = hashlib.sha1(np.asarray(sources[:EVAL_N]).tobytes()).hexdigest()[:10]
    f = CACHE / f"{TAG}.exact{EVAL_N}.{h}.k{K}.npz"
    if f.exists():
        return np.load(f)["ids"]
    log(f"computing exact PPR for {EVAL_N} sources (batched power iter)...")
    t0 = time.time()
    ids = exact.exact_topk_batch(
        g, sources[:EVAL_N], K,
        progress=lambda it, err: log(f"  exact iter {it}: err={err:.2e}"))
    np.savez(f, ids=ids)
    log(f"exact done in {time.time()-t0:.1f}s")
    return ids


def export_graph_bin(g):
    f = CACHE / f"{TAG}.bin"
    if not f.exists():
        with open(f, "wb") as fh:
            np.array([g.n, g.m], dtype=np.int64).tofile(fh)
            np.asarray(g.out_indptr, dtype=np.int64).tofile(fh)
            np.asarray(g.out_indices, dtype=np.int32).tofile(fh)
    return f


def run_cpp_baseline(g, sources):
    """Returns (qps, topk_ids or None). Cached per (TAG, EPS, K, actual
    query sources)."""
    src_sha = hashlib.sha1(
        Path("baselines/cpp/fora_baseline.cpp").read_bytes()).hexdigest()[:8]
    h = hashlib.sha1(np.asarray(sources[:CPPQ]).tobytes()).hexdigest()[:10]
    cache = CACHE / f"{TAG}.cpp.e{EPS}.k{K}.q{CPPQ}.{h}.{src_sha}.json"
    if cache.exists():
        d = json.loads(cache.read_text())
        return d["qps"], np.array(d["ids"]) if d.get("ids") else None
    # make is a no-op when the binary is newer than the source
    r = subprocess.run(["make", "-C", "baselines/cpp"], capture_output=True)
    binp = Path("baselines/cpp/fora_baseline")
    if r.returncode != 0 or not binp.exists():
        log("C++ baseline build failed; vs_baseline will be null")
        return None, None
    gbin = export_graph_bin(g)
    qf = CACHE / f"{TAG}.cppq.txt"
    qf.write_text("".join(f"{int(s)}\n" for s in sources[:CPPQ]))
    out = CACHE / f"{TAG}.cppout.txt"
    log(f"running C++ baseline on {CPPQ} queries ...")
    t0 = time.time()
    r = subprocess.run([str(binp), str(gbin), str(qf), str(EPS), str(K),
                        str(out)], capture_output=True, text=True,
                       timeout=36000)
    if r.returncode != 0:
        log(f"C++ baseline failed: {r.stderr[-400:]}")
        return None, None
    qps = float(r.stdout.split("qps=")[1])
    log(f"C++ baseline: {r.stdout.strip()}  ({time.time()-t0:.1f}s)")
    ids = [list(map(int, line.split()[1:]))
           for line in out.read_text().splitlines()]
    ids = [row + [-1] * (K - len(row)) for row in ids]
    cache.write_text(json.dumps({"qps": qps, "ids": ids}))
    return qps, np.array(ids)


def main():
    import jax
    import jax.numpy as jnp
    from fora.algo import topk as topk_algo
    from fora.config import ForaConfig
    from fora.eval import metrics
    from fora.graph import to_device
    from fora import index as widx
    from fora.utils import profiling
    from fora.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    log(f"platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}; nvidia-smi: "
        f"{profiling.gpu_name_and_power_limit()}")

    g = get_graph()
    sources = get_sources(g)
    log(f"graph n={g.n} m={g.m}")

    cfg = ForaConfig(epsilon=EPS, k=K, rmax_scale=RMAXS)
    rcfg = cfg.resolved(g.n, g.m)
    # RMAT emits ~5% parallel edges; merge them (losslessly, multiplicity
    # weights) so every push superstep gathers ~5% fewer rows
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=HUB,
                   pad_edges=CHUNK)

    index = None
    if USE_INDEX:
        idx_dir = CACHE / (f"{TAG}.idx.e{EPS}" +
                           (f".rs{RMAXS:g}" if RMAXS != 1 else ""))
        if (idx_dir / "meta.json").exists():
            index = widx.load(str(idx_dir), rcfg, graph=g, mmap=True)
        else:
            import shutil
            log("building FORA+ walk index ...")
            t0 = time.time()
            # chunk checkpoints: a preempted/wedged build resumes where it
            # stopped (bit-identical); progress lines make a hung remote
            # runtime diagnosable from the log
            ckpt = str(idx_dir) + ".ckpt"
            index = widx.build_walk_index(
                dg, rcfg, jax.random.key(SEED), checkpoint_dir=ckpt,
                progress=lambda i, n, cached: None if cached else log(
                    f"  walk chunk {i + 1}/{n} ({time.time()-t0:.0f}s)"))
            widx.save(index, rcfg, str(idx_dir), graph=g)
            shutil.rmtree(ckpt, ignore_errors=True)
            log(f"index built in {time.time()-t0:.1f}s "
                f"({index.total_edges} edges)")

    if USE_INDEX and index is not None:
        # indexed queries never touch the walk-side out-CSR; at judged
        # scale those 0.27 GB matter to the [n, 256] walk accumulator's
        # budget (out_indptr stays — it defines n)
        dg = dg._replace(out_indices=jnp.zeros((1,), jnp.int32))

    gdtype = jnp.bfloat16 if env_int("FORA_BENCH_BF16", 0) else None
    stepped = {-1: None, 0: False, 1: True}[env_int("FORA_BENCH_STEPPED", -1)]
    runner = topk_algo.TopkRunner(dg, rcfg, k=K, index=index,
                                  delta_stride=DSTRIDE, accept_slack=ACCEPT,
                                  gather_dtype=gdtype, gather_chunk=CHUNK,
                                  push_pair=bool(PAIR), stepped_push=stepped,
                                  walk_half=bool(
                                      env_int("FORA_BENCH_WALKHALF", 0)),
                                  narrow_r=bool(
                                      env_int("FORA_BENCH_NARROWR", 0)))
    key = jax.random.key(SEED + 2)
    pool_w = min(POOL, QUERIES)
    n_q = (QUERIES // pool_w) * pool_w
    if n_q != QUERIES:
        raise SystemExit(
            f"FORA_BENCH_QUERIES={QUERIES} must be a multiple of the pool "
            f"width {pool_w} (would silently drop {QUERIES - n_q} queries)")
    if EVAL_N > n_q:
        raise SystemExit(
            f"FORA_BENCH_EVAL={EVAL_N} exceeds the {n_q} queries run")
    pools = [sources[i:i + pool_w] for i in range(0, n_q, pool_w)]

    # persisted start level: skip the dead shallow levels on cold starts
    # (they accept nobody at this scale and cost ~67 s of push each run)
    stats_path = CACHE / (f"{TAG}.levelstats.e{EPS}.k{K}" +
                          (f".rs{RMAXS:g}" if RMAXS != 1 else "") + ".json")
    graph_sha = widx.graph_fingerprint(g)
    if runner.load_level_stats(stats_path, graph_sha):
        log(f"start level {runner.auto_start_level} (persisted stats)")

    # warmup: compile all delta levels of the pool path once, at the FULL
    # pool width — the pool-state ops (init scatter, re-take, concat) are
    # shaped by the pool size, so a smaller warmup pool leaves one-time
    # compiles inside the timed run
    log("warmup/compile ...")
    t0 = time.time()
    warm = runner.query_pool(pools[0], jax.random.fold_in(key, 999),
                             batch=BATCH)
    warmup_secs = time.time() - t0
    log(f"warmup done in {warmup_secs:.1f}s (levels: {warm.levels_used}, "
        f"next start level: {runner.auto_start_level})")
    runner.save_level_stats(stats_path, graph_sha)
    for st in getattr(runner, "last_level_stats", []):
        log(f"  warmup level {st['level']}: pending={st['pending']} "
            f"accepted={st['accepted']} {st['secs']}s")

    log(f"timing {n_q} queries (level-pipelined, batch {BATCH}, "
        f"{len(pools)} pool(s) of {pool_w}) ...")
    t0 = time.time()
    results = {}
    levels_used, n_accepted = 0, 0
    defer = DEFER if len(pools) > 1 else 0
    for pi, pool in enumerate(pools):
        res = runner.query_pool(pool, jax.random.fold_in(key, 1 + pi),
                                batch=BATCH, defer_below=defer)
        for i, s in enumerate(pool):
            if res.deferred is None or not res.deferred[i]:
                results[int(s)] = res.node_ids[i]
        levels_used = max(levels_used, res.levels_used)
        n_accepted += int(res.accepted.sum())
        for st in getattr(runner, "last_level_stats", []):
            log(f"  pool {pi} level {st['level']}: "
                f"pending={st['pending']} batches={st['batches']} "
                f"{st['secs']}s")
    # all pools' deferred stragglers refine together in ONE deep batch
    dsrcs, dres = runner.flush_deferred(jax.random.fold_in(key, 777),
                                        batch=BATCH)
    if dres is not None:
        for i, s in enumerate(dsrcs):
            results[int(s)] = dres.node_ids[i]
        levels_used = max(levels_used, dres.levels_used)
        n_accepted += int(dres.accepted.sum())
        for st in getattr(runner, "last_level_stats", []):
            log(f"  flush({len(dsrcs)}) level {st['level']}: "
                f"pending={st['pending']} batches={st['batches']} "
                f"{st['secs']}s")
    elapsed = time.time() - t0
    qps = n_q / elapsed
    log(f"levels used (max): {levels_used}; "
        f"accepted: {n_accepted}/{n_q}")
    log(f"ours: {n_q} queries in {elapsed:.2f}s -> {qps:.1f} q/s")

    # roofline: one dense push superstep (gather + segment_sum over every
    # in-edge at batch BATCH) vs the bytes-moved model and datasheet HBM BW
    from fora.ops import push as push_ops
    m_eff = int(dg.m_in)

    # init inside the jit and return only r: one [n, B] output, no
    # un-donated state pair alongside the resident runner/index
    def one_superstep(dgx, srcs):
        st0 = push_ops.init_state(dgx.n, srcs)
        return push_ops.forward_push_from(
            dgx, st0, rmax=0.0, alpha=rcfg.alpha, max_iters=1,
            max_chunk=CHUNK).r

    step = jax.jit(one_superstep)
    srcs = jnp.asarray(sources[:BATCH], jnp.int32)
    step_secs = profiling.measure(lambda: step(dg, srcs), reps=3, warmup=1)
    roof = profiling.SpmvRoofline(edges=m_eff, batch=BATCH, nodes=g.n)
    roof_eff = roof.efficiency(step_secs)
    elem_rate = m_eff / step_secs
    log(f"push superstep: {step_secs*1e3:.1f}ms for {m_eff} edges @ B={BATCH}"
        f" -> {roof.bytes_moved/step_secs/1e9:.1f} GB/s eff"
        f" = {roof_eff:.3f} of HBM speed-of-light; "
        f"{elem_rate/1e6:.1f} M rows/s")

    exact_ids = get_exact(g, sources)
    prec = metrics.batch_precision_at_k(
        np.stack([results[int(s)] for s in sources[:EVAL_N]]), exact_ids)
    log(f"precision@{K} vs exact: {prec:.4f}")

    if WEIGHTED:
        # the C++ baseline implements the unweighted reference kernel;
        # the weighted row is scored against the weighted exact oracle
        # only (vs_baseline null)
        cpp_qps, cpp_ids = None, None
    else:
        cpp_qps, cpp_ids = run_cpp_baseline(g, sources)
    cpp_prec = None
    if cpp_ids is not None:
        ncmp = min(len(cpp_ids), EVAL_N)
        cpp_prec = metrics.batch_precision_at_k(cpp_ids[:ncmp],
                                                exact_ids[:ncmp])
        log(f"C++ baseline: {cpp_qps:.2f} q/s, precision {cpp_prec:.4f}")

    out = {
        "metric": "topk_queries_per_sec_per_chip",
        "value": round(qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(qps / cpp_qps, 2) if cpp_qps else None,
        "precision_at_k": round(prec, 4),
        "baseline_qps": cpp_qps,
        "baseline_precision_at_k": cpp_prec,
        "k": K, "epsilon": EPS, "graph": TAG, "n": g.n, "m": g.m,
        "batch": BATCH, "queries": n_q, "indexed": bool(USE_INDEX),
        "push_pair": bool(PAIR), "pool": pool_w,
        "bf16_gather": bool(env_int("FORA_BENCH_BF16", 0)),
        "weighted": bool(WEIGHTED),
        "eval_queries": EVAL_N, "baseline_queries": CPPQ,
        # the baseline implements BOTH acceptance paths (threshold +
        # Bernstein bound separation), same as the JAX engine — the
        # comparison is stopping-rule symmetric
        "baseline_bound_accept": True,
        "warmup_secs": round(warmup_secs, 1),
        "push_superstep_secs": round(step_secs, 4),
        "push_roofline_efficiency": round(roof_eff, 4),
        "push_effective_gbps": round(roof.bytes_moved / step_secs / 1e9, 1),
        "push_mrows_per_sec": round(elem_rate / 1e6, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
