"""CLI driver — the engine's user-facing surface.

Mirrors the reference's action/flag interface [R: fora.cpp main —
reconstruction, SURVEY.md Sec. 1 L6]:

  python -m fora.cli <action> --prefix data --dataset dblp [flags]

Actions:
  query              single-source SSPPR over a query set
  topk               top-k queries with iterative refinement
  batch-topk         batched top-k over the whole query set (data-parallel,
                     replacing the reference's sequential loop)
  build              build + serialize the FORA+ walk index
  generate-ss-query  sample a query source set to <dataset>.query
  gen-exact-topk     ground-truth exact PPR top-k per query source

Algorithms (--algo): fora (default), montecarlo, fwdpush, hubppr
(hub-indexed Monte Carlo; --num-hubs controls the index).

Weighted graphs: a third column in graph.txt is auto-detected as positive
per-edge weights; every algorithm then runs the weighted kernel (walks step
v -> u w.p. w(v,u)/W(v) via alias tables; push propagates w/W fractions;
gen-exact-topk solves the weighted chain).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .config import ForaConfig
from .eval import metrics, queries as query_io
from .graph import io as graph_io
from .graph import to_device
from .utils.compile_cache import enable_compile_cache
from .utils.logging import RunLog, info
from .utils.timers import Timers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fora",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("action", choices=["query", "topk", "batch-topk", "build",
                                      "generate-ss-query", "gen-exact-topk",
                                      "serve", "sweep", "shard-graph"])
    p.add_argument("--shard-counts", default=None,
                   help="shard-graph: comma list of graph-shard counts to "
                        "persist (default: --graph-shards); sharded "
                        "batch-topk/serve then mmap only own rows' files "
                        "instead of loading + partitioning the full graph")
    p.add_argument("--port", type=int, default=8471, help="serve action port")
    p.add_argument("--sweep-eps", default="0.1,0.2,0.35,0.5",
                   help="epsilon grid for the sweep action")
    p.add_argument("--prefix", default="data", help="dataset root dir")
    p.add_argument("--dataset", required=True)
    p.add_argument("--algo", default="fora",
                   choices=["fora", "montecarlo", "fwdpush", "hubppr",
                            "bippr"])
    p.add_argument("--num-hubs", type=int, default=256,
                   help="hubppr: hub count for the forward hub index")
    p.add_argument("--target-file", default=None,
                   help="bippr: file of target node ids (one per line); "
                        "default: all nodes if n<=4096, else a seeded "
                        "sample of --bippr-targets")
    p.add_argument("--bippr-targets", type=int, default=2048,
                   help="bippr: sampled target-set size on large graphs")
    p.add_argument("--epsilon", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--delta", type=float, default=None, help="default 1/n")
    p.add_argument("--pfail", type=float, default=None, help="default 1/n")
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--query-size", type=int, default=20,
                   help="number of sources for generate-ss-query")
    p.add_argument("--batch", type=int, default=16,
                   help="sources per device batch")
    p.add_argument("--with-idx", action="store_true",
                   help="serve walks from the prebuilt FORA+ index")
    p.add_argument("--index-dir", default=None,
                   help="default <prefix>/index/<dataset>")
    p.add_argument("--index-shards", default=None,
                   help="build: also persist row-sharded store(s) for "
                        "these graph-shard counts (comma list, e.g. 4,8); "
                        "sharded batch-topk/serve then load only own rows")
    p.add_argument("--delta-stride", type=float, default=4.0,
                   help="top-k refinement delta divisor per level")
    p.add_argument("--accept-slack", type=float, default=1.0,
                   help=">1 tightens the top-k stopping rule")
    p.add_argument("--pool", type=int, default=0,
                   help="batch-topk: split the query set into resident "
                        "pools of this many queries (0 = one pool).  The "
                        "pool's [n, pool] push state must fit device "
                        "memory: 2.15 GB per f32 buffer at 4.2M nodes and "
                        "pool 128")
    p.add_argument("--defer", type=int, default=64,
                   help="batch-topk with --pool: stash a pool's stragglers "
                        "once <= this many remain and refine all pools' "
                        "stragglers together in one final batch "
                        "(0 disables)")
    p.add_argument("--start-level", type=int, default=None,
                   help="pin batch-topk's first delta level (default: "
                        "learned/persisted first-accepting level)")
    p.add_argument("--hub-rows", type=int, default=0,
                   help="split in-edges from the top-H out-degree sources "
                        "into a compact-operand gather (0 disables)")
    p.add_argument("--bf16-gather", action="store_true",
                   help="bf16 hot-path gathers (half the gathered bytes, "
                        "~0.4%% per-contribution error)")
    p.add_argument("--gather-chunk", type=int, default=21,
                   help="log2 edges per gather chunk (peak memory is the "
                        "[chunk, B] intermediate; 19 for judged-scale "
                        "wide batches)")
    p.add_argument("--push-pair", action="store_true",
                   help="paired-block push (opt-in alternative to a "
                        "single wide block — see TopkRunner)")
    p.add_argument("--stepped-push", choices=["auto", "on", "off"],
                   default="auto",
                   help="host-stepped split superstep (auto and off: one "
                        "while_loop program per push)")
    p.add_argument("--narrow-r", action="store_true",
                   help="bf16 residue between push and walk phases "
                        "(frees half a state buffer; ~0.2%% one-time "
                        "perturbation per delta level)")
    p.add_argument("--graph-shards", type=int, default=1,
                   help="row-shard the graph (+ index) over this many "
                        "devices on the mesh 'graph' axis; batch-topk and "
                        "serve then run the sharded refinement pool "
                        "(requires --with-idx)")
    p.add_argument("--query-shards", type=int, default=None,
                   help="devices on the mesh 'query' axis (default: "
                        "n_devices // graph_shards)")
    p.add_argument("--exchange", default=None,
                   choices=["dense", "compact", "routed", "hier"],
                   help="frontier exchange mode for the sharded push "
                        "(default dense; hier needs --chips-per-host)")
    p.add_argument("--chips-per-host", type=int, default=None,
                   help="exchange=hier: devices per host for the two-stage "
                        "(inter-host, intra-host) exchange")
    p.add_argument("--output", default=None,
                   help="write per-query results (JSONL: source, ids, vals)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runlog", default=None, help="JSONL metrics path")
    p.add_argument("--eval-exact", action="store_true",
                   help="report precision@k vs the exact oracle (slow)")
    return p


def _query_file(args) -> Path:
    return Path(args.prefix) / args.dataset / f"{args.dataset}.query"


def _index_dir(args) -> str:
    return args.index_dir or str(Path(args.prefix) / "index" / args.dataset)


def _load(args):
    t0 = time.perf_counter()
    g = graph_io.load_dataset(args.prefix, args.dataset)
    info("graph loaded", n=g.n, m=g.m, secs=f"{time.perf_counter()-t0:.2f}")
    return g


def _make_topk_runner(args, g, dg, rcfg, idx):
    """TopkRunner (single-chip) or ShardedTopkRunner (--graph-shards > 1,
    rows + index sharded over the mesh 'graph' axis) per the CLI flags."""
    import jax.numpy as jnp
    from .algo import topk as topk_algo
    if args.graph_shards <= 1:
        return topk_algo.TopkRunner(
            dg, rcfg, k=args.k, index=idx,
            delta_stride=args.delta_stride,
            accept_slack=args.accept_slack,
            gather_dtype=jnp.bfloat16 if args.bf16_gather else None,
            gather_chunk=1 << args.gather_chunk,
            push_pair=args.push_pair,
            stepped_push={"auto": None, "on": True,
                          "off": False}[args.stepped_push],
            narrow_r=args.narrow_r)
    from .parallel import ShardedTopkRunner, make_mesh
    if idx is None:
        raise ValueError("--graph-shards > 1 requires --with-idx (the "
                         "sharded refinement pool runs FORA+ indexed walks)")
    mesh = make_mesh(args.graph_shards, args.query_shards)
    nq = mesh.shape["query"]
    if args.batch % nq:
        raise ValueError(f"--batch {args.batch} must divide by the "
                         f"query-axis size {nq}")
    info("sharded mesh", graph=mesh.shape["graph"], query=nq,
         exchange=args.exchange or "dense")
    return ShardedTopkRunner(
        g, mesh, rcfg, idx, k=args.k, delta_stride=args.delta_stride,
        accept_slack=args.accept_slack, exchange=args.exchange,
        chips_per_host=args.chips_per_host)


def _level_stats_path(args) -> Path:
    return Path(_index_dir(args)) / "level_stats.json"


def _write_output(path: str, results: dict) -> None:
    """Per-query results as JSONL (source, ids, vals) — the machine-readable
    counterpart of the reference's per-query result files."""
    with open(path, "w") as f:
        for s, (ids, vals) in sorted(results.items()):
            f.write(json.dumps({
                "source": int(s),
                "ids": [int(x) for x in ids],
                "vals": [float(x) for x in vals]}) + "\n")
    info("results written", path=path, count=len(results))


def _batched(sources: np.ndarray, batch: int):
    """Pad the tail batch by repeating the last source (results discarded)."""
    for lo in range(0, len(sources), batch):
        chunk = sources[lo: lo + batch]
        pad = batch - len(chunk)
        yield np.concatenate([chunk, np.repeat(chunk[-1:], pad)]), len(chunk)


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(argv=None) -> int:
    import jax
    import jax.numpy as jnp

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    log = RunLog(args.runlog)
    timers = Timers()

    if args.action == "generate-ss-query":
        g = _load(args)
        src = query_io.generate_sources(g, args.query_size, seed=args.seed)
        query_io.save_queries(src, str(_query_file(args)))
        info("query set written", path=str(_query_file(args)), count=len(src))
        return 0

    # sharded batch-topk/serve: prefer the shard-aware graph store — no
    # process then materializes the full CSR or runs the O(m) partition
    # pass (SURVEY.md Sec. 5.4 "each host loads only its rows")
    g_store = None
    if args.graph_shards > 1 and args.action in ("batch-topk", "serve"):
        from .parallel.graph_store import ShardedGraphStore
        try:
            g_store = ShardedGraphStore(
                str(Path(args.prefix) / args.dataset), args.graph_shards)
            info("sharded graph store", dir=str(g_store.dir),
                 per_shard_mb=round(g_store.bytes_per_shard() / 1e6, 1))
        except FileNotFoundError:
            info("no sharded graph store; loading monolithic graph "
                 "(persist one with the shard-graph action)")
    g = _load(args) if g_store is None else None
    cfg = ForaConfig(alpha=args.alpha, epsilon=args.epsilon, delta=args.delta,
                     pfail=args.pfail, k=args.k)
    rcfg = cfg.resolved(*((g.n, g.m) if g is not None
                          else (g_store.n, g_store.m)))
    info("config", rmax=f"{rcfg.rmax:.3g}", omega_unit=f"{rcfg.omega_unit:.3g}",
         delta=f"{rcfg.delta:.3g}")

    if args.action == "gen-exact-topk":
        from .algo import exact
        sources = query_io.load_queries(str(_query_file(args)))
        out = Path(args.prefix) / args.dataset / "exact"
        out.mkdir(parents=True, exist_ok=True)
        for s in sources:
            with timers.phase("exact"):
                ids, vals = exact.exact_topk(g, int(s), max(args.k, 500),
                                             alpha=args.alpha)
            np.savez(out / f"{int(s)}.npz", ids=ids, vals=vals)
        info("exact top-k written", dir=str(out), count=len(sources))
        print(timers.report(), file=sys.stderr)
        return 0

    if args.action == "shard-graph":
        from .parallel.graph_store import save_sharded_graph
        counts = [int(x) for x in
                  (args.shard_counts or str(args.graph_shards)).split(",")]
        for c in counts:
            if c < 2:
                raise ValueError(f"shard count {c} must be >= 2 "
                                 "(pass --shard-counts or --graph-shards)")
            with timers.phase(f"shard-graph-{c}"):
                d = save_sharded_graph(
                    g, str(Path(args.prefix) / args.dataset), c)
            info("sharded graph store written", dir=str(d), shards=c)
        print(timers.report(), file=sys.stderr)
        return 0

    sharded = args.graph_shards > 1
    if sharded and args.action not in ("batch-topk", "serve"):
        raise ValueError("--graph-shards applies to batch-topk and serve")
    # sharded runs place rows per shard; never replicate the device graph
    dg = None if sharded else to_device(g, hub_rows=args.hub_rows)

    if args.action == "build":
        import shutil
        from . import index as widx
        key = jax.random.key(args.seed)
        # chunk-level checkpointing: a preempted build resumes where it
        # stopped; a stale checkpoint (different config/graph/key) is
        # discarded and the build restarts clean
        ckpt = Path(_index_dir(args)) / ".build_ckpt"
        # log every 8th chunk AND always the final one, so a completed
        # build's log ends with a completion line (the log's purpose is
        # diagnosing hangs — an absent final line must mean "not done")
        prog = (lambda i, n, cached: None
                if cached or ((i + 1) % 8 and i + 1 != n) else
                info("walk chunks", done=i + 1, total=n))
        with timers.phase("build"):
            try:
                idx = widx.build_walk_index(dg, rcfg, key,
                                            checkpoint_dir=str(ckpt),
                                            progress=prog)
            except ValueError as e:
                if "checkpoint" not in str(e):
                    raise
                info("discarding stale build checkpoint", dir=str(ckpt))
                shutil.rmtree(ckpt, ignore_errors=True)
                idx = widx.build_walk_index(dg, rcfg, key,
                                            checkpoint_dir=str(ckpt),
                                            progress=prog)
        widx.save(idx, rcfg, _index_dir(args), graph=g)
        shutil.rmtree(ckpt, ignore_errors=True)
        info("index built", dir=_index_dir(args),
             endpoints=idx.total_edges, bytes=widx.index_nbytes(idx))
        if args.index_shards:
            from .index import store as widx_store
            from .parallel.graph_store import save_sharded_graph
            for gshards in [int(x) for x in args.index_shards.split(",")]:
                d = widx_store.save_sharded(idx, rcfg, _index_dir(args),
                                            gshards, graph=g)
                info("sharded store written", dir=str(d), shards=gshards)
                # the sharded index is consumed together with the sharded
                # GRAPH store — persist both so engine start touches no
                # global array (SURVEY.md Sec. 5.4)
                dgs = save_sharded_graph(
                    g, str(Path(args.prefix) / args.dataset), gshards)
                info("sharded graph store written", dir=str(dgs),
                     shards=gshards)
        print(timers.report(), file=sys.stderr)
        return 0

    if args.action == "sweep":
        # relative-error sweep vs epsilon (reference experiment protocol;
        # BASELINE config 2): mean/max relative error over pi > delta vs
        # the exact oracle, per epsilon, FORA+ indexed when --with-idx
        from .algo import exact, fora as fora_algo
        from .ops import topk as topk_ops
        from . import index as widx
        key = jax.random.key(args.seed)
        sources = query_io.load_queries(str(_query_file(args)))[: args.batch]
        pad = args.batch - len(sources)
        src = jnp.asarray(np.concatenate(
            [sources, np.repeat(sources[-1:], pad)]), jnp.int32)
        with timers.phase("exact-oracle"):
            X = exact.exact_ppr_power_batch(g, sources, alpha=args.alpha)
        exacts = [X[:, b] for b in range(len(sources))]
        exact_topk = [np.argsort(-pi, kind="stable")[: args.k]
                      for pi in exacts]
        for eps in [float(x) for x in args.sweep_eps.split(",")]:
            rc = ForaConfig(alpha=args.alpha, epsilon=eps, delta=args.delta,
                            pfail=args.pfail).resolved(g.n, g.m)
            idx = None
            if args.with_idx:
                idx = widx.load(_index_dir(args), rc, graph=g)
            fn = fora_algo.make_fora_fn(dg, rc, index=idx)
            with timers.phase(f"eps={eps}"):
                res = fn(src, jax.random.fold_in(key, int(eps * 1e6)))
                jax.block_until_ready(res.ppr)
            ppr = np.asarray(res.ppr, np.float64)
            _, pred_ids = topk_ops.topk_nodes(res.ppr, args.k)
            pred_ids = np.asarray(pred_ids)
            maxres, meanres, precs, recs = [], [], [], []
            for b, pi in enumerate(exacts):
                maxres.append(metrics.max_relative_error(ppr[:, b], pi,
                                                         rc.delta))
                meanres.append(metrics.mean_relative_error(ppr[:, b], pi,
                                                           rc.delta))
                precs.append(metrics.precision_at_k(pred_ids[b],
                                                    exact_topk[b]))
                recs.append(metrics.recall_at_k(pred_ids[b], exact_topk[b]))
            rec = log.event("sweep", epsilon=eps, delta=rc.delta,
                            max_rel_err=float(np.max(maxres)),
                            mean_rel_err=float(np.mean(meanres)),
                            precision_at_k=float(np.mean(precs)),
                            recall_at_k=float(np.mean(recs)), k=args.k,
                            queries=len(sources))
            print(json.dumps(rec), flush=True)
        print(timers.report(), file=sys.stderr)
        return 0

    idx, graph_sha = None, None
    if args.with_idx:
        from . import index as widx
        from .index.store import ShardedIndexStore
        graph_sha = (widx.graph_fingerprint(g) if g is not None
                     else g_store.graph_sha)
        if sharded:
            # prefer the shard-aware store: each host reads only its rows'
            # files and no global edge array exists in host RAM
            try:
                idx = ShardedIndexStore(_index_dir(args), args.graph_shards,
                                        rcfg, graph=g)
                if g is None and graph_sha is not None \
                        and idx.meta.get("graph_sha") is not None \
                        and idx.meta["graph_sha"] != graph_sha:
                    raise ValueError(
                        "sharded index was built for a different graph "
                        "(fingerprint mismatch vs the graph store)")
                info("sharded index store", dir=str(idx.dir),
                     per_shard_mb=round(idx.bytes_per_shard() / 1e6, 1))
            except FileNotFoundError:
                info("no sharded store; loading monolithic index "
                     "(build with --index-shards to persist shards)")
        if idx is None:
            idx = widx.load(_index_dir(args), rcfg, graph=g)
            info("index loaded", dir=_index_dir(args))

    if args.action == "serve":
        from .serve import serve_forever
        runner = _make_topk_runner(
            args, g_store if g_store is not None else g, dg, rcfg, idx)
        if idx is not None and runner.load_level_stats(
                _level_stats_path(args), graph_sha):
            info("start level from persisted stats",
                 level=runner.auto_start_level)

        def query_fn(sources, seed):
            res = runner.query_pool(np.asarray(sources),
                                    jax.random.key(seed),
                                    batch=args.batch)
            return res.node_ids, res.values

        # inflight=1: TopkRunner.query_pool keeps [n, batch] state and is
        # not thread-safe; the device serializes batches regardless.
        serve_forever(query_fn, batch=args.batch, k=args.k, port=args.port,
                      inflight=1)
        return 0

    # --- query actions ---
    sources = query_io.load_queries(str(_query_file(args)))

    exact_dir = Path(args.prefix) / args.dataset / "exact"
    key = jax.random.key(args.seed)
    results = {}

    if args.action in ("query",):
        from .algo import fora as fora_algo
        from .algo import montecarlo as mc_algo
        from .ops import push as push_ops
        from .ops import topk as topk_ops
        if args.algo == "fora":
            fn = fora_algo.make_fora_fn(dg, rcfg, index=idx)
            run = lambda s, k: fn(s, k).ppr
        elif args.algo == "montecarlo":
            fn = mc_algo.make_montecarlo_fn(dg, rcfg)
            run = fn
        elif args.algo == "bippr":
            from .algo import bippr as bippr_algo
            if args.target_file:
                targets = np.array([int(x) for x in
                                    Path(args.target_file).read_text().split()])
            elif g.n <= 4096:
                targets = np.arange(g.n)
            else:
                targets = np.sort(np.random.default_rng(args.seed)
                                  .choice(g.n, args.bippr_targets,
                                          replace=False))
            tgt = jnp.asarray(targets, jnp.int32)
            bfn = bippr_algo.make_bippr_fn(dg, rcfg, tgt)
            info("bippr", targets=len(targets),
                 rmax_b=f"{bfn.rmax_b:.3g}", walks=bfn.num_walks)

            def run(s, k):
                est = bfn(s, k)                               # [S, T]
                return jnp.zeros((g.n, est.shape[0]),
                                 jnp.float32).at[tgt, :].set(est.T)
        elif args.algo == "hubppr":
            from .algo import hubppr as hub_algo
            with timers.phase("hub-build"):
                fn = hub_algo.make_hubppr_fn(dg, rcfg, key,
                                             num_hubs=args.num_hubs)
            info("hub index built", hubs=fn.hub_index.num_hubs,
                 pool=fn.hub_index.pool_size)
            run = fn
        else:  # fwdpush
            import functools
            _pp = jax.jit(functools.partial(
                push_ops.push_only_estimate,
                rmax=rcfg.rmax / max(rcfg.omega_unit, 1.0),
                alpha=rcfg.alpha, max_iters=2000))
            run = lambda s, k: _pp(dg, s)
        for chunk, valid in _batched(sources, args.batch):
            ppr = timers.timed("query", run, jnp.asarray(chunk),
                               jax.random.fold_in(key, int(chunk[0])))
            vals, ids = topk_ops.topk_nodes(ppr, args.k)
            for b in range(valid):
                results[int(chunk[b])] = (np.asarray(ids[b]),
                                          np.asarray(vals[b]))
    elif args.action == "batch-topk":
        # level-pipelined pool scheduling: accepted queries exit early,
        # stragglers re-batch at deeper delta levels; --graph-shards > 1
        # runs the same pool shard_mapped over the ('graph','query') mesh
        runner = _make_topk_runner(
            args, g_store if g_store is not None else g, dg, rcfg, idx)
        if idx is not None and args.start_level is None and \
                runner.load_level_stats(_level_stats_path(args), graph_sha):
            info("start level from persisted stats",
                 level=runner.auto_start_level)
        pool_w = args.pool if args.pool > 0 else len(sources)
        pools = [sources[i:i + pool_w]
                 for i in range(0, len(sources), pool_w)]
        defer = args.defer if len(pools) > 1 else 0
        with timers.phase("topk"):
            for pi, pool in enumerate(pools):
                res = runner.query_pool(
                    pool, jax.random.fold_in(key, pi) if pi else key,
                    batch=args.batch, start_level=args.start_level,
                    defer_below=defer)
                for i, s in enumerate(pool):
                    if res.deferred is None or not res.deferred[i]:
                        results[int(s)] = (res.node_ids[i], res.values[i])
            dsrcs, dres = runner.flush_deferred(
                jax.random.fold_in(key, 1 << 20), batch=args.batch)
            if dres is not None:
                for i, s in enumerate(dsrcs):
                    results[int(s)] = (dres.node_ids[i], dres.values[i])
        if idx is not None and args.start_level is None:
            try:
                runner.save_level_stats(_level_stats_path(args), graph_sha)
            except OSError:
                pass  # read-only index dir
    else:  # topk
        runner = _make_topk_runner(
            args, g_store if g_store is not None else g, dg, rcfg, idx)
        for chunk, valid in _batched(sources, args.batch):
            res = timers.timed("topk", runner.query, jnp.asarray(chunk),
                               jax.random.fold_in(key, int(chunk[0])))
            for b in range(valid):
                results[int(chunk[b])] = (res.node_ids[b], res.values[b])

    n_q = len(results)
    qps = n_q / max(timers.total.get("query", 0) + timers.total.get("topk", 0),
                    1e-9)
    info("queries done", count=n_q, qps=f"{qps:.2f}")

    if args.output:
        _write_output(args.output, results)

    if args.eval_exact:
        from .algo import exact
        if g is None:
            # store-backed runs never load the full graph; the exact
            # oracle (offline eval, explicitly slow) is the exception
            g = _load(args)
        precs = []
        for s, (ids, _) in results.items():
            f = exact_dir / f"{s}.npz"
            if f.exists():
                ex_ids = np.load(f)["ids"][: args.k]
            else:
                ex_ids = exact.exact_topk(g, s, args.k, alpha=args.alpha)[0]
            precs.append(metrics.precision_at_k(ids[: args.k], ex_ids))
        info("precision", at_k=args.k, mean=f"{float(np.mean(precs)):.4f}")
        log.event("eval", precision_at_k=float(np.mean(precs)), k=args.k,
                  queries=n_q, qps=qps, timers=timers.as_dict())
    else:
        log.event("run", queries=n_q, qps=qps, timers=timers.as_dict())

    print(timers.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
