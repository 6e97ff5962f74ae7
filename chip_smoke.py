"""Bring-up check: the FORA+ top-k engine on NVIDIA GPUs at LiveJournal scale.

The deployment is BASELINE config 3 as ``bench.py`` runs it: RMAT with 2^22
nodes x 16 edges per node (seed 7), duplicate edges merged, in-edges of the
131072 highest out-degree sources split into the compact hub gather, the
FORA+ walk index at eps=0.5, k=50, 128-query pools at batch 128 with
straggler deferral, driven through ``TopkRunner.query_pool`` /
``flush_deferred`` and served by ``ForaServer``.

  python chip_smoke.py                # one card: phases (a)-(d)
  python chip_smoke.py --four-cards   # phase (e) alone, on four cards
  python chip_smoke.py --nlog2 14     # a smaller graph, for debugging

Phases, one stdout line each:
  (a) device   JAX's first device is a GPU; the card's name and power limit
  (b) kernels  one dense push superstep (f32, then bf16 gathers), the
               largest index bucket's gather_scatter_add and the chunked
               top-k, each against a float64 host reference
  (c) topk     two 128-query pools plus the deferred flush; precision@50
               against the exact oracle; cold and warm wall times
  (d) serve    ForaServer in this process on the same runner, answering
               TCP requests
  (e) four     (--four-cards only) ShardedTopkRunner row-sharded over a
               4x1 ('graph', 'query') mesh against a one-card TopkRunner
               and the exact oracle
The last stdout line is {"ok": true, "device": {...}}; a failed phase exits
non-zero before it is printed.  Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import json
import os
import sys
import time

import numpy as np

# --- the deployment (bench.py defaults) -----------------------------------
SEED = 7
EDGES_PER_NODE = 16
HUB_ROWS = 131072
GATHER_CHUNK = 1 << 21
EPSILON = 0.5
K = 50
BATCH = 128
DEFER = 64
DELTA_STRIDE = 8.0
EVAL_SOURCES = 32    # scored against the exact oracle (host, float64)
SERVE_REQUESTS = 16  # TCP requests in the serve phase, all with truth

# --- tolerances -----------------------------------------------------------
# Kernel outputs are sums of positive terms (residue mass times
# multiplicity), so each output's relative error is bounded by the largest
# relative error of its terms plus the accumulation error.  The GPU adds in
# another order than the host, and scatter-add uses atomics whose order
# changes from run to run, so nothing is compared bit for bit.
#  * f32: an f32 sum of d positive terms in random order is off by about
#    sqrt(d) * 2^-24 relative, ~2e-5 for the ~1e6-term sums on the hottest
#    index destinations; 1e-3 leaves 50x margin and still catches one
#    dropped or doubled edge at every node of in-degree below ~1000, which
#    is nearly all of them.
F32_TOL = 1e-3
#  * bf16 gathers: every gathered term is rounded once to 8 significant
#    bits (relative error <= 2^-8 ~ 0.39%), then summed in f32.
BF16_TOL = 2.0 ** -8 + F32_TOL
# precision@50 against the exact oracle, averaged over the evaluated
# sources: the engine's (eps=0.5, delta=1/n) guarantee held 0.974 over 128
# sources on the previous accelerator, the C++ reference 0.946.
PRECISION_FLOOR = 0.95
# the sharded and one-card runners do the same arithmetic in another order,
# so a query at an acceptance boundary may accept one level apart and
# return a different valid top-50; on average the two answers must share
# this fraction of their ids.
SHARDED_AGREEMENT = 0.97


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def phase(name: str, **fields) -> None:
    print(f"{name}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def check_answer(source: int, ids) -> bool:
    """k distinct ids that include the source.  PPR(s, s) >= alpha = 0.2
    and the scores sum to at most 1, so the source always ranks in the top
    five — but not always first: a dangling (absorbing) out-neighbour of a
    low-degree source can hold more mass than the source itself."""
    ids = np.asarray(ids)
    return len(ids) == K and len(np.unique(ids)) == K and source in ids


def require_gpu(devices) -> None:
    """Phase (a)'s refusal: the measurement path never falls back."""
    d = devices[0]
    require(d.platform == "gpu",
            f"JAX's first device is {d.platform} ({d.device_kind}), not a "
            "GPU; this check runs only on the card")


# --- deployment -----------------------------------------------------------

def make_deployment(nlog2: int, hub_rows: int = HUB_ROWS,
                    chunk: int = GATHER_CHUNK):
    """(host graph, device graph, resolved config) as bench.py builds
    them."""
    from fora.config import ForaConfig
    from fora.graph import generators, to_device
    g = generators.rmat(nlog2, (1 << nlog2) * EDGES_PER_NODE, seed=SEED)
    rcfg = ForaConfig(epsilon=EPSILON, k=K).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=hub_rows,
                   pad_edges=chunk)
    return g, dg, rcfg


def host_index(index):
    """Index arrays on the host, as store.load(mmap=True) hands them to the
    engine: StagedForaPrograms then pre-pads each bucket and places it
    once."""
    return index._replace(
        edge_src=np.asarray(index.edge_src),
        edge_dst=np.asarray(index.edge_dst),
        counts_cum=np.asarray(index.counts_cum),
        edge_mult=(None if index.edge_mult is None
                   else np.asarray(index.edge_mult)))


# --- float64 host references ----------------------------------------------

def csr_from_edges(rows, cols, vals, n):
    import scipy.sparse as sp
    return sp.csr_matrix(
        (np.asarray(vals, np.float64),
         (np.asarray(rows, np.int64), np.asarray(cols, np.int64))),
        shape=(n, n))


def spmm(A, X, threads: int = 0):
    """A @ X for a scipy CSR A and a dense X, row blocks on threads."""
    threads = threads or os.cpu_count() or 1
    n = A.shape[0]
    lo = [i * n // threads for i in range(threads + 1)]
    out = np.empty((n, X.shape[1]), np.float64)

    def part(i):
        out[lo[i]:lo[i + 1]] = A[lo[i]:lo[i + 1]] @ X

    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        list(ex.map(part, range(threads)))
    return out


def push_reference(g, r64, alpha: float):
    """One push superstep from (p=0, r) with every positive row active
    (rmax=0), on the raw edge list: p' = alpha*r (all of r on dangling
    rows), r' = sum over in-edges u->t of (1-alpha) r[u] / deg[u]."""
    deg = np.asarray(g.out_deg, np.float64)[:, None]
    dangling = deg == 0.0
    p_ref = np.where(dangling, r64, alpha * r64)
    contrib = np.where(dangling, 0.0,
                       (1.0 - alpha) * r64 / np.maximum(deg, 1.0))
    M = csr_from_edges(g.in_dst, g.in_src, np.ones(g.m), g.n)
    return p_ref, spmm(M, contrib)


def bucket_reference(src, dst, mult, inv_cnt, r64, n):
    """sum over bucket edges v->t of mult * r[v] * inv_cnt[v]."""
    w = np.ones(len(src)) if mult is None else mult
    B = csr_from_edges(dst, src, w, n)
    return spmm(B, r64 * np.asarray(inv_cnt, np.float64)[:, None])


def rel_err(x, ref) -> float:
    """Largest elementwise relative error; where ref is 0 any nonzero x
    counts as an error of |x| / 1e-30."""
    x = np.asarray(x, np.float64)
    return float(np.max(np.abs(x - ref) / np.maximum(np.abs(ref), 1e-30)))


# --- kernels under test -----------------------------------------------------

def push_superstep_fn(alpha: float, chunk: int, gather_dtype=None):
    """Jitted dense superstep: forward_push_from with max_iters=1, rmax=0."""
    import jax
    import jax.numpy as jnp
    from fora.ops import push as push_ops

    def step(dg, p, r):
        st = push_ops.PushState(p=p, r=r, iters=jnp.zeros((), jnp.int32))
        st = push_ops.forward_push_from(dg, st, rmax=0.0, alpha=alpha,
                                        max_iters=1, max_chunk=chunk,
                                        gather_dtype=gather_dtype)
        return st.p, st.r

    return jax.jit(step)


def bucket_spmv_fn(chunk: int):
    """The index walk-phase kernel as StagedForaPrograms compiles it."""
    import jax
    from fora.ops import push as push_ops

    def spmv(acc, r, src, dst, mult, inv_cnt):
        return push_ops.gather_scatter_add(acc, r, src, dst, max_chunk=chunk,
                                           edge_w=mult, src_w=inv_cnt)

    return jax.jit(spmv, donate_argnums=(0,))


def largest_bucket(index):
    sizes = np.diff(np.asarray(index.bucket_offsets))
    q = int(np.argmax(sizes))
    lo, hi = int(index.bucket_offsets[q]), int(index.bucket_offsets[q + 1])
    mult = None if index.edge_mult is None else index.edge_mult[lo:hi]
    return q, index.edge_src[lo:hi], index.edge_dst[lo:hi], mult


def check_push(dg, r, refs, alpha, chunk, gather_dtype=None):
    """One dense superstep from (0, r) against the host reference ``refs``
    (push_reference): (p error, r error, push program, new residue)."""
    import jax.numpy as jnp
    fn = push_superstep_fn(alpha, chunk, gather_dtype)
    p2, r2 = fn(dg, jnp.zeros_like(r), r)
    return (rel_err(np.asarray(p2), refs[0]), rel_err(np.asarray(r2), refs[1]),
            fn, r2)


def check_bucket(index, r, r64, n, chunk, depth: int = 0):
    """Largest bucket's gather_scatter_add at ``depth``'s estimator weights
    against the host reference: (bucket id, edges, error)."""
    import jax.numpy as jnp
    from fora.ops import push as push_ops
    q, src, dst, mult = largest_bucket(index)
    inv = 1.0 / np.maximum(np.asarray(index.counts_cum)[:, depth], 1)
    src_p, dst_p, mult_p = push_ops.pad_edge_arrays(
        n, chunk, np.asarray(src), np.asarray(dst),
        None if mult is None else np.asarray(mult))
    out = bucket_spmv_fn(chunk)(
        jnp.zeros(r.shape, jnp.float32), r, jnp.asarray(src_p),
        jnp.asarray(dst_p), None if mult_p is None else jnp.asarray(mult_p),
        jnp.asarray(inv, jnp.float32))
    ref = bucket_reference(np.asarray(src), np.asarray(dst),
                           None if mult is None else np.asarray(mult),
                           inv, r64, n)
    return q, len(src), rel_err(np.asarray(out), ref)


def check_topk(scores, k: int) -> int:
    """topk_rows_chunked against numpy on the same f32 scores; returns the
    number of mismatching columns (0 = exact agreement up to ties)."""
    import jax.numpy as jnp
    from fora.ops.topk import topk_rows_chunked
    vals, ids = topk_rows_chunked(jnp.asarray(scores), k)
    vals, ids = np.asarray(vals), np.asarray(ids)
    host = np.asarray(scores)
    want = -np.sort(-host, axis=0)[:k].T                      # [B, k]
    picked = np.take_along_axis(host.T, ids, axis=1)
    bad = ~(np.all(vals == want, axis=1) & np.all(picked == vals, axis=1)
            & np.all(np.diff(vals, axis=1) <= 0, axis=1))
    return int(bad.sum())


# --- phases -----------------------------------------------------------------

def phase_device(expect: int):
    import jax
    from fora.utils import profiling
    devices = jax.devices()
    require_gpu(devices)
    require(len(devices) >= expect,
            f"need {expect} GPUs, JAX sees {len(devices)}")
    smi = profiling.gpu_name_and_power_limit().replace("\n", "; ")
    print(f"nvidia-smi: {smi}", flush=True)
    phase("(a) device", platform=devices[0].platform,
          kind=repr(devices[0].device_kind), count=len(devices),
          jax=jax.__version__)
    return devices


def phase_kernels(g, dg, rcfg, index, chunk):
    import jax
    import jax.numpy as jnp
    from fora.utils import profiling
    r = jax.random.uniform(jax.random.key(SEED), (g.n, BATCH), jnp.float32)
    r64 = np.asarray(r, np.float64)
    t0 = time.time()
    refs = push_reference(g, r64, rcfg.alpha)
    ep, er, fn, r2 = check_push(dg, r, refs, rcfg.alpha, chunk)
    mem = fn.lower(dg, jnp.zeros_like(r), r).compile().memory_analysis()
    print(f"push program memory_analysis: {mem}", flush=True)
    p0 = jnp.zeros_like(r)
    step_secs = profiling.measure(fn, dg, p0, r, reps=5)
    roof = profiling.SpmvRoofline(edges=int(dg.m_in), batch=BATCH, nodes=g.n)
    del p0
    require(ep <= F32_TOL and er <= F32_TOL,
            f"f32 push superstep error p={ep:.3g} r={er:.3g} > {F32_TOL}")
    _, eb, _, _ = check_push(dg, r, refs, rcfg.alpha, chunk,
                             gather_dtype=jnp.bfloat16)
    del refs
    require(eb <= BF16_TOL,
            f"bf16 push superstep error r={eb:.3g} > {BF16_TOL:.3g}")
    q, n_edges, es = check_bucket(index, r, r64, g.n, chunk)
    require(es <= F32_TOL,
            f"bucket {q} gather_scatter_add error {es:.3g} > {F32_TOL}")
    bad = check_topk(r2, K)
    require(bad == 0, f"topk_rows_chunked disagrees with numpy on {bad} "
                      f"of {BATCH} columns")
    phase("(b) kernels", batch=BATCH, edges=int(dg.m_in),
          push_f32_err=f"{max(ep, er):.3g}/{F32_TOL:g}",
          push_bf16_err=f"{eb:.3g}/{BF16_TOL:.3g}",
          push_superstep_ms=f"{step_secs * 1e3:.2f}",
          push_hbm_share=f"{roof.efficiency(step_secs):.3f}",
          bucket=q, bucket_edges=n_edges,
          bucket_err=f"{es:.3g}/{F32_TOL:g}",
          topk_mismatch=f"{bad}/{BATCH}", secs=f"{time.time() - t0:.1f}")


def precision(ids_by_source: dict, exact_ids: dict) -> float:
    from fora.eval import metrics
    srcs = [s for s in exact_ids if s in ids_by_source]
    return metrics.batch_precision_at_k(
        np.stack([np.asarray(ids_by_source[s])[:K] for s in srcs]),
        np.stack([exact_ids[s] for s in srcs]))


def run_pools(runner, pools, key):
    """query_pool over every pool (deferring stragglers when there are
    several) and the shared flush; returns ({source: ids}, seconds per
    pool, flush seconds)."""
    import jax
    out, pool_secs = {}, []
    defer = DEFER if len(pools) > 1 else 0
    for i, pool in enumerate(pools):
        t0 = time.time()
        res = runner.query_pool(pool, jax.random.fold_in(key, 1 + i),
                                batch=BATCH, defer_below=defer)
        pool_secs.append(time.time() - t0)
        for j, s in enumerate(pool):
            if res.deferred is None or not res.deferred[j]:
                out[int(s)] = res.node_ids[j]
    t0 = time.time()
    dsrcs, dres = runner.flush_deferred(jax.random.fold_in(key, 777),
                                        batch=BATCH)
    if dres is not None:
        for j, s in enumerate(dsrcs):
            out[int(s)] = dres.node_ids[j]
    return out, pool_secs, time.time() - t0, (0 if dres is None
                                              else len(dsrcs))


def phase_topk(runner, pools, exact_future):
    import jax
    results, pool_secs, flush_secs, n_def = run_pools(
        runner, pools, jax.random.key(SEED + 2))
    n_q = sum(len(p) for p in pools)
    require(len(results) == n_q, f"{n_q - len(results)} queries unanswered")
    for s, ids in results.items():
        require(check_answer(s, ids),
                f"source {s}: answer is not {K} distinct ids with the source")
    first = sum(int(ids[0]) == s for s, ids in results.items())
    exact_ids = exact_future.result()
    prec = precision(results, exact_ids)
    require(prec >= PRECISION_FLOOR,
            f"precision@{K} {prec:.4f} < {PRECISION_FLOOR}")
    phase("(c) topk", queries=n_q, eval_sources=len(exact_ids),
          precision=f"{prec:.4f}/{PRECISION_FLOOR}", source_first=first,
          cold_pool_secs=f"{pool_secs[0]:.2f}",
          warm_pool_secs=" ".join(f"{s:.2f}" for s in pool_secs[1:]),
          flush_secs=f"{flush_secs:.2f}", deferred=n_def,
          start_level=runner.auto_start_level)


async def _serve(runner, sources, exact_ids):
    import jax
    from fora.serve import ForaServer

    def query_fn(srcs, seed):
        res = runner.query_pool(np.asarray(srcs), jax.random.key(seed),
                                batch=BATCH)
        return res.node_ids, res.values

    server = ForaServer(query_fn, batch=BATCH, k=K, max_wait_ms=500.0,
                        inflight=1)
    port = await server.start("127.0.0.1", 0)

    async def ask(i, s):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((json.dumps({"id": i, "source": int(s)}) + "\n")
                     .encode())
        await writer.drain()
        line = await reader.readline()
        writer.close()
        return json.loads(line)

    try:
        t0 = time.time()
        answers = await asyncio.gather(*(ask(i, s)
                                         for i, s in enumerate(sources)))
        secs = time.time() - t0
    finally:
        await server.stop()
    return answers, secs, server.n_batches


def phase_serve(runner, sources, exact_ids):
    answers, secs, n_batches = asyncio.run(_serve(runner, sources,
                                                  exact_ids))
    got = {}
    for i, (s, a) in enumerate(zip(sources, answers)):
        require(a.get("id") == i and "nodes" in a, f"bad answer {a}")
        nodes = a["nodes"]
        require(check_answer(int(s), nodes),
                f"source {s}: served answer is not {K} distinct ids with "
                f"the source: {nodes[:5]}...")
        got[int(s)] = np.asarray(nodes)
    prec = precision(got, exact_ids)
    require(prec >= PRECISION_FLOOR,
            f"served precision@{K} {prec:.4f} < {PRECISION_FLOOR}")
    phase("(d) serve", requests=len(sources), batches=n_batches,
          precision=f"{prec:.4f}/{PRECISION_FLOOR}", secs=f"{secs:.2f}")


def exact_oracle(g, sources):
    from fora.algo import exact
    ids = exact.exact_topk_batch(g, sources, K, threads=os.cpu_count())
    return {int(s): ids[i] for i, s in enumerate(sources)}


def build_index(dg, rcfg):
    import jax
    from fora import index as widx
    t0 = time.time()
    index = host_index(widx.build_walk_index(dg, rcfg,
                                             jax.random.key(SEED)))
    log(f"index: {index.total_edges} edges in {time.time() - t0:.1f}s")
    return index


def one_card(args):
    from fora.algo import topk as topk_algo
    from fora.eval import queries as qio
    t_start = time.time()
    devices = phase_device(1)
    t0 = time.time()
    g, dg, rcfg = make_deployment(args.nlog2)
    log(f"graph n={g.n} m={g.m} in {time.time() - t0:.1f}s")
    sources = qio.generate_sources(g, 2 * BATCH, seed=SEED + 1)
    evals = np.concatenate([sources[:EVAL_SOURCES // 2],
                            sources[BATCH:BATCH + EVAL_SOURCES // 2]])
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        # the host oracle overlaps the device phases
        exact_future = ex.submit(exact_oracle, g, evals)
        index = build_index(dg, rcfg)
        phase_kernels(g, dg, rcfg, index, GATHER_CHUNK)
        runner = topk_algo.TopkRunner(dg, rcfg, k=K, index=index,
                                      delta_stride=DELTA_STRIDE,
                                      gather_chunk=GATHER_CHUNK)
        phase_topk(runner, [sources[:BATCH], sources[BATCH:]], exact_future)
        phase_serve(runner, evals[:SERVE_REQUESTS], exact_future.result())
    log(f"total {time.time() - t_start:.1f}s")
    return devices


def four_cards(args):
    import jax
    from fora.algo import topk as topk_algo
    from fora.eval import queries as qio
    from fora.parallel import ShardedTopkRunner, make_mesh
    t_start = time.time()
    devices = phase_device(4)[:4]
    g, dg, rcfg = make_deployment(args.nlog2)
    sources = qio.generate_sources(g, BATCH, seed=SEED + 1)
    evals = sources[:EVAL_SOURCES]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        exact_future = ex.submit(exact_oracle, g, evals)
        index = build_index(dg, rcfg)
        single = topk_algo.TopkRunner(dg, rcfg, k=K, index=index,
                                      delta_stride=DELTA_STRIDE,
                                      gather_chunk=GATHER_CHUNK)
        ref, _, _, _ = run_pools(single, [sources], jax.random.key(3))
        del single
        t0 = time.time()
        sharded = ShardedTopkRunner(
            g, make_mesh(4, 1, devices=devices), rcfg, index, k=K,
            delta_stride=DELTA_STRIDE, exchange=args.exchange,
            chips_per_host=2 if args.exchange == "hier" else None,
            hub_rows=HUB_ROWS)
        setup = time.time() - t0
        t0 = time.time()
        got, _, _, _ = run_pools(sharded, [sources], jax.random.key(3))
        secs = time.time() - t0
        exact_ids = exact_future.result()
    agree = float(np.mean([len(np.intersect1d(got[s][:K], ref[s][:K])) / K
                           for s in ref]))
    p_sharded = precision(got, exact_ids)
    p_single = precision(ref, exact_ids)
    require(all(check_answer(s, got[s]) for s in got),
            f"a sharded answer is not {K} distinct ids with its source")
    require(agree >= SHARDED_AGREEMENT,
            f"sharded vs one-card overlap {agree:.4f} < {SHARDED_AGREEMENT}")
    require(min(p_sharded, p_single) >= PRECISION_FLOOR,
            f"precision sharded {p_sharded:.4f} one-card {p_single:.4f} "
            f"< {PRECISION_FLOOR}")
    phase("(e) four", mesh="4x1", exchange=args.exchange, queries=len(got),
          agreement=f"{agree:.4f}/{SHARDED_AGREEMENT}",
          precision_sharded=f"{p_sharded:.4f}/{PRECISION_FLOOR}",
          precision_one_card=f"{p_single:.4f}", setup_secs=f"{setup:.1f}",
          pool_secs=f"{secs:.2f}")
    log(f"total {time.time() - t_start:.1f}s")
    return devices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase (e) on four GPUs")
    ap.add_argument("--exchange", default="routed",
                    choices=["routed", "hier"],
                    help="frontier exchange of the sharded phase")
    ap.add_argument("--nlog2", type=int, default=22,
                    help="log2 of the node count (22 = LiveJournal scale)")
    args = ap.parse_args(argv)

    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    try:
        devices = four_cards(args) if args.four_cards else one_card(args)
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
