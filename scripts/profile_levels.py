"""Phase-split profile of the bench's dominant delta levels.

Times, per level of the bench pool (width 512 / 256), the three phases of
the staged indexed FORA program separately:
  * resumed forward push to the level's coverage threshold,
  * the multi-resolution index SpMV (buckets depth..7),
  * per-query top-k.
Uses bench_data caches; run AFTER bench.py has populated them.

  FORA_PROF_MERGE=1   merge duplicate push edges (DeviceGraph.in_w)
  FORA_PROF_WIDTH     pool width (default 512)
  FORA_PROF_LEVELS    comma-separated level indices (default "2,3")
  FORA_PROF_BF16=1    bf16 hot-path gathers
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench


def main():
    if int(os.environ.get("FORA_PROF_LOGC", "0")):
        import jax as _j; _j.config.update("jax_log_compiles", True)
    import jax
    import jax.numpy as jnp
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from fora import index as widx
    from fora.algo import topk as topk_algo
    from fora.config import ForaConfig
    from fora.graph import to_device
    from fora.ops import topk as topk_ops

    merge = int(os.environ.get("FORA_PROF_MERGE", "0"))
    width = int(os.environ.get("FORA_PROF_WIDTH", "512"))
    levels = [int(x) for x in
              os.environ.get("FORA_PROF_LEVELS", "2,3").split(",")]
    bf16 = int(os.environ.get("FORA_PROF_BF16", "0"))

    g = bench.get_graph()
    sources = bench.get_sources(g)
    rcfg = ForaConfig(epsilon=bench.EPS, k=bench.K).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=bool(merge))
    idx_dir = bench.CACHE / f"{bench.TAG}.idx.e{bench.EPS}"
    index = widx.load(str(idx_dir), rcfg)
    print(f"merge={merge} unique_push_edges={dg.in_src.shape[0]} "
          f"(of {g.m})", file=sys.stderr)

    runner = topk_algo.TopkRunner(dg, rcfg, k=bench.K, index=index,
                                  delta_stride=bench.DSTRIDE,
                                  gather_dtype=jnp.bfloat16 if bf16 else None,
                                  gather_chunk=bench.CHUNK)
    staged = None

    def split_level(level, p0, r0):
        nonlocal staged
        ckey, rmax, omega_unit = runner._levels[level]
        runner._state_fn(ckey)  # builds runner._staged
        staged = runner._staged
        from fora.ops import push as push_ops
        counts_col = index.counts_cum[:, ckey]
        thr = counts_col.astype(jnp.float32) / jnp.float32(omega_unit)
        # push
        t0 = time.time()
        st = staged._push(dg, push_ops.PushState(
            p=p0, r=r0, iters=jnp.zeros((), jnp.int32)),
            rmax=jnp.float32(rmax), thr=thr)
        jax.block_until_ready(st)
        t_push = time.time() - t0
        # index SpMV
        t0 = time.time()
        rw, contrib = staged._weight(st.r, counts_col)
        from fora.index import build as ib
        for q in range(ckey, ib.NUM_BUCKETS):
            if staged._buckets[q] is None:
                continue
            s, d, mult = staged._buckets[q]
            contrib = staged._bucket(s, d, mult, rw, contrib)
        res = staged._finish(st.p, contrib, st.r, st.iters)
        jax.block_until_ready(res)
        t_spmv = time.time() - t0
        # top-k
        t0 = time.time()
        vals, ids = topk_ops.topk_nodes(res.ppr, bench.K)
        jax.block_until_ready((vals, ids))
        t_topk = time.time() - t0
        print(f"level {level} depth={ckey} width={p0.shape[1]} "
              f"push={t_push*1e3:.0f}ms (iters={int(st.iters)}) "
              f"spmv={t_spmv*1e3:.0f}ms topk={t_topk*1e3:.0f}ms",
              file=sys.stderr)
        return st.p, st.r

    src = jnp.asarray(np.asarray(sources[:width]), jnp.int32)
    n = rcfg.n
    p0 = jnp.zeros((n, width), jnp.float32)
    r0 = jnp.zeros((n, width), jnp.float32).at[
        src, jnp.arange(width)].set(1.0)
    # warm both levels once (compile), then measure
    for tag in ("warm", "meas"):
        print(f"--- {tag}", file=sys.stderr)
        p, r = p0, r0
        t0 = time.time()
        for level in levels:
            p, r = split_level(level, p, r)
        print(f"total (levels {levels}, width {width}): "
              f"{time.time()-t0:.2f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
