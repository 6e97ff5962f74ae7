"""A/B the pool start level at bench/judged scale on the real chip.

The structural start-level rule (algo/topk.py _update_start_level) skips
levels whose acceptances leave downstream batch shapes unchanged — at
judged scale that moves the start from level 2 (first-accepting) to
level 3.  Skipping is only a win if the merged from-scratch push at the
deeper level costs less than the skipped level's full pass; this probe
measures exactly that: one fresh pool per candidate start level, timed
end to end.

Usage (on the accelerator, after a bench has populated the cache):
  python scripts/start_level_probe.py [start_levels ...]   # default 2 3
Scale knobs: the same FORA_BENCH_* env vars as bench.py.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    import bench
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import numpy as np
    from fora import index as widx
    from fora.algo import topk as topk_algo
    from fora.config import ForaConfig
    from fora.graph import to_device

    levels = [int(x) for x in sys.argv[1:]] or [2, 3]
    g = bench.get_graph()
    sources = bench.get_sources(g)
    cfg = ForaConfig(epsilon=bench.EPS, k=bench.K, rmax_scale=bench.RMAXS)
    rcfg = cfg.resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True)
    idx_dir = bench.CACHE / (f"{bench.TAG}.idx.e{bench.EPS}" +
                             (f".rs{bench.RMAXS:g}" if bench.RMAXS != 1
                              else ""))
    index = widx.load(str(idx_dir), rcfg, graph=g)
    runner = topk_algo.TopkRunner(dg, rcfg, k=bench.K, index=index,
                                  delta_stride=bench.DSTRIDE,
                                  accept_slack=bench.ACCEPT,
                                  gather_chunk=bench.CHUNK)
    key = jax.random.key(bench.SEED + 2)
    pool = sources[: min(bench.POOL, len(sources))]

    # warm compiles once from the shallowest candidate (deeper levels run
    # inside the same pool, so this covers every level's program)
    print("warmup ...", flush=True)
    runner.query_pool(pool, jax.random.fold_in(key, 999), batch=bench.BATCH,
                      start_level=min(levels))

    for reps in range(2):
        for lv in levels:
            t0 = time.time()
            res = runner.query_pool(pool, jax.random.fold_in(key, reps),
                                    batch=bench.BATCH, start_level=lv)
            secs = time.time() - t0
            acc = int(np.asarray(res.accepted).sum())
            st = "; ".join(
                f"L{s['level']}:{s['secs']}s acc={s['accepted']}"
                for s in runner.last_level_stats)
            print(f"rep{reps} start={lv}: {secs:.2f}s/pool "
                  f"({len(pool)/secs:.2f} q/s) accepted={acc} [{st}]",
                  flush=True)


if __name__ == "__main__":
    main()
