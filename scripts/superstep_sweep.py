"""Micro-sweep of the dense push superstep at judged scale: gather chunk
size and batch width vs effective bandwidth.  Uses bench.py's cached RMAT
graph; run on the real chip after a bench (the compile cache is shared).

Usage: python scripts/superstep_sweep.py [chunk_log2 ...]
"""

import functools
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    import bench
    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from fora.graph import to_device
    from fora.ops import push as push_ops
    from fora.utils import profiling

    g = bench.get_graph()
    dg = to_device(g, merge_duplicate_edges=True)
    sources = bench.get_sources(g)
    m_eff = int(dg.in_src.shape[0])
    chunks = [int(x) for x in sys.argv[1:]] or [20, 21, 22]

    for B in (128,):
        srcs = jnp.asarray(sources[:B], jnp.int32)
        for clog in chunks:
            def one_superstep(dgx, s, *, ck):
                st0 = push_ops.init_state(dgx.n, s)
                return push_ops.forward_push_from(
                    dgx, st0, rmax=0.0, alpha=0.2, max_iters=1,
                    max_chunk=1 << ck).r

            step = jax.jit(functools.partial(one_superstep, ck=clog))
            try:
                secs = profiling.measure(lambda: step(dg, srcs), reps=3,
                                         warmup=1)
            except Exception as e:  # OOM at too-large chunks: report, go on
                print(f"B={B} chunk=2^{clog}: failed ({str(e)[:80]})",
                      flush=True)
                continue
            roof = profiling.SpmvRoofline(edges=m_eff, batch=B, nodes=g.n)
            print(f"B={B} chunk=2^{clog}: {secs*1e3:.0f} ms "
                  f"-> {roof.bytes_moved/secs/1e9:.1f} GB/s eff "
                  f"({m_eff/secs/1e6:.1f} M edges/s)", flush=True)


if __name__ == "__main__":
    main()
