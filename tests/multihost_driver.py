"""Worker script for the multi-process multi-host tests (not a pytest
module).

Usage:
  python tests/multihost_driver.py <pid> <nproc> <port>               # check
  python tests/multihost_driver.py <pid> <nproc> <port> bench <local> \
      [nlog2 [batch]]                                                 # bench
  python tests/multihost_driver.py <pid> <nproc> <port> collectives <local>

check: each process contributes 4 virtual CPU devices; the global 8-device
mesh runs the sharded top-k pipeline; process 0 checks precision vs the
oracle and prints MULTIHOST_OK.

bench: each process contributes <local> devices; the global mesh runs the
INDEXED sharded refinement path with the hier (ICI/DCN) exchange grouped
at the process boundary, times batches, and process 0 prints one JSON line
— the multi-host rows of scripts/record_scaling.py.
``nlog2``/``batch`` size the RMAT graph (default 2^14 nodes x8 edges) and
the query batch (default 32): the round-3 toy config (300 nodes, batch 8)
had ~zero per-superstep compute, so its "efficiency" measured nothing but
gloo's per-collective TCP latency growth — see the collectives mode.

collectives: microbenchmark ONE psum over the global mesh, isolating the
cross-process collective latency that dominates the toy-scale bench
(process count grows -> more TCP hops per collective on 2 physical cores).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "check"
    local = int(sys.argv[5]) if len(sys.argv) > 5 else 4
    from fora.parallel import multihost
    multihost.init(f"localhost:{port}", nproc, pid,
                   local_cpu_devices=local)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from fora.algo import exact
    from fora.config import ForaConfig
    from fora.eval import metrics
    from fora.graph import generators
    from fora.parallel import ShardedForaEngine, make_mesh

    assert len(jax.devices()) == local * nproc, jax.devices()

    if mode == "collectives":
        from fora.parallel.mesh import GRAPH_AXIS, shard_map
        import jax.sharding as jsh
        mesh = make_mesh(local * nproc, 1)
        P = jsh.PartitionSpec
        x = jax.device_put(
            np.ones((local * nproc * 256, 32), np.float32),
            jsh.NamedSharding(mesh, P(GRAPH_AXIS)))
        fn = jax.jit(shard_map(
            lambda v: jax.lax.psum(v, GRAPH_AXIS), mesh,
            in_specs=(P(GRAPH_AXIS),), out_specs=P()))
        np.asarray(fn(x))                      # warm + fence
        # fence EVERY rep: an unfenced dispatch flood wedges the gloo
        # transport (measured: 50 queued psums never complete)
        reps, t0 = 20, time.time()
        for _ in range(reps):
            np.asarray(fn(x))
        us = (time.time() - t0) / reps * 1e6
        if pid == 0:
            print(json.dumps({
                "processes": nproc, "devices_per_process": local,
                "psum_us": round(us, 1)}), flush=True)
        return

    if mode == "bench":
        nlog2 = int(sys.argv[6]) if len(sys.argv) > 6 else 14
        batch = int(sys.argv[7]) if len(sys.argv) > 7 else 32
        from fora import index as widx
        from fora.graph import to_device
        g = generators.rmat(nlog2, (1 << nlog2) * 8, seed=7)
        rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
        mesh = make_mesh(local * nproc, 1)
        idx = widx.build_walk_index(to_device(g), rcfg, jax.random.key(0))
        eng = ShardedForaEngine(
            g, mesh, rcfg, k=10, index=idx, exchange="hier",
            chips_per_host=local)
        rng = np.random.default_rng(3)
        src0 = jnp.asarray(rng.integers(0, g.n, batch), jnp.int32)
        np.asarray(eng.topk(src0, jax.random.key(1)).values)  # warm + fence
        reps, t0 = 5, time.time()
        for i in range(reps):
            r = eng.topk(src0, jax.random.fold_in(jax.random.key(2), i))
            np.asarray(r.values)
        dt = (time.time() - t0) / reps
        if pid == 0:
            print(json.dumps({
                "processes": nproc, "devices_per_process": local,
                "graph_shards": local * nproc, "exchange": "hier",
                "indexed": True, "batch": batch, "nlog2": nlog2,
                "qps": round(batch / dt, 2),
                "ms_per_batch": round(dt * 1e3, 1)}), flush=True)
        return

    g = generators.erdos_renyi(300, 3000, seed=21)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    # 'graph' axis spans the processes (the DCN axis in a real pod)
    mesh = make_mesh(local * nproc, 1)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])

    eng = ShardedForaEngine(g, mesh, rcfg, k=10)
    res = eng.topk(jnp.asarray(sources), jax.random.key(1))
    ids = multihost.gather_to_host(res.node_ids)[: len(sources)]

    if pid == 0:
        exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                              for s in sources])
        prec = metrics.batch_precision_at_k(ids, exact_ids)
        assert prec >= 0.85, prec
        print(f"MULTIHOST_OK precision={prec:.3f}", flush=True)


if __name__ == "__main__":
    main()
