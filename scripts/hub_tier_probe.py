"""Two-tier hub probe: does splitting the hub operand into TWO 64 MB tiers
(top 2^17 + next 2^17 out-degree sources) beat one 64 MB tier (H=2^17,
the default) or one 128 MB tier (H=2^18)?

Times a full judged-scale superstep (jax.block_until_ready) for each
layout.
Usage: python scripts/hub_tier_probe.py [--nlog2 22]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=22)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from fora.graph.csr import CSRGraph, to_device
    from fora.ops import push as push_ops

    z = np.load(ROOT / "bench_data" / f"rmat{args.nlog2}x16s7.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    B = args.batch
    rng = np.random.default_rng(0)
    r_host = (rng.random((g.n, B), np.float32) * 1e-3)
    chunk = 1 << 21

    def superstep_time(dg, extra_tiers=()):
        """One dense superstep: tail gather+scatter + hub tiers."""
        def step(dgx, p, r, tiers):
            thr = jnp.zeros((g.n, 1), jnp.float32)
            deg = dgx.out_deg.astype(jnp.float32)[:, None]
            dangling = deg == 0.0
            active = r > thr
            ar = jnp.where(active, r, 0.0)
            p = p + jnp.where(dangling, ar, 0.2 * ar)
            contrib = jnp.where(dangling, 0.0,
                                0.8 * ar / jnp.maximum(deg, 1e-30))
            rn = jnp.where(active, 0.0, r)
            rn = push_ops.gather_scatter_add(
                rn, contrib, dgx.in_src, dgx.in_dst, max_chunk=chunk,
                edge_w=dgx.in_w)
            if dgx.hub_split:
                rn = push_ops.gather_scatter_add(
                    rn, contrib[dgx.hub_ids], dgx.hub_src_local,
                    dgx.hub_dst, max_chunk=chunk, edge_w=dgx.hub_w)
            for ids, src_sl, dst_l, w in tiers:
                rn = push_ops.gather_scatter_add(
                    rn, contrib[ids], src_sl, dst_l, max_chunk=chunk,
                    edge_w=w)
            return p, rn

        stepj = jax.jit(step)
        p = jnp.zeros((g.n, B), jnp.float32)
        r = jnp.asarray(r_host)
        jax.block_until_ready(stepj(dg, p, r, extra_tiers))
        ts = []
        for _ in range(args.reps):
            t0 = time.time()
            out = stepj(dg, p, r, extra_tiers)
            jax.block_until_ready(out)
            ts.append(time.time() - t0)
        return min(ts)

    H = 1 << 17
    t1 = t2 = float("nan")
    if not int(__import__("os").environ.get("TIER_C_ONLY", "0")):
        # (a) one 64 MB tier (default)
        dg1 = to_device(g, merge_duplicate_edges=True, hub_rows=H,
                        pad_edges=chunk)
        t1 = superstep_time(dg1)
        print(f"one tier H=2^17: {t1*1e3:.0f} ms", flush=True)
        del dg1

        # (b) one 128 MB tier
        dg2 = to_device(g, merge_duplicate_edges=True, hub_rows=2 * H,
                        pad_edges=chunk)
        t2 = superstep_time(dg2)
        print(f"one tier H=2^18: {t2*1e3:.0f} ms", flush=True)
        del dg2

    # (c) two 64 MB tiers: top 2^17 and next 2^17.  Build from the
    # H=2^18 split: partition its hub edges by tier membership.
    dg3h = to_device(g, merge_duplicate_edges=True, hub_rows=2 * H,
                     pad_edges=0)
    hub_ids = np.asarray(dg3h.hub_ids)
    deg = np.asarray(g.out_deg, np.int64)
    order = np.argsort(-deg[hub_ids], kind="stable")
    tier1_slots = np.sort(order[:H])      # slots of the top-2^17 subset
    in_t1 = np.zeros(2 * H, bool)
    in_t1[tier1_slots] = True
    sl = np.asarray(dg3h.hub_src_local)
    dl = np.asarray(dg3h.hub_dst)
    w = np.asarray(dg3h.hub_w) if dg3h.hub_w is not None else None
    m1 = in_t1[sl]
    # remap tier slots to compact per-tier ids
    remap1 = np.cumsum(in_t1) - 1
    remap2 = np.cumsum(~in_t1) - 1
    import jax.numpy as jnp2
    tiers = []
    for mask, remap, ids in (
            (m1, remap1, hub_ids[in_t1]),
            (~m1, remap2, hub_ids[~in_t1])):
        s, d, ww = push_ops.pad_edge_arrays(
            g.n, chunk, remap[sl[mask]].astype(np.int32), dl[mask],
            None if w is None else w[mask])
        tiers.append((jnp2.asarray(ids.astype(np.int32)),
                      jnp2.asarray(s), jnp2.asarray(d),
                      None if ww is None else jnp2.asarray(ww)))
    dg3 = dg3h._replace(hub_ids=None, hub_src_local=None, hub_dst=None,
                        hub_w=None)
    # re-pad the tail
    s, d, ww = push_ops.pad_edge_arrays(
        g.n, chunk, np.asarray(dg3.in_src), np.asarray(dg3.in_dst),
        None if dg3.in_w is None else np.asarray(dg3.in_w))
    dg3 = dg3._replace(in_src=jnp2.asarray(s), in_dst=jnp2.asarray(d),
                       in_w=None if ww is None else jnp2.asarray(ww))
    t3 = superstep_time(dg3, tuple(tiers))
    print(f"two tiers 2x2^17: {t3*1e3:.0f} ms", flush=True)
    print(f"verdict: one64={t1*1e3:.0f} one128={t2*1e3:.0f} "
          f"two64={t3*1e3:.0f} ms", flush=True)


if __name__ == "__main__":
    main()
