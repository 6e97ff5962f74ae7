"""Sharded-pipeline tests on the virtual 8-device CPU mesh (SURVEY.md Sec. 4:
distributed-without-a-cluster via xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fora import index as widx
from fora.algo import exact
from fora.config import ForaConfig
from fora.eval import metrics
from fora.graph import generators, to_device
from fora.parallel import (ShardedForaEngine, ShardedTopkRunner,
                               exchange_bytes_model, make_mesh,
                               partition_rows, partition_index)
from fora.parallel.partition import needed_masks


def _graph_and_cfg(n=300, m=3000, seed=21, eps=0.5):
    g = generators.erdos_renyi(n, m, seed=seed)
    rcfg = ForaConfig(epsilon=eps).resolved(g.n, g.m)
    return g, rcfg


def test_partition_rows_covers_all_edges():
    g, _ = _graph_and_cfg()
    pg = partition_rows(g, 4)
    # every real edge appears exactly once with a correctly localized dst
    seen = []
    for s in range(4):
        src = pg.in_src_global[s * pg.m_loc:(s + 1) * pg.m_loc]
        dst = pg.in_dst_local[s * pg.m_loc:(s + 1) * pg.m_loc]
        real = dst < pg.n_loc
        seen += list(zip(src[real].tolist(),
                         (dst[real] + s * pg.n_loc).tolist()))
    assert sorted(seen) == sorted(zip(g.in_src.tolist(), g.in_dst.tolist()))


def test_partition_index_preserves_edges():
    """Sharded bucket slices hold exactly the global index edges, with
    localized src and per-bucket alignment."""
    g, rcfg = _graph_and_cfg(n=100, m=800)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(0))
    pg = partition_rows(g, 4)
    pi = partition_index(idx, 4, pg.n_loc)
    gsrc = np.asarray(idx.edge_src)
    gdst = np.asarray(idx.edge_dst)
    for q in range(widx.NUM_BUCKETS):
        glo, ghi = int(idx.bucket_offsets[q]), int(idx.bucket_offsets[q + 1])
        want = sorted(zip(gsrc[glo:ghi].tolist(), gdst[glo:ghi].tolist()))
        got = []
        for s in range(4):
            base = s * pi.e_loc_total
            lo = base + int(pi.bucket_local_offsets[q])
            hi = base + int(pi.bucket_local_offsets[q + 1])
            src_l = pi.edge_src_local[lo:hi]
            dst = pi.edge_dst[lo:hi]
            real = src_l < pg.n_loc
            got += list(zip((src_l[real] + s * pg.n_loc).tolist(),
                            dst[real].tolist()))
        assert sorted(got) == want, q
    # counts_cum rows land at their global node position
    assert np.array_equal(pi.counts_cum[: g.n], np.asarray(idx.counts_cum))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_topk_matches_oracle(mesh_shape):
    g, rcfg = _graph_and_cfg()
    mesh = make_mesh(*mesh_shape)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10)
    B = 8
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    res = eng.topk(jnp.asarray(sources), jax.random.key(1))
    assert not bool(np.asarray(res.walk_overflow).any())
    ids = np.asarray(res.node_ids)
    vals = np.asarray(res.values)
    assert np.all(np.diff(vals, axis=1) <= 1e-7)
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(ids, exact_ids) >= 0.85


def test_sharded_matches_single_device():
    """Same seed, same mesh split over graph only -> deterministic result,
    and consistent accuracy with the unsharded engine."""
    g, rcfg = _graph_and_cfg()
    mesh = make_mesh(4, 2)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10)
    r1 = eng.topk(jnp.arange(8), jax.random.key(5))
    r2 = eng.topk(jnp.arange(8), jax.random.key(5))
    assert np.array_equal(np.asarray(r1.node_ids), np.asarray(r2.node_ids))


def test_ragged_exchange_matches_dense():
    """The fixed-capacity ragged frontier exchange (SURVEY Sec. 2.3 EP-style
    routing) is a pure comm-layout change: results must match the dense
    all_gather path exactly for the same key, including supersteps that
    overflow capacity and fall back to dense."""
    g, rcfg = _graph_and_cfg()
    mesh = make_mesh(4, 2)
    dense = ShardedForaEngine(g, mesh, rcfg, k=10)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    want = dense.topk(jnp.asarray(sources), jax.random.key(5))
    for frac in (0.5, 0.02):   # ample capacity / mostly-fallback capacity
        eng = ShardedForaEngine(g, mesh, rcfg, k=10, ragged_exchange=True,
                                ragged_capacity_frac=frac)
        res = eng.topk(jnp.asarray(sources), jax.random.key(5))
        assert np.array_equal(np.asarray(res.node_ids),
                              np.asarray(want.node_ids)), frac
        np.testing.assert_allclose(np.asarray(res.values),
                                   np.asarray(want.values), rtol=1e-5)


def test_ragged_exchange_with_index():
    g, rcfg = _graph_and_cfg()
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    mesh = make_mesh(4, 2)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10, index=idx,
                            ragged_exchange=True)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    res = eng.topk(jnp.asarray(sources), jax.random.key(3))
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(np.asarray(res.node_ids),
                                        exact_ids) >= 0.85


def test_needed_masks_routing_metadata():
    """needed[s*G + t, i] iff shard t's in-edge list references shard s's
    local row i (the precomputed EP routing mask for the routed exchange)."""
    g, _ = _graph_and_cfg()
    G = 4
    pg = partition_rows(g, G)
    need = needed_masks(pg).reshape(G, G, pg.n_loc)
    for t in range(G):
        src = pg.in_src_global[t * pg.m_loc:(t + 1) * pg.m_loc]
        src = src[src < pg.n_pad]
        want = np.zeros((G, pg.n_loc), dtype=bool)
        s, i = np.divmod(src.astype(np.int64), pg.n_loc)
        want[s, i] = True
        assert np.array_equal(need[:, t, :], want), t


def test_routed_exchange_matches_dense():
    """The routed (all-to-all, owner-targeted) frontier exchange is a pure
    comm-layout change: bit-identical results vs the dense all_gather path,
    including capacity-overflow supersteps that fall back to dense."""
    g, rcfg = _graph_and_cfg()
    mesh = make_mesh(4, 2)
    dense = ShardedForaEngine(g, mesh, rcfg, k=10)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    want = dense.topk(jnp.asarray(sources), jax.random.key(5))
    for frac in (0.5, 0.02):   # ample capacity / mostly-fallback capacity
        eng = ShardedForaEngine(g, mesh, rcfg, k=10, exchange="routed",
                                ragged_capacity_frac=frac)
        res = eng.topk(jnp.asarray(sources), jax.random.key(5))
        assert np.array_equal(np.asarray(res.node_ids),
                              np.asarray(want.node_ids)), frac
        np.testing.assert_allclose(np.asarray(res.values),
                                   np.asarray(want.values), rtol=1e-5)


def test_routed_exchange_with_index():
    g, rcfg = _graph_and_cfg()
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    mesh = make_mesh(4, 2)
    dense = ShardedForaEngine(g, mesh, rcfg, k=10, index=idx)
    routed = ShardedForaEngine(g, mesh, rcfg, k=10, index=idx,
                               exchange="routed")
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    want = dense.topk(jnp.asarray(sources), jax.random.key(3))
    res = routed.topk(jnp.asarray(sources), jax.random.key(3))
    assert np.array_equal(np.asarray(res.node_ids),
                          np.asarray(want.node_ids))


def test_exchange_bytes_model_ordering():
    """Routed wire volume beats the compact broadcast, which beats dense,
    once the frontier is sparse (the point of SURVEY Sec. 2.3 EP routing —
    the model backs scaling_test's bytes-per-superstep report)."""
    kw = dict(n_loc=65536, batch=128, G=8)
    dense = exchange_bytes_model("dense", **kw)
    compact = exchange_bytes_model("compact", cap=1024, **kw)
    routed = exchange_bytes_model("routed", cap=1024, **kw)
    assert dense > compact
    # routed pads per-destination but sends to G-1 peers like compact
    assert routed <= compact < dense


def test_sharded_pool_matches_single_chip():
    """Refinement parity (VERDICT round-1 item 3): the sharded delta-halving
    pool runner returns the same accepted sets and node ids as the
    single-chip TopkRunner on the same graph + index (indexed mode is
    deterministic — the only differences are float reassociation in the
    sharded segment sums)."""
    from fora.algo.topk import TopkRunner
    g, rcfg = _graph_and_cfg(n=400, m=4000)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(7))
    single = TopkRunner(dg, rcfg, k=10, index=idx)
    mesh = make_mesh(4, 2)
    sharded = ShardedTopkRunner(g, mesh, rcfg, idx, k=10)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287, 311, 399])
    key = jax.random.key(11)
    want = single.query_pool(sources, key, batch=8)
    got = sharded.query_pool(sources, key, batch=8)
    assert np.array_equal(want.accepted, got.accepted)
    assert np.array_equal(want.node_ids, got.node_ids)
    np.testing.assert_allclose(want.values, got.values, rtol=1e-4)
    # per-node guarantee statement survives the sharded path
    np.testing.assert_allclose(want.lower_bounds, got.lower_bounds,
                               rtol=1e-4)
    assert np.all(got.lower_bounds <= got.values + 1e-7)
    assert np.all(got.values <= got.upper_bounds + 1e-7)


def test_hier_exchange_matches_dense():
    """The hierarchical (cross-host all_to_all + intra-host all_gather)
    exchange is a pure comm-layout change: bit-identical results vs the
    dense path on a 4-shard graph axis modeled as 2 hosts x 2 chips,
    including capacity-overflow fallback supersteps."""
    g, rcfg = _graph_and_cfg()
    mesh = make_mesh(4, 2)
    dense = ShardedForaEngine(g, mesh, rcfg, k=10)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    want = dense.topk(jnp.asarray(sources), jax.random.key(5))
    for frac in (0.5, 0.02):
        eng = ShardedForaEngine(g, mesh, rcfg, k=10, exchange="hier",
                                chips_per_host=2,
                                ragged_capacity_frac=frac)
        res = eng.topk(jnp.asarray(sources), jax.random.key(5))
        assert np.array_equal(np.asarray(res.node_ids),
                              np.asarray(want.node_ids)), frac
        np.testing.assert_allclose(np.asarray(res.values),
                                   np.asarray(want.values), rtol=1e-5)


def test_hier_exchange_pool_runner():
    g, rcfg = _graph_and_cfg(n=400, m=4000)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(7))
    mesh = make_mesh(4, 2)
    dense = ShardedTopkRunner(g, mesh, rcfg, idx, k=10)
    hier = ShardedTopkRunner(g, mesh, rcfg, idx, k=10, exchange="hier",
                             chips_per_host=2)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    key = jax.random.key(11)
    want = dense.query_pool(sources, key, batch=8)
    got = hier.query_pool(sources, key, batch=8)
    assert np.array_equal(want.node_ids, got.node_ids)


def test_needed_host_masks_and_dcn_bytes():
    """Host masks OR the chip masks; hier's DCN volume beats routed's
    whenever a row is needed by >1 chip of a host (the staging's point)."""
    from fora.parallel.partition import needed_host_masks
    g, _ = _graph_and_cfg()
    G, C = 4, 2
    pg = partition_rows(g, G)
    chip = needed_masks(pg).reshape(G, G, pg.n_loc)
    host = needed_host_masks(pg, C).reshape(G, G // C, pg.n_loc)
    want = chip.reshape(G, G // C, C, pg.n_loc).any(axis=2)
    assert np.array_equal(host, want)
    kw = dict(n_loc=65536, batch=128, G=8, cap=1024)
    routed = exchange_bytes_model("routed", **kw)
    hier_dcn = exchange_bytes_model("hier", chips_per_host=4, **kw)
    assert hier_dcn < routed / 4   # (H-1) pairs vs (G-1)


def test_sharded_pool_routed_exchange():
    g, rcfg = _graph_and_cfg(n=400, m=4000)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(7))
    mesh = make_mesh(4, 2)
    dense = ShardedTopkRunner(g, mesh, rcfg, idx, k=10)
    routed = ShardedTopkRunner(g, mesh, rcfg, idx, k=10, exchange="routed")
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    key = jax.random.key(11)
    want = dense.query_pool(sources, key, batch=8)
    got = routed.query_pool(sources, key, batch=8)
    assert np.array_equal(want.node_ids, got.node_ids)


def test_sharded_with_index():
    g, rcfg = _graph_and_cfg()
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    mesh = make_mesh(4, 2)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10, index=idx)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    res = eng.topk(jnp.asarray(sources), jax.random.key(3))
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(np.asarray(res.node_ids),
                                        exact_ids) >= 0.85


def test_sharded_index_store_matches_partition(tmp_path):
    """save_sharded + ShardedIndexStore serve byte-identical arrays to an
    in-RAM partition_index of the monolithic index, and per-shard on-disk
    load is ~1/G of the total (the SURVEY Sec. 5.4 contract: each host
    reads only its rows)."""
    from fora.index import store as widx_store
    from fora.parallel.partition import partition_rows

    g, rcfg = _graph_and_cfg(n=200, m=2000)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    G = 4
    d = widx_store.save_sharded(idx, rcfg, tmp_path, G, graph=g)
    assert d.exists()
    st = widx_store.ShardedIndexStore(tmp_path, G, rcfg, graph=g)

    pg = partition_rows(g, G)
    assert st.n_loc == pg.n_loc
    pi = partition_index(idx, G, pg.n_loc)
    assert st.e_loc_total == pi.e_loc_total
    assert np.array_equal(st.bucket_local_offsets, pi.bucket_local_offsets)
    e, nl = pi.e_loc_total, pg.n_loc
    total = 0
    for s in range(G):
        sh = st.shard(s)
        np.testing.assert_array_equal(
            sh["edge_src_local"], pi.edge_src_local[s * e:(s + 1) * e])
        np.testing.assert_array_equal(
            sh["edge_dst"], pi.edge_dst[s * e:(s + 1) * e])
        np.testing.assert_array_equal(
            sh["counts_cum"], pi.counts_cum[s * nl:(s + 1) * nl])
        if pi.edge_mult is not None:
            np.testing.assert_array_equal(
                sh["edge_mult"], pi.edge_mult[s * e:(s + 1) * e])
        total += st.bytes_per_shard(s)
    # bytes model: every shard loads ~1/G of the total (equal by padding)
    assert st.bytes_per_shard(0) <= total / G + 4096

    # identity/compat guards
    with pytest.raises(FileNotFoundError):
        widx_store.ShardedIndexStore(tmp_path, 8)
    wrong = ForaConfig(epsilon=0.1).resolved(g.n, g.m)   # finer than built
    with pytest.raises(ValueError):
        widx_store.ShardedIndexStore(tmp_path, G, wrong)


def test_sharded_runner_from_store_matches_in_memory(tmp_path):
    """The refinement pool fed from the shard files returns the in-memory
    index's results bit-for-bit (same partitioned layout, same programs)."""
    from fora.index import store as widx_store

    g, rcfg = _graph_and_cfg()
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    G = 4
    widx_store.save_sharded(idx, rcfg, tmp_path, G, graph=g)
    st = widx_store.ShardedIndexStore(tmp_path, G, rcfg, graph=g)
    assert st.depth_for(rcfg.omega_unit, rcfg.rmax) == \
        idx.depth_for(rcfg.omega_unit, rcfg.rmax)

    mesh = make_mesh(4, 2)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    r_mem = ShardedTopkRunner(g, mesh, rcfg, idx, k=10).query_pool(
        sources, jax.random.key(7), batch=8)
    r_store = ShardedTopkRunner(g, mesh, rcfg, st, k=10).query_pool(
        sources, jax.random.key(7), batch=8)
    np.testing.assert_array_equal(r_store.node_ids, r_mem.node_ids)
    np.testing.assert_array_equal(r_store.values, r_mem.values)
    np.testing.assert_array_equal(r_store.accepted, r_mem.accepted)


def test_raw_walk_no_replicated_csr():
    """The raw-walk sharded engine places only per-shard CSR slices on the
    'graph' axis — no O(m) replicated array remains in the query path
    (SURVEY Sec. 5.7; retires the round-2 'v1 replication')."""
    g, rcfg = _graph_and_cfg()
    mesh = make_mesh(4, 2)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10)
    from fora.parallel.mesh import GRAPH_AXIS
    for a in eng._args:
        sh = a.sharding
        spec = sh.spec
        if a.ndim and a.shape[0] >= g.m:     # any m-sized leading axis
            assert spec and spec[0] == GRAPH_AXIS, (a.shape, spec)
    # per-shard walk-side bytes ~ m/G, not m
    walk_indices = eng._args[7]              # indices slice arg
    assert walk_indices.shape[0] <= 2 * g.m  # padded G * m_loc
    shard_rows = walk_indices.shape[0] // 4
    assert shard_rows < g.m                  # strictly smaller than full m


def test_partition_rows_hub_split_covers_all_edges():
    """hub_rows splits each shard's in-edges into tail + hub partitions;
    together they cover every edge exactly once, hub sources are exactly
    the global top-H out-degree nodes, and the routed-exchange needed
    masks still include hub sources."""
    g, _ = _graph_and_cfg(n=300, m=3000)
    H = 16
    pg = partition_rows(g, 4, hub_rows=H)
    assert pg.hub_split and len(pg.hub_ids) == H
    deg = np.asarray(g.out_deg)
    want_hubs = np.sort(np.argsort(-deg.astype(np.int64),
                                   kind="stable")[:H])
    np.testing.assert_array_equal(pg.hub_ids, want_hubs)
    seen = []
    for s in range(4):
        src = pg.in_src_global[s * pg.m_loc:(s + 1) * pg.m_loc]
        dst = pg.in_dst_local[s * pg.m_loc:(s + 1) * pg.m_loc]
        real = dst < pg.n_loc
        assert not np.isin(src[real], pg.hub_ids).any()
        seen += list(zip(src[real].tolist(),
                         (dst[real] + s * pg.n_loc).tolist()))
        hsl = pg.hub_src_slot_sharded[s * pg.mh_loc:(s + 1) * pg.mh_loc]
        hdl = pg.hub_dst_local_sharded[s * pg.mh_loc:(s + 1) * pg.mh_loc]
        hreal = hdl < pg.n_loc
        seen += list(zip(pg.hub_ids[hsl[hreal]].tolist(),
                         (hdl[hreal] + s * pg.n_loc).tolist()))
    assert sorted(seen) == sorted(zip(g.in_src.tolist(), g.in_dst.tolist()))
    # needed masks: the hub-split partition must route the same sources
    plain = needed_masks(partition_rows(g, 4))
    np.testing.assert_array_equal(needed_masks(pg), plain)


@pytest.mark.parametrize("exchange", ["dense", "routed"])
def test_sharded_runner_hub_split_matches_plain(exchange):
    """Per-shard hub split is exactness-neutral: same edges, same weights,
    two sorted segment sums instead of one — the refinement pool must
    return identical ids/acceptance and values to float round-off."""
    g, rcfg = _graph_and_cfg(n=400, m=4000)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(7))
    mesh = make_mesh(4, 2)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287, 311, 399])
    key = jax.random.key(11)
    plain = ShardedTopkRunner(g, mesh, rcfg, idx, k=10,
                              exchange=exchange).query_pool(
        sources, key, batch=8)
    hub = ShardedTopkRunner(g, mesh, rcfg, idx, k=10, exchange=exchange,
                            hub_rows=32).query_pool(
        sources, key, batch=8)
    assert np.array_equal(plain.accepted, hub.accepted)
    assert np.array_equal(plain.node_ids, hub.node_ids)
    np.testing.assert_allclose(plain.values, hub.values, rtol=1e-5)


def test_sharded_engine_hub_split_matches_plain():
    """The one-shot fused engine (raw-walk mode) with hub_rows: identical
    walk phase (hub split only touches push), so top-k must match the
    plain engine bit-for-bit given the same key."""
    g, rcfg = _graph_and_cfg(n=300, m=3000)
    mesh = make_mesh(4, 2)
    srcs = np.array([1, 5, 9, 13, 100, 150, 200, 299])
    key = jax.random.key(5)
    plain = ShardedForaEngine(g, mesh, rcfg, k=8).topk(srcs, key)
    hub = ShardedForaEngine(g, mesh, rcfg, k=8, hub_rows=32).topk(srcs, key)
    np.testing.assert_array_equal(np.asarray(plain.node_ids),
                                  np.asarray(hub.node_ids))
    np.testing.assert_allclose(np.asarray(plain.values),
                               np.asarray(hub.values), rtol=1e-5)
