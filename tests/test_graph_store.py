"""Shard-aware GRAPH store (SURVEY.md Sec. 5.4: "each host loads only its
rows" — the graph half; the index half is tests/test_sharded.py's store
tests)."""

import jax
import numpy as np
import pytest

from fora import index as widx
from fora.config import ForaConfig
from fora.graph import generators, to_device
from fora.parallel import ShardedForaEngine, ShardedTopkRunner, make_mesh
from fora.parallel.graph_store import (ShardedGraphStore,
                                           save_sharded_graph)
from fora.parallel.partition import (needed_host_masks, needed_masks,
                                         partition_rows)


def _graph_and_cfg(n=300, m=3000, seed=21, eps=0.5, weighted=False):
    g = generators.erdos_renyi(n, m, seed=seed)
    if weighted:
        rng = np.random.default_rng(5)
        w = rng.uniform(0.5, 2.0, size=g.m).astype(np.float32)
        from fora.graph.csr import from_edges
        src = np.repeat(np.arange(g.n), np.asarray(g.out_deg, np.int64))
        g = from_edges(src, np.asarray(g.out_indices), g.n, w=w)
    rcfg = ForaConfig(epsilon=eps).resolved(g.n, g.m)
    return g, rcfg


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_store_matches_partition(tmp_path, weighted):
    """save_sharded_graph + ShardedGraphStore serve byte-identical arrays
    to an in-RAM partition_rows/_shard_csr, and per-shard on-disk bytes
    are ~1/G of the total."""
    from fora.index.build_sharded import _shard_csr

    g, _ = _graph_and_cfg(weighted=weighted)
    G = 4
    d = save_sharded_graph(g, tmp_path, G)
    assert d.exists()
    st = ShardedGraphStore(tmp_path, G)
    assert (st.n, st.m, st.weighted) == (g.n, g.m, weighted)

    pg = partition_rows(g, G)
    need = needed_masks(pg).reshape(G, G, pg.n_loc)
    n_loc_w, windptr, windices, _deg, ap, ao = _shard_csr(g, G)
    assert st.n_loc == pg.n_loc == n_loc_w and st.m_loc == pg.m_loc
    nl, ml = pg.n_loc, pg.m_loc
    total = 0
    for s in range(G):
        sh = st.shard(s)
        np.testing.assert_array_equal(
            sh["in_src_global"], pg.in_src_global[s * ml:(s + 1) * ml])
        np.testing.assert_array_equal(
            sh["in_dst_local"], pg.in_dst_local[s * ml:(s + 1) * ml])
        np.testing.assert_array_equal(
            sh["out_deg"], pg.out_deg_sharded[s * nl:(s + 1) * nl])
        np.testing.assert_array_equal(
            sh["needed"].astype(bool), need[s])
        np.testing.assert_array_equal(sh["walk_indptr"], windptr[s])
        np.testing.assert_array_equal(sh["walk_indices"], windices[s])
        if weighted:
            np.testing.assert_array_equal(
                sh["in_w"], pg.in_w_sharded[s * ml:(s + 1) * ml])
            np.testing.assert_array_equal(
                sh["out_wsum"], pg.out_wsum_sharded[s * nl:(s + 1) * nl])
            np.testing.assert_array_equal(sh["alias_prob"], ap[s])
            np.testing.assert_array_equal(sh["alias_other"], ao[s])
        # mmap-backed: bytes are touched lazily, per shard
        assert isinstance(sh["in_src_global"], np.memmap)
        total += st.bytes_per_shard(s)
    assert st.bytes_per_shard(0) <= total / G + 4096

    with pytest.raises(FileNotFoundError):
        ShardedGraphStore(tmp_path, 8)


def test_store_placement_equals_in_ram_placement(tmp_path):
    """A _ShardedPlacement built from the store device-places the same
    arrays as one built from the full CSR (routed exchange: includes the
    needed mask; hier: includes the derived per-host mask)."""
    from fora.parallel.sharded import _ShardedPlacement

    g, rcfg = _graph_and_cfg()
    G = 4
    save_sharded_graph(g, tmp_path, G)
    st = ShardedGraphStore(tmp_path, G)
    mesh = make_mesh(G, 2)
    for kw in (dict(exchange="routed"),
               dict(exchange="hier", chips_per_host=2)):
        a = _ShardedPlacement(g, mesh, None, with_walk_side=True, **kw)
        b = _ShardedPlacement(st, mesh, None, with_walk_side=True, **kw)
        assert a.exchange_cap == b.exchange_cap
        assert a.pg.n_loc == b.pg.n_loc and a.pg.m_loc == b.pg.m_loc
        for x, y in zip(a.push_args + a.walk_args,
                        b.push_args + b.walk_args):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # hier per-host mask derived from the per-chip file matches the
    # in-RAM needed_host_masks
    pg = partition_rows(g, G)
    np.testing.assert_array_equal(
        np.asarray(b.push_args[5]), needed_host_masks(pg, 2))


def test_sharded_runner_from_graph_store_matches(tmp_path):
    """The refinement pool fed from graph-store files returns the in-RAM
    graph's results bit-for-bit — including with the sharded INDEX store,
    i.e. a fully store-backed engine start with no global array."""
    from fora.index import store as widx_store

    g, rcfg = _graph_and_cfg()
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    G = 4
    save_sharded_graph(g, tmp_path, G)
    widx_store.save_sharded(idx, rcfg, tmp_path, G, graph=g)
    gst = ShardedGraphStore(tmp_path, G)
    ist = widx_store.ShardedIndexStore(tmp_path, G, rcfg, graph=g)

    mesh = make_mesh(G, 2)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    r_mem = ShardedTopkRunner(g, mesh, rcfg, idx, k=10,
                              exchange="routed").query_pool(
        sources, jax.random.key(7), batch=8)
    r_store = ShardedTopkRunner(gst, mesh, rcfg, ist, k=10,
                                exchange="routed").query_pool(
        sources, jax.random.key(7), batch=8)
    np.testing.assert_array_equal(r_store.node_ids, r_mem.node_ids)
    np.testing.assert_array_equal(r_store.values, r_mem.values)
    np.testing.assert_array_equal(r_store.accepted, r_mem.accepted)


def test_engine_from_graph_store_raw_walk(tmp_path):
    """Raw-walk mode (walk-side CSR slices) from the store matches the
    in-RAM engine bit-for-bit."""
    g, rcfg = _graph_and_cfg()
    G = 4
    save_sharded_graph(g, tmp_path, G)
    st = ShardedGraphStore(tmp_path, G)
    mesh = make_mesh(G, 2)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    import jax.numpy as jnp
    r_mem = ShardedForaEngine(g, mesh, rcfg, k=10).topk(
        jnp.asarray(sources), jax.random.key(1))
    r_store = ShardedForaEngine(st, mesh, rcfg, k=10).topk(
        jnp.asarray(sources), jax.random.key(1))
    np.testing.assert_array_equal(np.asarray(r_store.node_ids),
                                  np.asarray(r_mem.node_ids))
    np.testing.assert_array_equal(np.asarray(r_store.values),
                                  np.asarray(r_mem.values))


def test_graph_store_mismatch_guards(tmp_path):
    g, _ = _graph_and_cfg()
    save_sharded_graph(g, tmp_path, 4)
    st = ShardedGraphStore(tmp_path, 4)
    mesh = make_mesh(2, 4)
    with pytest.raises(ValueError, match="4-way"):
        from fora.parallel.sharded import _ShardedPlacement
        _ShardedPlacement(st, mesh, None)
    # store saved without walk side refuses raw-walk mode
    save_sharded_graph(g, tmp_path / "nw", 2, with_walk_side=False)
    st2 = ShardedGraphStore(tmp_path / "nw", 2)
    mesh2 = make_mesh(2, 4)
    with pytest.raises(ValueError, match="walk-side"):
        from fora.parallel.sharded import _ShardedPlacement
        _ShardedPlacement(st2, mesh2, None, with_walk_side=True)
