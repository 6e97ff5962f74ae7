"""HubPPR tests: hub-index structure, distributional equivalence of
hub-short-circuited walks vs the exact oracle, short-circuit execution,
pairwise bidirectional estimates vs exact PPR."""

import jax
import jax.numpy as jnp
import numpy as np

from fora.algo import exact, hubppr
from fora.config import ForaConfig
from fora.graph import generators, to_device


def test_hub_index_structure():
    g = generators.karate_club()
    dg = to_device(g)
    hub = hubppr.build_hub_index(dg, jax.random.key(0), alpha=0.2,
                                 num_hubs=5, pool_size=64)
    hubs = np.asarray(hub.hub_nodes)
    hub_id = np.asarray(hub.hub_id)
    assert hub.pool.shape == (5, 64)
    # slot map round-trips and marks exactly the hub rows
    assert np.all(hub_id[hubs] == np.arange(5))
    assert (hub_id >= 0).sum() == 5
    # hubs are the top-degree nodes (karate: 33, 0, 32 lead)
    score = g.out_deg.astype(int) + g.in_deg.astype(int)
    top = set(np.argsort(-score)[:5].tolist())
    assert set(hubs.tolist()) == top
    # pool endpoints are valid node ids
    assert np.asarray(hub.pool).min() >= 0
    assert np.asarray(hub.pool).max() < g.n


def test_hub_selection_excludes_dangling():
    g = generators.star_graph(6)   # center 0 -> dangling leaves
    hubs = hubppr.select_hubs(g.out_deg, g.in_deg, 4)
    assert hubs.tolist() == [0]    # only non-dangling node


def test_hub_walks_match_exact_ppr():
    """Endpoint frequencies with hub short-circuiting must match pi(s, .)
    exactly in distribution (walk_ops.run_walks' contract)."""
    g = generators.karate_club()
    dg = to_device(g)
    hub = hubppr.build_hub_index(dg, jax.random.key(1), alpha=0.2,
                                 num_hubs=6, pool_size=8192)
    W = 100_000
    start = jnp.full((W, 1), 11, jnp.int32)   # low-degree source
    ends = np.asarray(hubppr.hub_walks(dg, start, jax.random.key(2), hub,
                                       alpha=0.2)).ravel()
    freq = np.bincount(ends, minlength=g.n) / W
    pi = exact.exact_ppr_dense(g, 11)
    # pool sharing correlates lanes (~12 uses/entry here), so tolerance is
    # looser than the independent-walk test (0.02 there)
    assert np.abs(freq - pi).sum() < 0.06


def test_hub_walks_cycle_with_hub_on_path():
    """Cycle graph: every walk from 0 passes node 2 on hop 2, so nearly
    every lane exercises the substitution path; distribution must still
    match the exact chain."""
    n = 8
    g = generators.cycle_graph(n)
    dg = to_device(g)
    hub_nodes = np.array([2], np.int32)
    hub_id = np.full(n, -1, np.int32)
    hub_id[2] = 0
    # honest pool for node 2: plain walks
    from fora.ops import walk as walk_ops
    pool = walk_ops.run_walks(dg, jnp.full((4096, 1), 2, jnp.int32),
                              jax.random.key(3), alpha=0.2).T
    hub = hubppr.HubIndex(jnp.asarray(hub_nodes), jnp.asarray(hub_id),
                          jnp.asarray(pool))
    W = 60_000
    ends = np.asarray(hubppr.hub_walks(
        dg, jnp.zeros((W, 1), jnp.int32), jax.random.key(4), hub,
        alpha=0.2)).ravel()
    freq = np.bincount(ends, minlength=n) / W
    pi = exact.exact_ppr_dense(g, 0)
    assert np.abs(freq - pi).sum() < 0.03


def test_hub_walks_substitution_executes():
    """Poisoned pool proves arrivals at the hub really read the pool: on a
    cycle with hub at node 1, any walk surviving hop 1 must end at the
    poison node, and walks stopping at hop 0 end at the source."""
    n = 8
    g = generators.cycle_graph(n)
    dg = to_device(g)
    hub_id = np.full(n, -1, np.int32)
    hub_id[1] = 0
    poison = 5
    hub = hubppr.HubIndex(jnp.asarray(np.array([1], np.int32)),
                          jnp.asarray(hub_id),
                          jnp.full((1, 16), poison, jnp.int32))
    W = 20_000
    ends = np.asarray(hubppr.hub_walks(
        dg, jnp.zeros((W, 1), jnp.int32), jax.random.key(5), hub,
        alpha=0.2)).ravel()
    assert set(np.unique(ends)) <= {0, poison}
    # P(end at source) = alpha
    assert abs((ends == 0).mean() - 0.2) < 0.02


def test_hubppr_query_accuracy():
    """End-to-end make_hubppr_fn: on karate nearly every walk routes
    through one of 4 hubs, so accuracy is pool-noise dominated — the
    documented (1 + U/P) variance inflation bounds the tolerance (walks
    == pool size here, inflation <= 2x over plain MC's ~0.035 L1)."""
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.15).resolved(g.n, g.m)  # omega ~ 13K walks
    fn = hubppr.make_hubppr_fn(dg, rcfg, jax.random.key(6), num_hubs=4,
                               max_walks=1 << 15)
    src = jnp.asarray([0, 7, 20], jnp.int32)
    ppr = np.asarray(fn(src, jax.random.key(7)))
    for b, s in enumerate([0, 7, 20]):
        pi = exact.exact_ppr_dense(g, s)
        assert np.abs(ppr[:, b] - pi).sum() < 0.1
        # mass preserved exactly (every walk ends somewhere)
        np.testing.assert_allclose(ppr[:, b].sum(), 1.0, rtol=1e-5)


def test_hubppr_pairs_vs_exact():
    g = generators.erdos_renyi(40, 200, seed=9)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    hub = hubppr.build_hub_index(dg, jax.random.key(8), alpha=rcfg.alpha,
                                 num_hubs=6, pool_size=4096)
    sources = jnp.asarray([0, 3], jnp.int32)
    targets = jnp.asarray([1, 7, 11], jnp.int32)
    est = np.asarray(hubppr.hubppr_pairs(
        dg, sources, targets, jax.random.key(10), hub, rcfg=rcfg,
        rmax_b=1e-3, num_walks=30_000))
    for i, s in enumerate([0, 3]):
        pi = exact.exact_ppr_dense(g, s)
        for j, t in enumerate([1, 7, 11]):
            assert abs(est[i, j] - pi[t]) < 0.02
