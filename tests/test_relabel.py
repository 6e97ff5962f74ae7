"""Relabeling (graph/relabel.py) is exactness-preserving: PPR, push, and
the FORA+ index are label-invariant, so any permutation may be applied for
gather locality without touching the accuracy contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fora import index as widx
from fora.algo import exact, fora
from fora.config import ForaConfig
from fora.graph import generators, relabel, to_device


@pytest.mark.parametrize("order", ["degree", "bfs", "random"])
def test_orders_are_permutations(order):
    g = generators.erdos_renyi(300, 2500, seed=5)
    if order == "degree":
        perm = relabel.degree_order(g)
    elif order == "bfs":
        perm = relabel.bfs_order(g)
    else:
        perm = np.random.default_rng(0).permutation(g.n).astype(np.int32)
    assert np.array_equal(np.sort(perm), np.arange(g.n))
    inv = relabel.invert(perm)
    assert np.array_equal(perm[inv], np.arange(g.n))


def test_degree_order_clusters_hubs():
    g = generators.rmat(10, 1 << 13, seed=3)
    perm = relabel.degree_order(g)
    rg = relabel.relabel_graph(g, perm)
    d = np.asarray(rg.out_deg, dtype=np.int64)
    assert np.array_equal(d, np.sort(d)[::-1])  # descending by new label


def test_relabel_graph_preserves_exact_ppr():
    g = generators.rmat(9, 1 << 12, seed=7)   # multigraph with dangling
    perm = relabel.bfs_order(g)
    rg = relabel.relabel_graph(g, perm)
    assert rg.m == g.m
    for s in (0, 3, 11):
        pi = exact.exact_ppr(g, s)
        pi_r = exact.exact_ppr(rg, int(perm[s]))
        np.testing.assert_allclose(pi_r[perm], pi, atol=1e-10)


def test_relabel_weighted_graph():
    rng = np.random.default_rng(2)
    from fora.graph.csr import from_edges
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    w = rng.random(400).astype(np.float32) + 0.1
    g = from_edges(src, dst, 50, w=w)
    perm = relabel.degree_order(g)
    rg = relabel.relabel_graph(g, perm)
    assert rg.weighted
    pi = exact.exact_ppr(g, 4)
    pi_r = exact.exact_ppr(rg, int(perm[4]))
    np.testing.assert_allclose(pi_r[perm], pi, atol=1e-10)


def test_relabel_index_matches_rebuilt_queries():
    """A FORA+ query on (relabeled graph, relabeled index) returns the
    original query's estimates under the permutation — the indexed walk
    phase is a deterministic SpMV, so this is exact equality up to f32
    reassociation."""
    g = generators.rmat(9, 1 << 12, seed=7)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))

    perm = relabel.degree_order(g)
    rg = relabel.relabel_graph(g, perm)
    ridx = relabel.relabel_index(idx, perm)
    rdg = to_device(rg)

    sources = np.asarray([0, 5, 17, 100], np.int32)
    fn = fora.make_fora_fn(dg, rcfg, index=idx)
    rfn = fora.make_fora_fn(rdg, rcfg, index=ridx)
    res = np.asarray(fn(jnp.asarray(sources), jax.random.key(2)).ppr)
    res_r = np.asarray(rfn(jnp.asarray(perm[sources]),
                           jax.random.key(2)).ppr)
    np.testing.assert_allclose(res_r[perm], res, rtol=1e-5, atol=1e-9)


def test_relabel_index_bucket_contract():
    """Relabeled index keeps the bucket partition and the dst-sorted-per-
    bucket layout pack_index guarantees."""
    g = generators.rmat(9, 1 << 12, seed=7)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(to_device(g), rcfg, jax.random.key(1))
    ridx = relabel.relabel_index(idx, relabel.bfs_order(g))
    assert ridx.total_edges == idx.total_edges
    offs = np.asarray(ridx.bucket_offsets)
    dst = np.asarray(ridx.edge_dst)
    for q in range(len(offs) - 1):
        seg = dst[offs[q]:offs[q + 1]]
        assert np.all(np.diff(seg) >= 0), q
