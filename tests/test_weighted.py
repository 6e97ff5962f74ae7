"""Weighted-graph path, end to end (SURVEY.md Sec. 2.1 checklist item 2):
optional third column in graph.txt -> per-edge weights -> weighted push
kernel (w/W transition fractions) + alias-table walk sampling + weighted
exact oracle + sharded parity.  Walks step v -> u w.p. w(v,u)/W(v)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fora import index as widx
from fora.algo import exact, fora
from fora.config import ForaConfig
from fora.eval import metrics
from fora.graph import generators, io, to_device
from fora.graph.csr import from_edges


def _weighted_graph(n=300, m=3000, seed=11):
    g0 = generators.erdos_renyi(n, m, seed=seed)
    src = np.repeat(np.arange(g0.n, dtype=np.int64),
                    np.asarray(g0.out_deg, np.int64))
    rng = np.random.default_rng(seed + 1)
    w = rng.uniform(0.1, 5.0, size=g0.m).astype(np.float32)
    return from_edges(src, np.asarray(g0.out_indices, np.int64), n, w=w)


def test_weighted_dataset_roundtrip(tmp_path):
    """save -> parse (native C++ 3-column fast path) -> identical graph."""
    g = _weighted_graph(n=50, m=400)
    io.save_dataset(g, str(tmp_path), "wg")
    g2 = io.load_dataset(str(tmp_path), "wg", use_cache=False)
    assert g2.weighted
    assert np.array_equal(g.out_indices, g2.out_indices)
    np.testing.assert_allclose(g.out_w, g2.out_w, rtol=1e-5)
    np.testing.assert_allclose(g.in_w, g2.in_w, rtol=1e-5)
    # cache round-trip preserves the optional weight fields
    g3 = io.load_dataset(str(tmp_path), "wg", use_cache=True)
    g4 = io.load_dataset(str(tmp_path), "wg", use_cache=True)
    for gx in (g3, g4):
        assert gx.weighted
        np.testing.assert_allclose(g.out_w, gx.out_w, rtol=1e-5)


def test_weighted_exact_dense_matches_power():
    g = _weighted_graph(n=120, m=900)
    for s in (0, 7, 64):
        d = exact.exact_ppr_dense(g, s)
        p = exact.exact_ppr_power(g, s, tol=1e-13)
        np.testing.assert_allclose(d, p, atol=1e-9)
    B = exact.exact_ppr_power_batch(g, [0, 7, 64], tol=1e-13)
    np.testing.assert_allclose(B[:, 1], exact.exact_ppr_dense(g, 7),
                               atol=1e-9)


def test_weighted_push_invariant_and_convergence():
    """The weighted push must preserve pi = p + sum_v r_v pi_v at every
    superstep; with rmax -> 0 the settled mass converges to exact PPR."""
    from fora.ops import push as push_ops
    g = _weighted_graph(n=80, m=600)
    dg = to_device(g)
    st = push_ops.forward_push(dg, jnp.asarray([3, 17], jnp.int32),
                               rmax=1e-7, alpha=0.2, max_iters=3000)
    want = np.stack([exact.exact_ppr_dense(g, 3), exact.exact_ppr_dense(g, 17)],
                    axis=1)
    np.testing.assert_allclose(np.asarray(st.p), want, atol=1e-4)


def test_weighted_fora_raw_walks_matches_oracle():
    g = _weighted_graph()
    rcfg = ForaConfig(epsilon=0.3).resolved(g.n, g.m)
    dg = to_device(g)
    fn = fora.make_fora_fn(dg, rcfg, max_lanes=1 << 20)
    sources = np.array([3, 17, 42, 99])
    res = fn(jnp.asarray(sources, jnp.int32), jax.random.key(0))
    _, ids = jax.lax.top_k(res.ppr.T, 10)
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(np.asarray(ids), exact_ids) >= 0.9


def test_weighted_fora_indexed_matches_oracle():
    """FORA+ index built with weighted walks serves weighted queries."""
    g = _weighted_graph()
    rcfg = ForaConfig(epsilon=0.3).resolved(g.n, g.m)
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(4))
    fn = fora.make_fora_fn(dg, rcfg, index=idx)
    sources = np.array([3, 17, 42, 99])
    res = fn(jnp.asarray(sources, jnp.int32), jax.random.key(0))
    _, ids = jax.lax.top_k(res.ppr.T, 10)
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(np.asarray(ids), exact_ids) >= 0.9


def test_weighted_merge_duplicates_matches_unmerged():
    """Parallel weighted edges merged by summing weights: identical push."""
    from fora.ops import push as push_ops
    rng = np.random.default_rng(3)
    n, m = 60, 500
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)   # collisions guaranteed
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    g = from_edges(src, dst, n, w=w)
    plain = to_device(g)
    merged = to_device(g, merge_duplicate_edges=True)
    assert merged.in_src.shape[0] < plain.in_src.shape[0]
    s = jnp.asarray([1, 2], jnp.int32)
    a = push_ops.forward_push(plain, s, rmax=1e-5, alpha=0.2, max_iters=2000)
    b = push_ops.forward_push(merged, s, rmax=1e-5, alpha=0.2, max_iters=2000)
    np.testing.assert_allclose(np.asarray(a.p), np.asarray(b.p), rtol=1e-5,
                               atol=1e-9)


def test_weighted_walk_endpoint_distribution():
    """chi^2: endpoints of 1-hop walks from a hub follow w/W, not 1/deg."""
    from fora.ops import walk as walk_ops
    n = 6
    src = np.zeros(5, np.int64)
    dst = np.arange(1, 6, dtype=np.int64)
    w = np.array([1.0, 2.0, 4.0, 8.0, 1.0], np.float32)
    g = from_edges(src, dst, n, w=w)
    dg = to_device(g)
    W = 20000
    start = jnp.zeros((W, 1), jnp.int32)
    # alpha tiny -> nearly all walks take >= 1 hop; endpoints are neighbors
    ends = np.asarray(walk_ops.run_walks(dg, start, jax.random.key(0),
                                         alpha=1e-6, max_hops=1))[:, 0]
    counts = np.bincount(ends, minlength=n)[1:]
    expect = w / w.sum() * counts.sum()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 20.0, (counts, expect)   # df=4, p<1e-3 at 18.5


def test_weighted_sharded_matches_oracle():
    from fora.parallel import ShardedForaEngine, ShardedTopkRunner, \
        make_mesh
    g = _weighted_graph()
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    mesh = make_mesh(4, 2)
    sources = np.array([3, 17, 42, 99, 123, 200, 250, 287])
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    eng = ShardedForaEngine(g, mesh, rcfg, k=10)
    res = eng.topk(jnp.asarray(sources), jax.random.key(1))
    assert metrics.batch_precision_at_k(np.asarray(res.node_ids),
                                        exact_ids) >= 0.85
    # indexed sharded refinement pool on the weighted graph
    dg = to_device(g)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    runner = ShardedTopkRunner(g, mesh, rcfg, idx, k=10, exchange="routed")
    pool = runner.query_pool(sources, jax.random.key(3), batch=8)
    assert metrics.batch_precision_at_k(pool.node_ids, exact_ids) >= 0.85


def test_weighted_bippr_matches_oracle():
    from fora.algo import bippr
    g = _weighted_graph(n=150, m=1200)
    rcfg = ForaConfig(epsilon=0.3).resolved(g.n, g.m)
    dg = to_device(g)
    targets = jnp.arange(g.n, dtype=jnp.int32)
    fn = bippr.make_bippr_fn(dg, rcfg, targets)
    sources = np.array([3, 17, 42])
    est = np.asarray(fn(jnp.asarray(sources, jnp.int32), jax.random.key(6)))
    ids = np.argsort(-est, axis=1)[:, :10]
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(ids, exact_ids) >= 0.8


def test_native_alias_matches_python_distribution():
    """The C++ alias builder and the Python Vose fallback induce the same
    per-neighbor sampling distribution (tables may differ in stack order)."""
    from fora._native import native_build_alias
    from fora.graph import alias as al
    if native_build_alias is None:
        pytest.skip("native library unavailable")
    g = _weighted_graph(n=100, m=1500)
    nat_p, nat_o = native_build_alias(np.asarray(g.out_indptr, np.int64),
                                      g.out_indices, g.out_w)

    def dist(prob, other):
        d = np.zeros((g.n, g.n))
        indptr = np.asarray(g.out_indptr, np.int64)
        for v in range(g.n):
            lo, hi = indptr[v], indptr[v + 1]
            for s in range(lo, hi):
                d[v, g.out_indices[s]] += prob[s] / (hi - lo)
                d[v, other[s]] += (1 - prob[s]) / (hi - lo)
        return d

    # compare against the exact weighted distribution directly
    want = np.zeros((g.n, g.n))
    indptr = np.asarray(g.out_indptr, np.int64)
    for v in range(g.n):
        lo, hi = indptr[v], indptr[v + 1]
        if hi == lo:
            continue
        np.add.at(want[v], g.out_indices[lo:hi],
                  g.out_w[lo:hi] / g.out_w[lo:hi].sum())
    np.testing.assert_allclose(dist(nat_p, nat_o), want, atol=1e-5)
