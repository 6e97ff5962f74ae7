"""Walk-phase tests: geometric lengths, endpoint distribution vs exact PPR,
lane allocation, dangling restart, alias-table sampling path."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from fora.algo import exact
from fora.graph import build_alias, generators, to_device
from fora.ops import walk as walk_ops


def test_geometric_lengths_distribution():
    alpha = 0.2
    lens = np.asarray(walk_ops.geometric_lengths(
        jax.random.key(0), (200_000, 1), alpha, max_hops=64)).ravel()
    # E[len] = (1-a)/a = 4; P(len=0) = a
    assert abs(lens.mean() - 4.0) < 0.05
    assert abs((lens == 0).mean() - alpha) < 0.005


def test_walk_endpoints_match_exact_ppr():
    """Endpoint frequencies of walks from node v estimate pi_v."""
    g = generators.karate_club()
    dg = to_device(g)
    W = 100_000
    start = jnp.zeros((W, 1), jnp.int32)
    ends = np.asarray(walk_ops.run_walks(
        dg, start, jax.random.key(1), alpha=0.2)).ravel()
    freq = np.bincount(ends, minlength=g.n) / W
    pi = exact.exact_ppr_dense(g, 0)
    assert np.abs(freq - pi).sum() < 0.02  # L1; MC noise ~ sqrt(n/W)


def test_walk_dangling_absorbs():
    """Star graph: a walk on a dangling leaf ends there; a walk from the hub
    either stops at the hub (alpha) or is absorbed at a uniform leaf."""
    n, alpha = 5, 0.2
    g = generators.star_graph(n)
    dg = to_device(g)
    W = 40_000
    # from a dangling leaf: endpoint is always the leaf itself
    start = jnp.full((W, 1), 3, jnp.int32)
    ends = np.asarray(walk_ops.run_walks(
        dg, start, jax.random.key(2), alpha=alpha)).ravel()
    assert np.all(ends == 3)
    # from the hub: matches the absorbing-chain exact PPR
    start = jnp.zeros((W, 1), jnp.int32)
    ends = np.asarray(walk_ops.run_walks(
        dg, start, jax.random.key(3), alpha=alpha)).ravel()
    freq = np.bincount(ends, minlength=n) / W
    expected = exact.exact_ppr_dense(g, 0, alpha=alpha)
    np.testing.assert_allclose(freq, expected, atol=0.01)


def test_allocate_walks_matches_numpy():
    rng = np.random.default_rng(3)
    n, B, W = 50, 3, 64
    r = rng.random((n, B)).astype(np.float32) * (rng.random((n, B)) < 0.3)
    omega_unit = 7.0
    alloc = walk_ops.allocate_walks(jnp.asarray(r), omega_unit, W)
    omega_v = np.where(r > 0, np.ceil(r * np.float32(omega_unit)), 0).astype(int)
    for b in range(B):
        total = omega_v[:, b].sum()
        assert int(alloc.total[b]) == total
        lane = 0
        for v in range(n):
            for j in range(omega_v[v, b]):
                if lane >= W:
                    break
                assert int(alloc.start[lane, b]) == v
                assert int(alloc.walk_idx[lane, b]) == j
                np.testing.assert_allclose(
                    float(alloc.weight[lane, b]),
                    r[v, b] / omega_v[v, b], rtol=1e-5)
                lane += 1
        # invalid lanes carry zero weight
        if total < W:
            assert float(np.asarray(alloc.weight)[total:, b].sum()) == 0.0
        assert bool(alloc.overflow[b]) == (total > W)
    # sum of weights == rsum (estimator preserves residue mass exactly)
    for b in range(B):
        if int(alloc.total[b]) <= W:
            np.testing.assert_allclose(float(alloc.weight[:, b].sum()),
                                       r[:, b].sum(), rtol=1e-4)


def test_alias_sampling_path_uniform_equivalence():
    """With uniform alias tables the weighted path must match unweighted
    statistics (same exact PPR target)."""
    g = generators.karate_club()
    dg = to_device(g)
    t = build_alias(g)
    W = 50_000
    start = jnp.zeros((W, 1), jnp.int32)
    ends = np.asarray(walk_ops.run_walks(
        dg, start, jax.random.key(4), alpha=0.2,
        alias_prob=jnp.asarray(t.prob), alias_other=jnp.asarray(t.other),
    )).ravel()
    freq = np.bincount(ends, minlength=g.n) / W
    pi = exact.exact_ppr_dense(g, 0)
    assert np.abs(freq - pi).sum() < 0.03


def test_walk_lane_budget_static():
    w = walk_ops.walk_lane_budget(omega_unit=1e6, rmax=1e-5, m=10_000,
                                  n=1000, cap=1 << 20)
    assert w % 1024 == 0 and w <= 1 << 20
    # rsum bound = 0.1 -> ~110k lanes + n
    assert 100_000 <= w <= 120_000 + 2048


def test_scheduled_walk_matches_distribution():
    """run_walks_scheduled endpoints follow the same distribution as the
    plain lockstep walk: endpoint frequencies from a single hub source
    match exact PPR (both kernels, same tolerance)."""
    from fora.algo import exact
    from fora.graph import generators, to_device

    g = generators.erdos_renyi(60, 600, seed=9)
    dg = to_device(g)
    W = 1 << 15
    src = 7
    start = jnp.full((W,), src, jnp.int32)
    ep, ok = walk_ops.run_walks_scheduled(dg, start, jax.random.key(4),
                                      alpha=0.2, max_hops=64)
    assert bool(ok)
    freq = np.bincount(np.asarray(ep), minlength=g.n) / W
    pi = exact.exact_ppr(g, src)
    # PPR = alpha-walk endpoint distribution; MC error ~ 1/sqrt(W)
    assert np.abs(freq - pi).max() < 6.0 / np.sqrt(W)


def test_scheduled_walk_overflow_flag():
    """A schedule too tight for the sampled lengths reports ok=False (the
    builder then falls back to the plain kernel)."""
    from fora.graph import generators, to_device

    g = generators.erdos_renyi(60, 600, seed=9)
    dg = to_device(g)
    start = jnp.zeros((1024,), jnp.int32)
    ep, ok = walk_ops.run_walks_scheduled(dg, start, jax.random.key(4),
                                      alpha=0.2, max_hops=16,
                                      slack=1e-6, margin=0)
    assert not bool(ok)


def test_hop_widths_schedule():
    ws = walk_ops.hop_widths(1 << 20, 0.2, 64)
    assert ws[0] == 1 << 20
    assert all(a >= b for a, b in zip(ws, ws[1:]))   # non-increasing
    assert all(w % 128 == 0 for w in ws)
    # total scheduled work ~ W/alpha, far below W*max_hops
    assert sum(ws) < (1 << 20) * 8
