"""End-to-end FORA tests: accuracy guarantee vs oracle, top-k refinement,
Monte-Carlo competitor (SURVEY.md Sec. 4 statistical strategy)."""

import jax
import jax.numpy as jnp
import numpy as np

from fora.algo import exact, fora, montecarlo, topk as topk_algo
from fora.config import ForaConfig
from fora.eval import metrics
from fora.graph import generators, to_device
from fora.ops import topk as topk_ops


def test_fora_karate_accuracy():
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    fn = fora.make_fora_fn(dg, rcfg)
    sources = jnp.array([0, 16, 33])
    res = fn(sources, jax.random.key(0))
    assert not bool(res.walk_overflow.any())
    ppr = np.asarray(res.ppr, dtype=np.float64)
    for b, s in enumerate([0, 16, 33]):
        pi = exact.exact_ppr_dense(g, int(s))
        # guarantee: relative error <= eps on pi > delta (whp; fixed seed)
        assert metrics.max_relative_error(ppr[:, b], pi, rcfg.delta) <= 0.5
        # precision@5 vs oracle
        vals, idx = topk_ops.topk_nodes(res.ppr, 5)
        assert metrics.precision_at_k(np.asarray(idx[b]),
                                      exact.exact_topk(g, int(s), 5)[0]) >= 0.8


def test_fora_er_batch_precision():
    g = generators.erdos_renyi(500, 5000, seed=11)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    fn = fora.make_fora_fn(dg, rcfg)
    sources = np.array([3, 77, 200, 412])
    res = fn(jnp.asarray(sources), jax.random.key(1))
    vals, idx = topk_ops.topk_nodes(res.ppr, 10)
    exact_ids = np.stack([exact.exact_topk(g, int(s), 10)[0] for s in sources])
    assert metrics.batch_precision_at_k(np.asarray(idx), exact_ids) >= 0.9


def test_fora_estimate_unbiased_mass():
    """Total estimated mass ~ 1 (p-mass + walk weights = 1 exactly)."""
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    fn = fora.make_fora_fn(dg, rcfg)
    res = fn(jnp.array([4]), jax.random.key(2))
    np.testing.assert_allclose(float(res.ppr.sum()), 1.0, rtol=1e-4)


def test_topk_runner_karate():
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=5).resolved(g.n, g.m)
    runner = topk_algo.TopkRunner(dg, rcfg)
    res = runner.query(jnp.array([0, 33]), jax.random.key(3))
    for b, s in enumerate([0, 33]):
        ex_ids, _ = exact.exact_topk(g, s, 5)
        assert metrics.precision_at_k(res.node_ids[b], ex_ids) >= 0.8
    assert res.levels_used <= len(runner.deltas)


def test_topk_delta_schedule():
    rcfg = ForaConfig(epsilon=0.5, k=50).resolved(10_000, 100_000)
    sched = topk_algo.delta_schedule(rcfg, 50)
    assert sched[0] == 1.0 / 50
    assert sched[-1] == rcfg.delta
    assert all(a > b for a, b in zip(sched, sched[1:]))


def test_montecarlo_matches_exact():
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, delta=0.01, pfail=0.01).resolved(g.n, g.m)
    fn = montecarlo.make_montecarlo_fn(dg, rcfg, max_walks=100_000)
    est = np.asarray(fn(jnp.array([0]), jax.random.key(4)))[:, 0]
    pi = exact.exact_ppr_dense(g, 0)
    # omega ~ 5k walks from the config derivation -> expected L1 ~ 0.045
    assert np.abs(est - pi).sum() < 0.12


def test_fora_deterministic_given_key():
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    fn = fora.make_fora_fn(dg, rcfg)
    a = fn(jnp.array([7]), jax.random.key(5))
    b = fn(jnp.array([7]), jax.random.key(5))
    assert np.array_equal(np.asarray(a.ppr), np.asarray(b.ppr))


def test_topk_query_pool_matches_query():
    """Level-pipelined pool scheduling returns the same accepted top-k sets
    as the all-advance batch loop."""
    from fora.algo import topk as topk_algo
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    runner = topk_algo.TopkRunner(dg, rcfg, k=8)
    sources = np.arange(20)
    pool = runner.query_pool(sources, jax.random.key(9), batch=8)
    assert pool.node_ids.shape == (20, 8)
    assert pool.accepted.all()
    exact_ids = np.stack([exact.exact_topk(g, int(s), 8)[0] for s in sources])
    assert metrics.batch_precision_at_k(pool.node_ids, exact_ids) >= 0.85


def test_topk_query_pool_adaptive_width():
    """With batch > 128, straggler levels re-batch at narrower widths
    (>= 128) and results still match the exact oracle."""
    from fora.algo import topk as topk_algo
    g = generators.erdos_renyi(500, 6000, seed=17)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    runner = topk_algo.TopkRunner(dg, rcfg, k=8)
    sources = np.arange(300) % g.n
    pool = runner.query_pool(sources, jax.random.key(11), batch=256)
    assert pool.node_ids.shape == (300, 8)
    assert pool.accepted.all()
    widths = [st["width"] for st in runner.last_level_stats]
    assert widths[0] == 256
    assert all(w >= 128 and 256 % w == 0 for w in widths)
    # stragglers after level 0 must not pay full-pool padding
    if len(widths) > 1 and runner.last_level_stats[1]["pending"] <= 128:
        assert widths[1] == 128
    exact_ids = np.stack([exact.exact_topk(g, int(s), 8)[0]
                          for s in sources[:40]])
    assert metrics.batch_precision_at_k(pool.node_ids[:40], exact_ids) >= 0.85


def test_topk_query_pool_adaptive_start_level():
    """A second pool run skips levels that accepted nothing in the first,
    with identical acceptance and matching results."""
    from fora.algo import topk as topk_algo
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    runner = topk_algo.TopkRunner(dg, rcfg, k=8)
    sources = np.arange(20)
    first = runner.query_pool(sources, jax.random.key(9), batch=8)
    assert first.accepted.all()
    start = runner.auto_start_level
    first_levels = [st["level"] for st in runner.last_level_stats]
    assert first_levels[0] == 0
    second = runner.query_pool(sources, jax.random.key(10), batch=8)
    second_levels = [st["level"] for st in runner.last_level_stats]
    assert second_levels[0] == start
    assert second.accepted.all()
    exact_ids = np.stack([exact.exact_topk(g, int(s), 8)[0] for s in sources])
    assert metrics.batch_precision_at_k(second.node_ids, exact_ids) >= 0.85
    # explicit start_level=0 restores the full schedule
    runner.query_pool(sources[:8], jax.random.key(11), batch=8,
                      start_level=0)
    assert runner.last_level_stats[0]["level"] == 0


def test_level_stats_persist_across_runners(tmp_path):
    """The learned start level survives process restarts via the persisted
    stats file — keyed by graph content + config, so a different graph or
    config refuses the record instead of inheriting a wrong start level."""
    from fora.algo import topk as topk_algo
    from fora.index.store import graph_fingerprint
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    sha = graph_fingerprint(g)
    path = tmp_path / "level_stats.json"

    r1 = topk_algo.TopkRunner(dg, rcfg, k=8)
    sources = np.arange(20)
    r1.query_pool(sources, jax.random.key(9), batch=8)
    r1.save_level_stats(path, sha)

    # cold runner adopts the start level and skips the dead levels
    r2 = topk_algo.TopkRunner(dg, rcfg, k=8)
    assert r2.load_level_stats(path, sha)
    assert r2.auto_start_level == r1.auto_start_level
    res = r2.query_pool(sources, jax.random.key(10), batch=8)
    assert res.accepted.all()
    assert r2.last_level_stats[0]["level"] == r1.auto_start_level
    exact_ids = np.stack([exact.exact_topk(g, int(s), 8)[0] for s in sources])
    assert metrics.batch_precision_at_k(res.node_ids, exact_ids) >= 0.85

    # wrong graph content: refused
    r3 = topk_algo.TopkRunner(dg, rcfg, k=8)
    assert not r3.load_level_stats(path, "deadbeef")
    assert r3.auto_start_level == 0
    # wrong config (different k -> different schedule fingerprint): refused
    rk = topk_algo.TopkRunner(dg, ForaConfig(epsilon=0.5, k=4)
                              .resolved(g.n, g.m), k=4)
    assert not rk.load_level_stats(path, sha)
    # missing / corrupt file: refused, not raised
    assert not r3.load_level_stats(tmp_path / "nope.json", sha)
    (tmp_path / "bad.json").write_text("{")
    assert not r3.load_level_stats(tmp_path / "bad.json", sha)


def test_topk_pool_straggler_deferral_indexed():
    """defer_below stashes thinned-out stragglers; flush_deferred resumes
    them from the stashed push state.  In indexed mode the walk phase is a
    deterministic SpMV, so deferral + flush reproduces the uninterrupted
    pool refinement bitwise."""
    from fora import index as widx
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    sources = np.arange(20)
    key = jax.random.key(9)

    base_runner = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx)
    base = base_runner.query_pool(sources, key, batch=8, start_level=0)
    assert base.accepted.all()

    r = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx)
    part = r.query_pool(sources, key, batch=8, start_level=0,
                        defer_below=19)
    assert part.deferred is not None and part.deferred.any()
    done = ~part.deferred
    np.testing.assert_array_equal(part.node_ids[done], base.node_ids[done])

    dsrcs, dres = r.flush_deferred(jax.random.key(77), batch=8)
    assert dres is not None and len(dsrcs) == int(part.deferred.sum())
    combined_ids = part.node_ids.copy()
    combined_acc = part.accepted.copy()
    for i, s in enumerate(dsrcs):
        q = int(np.where(sources == s)[0][0])
        combined_ids[q] = dres.node_ids[i]
        combined_acc[q] = dres.accepted[i]
    np.testing.assert_array_equal(combined_ids, base.node_ids)
    np.testing.assert_array_equal(combined_acc, base.accepted)
    # the stash is consumed; a second flush is a no-op
    empty_srcs, none_res = r.flush_deferred(jax.random.key(78), batch=8)
    assert len(empty_srcs) == 0 and none_res is None


def test_update_start_level_structural_rule():
    """The start level skips levels whose acceptances leave downstream
    batch shapes unchanged, and keeps levels that (nearly) terminate the
    pool or shrink later batches."""
    g = generators.erdos_renyi(200, 1500, seed=5)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    r = topk_algo.TopkRunner(dg, rcfg, k=8)

    def mk(lvl, pend, acc, batches, width):
        return dict(level=lvl, delta=0.0, width=width, batches=batches,
                    pending=pend, accepted=acc, accepted_bound_only=0,
                    secs=0.0)

    # round-2 judged-scale shape: dead levels 0-1, minority-accept level 2
    # at the width floor (batch shape unchanged), level 3 nearly terminates
    r.last_level_stats = [mk(0, 128, 0, 1, 128), mk(1, 128, 0, 1, 128),
                          mk(2, 128, 34, 1, 128), mk(3, 94, 93, 1, 128),
                          mk(4, 1, 1, 1, 128)]
    r._update_start_level(128)
    assert r.auto_start_level == 3

    # a level whose acceptances shrink downstream batches is kept
    r.last_level_stats = [mk(0, 512, 0, 2, 256), mk(1, 512, 300, 2, 256),
                          mk(2, 212, 212, 1, 256)]
    r._update_start_level(512)
    assert r.auto_start_level == 1

    # a level that (nearly) terminates pools is kept
    r.last_level_stats = [mk(0, 128, 126, 1, 128)]
    r._update_start_level(128)
    assert r.auto_start_level == 0


def test_topk_pool_push_pair_matches_single():
    """push_pair pairs pool blocks through shared concatenated-width push
    supersteps (gather_scatter_add_pair).  Indexed refinement is
    deterministic, and the paired scatter adds the same edge
    contributions per destination in the same order — results must match
    the unpaired pool to f32 round-off, with identical top-k ids."""
    from fora import index as widx
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    sources = np.arange(24)
    key = jax.random.key(9)

    base = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx).query_pool(
        sources, key, batch=8, start_level=0)
    paired_runner = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx,
                                         push_pair=True)
    assert paired_runner.push_pair
    paired = paired_runner.query_pool(sources, key, batch=8, start_level=0)

    np.testing.assert_array_equal(paired.node_ids, base.node_ids)
    np.testing.assert_allclose(paired.values, base.values,
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(paired.accepted, base.accepted)


def test_topk_pool_push_pair_odd_blocks():
    """An odd trailing block falls back to the single-block level step;
    pairing must not disturb per-query results or bookkeeping."""
    from fora import index as widx
    g = generators.erdos_renyi(300, 2400, seed=5)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=6).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(2))
    sources = np.arange(18)    # 3 blocks of 6: one pair + one single
    key = jax.random.key(3)

    base = topk_algo.TopkRunner(dg, rcfg, k=6, index=idx).query_pool(
        sources, key, batch=6, start_level=0)
    paired = topk_algo.TopkRunner(dg, rcfg, k=6, index=idx,
                                  push_pair=True).query_pool(
        sources, key, batch=6, start_level=0)
    np.testing.assert_array_equal(paired.node_ids, base.node_ids)
    np.testing.assert_array_equal(paired.accepted, base.accepted)


def test_topk_pool_walk_half_matches_full():
    """walk_half runs the walk SpMV + accept in two column halves with
    column-windowed gathers; same edges, same f32 accumulation per
    column — results must match the full-width path exactly (ids,
    acceptance) with values equal to round-off."""
    from fora import index as widx
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    sources = np.arange(256) % g.n
    key = jax.random.key(9)

    base = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx).query_pool(
        sources, key, batch=256, start_level=0)
    halved_runner = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx,
                                         walk_half=True)
    assert halved_runner.walk_half
    halved = halved_runner.query_pool(sources, key, batch=256,
                                      start_level=0)
    np.testing.assert_array_equal(halved.node_ids, base.node_ids)
    np.testing.assert_allclose(halved.values, base.values,
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_array_equal(halved.accepted, base.accepted)
    np.testing.assert_allclose(halved.lower_bounds, base.lower_bounds,
                               rtol=1e-5)


def test_topk_pool_stepped_push_matches_while_loop():
    """stepped_push=True (the judged-scale host-stepped split superstep,
    with its threaded contrib slot and lagged convergence polls) must
    reproduce the while-loop path exactly: same scatter-added sums in the
    same order, one superstep per iteration."""
    from fora import index as widx
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    sources = np.arange(24)
    key = jax.random.key(9)
    base = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx,
                                stepped_push=False).query_pool(
        sources, key, batch=8, start_level=0)
    stepped = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx,
                                   stepped_push=True).query_pool(
        sources, key, batch=8, start_level=0)
    np.testing.assert_array_equal(stepped.node_ids, base.node_ids)
    np.testing.assert_allclose(stepped.values, base.values, rtol=1e-6)
    np.testing.assert_array_equal(stepped.accepted, base.accepted)


def test_topk_pool_narrow_r_close_to_full():
    """narrow_r stores the residue bf16 between push and walk (one
    rounding per level, f32 everywhere else).  Results must agree with
    the f32 path on ids and acceptance for non-borderline queries; values
    within the ~0.4% bf16 perturbation."""
    from fora import index as widx
    g = generators.erdos_renyi(400, 4000, seed=13)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    sources = np.arange(24)
    key = jax.random.key(9)
    base = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx).query_pool(
        sources, key, batch=8, start_level=0)
    nr = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx,
                              narrow_r=True).query_pool(
        sources, key, batch=8, start_level=0)
    np.testing.assert_allclose(nr.values, base.values, rtol=6e-3)
    # ranking agreement: overlap of returned sets >= 7/8 per query
    for b in range(len(sources)):
        inter = len(set(nr.node_ids[b]) & set(base.node_ids[b]))
        assert inter >= 7, (b, inter)
