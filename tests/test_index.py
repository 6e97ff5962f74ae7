"""FORA+ multi-resolution walk-index tests: bucket structure, SpMV walk
phase, serialization round-trip, compat checking, indexed-query accuracy
(SURVEY.md Sec. 2.1 / 5.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fora import index as widx
from fora.algo import exact, fora
from fora.config import ForaConfig
from fora.eval import metrics
from fora.graph import generators, to_device
from fora.ops import topk as topk_ops


def _setup(eps=0.5, gen=generators.karate_club):
    g = gen()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=eps).resolved(g.n, g.m)
    return g, dg, rcfg


def test_index_counts_cover_demand():
    g, dg, rcfg = _setup()
    counts = widx.index_counts(np.asarray(g.out_deg), rcfg)
    deg = np.asarray(g.out_deg, dtype=np.float64)
    demand = np.ceil(rcfg.rmax * deg * rcfg.omega_unit)
    assert np.all(counts[deg > 0] >= demand[deg > 0])
    assert np.all(counts[deg == 0] == 0)


def test_bucket_structure():
    """Depth-q tail = per-node prefix of size ceil(K_v * 4^-q); deepest
    bucket counts cover each node with >= 1 entry; dangling self-edges."""
    g, dg, rcfg = _setup(gen=lambda: generators.erdos_renyi(64, 120, seed=7))
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(0))
    counts = widx.index_counts(np.asarray(g.out_deg), rcfg)
    cc = np.asarray(idx.counts_cum)
    deg = np.asarray(g.out_deg)
    for q in range(widx.NUM_BUCKETS):
        expect = np.ceil(counts * 4.0 ** (-q)).astype(int)
        expect[deg == 0] = 1    # dangling self-edge visible at every depth
        assert np.array_equal(cc[:, q], expect), q
    # edges in the depth-q tail carry exactly counts_cum[:, q] samples per
    # node (multiplicity-weighted: duplicates are merged, see build.py)
    src = np.asarray(idx.edge_src)
    mult = (np.asarray(idx.edge_mult) if idx.edge_mult is not None
            else np.ones(len(src)))
    for q in (0, 3, widx.NUM_BUCKETS - 1):
        lo = int(idx.bucket_offsets[q])
        got = np.bincount(src[lo:], weights=mult[lo:], minlength=g.n)
        assert np.array_equal(got.astype(np.int64), cc[:, q])
    # dangling self-edge: dst == src for dangling nodes
    dst = np.asarray(idx.edge_dst)
    for v in np.nonzero(deg == 0)[0]:
        assert np.all(dst[src == v] == v)
    # within each bucket, dst ascending (sorted segment_sum contract)
    boff = idx.bucket_offsets
    for q in range(widx.NUM_BUCKETS):
        seg = dst[int(boff[q]):int(boff[q + 1])]
        assert np.all(np.diff(seg) >= 0)


def test_depth_for():
    g, dg, rcfg = _setup()
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    assert idx.depth_for(rcfg.omega_unit) == 0
    assert idx.depth_for(rcfg.omega_unit / 4.0) in (0, 1)
    assert idx.depth_for(rcfg.omega_unit / 16.5) == 2
    assert idx.depth_for(rcfg.omega_unit * 1e-9) == widx.NUM_BUCKETS - 1
    with pytest.raises(ValueError, match="too coarse"):
        idx.depth_for(rcfg.omega_unit * 2)


def test_depth_for_rmax_aware():
    """Coarse refinement levels have smaller omega but LARGER rmax, so the
    per-node demand ratio is rmax*omega — the rmax-aware rule must pick a
    shallower depth than the omega-only rule (guarantee coverage)."""
    g, dg, rcfg = _setup()
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(1))
    coarse = rcfg.with_delta(rcfg.delta * 256)   # omega /256, rmax *16
    q_omega = idx.depth_for(coarse.omega_unit)
    q_joint = idx.depth_for(coarse.omega_unit, coarse.rmax)
    assert q_omega == 4 and q_joint == 2
    # at the built config the two rules agree
    assert idx.depth_for(rcfg.omega_unit, rcfg.rmax) == 0
    # demand beyond the built rmax is rejected even at equal omega
    with pytest.raises(ValueError, match="too coarse"):
        idx.depth_for(rcfg.omega_unit, rcfg.rmax * 2)


def test_indexed_contrib_statistics():
    """SpMV walk contribution from residue e_v estimates pi_v."""
    g, dg, rcfg = _setup(eps=0.5)
    big = ForaConfig(epsilon=0.5, walk_multiplier=50.0).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, big, jax.random.key(2), chunk=1 << 14)
    v = 0
    r = jnp.zeros((g.n, 1), jnp.float32).at[v, 0].set(1.0)
    est = np.asarray(widx.indexed_walk_contrib(idx, r, 0))[:, 0]
    pool = int(np.asarray(idx.counts_cum)[v, 0])
    pi = exact.exact_ppr_dense(g, v)
    assert abs(est.sum() - 1.0) < 1e-5      # weights sum to residue mass
    assert np.abs(est - pi).sum() < 4.0 / np.sqrt(pool) * np.sqrt(g.n)


def test_indexed_query_matches_guarantee():
    g, dg, rcfg = _setup()
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(3))
    fn = fora.make_fora_fn(dg, rcfg, index=idx)
    res = fn(jnp.array([0, 33]), jax.random.key(4))
    ppr = np.asarray(res.ppr, dtype=np.float64)
    for b, s in enumerate([0, 33]):
        pi = exact.exact_ppr_dense(g, s)
        assert metrics.max_relative_error(ppr[:, b], pi, rcfg.delta) <= 0.6
        _, ids = topk_ops.topk_nodes(res.ppr, 5)
        assert metrics.precision_at_k(np.asarray(ids[b]),
                                      exact.exact_topk(g, s, 5)[0]) >= 0.8


def test_indexed_query_at_coarse_depth():
    """A coarser query config rides a deeper (cheaper) bucket slice and
    still meets its (weaker) guarantee."""
    g, dg, rcfg = _setup()
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(5))
    coarse = ForaConfig(epsilon=0.5, delta=16.5 / g.n).resolved(g.n, g.m)
    assert idx.depth_for(coarse.omega_unit) >= 2
    fn = fora.make_fora_fn(dg, coarse, index=idx)
    res = fn(jnp.array([0]), jax.random.key(6))
    pi = exact.exact_ppr_dense(g, 0)
    err = metrics.max_relative_error(
        np.asarray(res.ppr, np.float64)[:, 0], pi, coarse.delta)
    assert err <= 0.6


def test_index_dedup_lossless(tmp_path):
    """Duplicate-merge (edge_mult) preserves the estimator exactly: same
    contrib at every depth, same counts_cum; legacy saved indexes are
    upgraded on load."""
    g = generators.erdos_renyi(80, 400, seed=9)
    rcfg = ForaConfig(epsilon=0.5, walk_multiplier=5.0).resolved(g.n, g.m)
    deg = np.asarray(g.out_deg)
    counts = widx.index_counts(deg, rcfg)
    rng = np.random.default_rng(0)
    endpoints = rng.integers(0, g.n, size=int(counts.sum())).astype(np.int32)
    raw = widx.pack_index(endpoints, counts, deg, rcfg, dedup=False)
    merged = widx.pack_index(endpoints, counts, deg, rcfg)
    assert raw.edge_mult is None and merged.edge_mult is not None
    assert merged.total_edges < raw.total_edges
    # multiplicities account for every raw edge
    assert float(np.asarray(merged.edge_mult).sum()) == raw.total_edges
    assert np.array_equal(np.asarray(raw.counts_cum),
                          np.asarray(merged.counts_cum))
    r = jnp.asarray(rng.random((g.n, 4)), jnp.float32)
    for q in (0, 2, widx.NUM_BUCKETS - 1):
        a = np.asarray(widx.indexed_walk_contrib(raw, r, q))
        b = np.asarray(widx.indexed_walk_contrib(merged, r, q))
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-8)
    # dedup_index on the raw layout gives the same packed arrays
    up = widx.dedup_index(raw)
    assert np.array_equal(np.asarray(up.edge_src),
                          np.asarray(merged.edge_src))
    assert np.array_equal(np.asarray(up.edge_mult),
                          np.asarray(merged.edge_mult))
    # legacy save -> load upgrades in memory
    widx.save(raw, rcfg, str(tmp_path / "legacy"))
    loaded = widx.load(str(tmp_path / "legacy"), rcfg)
    assert loaded.edge_mult is not None
    np.testing.assert_allclose(
        np.asarray(widx.indexed_walk_contrib(loaded, r, 0)),
        np.asarray(widx.indexed_walk_contrib(raw, r, 0)),
        rtol=2e-6, atol=1e-8)


def test_index_store_roundtrip(tmp_path):
    g, dg, rcfg = _setup()
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(7))
    widx.save(idx, rcfg, str(tmp_path / "idx"))
    idx2 = widx.load(str(tmp_path / "idx"), rcfg)
    assert np.array_equal(np.asarray(idx.edge_src), np.asarray(idx2.edge_src))
    assert np.array_equal(np.asarray(idx.edge_dst), np.asarray(idx2.edge_dst))
    assert np.array_equal(idx.bucket_offsets, idx2.bucket_offsets)
    assert np.array_equal(np.asarray(idx.counts_cum),
                          np.asarray(idx2.counts_cum))
    assert idx2.omega_unit_built == pytest.approx(rcfg.omega_unit)


def test_index_compat_rejects_coarser(tmp_path):
    g, dg, rcfg = _setup()
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(8))
    widx.save(idx, rcfg, str(tmp_path / "idx"))
    finer = ForaConfig(epsilon=0.25).resolved(g.n, g.m)  # needs more walks
    with pytest.raises(ValueError, match="too coarse"):
        widx.load(str(tmp_path / "idx"), finer)
    other_graph = ForaConfig(epsilon=0.5).resolved(g.n + 1, g.m)
    with pytest.raises(ValueError, match="different graph"):
        widx.load(str(tmp_path / "idx"), other_graph)


def test_staged_query_pool_matches_fused():
    """The staged (shared compiled pieces) indexed pool runner matches the
    per-depth fused path bit-for-bit (both are deterministic SpMV)."""
    from fora.algo import topk as topk_algo
    g = generators.erdos_renyi(400, 4000, seed=17)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    idx = widx.build_walk_index(dg, rcfg, jax.random.key(20))
    runner = topk_algo.TopkRunner(dg, rcfg, k=8, index=idx)  # staged path
    sources = np.arange(16)
    pool = runner.query_pool(sources, jax.random.key(21), batch=8)
    # fused per-depth state path
    fused_fn = fora.make_fora_state_fn(dg, rcfg, 0, index=idx, index_depth=0)
    from fora.ops import push as push_ops
    import jax.numpy as jnp
    st0 = push_ops.init_state(g.n, jnp.asarray(sources[:8], jnp.int32))
    res_f, _, _ = fused_fn(st0.p, st0.r, None, np.float32(rcfg.rmax),
                           np.float32(rcfg.omega_unit))
    staged = fora.StagedForaPrograms(dg, rcfg, idx).state_fn(0)
    res_s, _, _ = staged(st0.p, st0.r, None, np.float32(rcfg.rmax),
                         np.float32(rcfg.omega_unit))
    np.testing.assert_allclose(np.asarray(res_f.ppr), np.asarray(res_s.ppr),
                               rtol=1e-6, atol=1e-8)


def test_build_checkpoint_resume(tmp_path, monkeypatch):
    """An interrupted index build resumes from its chunk checkpoints and
    produces a bit-identical index; a mismatched checkpoint is refused."""
    import pytest
    from fora.index import build as ib

    g = generators.erdos_renyi(300, 3000, seed=5)
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    key = jax.random.key(12)
    chunk = 1 << 11   # force >= 4 chunks
    ref = ib.build_walk_index(dg, rcfg, key, chunk=chunk)

    # interrupt after 2 chunks (np.pad runs host-side once per chunk;
    # the walk kernel itself is jitted, so patching it would only catch
    # the trace call)
    calls = {"n": 0}
    real_pad = np.pad

    def flaky_pad(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("preempted")
        return real_pad(*a, **kw)

    ckpt = tmp_path / "ckpt"
    monkeypatch.setattr(np, "pad", flaky_pad)
    with pytest.raises(RuntimeError):
        ib.build_walk_index(dg, rcfg, key, chunk=chunk,
                            checkpoint_dir=str(ckpt))
    monkeypatch.setattr(np, "pad", real_pad)
    done = sorted(p.name for p in ckpt.glob("chunk_*.npy"))
    assert len(done) == 2

    resumed = ib.build_walk_index(dg, rcfg, key, chunk=chunk,
                                  checkpoint_dir=str(ckpt))
    np.testing.assert_array_equal(np.asarray(resumed.edge_src),
                                  np.asarray(ref.edge_src))
    np.testing.assert_array_equal(np.asarray(resumed.edge_dst),
                                  np.asarray(ref.edge_dst))
    np.testing.assert_array_equal(np.asarray(resumed.counts_cum),
                                  np.asarray(ref.counts_cum))

    # a different key must refuse the stale checkpoint
    with pytest.raises(ValueError, match="checkpoint"):
        ib.build_walk_index(dg, rcfg, jax.random.key(99), chunk=chunk,
                            checkpoint_dir=str(ckpt))


def test_store_refuses_same_shape_different_graph(tmp_path):
    """(n, m) alone can't identify a graph: a content-fingerprinted index
    refuses to serve a rewired or reweighted graph of the same shape."""
    import pytest
    from fora.index import store
    g1 = generators.erdos_renyi(200, 1500, seed=1)
    g2 = generators.erdos_renyi(200, 1500, seed=2)   # same (n, m)
    rcfg = ForaConfig(epsilon=0.5).resolved(g1.n, g1.m)
    idx = widx.build_walk_index(to_device(g1), rcfg, jax.random.key(0))
    store.save(idx, rcfg, str(tmp_path / "i"), graph=g1)
    widx.load(str(tmp_path / "i"), rcfg, graph=g1)          # same graph ok
    widx.load(str(tmp_path / "i"), rcfg)                    # no graph: legacy
    with pytest.raises(ValueError, match="fingerprint"):
        widx.load(str(tmp_path / "i"), rcfg, graph=g2)


def test_pack_fast_path_equals_legacy_merge():
    """pack_index's packed-key fast path produces exactly the legacy
    pipeline's merged layout: pack(dedup=False) (legacy sort) upgraded by
    dedup_index equals pack(dedup=True) (fast path) bit for bit."""
    from fora.config import ForaConfig
    from fora.index import build as ib

    rng = np.random.default_rng(3)
    n = 1 << 10
    deg = rng.integers(0, 12, n)
    deg[rng.random(n) < 0.05] = 0
    rcfg = ForaConfig(epsilon=0.5).resolved(n, max(int(deg.sum()), 1))
    counts = ib.index_counts(deg, rcfg)
    endpoints = rng.integers(0, n, int(counts.sum())).astype(np.int32)
    fast = ib.pack_index(endpoints, counts, deg, rcfg, dedup=True)
    legacy = ib.dedup_index(
        ib.pack_index(endpoints, counts, deg, rcfg, dedup=False))
    np.testing.assert_array_equal(np.asarray(fast.edge_src),
                                  np.asarray(legacy.edge_src))
    np.testing.assert_array_equal(np.asarray(fast.edge_dst),
                                  np.asarray(legacy.edge_dst))
    np.testing.assert_array_equal(np.asarray(fast.edge_mult),
                                  np.asarray(legacy.edge_mult))
    np.testing.assert_array_equal(fast.bucket_offsets,
                                  legacy.bucket_offsets)
    np.testing.assert_array_equal(np.asarray(fast.counts_cum),
                                  np.asarray(legacy.counts_cum))
