"""Push-phase tests: termination, mass conservation, the FORA invariant,
and push-only estimates vs the dense oracle (SURVEY.md Sec. 4)."""

import numpy as np
import jax.numpy as jnp

from fora.algo import exact
from fora.graph import generators, to_device
from fora.ops import push as push_ops


def _ppr_matrix(g, alpha=0.2):
    """Exact PPR from every source; rows indexed by source."""
    return np.stack([exact.exact_ppr_dense(g, s, alpha) for s in range(g.n)])


def test_push_terminates_below_threshold():
    g = generators.karate_club()
    dg = to_device(g)
    rmax = 1e-3
    st = push_ops.forward_push(dg, jnp.array([0, 5, 33]), rmax=rmax, alpha=0.2)
    r = np.asarray(st.r)
    deg = np.asarray(g.out_deg, dtype=np.float64)
    assert np.all(r.T <= rmax * deg + 1e-7)
    assert int(st.iters) < 200


def test_push_conserves_mass():
    g = generators.star_graph(8)  # exercises dangling -> source
    dg = to_device(g)
    st = push_ops.forward_push(dg, jnp.array([0, 3]), rmax=1e-4, alpha=0.2)
    total = np.asarray(st.p + st.r).sum(axis=0)
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_fora_invariant():
    """pi_s = p + sum_v r[v] * pi_v  must hold after push (paper Sec. 3)."""
    g = generators.karate_club()  # no dangling: pi_v is source-independent
    dg = to_device(g)
    P = _ppr_matrix(g)
    for rmax in (1e-2, 1e-4):
        st = push_ops.forward_push(dg, jnp.array([0, 17]), rmax=rmax, alpha=0.2)
        p, r = np.asarray(st.p, dtype=np.float64), np.asarray(st.r, dtype=np.float64)
        for b, s in enumerate((0, 17)):
            reconstructed = p[:, b] + r[:, b] @ P
            np.testing.assert_allclose(reconstructed,
                                       exact.exact_ppr_dense(g, s),
                                       atol=1e-5)


def test_push_only_estimate_converges():
    g = generators.karate_club()
    dg = to_device(g)
    est = np.asarray(push_ops.push_only_estimate(
        dg, jnp.array([0]), rmax=1e-7, alpha=0.2, max_iters=500))[:, 0]
    np.testing.assert_allclose(est, exact.exact_ppr_dense(g, 0), atol=1e-4)


def test_push_batch_independent_of_batching():
    """Query results must not depend on which batch they run in."""
    g = generators.erdos_renyi(128, 512, seed=9)
    dg = to_device(g)
    single = push_ops.forward_push(dg, jnp.array([7]), rmax=1e-4, alpha=0.2)
    batch = push_ops.forward_push(dg, jnp.array([3, 7, 11]), rmax=1e-4, alpha=0.2)
    np.testing.assert_allclose(np.asarray(single.p[:, 0]),
                               np.asarray(batch.p[:, 1]), atol=1e-6)


def test_gather_segment_sum_chunked_matches():
    """Edge-chunked scan path == one-shot path (large-graph memory mode)."""
    rng = np.random.default_rng(31)
    n, E, B = 97, 4000, 8
    values = jnp.asarray(rng.random((n, B)), jnp.float32)
    dst = np.sort(rng.integers(0, n, E))
    src = rng.integers(0, n, E)
    one = push_ops.gather_segment_sum(values, jnp.asarray(src, jnp.int32),
                                      jnp.asarray(dst, jnp.int32), n)
    chunked = push_ops.gather_segment_sum(
        values, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), n,
        max_chunk=512)  # forces 8 chunks incl. a padded tail
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(one),
                               rtol=1e-5, atol=1e-6)


def test_gather_segment_sum_edge_weight():
    """Per-edge multiplier (index duplicate-merge) matches an explicit
    numpy scatter, in both one-shot and chunked modes."""
    rng = np.random.default_rng(3)
    n, E, B = 50, 1000, 4
    src = rng.integers(0, n, E).astype(np.int32)
    dst = np.sort(rng.integers(0, n, E)).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    vals = rng.random((n, B)).astype(np.float32)
    want = np.zeros((n, B), np.float32)
    np.add.at(want, dst, vals[src] * w[:, None])
    for chunk in (1 << 23, 256):
        got = push_ops.gather_segment_sum(
            jnp.asarray(vals), jnp.asarray(src), jnp.asarray(dst), n,
            max_chunk=chunk, edge_w=jnp.asarray(w))
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=1e-5, atol=1e-5)


def test_compact_frontier_matches_dense():
    """The frontier-compacted superstep path (active_edge_segment_sum) is a
    pure execution-layout change: same fixed point, same estimates, for
    capacities that always compact, sometimes fall back, and always fall
    back."""
    import jax
    g = generators.erdos_renyi(400, 5000, seed=13)
    dg = to_device(g)
    srcs = jnp.array([0, 7, 123, 399])
    want = push_ops.forward_push_from(
        dg, push_ops.init_state(g.n, srcs), rmax=1e-4, alpha=0.2,
        compact_edges=0)
    for cap in (4096, 512, 8):
        got = push_ops.forward_push_from(
            dg, push_ops.init_state(g.n, srcs), rmax=1e-4, alpha=0.2,
            compact_edges=cap)
        np.testing.assert_allclose(np.asarray(got.p), np.asarray(want.p),
                                   rtol=1e-6, atol=1e-9, err_msg=str(cap))
        np.testing.assert_allclose(np.asarray(got.r), np.asarray(want.r),
                                   rtol=1e-6, atol=1e-9, err_msg=str(cap))
        assert int(got.iters) == int(want.iters), cap


def test_compact_frontier_under_jit():
    """Compact path traces cleanly under jit (cond + nonzero static size)."""
    import functools
    import jax
    g = generators.erdos_renyi(300, 4000, seed=5)
    dg = to_device(g)
    srcs = jnp.array([1, 2])
    want = push_ops.forward_push_from(
        dg, push_ops.init_state(g.n, srcs), rmax=1e-3, alpha=0.2,
        compact_edges=0)
    fn = jax.jit(functools.partial(
        push_ops.forward_push_from, rmax=1e-3, alpha=0.2,
        compact_edges=1024))
    got = fn(dg, push_ops.init_state(g.n, srcs))
    np.testing.assert_allclose(np.asarray(got.p), np.asarray(want.p),
                               rtol=1e-6, atol=1e-9)


def test_bf16_gather_close_to_f32():
    """bf16 gather_dtype trades <=0.5% relative error for half the gather
    bytes; push results must stay within that envelope."""
    g = generators.erdos_renyi(400, 5000, seed=13)
    dg = to_device(g)
    srcs = jnp.array([0, 7, 123, 399])
    want = push_ops.forward_push_from(
        dg, push_ops.init_state(g.n, srcs), rmax=1e-4, alpha=0.2)
    got = push_ops.forward_push_from(
        dg, push_ops.init_state(g.n, srcs), rmax=1e-4, alpha=0.2,
        gather_dtype=jnp.bfloat16)
    p_w, p_g = np.asarray(want.p, np.float64), np.asarray(got.p, np.float64)
    # settled mass agrees to bf16 granularity, and total mass is conserved
    np.testing.assert_allclose(p_g.sum(0) + np.asarray(got.r).sum(0),
                               1.0, rtol=2e-2)
    assert np.abs(p_g - p_w).max() < 2e-2 * p_w.max()


def test_merged_duplicate_edges_match_multigraph():
    """to_device(merge_duplicate_edges=True) must be lossless: push on the
    multiplicity-weighted unique edge list equals push on the raw multigraph
    edge list (RMAT-style parallel edges)."""
    rng = np.random.default_rng(11)
    n, m = 64, 512
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    src = np.concatenate([src, src[:200]])   # force heavy duplication
    dst = np.concatenate([dst, dst[:200]])
    from fora.graph.csr import from_edges
    g = from_edges(src, dst, n)
    dg_raw = to_device(g)
    dg_merged = to_device(g, merge_duplicate_edges=True)
    assert dg_merged.in_w is not None
    assert dg_merged.in_src.shape[0] < dg_raw.in_src.shape[0]
    assert float(jnp.sum(dg_merged.in_w)) == g.m
    a = push_ops.forward_push(dg_raw, jnp.array([3, 9]), rmax=1e-4, alpha=0.2)
    b = push_ops.forward_push(dg_merged, jnp.array([3, 9]), rmax=1e-4,
                              alpha=0.2)
    np.testing.assert_allclose(np.asarray(a.p), np.asarray(b.p), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.r), np.asarray(b.r), atol=1e-6)


def test_hub_split_matches_dense():
    """to_device(hub_rows=H) partitions in-edges exactly: push results are
    bit-identical to the dense single-gather superstep (same edges, same
    weights, two dst-sorted segment sums)."""
    import jax.numpy as jnp
    from fora.graph import generators, to_device

    g = generators.rmat(10, 1024 * 8, seed=3)    # parallel edges included
    for merge in (False, True):
        dg0 = to_device(g, merge_duplicate_edges=merge)
        dgh = to_device(g, merge_duplicate_edges=merge, hub_rows=64)
        assert dgh.hub_split and not dg0.hub_split
        assert dgh.m_in == dg0.m_in
        src = jnp.asarray([3, 99, 500, 1000], jnp.int32)
        st0 = push_ops.forward_push(dg0, src, rmax=1e-4, alpha=0.2)
        sth = push_ops.forward_push(dgh, src, rmax=1e-4, alpha=0.2)
        np.testing.assert_allclose(np.asarray(sth.p), np.asarray(st0.p),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.asarray(sth.r), np.asarray(st0.r),
                                   rtol=1e-6, atol=1e-9)
        assert int(sth.iters) == int(st0.iters)


def test_hub_split_weighted_matches_dense():
    from fora.graph import generators, to_device
    from fora.graph.csr import from_edges
    import jax.numpy as jnp

    g = generators.erdos_renyi(400, 4000, seed=11)
    rng = np.random.default_rng(2)
    src = np.repeat(np.arange(g.n), np.asarray(g.out_deg, np.int64))
    w = rng.uniform(0.5, 2.0, size=g.m).astype(np.float32)
    gw = from_edges(src, np.asarray(g.out_indices), g.n, w=w)
    dg0 = to_device(gw)
    dgh = to_device(gw, hub_rows=32)
    s = jnp.asarray([7, 42], jnp.int32)
    st0 = push_ops.forward_push(dg0, s, rmax=1e-4, alpha=0.2)
    sth = push_ops.forward_push(dgh, s, rmax=1e-4, alpha=0.2)
    np.testing.assert_allclose(np.asarray(sth.p), np.asarray(st0.p),
                               rtol=1e-6, atol=1e-9)


def test_pad_edge_arrays_and_padded_graph_equivalence():
    """Edge padding (src 0 / dst n / w 0 sentinels to a chunk multiple)
    is semantically inert: padded and unpadded device graphs produce
    bitwise-identical push results, and the pre-padded layout reshapes
    for free in the chunked kernels."""
    import numpy as np

    from fora.graph import generators, to_device
    from fora.ops import push as push_ops

    g = generators.erdos_renyi(300, 5000, seed=3)
    pad = 1 << 10
    src, dst, w = push_ops.pad_edge_arrays(
        g.n, pad, np.asarray(g.in_src), np.asarray(g.in_dst), None)
    assert len(src) % pad == 0 and len(src) > g.m
    assert (dst[g.m:] == g.n).all() and (src[g.m:] == 0).all()

    dg = to_device(g)
    dgp = to_device(g, pad_edges=pad)
    sources = jnp.arange(8, dtype=jnp.int32)
    a = push_ops.forward_push(dg, sources, rmax=1e-4, alpha=0.2)
    b = push_ops.forward_push(dgp, sources, rmax=1e-4, alpha=0.2)
    np.testing.assert_array_equal(np.asarray(a.p), np.asarray(b.p))
    np.testing.assert_array_equal(np.asarray(a.r), np.asarray(b.r))
