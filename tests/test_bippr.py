"""BiPPR competitor tests: backward-push invariant and pair estimates."""

import jax
import jax.numpy as jnp
import numpy as np

from fora.algo import bippr, exact
from fora.config import ForaConfig
from fora.graph import generators, to_device


def _ppr_matrix(g, alpha=0.2):
    return np.stack([exact.exact_ppr_dense(g, s, alpha) for s in range(g.n)])


def test_backward_push_invariant():
    """pi(s,t) = p_t(s) + sum_v pi(s,v) r_t(v) for every s, at any rmax_b."""
    g = generators.karate_club()
    dg = to_device(g)
    P = _ppr_matrix(g)          # P[s, v] = pi(s, v)
    for t in (0, 33):
        st = bippr.backward_push(dg, jnp.array([t]), rmax_b=1e-3, alpha=0.2)
        p = np.asarray(st.p, dtype=np.float64)[:, 0]
        r = np.asarray(st.r, dtype=np.float64)[:, 0]
        recon = p + P @ r
        np.testing.assert_allclose(recon, P[:, t], atol=1e-5)


def test_backward_push_invariant_with_dangling():
    g = generators.erdos_renyi(64, 120, seed=7)   # has dangling nodes
    dg = to_device(g)
    P = _ppr_matrix(g)
    dang = int(np.nonzero(np.asarray(g.out_deg) == 0)[0][0])
    for t in (3, dang):
        st = bippr.backward_push(dg, jnp.array([t]), rmax_b=1e-4, alpha=0.2)
        p = np.asarray(st.p, dtype=np.float64)[:, 0]
        r = np.asarray(st.r, dtype=np.float64)[:, 0]
        np.testing.assert_allclose(p + P @ r, P[:, t], atol=1e-5)


def test_bippr_ssppr_topk():
    """make_bippr_fn with targets=all nodes answers SSPPR top-k (the CLI's
    --algo bippr surface) at good precision; recall@k matches when the
    lists are equal length."""
    from fora.eval import metrics
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    tgt = jnp.arange(g.n, dtype=jnp.int32)
    fn = make_fn = bippr.make_bippr_fn(dg, rcfg, tgt, num_walks=8192)
    est = np.asarray(fn(jnp.array([0, 33]), jax.random.key(1)))  # [2, n]
    P = _ppr_matrix(g)
    precs = []
    for i, s in enumerate((0, 33)):
        pred = np.argsort(-est[i])[:5]
        ex = np.argsort(-P[s])[:5]
        precs.append(metrics.precision_at_k(pred, ex))
        assert metrics.recall_at_k(pred, ex) == precs[-1]
    assert np.mean(precs) >= 0.8


def test_bippr_pair_estimates():
    g = generators.karate_club()
    dg = to_device(g)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    P = _ppr_matrix(g)
    est = np.asarray(bippr.bippr_pairs(
        dg, jnp.array([0, 5]), jnp.array([33, 2]), jax.random.key(0),
        rcfg=rcfg, rmax_b=1e-3, num_walks=20_000))
    truth = P[np.ix_([0, 5], [33, 2])]
    np.testing.assert_allclose(est, truth, rtol=0.15, atol=1e-3)
