"""Oracle tests: closed-form PPR on analytic graphs; dense vs power iteration."""

import math

import numpy as np

from fora.algo import exact
from fora.graph import generators


def test_cycle_closed_form():
    """On a directed n-cycle, pi(s, s+j) = a(1-a)^j / (1-(1-a)^n)."""
    n, a = 8, 0.2
    g = generators.cycle_graph(n)
    pi = exact.exact_ppr_dense(g, 0, alpha=a)
    norm = 1.0 - (1.0 - a) ** n
    expected = np.array([a * (1 - a) ** j / norm for j in range(n)])
    np.testing.assert_allclose(pi, expected, rtol=1e-10)
    assert abs(pi.sum() - 1.0) < 1e-10


def test_star_dangling_absorbs():
    """Star 0->{1..n-1}, leaves dangling (absorbing).

    Closed form: walk from 0 stops at 0 with the first alpha-coin (pi0 = a);
    otherwise it moves to a uniform leaf and is absorbed there:
    pi(leaf) = (1-a)/(n-1).
    """
    n, a = 6, 0.2
    g = generators.star_graph(n)
    pi = exact.exact_ppr_dense(g, 0, alpha=a)
    np.testing.assert_allclose(pi[0], a, rtol=1e-10)
    np.testing.assert_allclose(pi[1:], (1 - a) / (n - 1), rtol=1e-10)
    assert abs(pi.sum() - 1.0) < 1e-10


def test_power_matches_dense():
    g = generators.karate_club()
    for s in (0, 33, 16):
        pd = exact.exact_ppr_dense(g, s)
        pp = exact.exact_ppr_power(g, s, tol=1e-14)
        np.testing.assert_allclose(pp, pd, atol=1e-10)


def test_power_with_dangling_matches_dense():
    g = generators.erdos_renyi(64, 120, seed=7)  # sparse -> some dangling nodes
    assert (np.asarray(g.out_deg) == 0).any()
    pd = exact.exact_ppr_dense(g, 3)
    pp = exact.exact_ppr_power(g, 3, tol=1e-14)
    np.testing.assert_allclose(pp, pd, atol=1e-10)


def test_exact_topk():
    g = generators.karate_club()
    idx, vals = exact.exact_topk(g, 0, k=5)
    assert idx[0] == 0  # source dominates its own PPR
    assert np.all(np.diff(vals) <= 0)


def test_power_batch_matches_per_source():
    """The threaded raw-kernel batch oracle (row-split csr_matvecs into a
    ping-pong buffer) reproduces the per-source bincount oracle to
    near-machine precision, including dangling rows and both thread
    counts (1 exercises the single-part path)."""
    from fora.graph import generators
    g = generators.erdos_renyi(1500, 18000, seed=21)
    srcs = np.array([3, 700, 1100, 1499])
    for threads in (1, 2):
        X = exact.exact_ppr_power_batch(g, srcs, threads=threads)
        for i, s in enumerate(srcs):
            pi = exact.exact_ppr_power(g, int(s))
            assert np.abs(X[:, i] - pi).max() < 1e-10, (threads, i)
