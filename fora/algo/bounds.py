"""Per-node confidence bounds for top-k acceptance (TODS'19-style).

The reference's top-k refinement stops via per-node upper/lower confidence
bounds: accept once the k-th lower bound separates from the best excluded
upper bound within (1+eps) [R: query.h topk bounds — reconstruction;
TODS'19 Sec. 5 per SURVEY.md Sec. 2.2/3.2].  This module supplies the
batched equivalent, derived directly from the Bernstein concentration
of the FORA walk-phase estimator.

Estimator shape: after push, pi(v) = p(v) + mu(v) with p exact and
mu(v) = sum_u r_u * pi_u(v) estimated by independent bounded terms — node u
contributes omega_u i.i.d. walk endpoints each weighted r_u / omega_u
<= c := 1/omega_unit (with the FORA+ index, count_u >= omega_u samples at
weight r_u / count_u <= c, the per-node coverage threshold guarantees it).
Variance of the estimate is <= c * mu, so Bernstein gives, for deviation
probability exp(-t):

    P(mu_hat <= mu - lam) <= exp(-lam^2 / (2 (c mu + c lam / 3)))
    P(mu_hat >= mu + lam) <= exp(-lam^2 / (2 (c mu + c lam / 3)))

Inverting the downward branch at confidence t yields an upper confidence
bound as the root of  m - sqrt(2 t c m) - (mu_hat + 2 c t / 3) = 0:

    UB_mu(mu_hat) = ((sqrt(2tc) + sqrt(2tc + 4 (mu_hat + 2ct/3))) / 2)^2
    LB_mu(mu_hat) = max(0, mu_hat - 2ct/3 - sqrt(2 t c UB_mu(mu_hat)))

and per-node PPR bounds LB = p + LB_mu, UB = p + UB_mu.

Acceptance (the separation test): rank nodes by pi_hat; accept when

    min over returned top-k of LB  >=  UB_excluded / (1 + eps)

where UB_excluded bounds EVERY non-returned node: UB(v) = p(v) +
UB_mu(mu_hat(v)) = pi_hat(v) + (UB_mu - id)(mu_hat(v)) is increasing in
both pi_hat and mu_hat <= pi_hat, so for any v outside the top-k
(pi_hat(v) <= pi_hat_{k+1}) it holds that UB(v) <= UB_mu(pi_hat_{k+1})
(the worst case p = 0).  On acceptance the returned set R carries the
eps-approximate top-k guarantee: w.p. >= 1 - pfail, every excluded node u
satisfies pi(u) <= (1 + eps) * pi(v) for every v in R — independent of
delta, so it can fire at levels the threshold rule kth >= (1+eps) delta_i
rejects (e.g. a clear gap between the k-th and (k+1)-th estimates).

``t`` budgets the failure probability with a union bound over all n nodes,
all refinement levels, and both deviation sides:
t = ln(2 n L / pfail).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


def bernstein_ub(mu_hat, c, t):
    """Upper confidence bound on mu given estimate mu_hat (elementwise).
    Exact root of the inverted downward Bernstein branch; monotone
    increasing in mu_hat, c, and t."""
    s2 = 2.0 * t * c
    root = (jnp.sqrt(s2) + jnp.sqrt(s2 + 4.0 * (mu_hat + s2 / 3.0))) * 0.5
    return root * root


def bernstein_lb(mu_hat, c, t, ub=None):
    """Lower confidence bound on mu (elementwise, clamped at 0)."""
    if ub is None:
        ub = bernstein_ub(mu_hat, c, t)
    s2 = 2.0 * t * c
    return jnp.maximum(mu_hat - s2 / 3.0 - jnp.sqrt(s2 * ub), 0.0)


def union_bound_t(n: int, num_levels: int, pfail: float) -> float:
    """ln(2 n L / pfail): failure budget split over n nodes, L refinement
    levels, and the two deviation sides."""
    return math.log(2.0 * n * max(num_levels, 1) / pfail)


def _topk_with_bounds(ppr, p, omega_unit, *, k: int, t: float, eps: float):
    """ppr, p: [n, B] (p = settled push mass; pass zeros when unavailable —
    bounds stay valid, just wider).  Returns per-query:

      vals, idx      [B, k]  top-k estimates (desc) and node ids
      lb, ub         [B, k]  per-node PPR confidence bounds
      lbk            [B]     min lower bound over the returned set
      ub_excluded    [B]     upper bound on every non-returned node
      bound_accept   [B]     separation test at this level's (eps, t)
    """
    from ..ops.topk import topk_rows_chunked
    n, B = ppr.shape
    kk = min(k + 1, n)
    c = 1.0 / omega_unit
    # node-chunked top-k + p gather: never builds the [B, n] transposes
    # (2 GB each at 4.2M nodes x B=128)
    vals, idx, p_all = topk_rows_chunked(ppr, kk, p)        # [B, kk]
    vals_k, idx_k = vals[:, :k], idx[:, :k]
    p_at = p_all[:, :k]
    mu_hat = jnp.maximum(vals_k - p_at, 0.0)
    ub_mu = bernstein_ub(mu_hat, c, t)
    lb = p_at + bernstein_lb(mu_hat, c, t, ub=ub_mu)
    ub = p_at + ub_mu
    lbk = jnp.min(lb, axis=1)
    if kk > k:
        ub_excluded = bernstein_ub(vals[:, k], c, t)        # worst case p=0
    else:  # k >= n: nothing is excluded
        ub_excluded = jnp.zeros((B,), ppr.dtype)
    bound_accept = lbk * (1.0 + eps) >= ub_excluded
    return vals_k, idx_k, lb, ub, lbk, ub_excluded, bound_accept


def _topk_with_bounds_split(p, contrib, omega_unit, *, k: int, t: float,
                            eps: float, cols=None):
    """_topk_with_bounds on a SPLIT estimate ppr = p + contrib: the sum is
    formed per node-slab inside the chunked top-k (topk_rows_chunked
    ``addend``), so the full [n, B] ppr is never materialized — at
    LiveJournal scale B=256 that buffer is 4.3 GB.

    ``cols`` ((c0, w), static): half-walk mode — ``contrib`` is the
    [n, w] walk accumulator of query columns [c0, c0+w); p's columns are
    windowed per slab inside the fused scoring."""
    from ..ops.topk import topk_rows_chunked
    n = p.shape[0]
    B = cols[1] if cols is not None else p.shape[1]
    kk = min(k + 1, n)
    c = 1.0 / omega_unit
    vals, idx, p_all = topk_rows_chunked(p, kk, p, addend=contrib,
                                         cols=cols)
    vals_k, idx_k = vals[:, :k], idx[:, :k]
    p_at = p_all[:, :k]
    mu_hat = jnp.maximum(vals_k - p_at, 0.0)
    ub_mu = bernstein_ub(mu_hat, c, t)
    lb = p_at + bernstein_lb(mu_hat, c, t, ub=ub_mu)
    ub = p_at + ub_mu
    lbk = jnp.min(lb, axis=1)
    if kk > k:
        ub_excluded = bernstein_ub(vals[:, k], c, t)        # worst case p=0
    else:  # k >= n: nothing is excluded
        ub_excluded = jnp.zeros((B,), p.dtype)
    bound_accept = lbk * (1.0 + eps) >= ub_excluded
    return vals_k, idx_k, lb, ub, lbk, ub_excluded, bound_accept


def make_topk_bounds_fn(k: int, t: float, eps: float):
    """Jitted (ppr, p, omega_unit) -> topk+bounds; omega_unit is a runtime
    scalar so all delta levels share one compile per batch width."""
    return jax.jit(functools.partial(_topk_with_bounds, k=k, t=t, eps=eps))


def make_topk_bounds_split_fn(k: int, t: float, eps: float):
    """Jitted (p, contrib, omega_unit) -> topk+bounds with the estimate
    supplied split (ppr = p + contrib summed per slab, never fully
    materialized); ``contrib`` is DONATED — it is dead after the accept."""
    return jax.jit(functools.partial(_topk_with_bounds_split, k=k, t=t,
                                     eps=eps), donate_argnums=(1,))


def make_topk_bounds_split_cols_fn(k: int, t: float, eps: float):
    """make_topk_bounds_split_fn with a STATIC column window:
    (p, contrib_half, omega_unit, c0, w) -> topk+bounds for query columns
    [c0, c0+w) (half-walk mode)."""
    def fn(p, contrib, omega_unit, c0, w):
        return _topk_with_bounds_split(p, contrib, omega_unit, k=k, t=t,
                                       eps=eps, cols=(c0, w))

    return jax.jit(fn, donate_argnums=(1,), static_argnums=(3, 4))
