"""Exact / near-exact PPR oracle — the ground-truth generator.

Plays the role of the reference's ``gen-exact-topk`` action [R: query.h —
reconstruction, SURVEY.md Sec. 3.4]: produce machine-precision PPR per query
source, to be consumed by the precision@k evaluator.

Dangling-node convention (fixed across the whole engine, oracle included):
a node with zero out-degree is ABSORBING — a walk reaching it ends there
(equivalently: it carries a self-loop, so the alpha-coin eventually stops
the walk in place).  This keeps the chain source-independent, which is what
makes the FORA+ precomputed walk index valid: endpoints of walks from v do
not depend on which query is running.  In the push phase the entire residue
at a dangling node settles (geometric series of the self-loop).

PPR solves  pi = alpha * e_s + (1 - alpha) * M^T pi  with M the transition
matrix where dangling rows are self-loops.

Small graphs get a dense linear solve; large graphs a power iteration over
the packed CSR (numpy, host-side: ground truth is offline work).
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import CSRGraph


def exact_ppr_dense(g: CSRGraph, source: int, alpha: float = 0.2) -> np.ndarray:
    """Dense solve: (I - (1-a) M^T) pi = a e_s, where M is the transition
    matrix with self-loops on dangling rows. O(n^3); fixtures only.
    Weighted graphs: M[v, t] = w(v, t) / W(v)."""
    n = g.n
    M = np.zeros((n, n), dtype=np.float64)
    deg = np.asarray(g.out_deg, dtype=np.int64)
    src = np.repeat(np.arange(n), deg)
    if g.weighted:
        w = np.asarray(g.out_w, dtype=np.float64)
        wsum = np.bincount(src, weights=w, minlength=n)
        vals = w / wsum[src]
    else:
        vals = 1.0 / deg[src]
    # np.add.at: fancy-index += would drop parallel edges
    np.add.at(M, (src, np.asarray(g.out_indices, dtype=np.int64)), vals)
    dang = np.nonzero(deg == 0)[0]
    M[dang, dang] = 1.0
    A = np.eye(n) - (1.0 - alpha) * M.T
    pi = np.linalg.solve(A, alpha * np.eye(n)[:, source])
    return pi


def exact_ppr_power(g: CSRGraph, source: int, alpha: float = 0.2,
                    tol: float = 1e-12, max_iters: int = 2000) -> np.ndarray:
    """Power iteration to ||delta||_1 <= tol. O(m) per iteration.
    Weighted graphs: transitions w(v, t) / W(v)."""
    n = g.n
    deg = np.asarray(g.out_deg, dtype=np.float64)
    in_src = np.asarray(g.in_src, dtype=np.int64)
    in_dst = np.asarray(g.in_dst, dtype=np.int64)
    dangling = deg == 0
    if g.weighted:
        src = np.repeat(np.arange(n), np.asarray(g.out_deg, np.int64))
        wsum = np.bincount(src, weights=np.asarray(g.out_w, np.float64),
                           minlength=n)
        inv_deg = np.where(dangling, 0.0, 1.0 / np.maximum(wsum, 1e-300))
        edge_w = np.asarray(g.in_w, dtype=np.float64)
    else:
        inv_deg = np.where(dangling, 0.0, 1.0 / np.maximum(deg, 1.0))
        edge_w = None

    pi = np.zeros(n, dtype=np.float64)
    pi[source] = 1.0
    e_s = np.zeros(n, dtype=np.float64)
    e_s[source] = 1.0
    for _ in range(max_iters):
        contrib = pi * inv_deg
        vals = contrib[in_src] if edge_w is None else contrib[in_src] * edge_w
        nxt = np.bincount(in_dst, weights=vals, minlength=n)
        nxt[dangling] += pi[dangling]          # self-loop on dangling rows
        nxt = alpha * e_s + (1.0 - alpha) * nxt
        if np.abs(nxt - pi).sum() <= tol:
            pi = nxt
            break
        pi = nxt
    return pi


def exact_ppr_power_batch(g: CSRGraph, sources, alpha: float = 0.2,
                          tol: float = 1e-12, max_iters: int = 2000,
                          progress=None, threads: int = None) -> np.ndarray:
    """Batched float64 power iteration over all sources at once.

    One scipy.sparse CSR operand (row-split across ``threads`` — scipy's
    matmat releases the GIL), one ping-pong [n, B] dense iterate pair:
    O(m * B) per iteration with NO per-iteration [n, B] temporaries.
    The naive ``E + (1-a) * (A @ X)`` formulation allocated three [n, B]
    float64 temporaries per iteration (4.3 GB each at LiveJournal scale,
    128 eval sources) — page-zeroing those dominated the sweep (measured
    round 3: ~150 s/iteration, i.e. hours to tol); the in-place split
    form runs the same iteration at a fraction of that.  Semantics
    identical to exact_ppr_power (absorbing dangling rows).
    Returns [n, B] float64.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    import scipy.sparse as sp
    n = g.n
    sources = np.asarray(sources, dtype=np.int64)
    B = len(sources)
    deg = np.asarray(g.out_deg, dtype=np.float64)
    dangling = np.nonzero(deg == 0)[0]
    in_src = np.asarray(g.in_src, dtype=np.int64)
    in_dst = np.asarray(g.in_dst, dtype=np.int64)
    # A[t, v] = w(v->t) / W(v) (unweighted: multiplicity / deg); dangling
    # v: A[v, v] = 1.  coo->csr sums duplicates, preserving parallel edges.
    if g.weighted:
        srcs = np.repeat(np.arange(n, dtype=np.int64),
                         np.asarray(g.out_deg, np.int64))
        wsum = np.bincount(srcs, weights=np.asarray(g.out_w, np.float64),
                           minlength=n)
        data = np.asarray(g.in_w, np.float64) / wsum[in_src]
    else:
        data = 1.0 / deg[in_src]
    rows = np.concatenate([in_dst, dangling])
    cols = np.concatenate([in_src, dangling])
    data = np.concatenate([data, np.ones(len(dangling))])
    A = sp.csr_matrix((data, (rows, cols)), shape=(n, n))

    T = threads or min(4, os.cpu_count() or 1)
    lo = [i * n // T for i in range(T + 1)]
    parts = [A[lo[i]: lo[i + 1]] for i in range(T)]
    # raw kernel writes straight into the ping-pong buffer: the public
    # ``A @ X`` allocates (and page-zeroes) a fresh [rows, B] output per
    # call, which at 4.2M x 128 f64 costs more than the arithmetic
    try:
        from scipy.sparse import _sparsetools
        _matvecs = _sparsetools.csr_matvecs       # Y += A @ X, flat C-order
        # one-time sanity check of the private kernel's contract (Y += A@X
        # over C-order flats): a future scipy signature/semantic change
        # must fall back to the public matmul, not corrupt inside workers
        _At = sp.csr_matrix(np.array([[0.0, 1.5], [2.0, 0.0]]))
        _Xt = np.array([[1.0, 2.0], [3.0, 4.0]])
        _Yt = np.ones((2, 2))
        _matvecs(2, 2, 2, _At.indptr, _At.indices, _At.data,
                 _Xt.ravel(), _Yt.ravel())
        if not np.allclose(_Yt, 1.0 + _At @ _Xt):
            _matvecs = None
    except Exception:
        _matvecs = None

    cols_b = np.arange(B)
    X = np.zeros((n, B), dtype=np.float64)
    X[sources, cols_b] = 1.0
    XN = np.empty_like(X)
    err_chunk = 1 << 17

    def one_part(i):
        Yi = XN[lo[i]: lo[i + 1]]
        Ai = parts[i]
        if _matvecs is not None:
            Yi.fill(0.0)
            _matvecs(Ai.shape[0], n, B, Ai.indptr, Ai.indices, Ai.data,
                     X.ravel(), Yi.ravel())
        else:
            Yi[...] = Ai @ X
        Yi *= (1.0 - alpha)

    with ThreadPoolExecutor(T) as ex:
        for it in range(max_iters):
            list(ex.map(one_part, range(T)))
            XN[sources, cols_b] += alpha     # E = alpha * e_s per column
            err_col = np.zeros(B)
            for c in range(0, n, err_chunk):
                err_col += np.abs(XN[c: c + err_chunk]
                                  - X[c: c + err_chunk]).sum(axis=0)
            err = float(err_col.max())
            X, XN = XN, X                    # ping-pong, no reallocation
            if progress is not None and it % 20 == 0:
                progress(it, err)
            if err <= tol:
                break
    return X


def exact_topk_batch(g: CSRGraph, sources, k: int, alpha: float = 0.2,
                     tol: float = 1e-12, progress=None,
                     threads: int = None) -> np.ndarray:
    """Top-k ids per source, [B, k] (descending by exact PPR)."""
    X = exact_ppr_power_batch(g, sources, alpha, tol=tol, progress=progress,
                              threads=threads)
    part = np.argpartition(-X, k - 1, axis=0)[:k].T          # [B, k]
    vals = np.take_along_axis(X.T, part, axis=1)
    order = np.argsort(-vals, kind="stable", axis=1)
    return np.take_along_axis(part, order, axis=1).astype(np.int64)


def exact_ppr(g: CSRGraph, source: int, alpha: float = 0.2,
              tol: float = 1e-12) -> np.ndarray:
    if g.n <= 512:
        return exact_ppr_dense(g, source, alpha)
    return exact_ppr_power(g, source, alpha, tol=tol)


def exact_topk(g: CSRGraph, source: int, k: int, alpha: float = 0.2
               ) -> tuple[np.ndarray, np.ndarray]:
    """Top-k node ids (desc by exact PPR) and their values."""
    pi = exact_ppr(g, source, alpha)
    idx = np.argsort(-pi, kind="stable")[:k]
    return idx.astype(np.int64), pi[idx]
