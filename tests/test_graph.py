"""Unit tests: CSR/ELL packing round-trips, generators, alias tables, native loader."""

import numpy as np
import pytest

from fora.graph import (
    from_edges, build_alias, generators, io,
)


def test_csr_roundtrip_small():
    src = np.array([0, 0, 1, 2, 3, 3, 3])
    dst = np.array([1, 2, 2, 0, 0, 1, 2])
    g = from_edges(src, dst, 4)
    assert g.n == 4 and g.m == 7
    # out-CSR: row v = out_indices[indptr[v]:indptr[v+1]]
    assert sorted(g.out_indices[g.out_indptr[0]:g.out_indptr[1]].tolist()) == [1, 2]
    assert g.out_indices[g.out_indptr[3]:g.out_indptr[4]].tolist() == [0, 1, 2]
    assert g.out_deg.tolist() == [2, 1, 1, 3]
    assert g.in_deg.tolist() == [2, 2, 3, 0]
    # in-edges sorted by dst, edge set preserved
    assert np.all(np.diff(g.in_dst) >= 0)
    orig = set(zip(src.tolist(), dst.tolist()))
    got = set(zip(g.in_src.tolist(), g.in_dst.tolist()))
    assert orig == got


def test_csr_dedup():
    src = np.array([0, 0, 0])
    dst = np.array([1, 1, 2])
    g = from_edges(src, dst, 3, dedup=True)
    assert g.m == 2


def test_csr_validates_range():
    with pytest.raises(ValueError):
        from_edges(np.array([0]), np.array([5]), 3)


def test_generators_shapes():
    g = generators.cycle_graph(10)
    assert g.n == 10 and g.m == 10 and np.all(g.out_deg == 1)
    g = generators.star_graph(5)
    assert g.out_deg.tolist() == [4, 0, 0, 0, 0]
    g = generators.karate_club()
    assert g.n == 34 and g.m == 156  # 78 undirected edges, symmetrized
    assert np.array_equal(np.sort(g.out_deg), np.sort(g.in_deg))
    g = generators.erdos_renyi(100, 500, seed=1)
    assert g.n == 100 and g.m == 500
    g = generators.rmat(8, 1000, seed=2)
    assert g.n == 256 and g.m == 1000
    # RMAT should be skewed: max degree well above mean
    assert g.out_deg.max() > 3 * g.out_deg.mean()


def test_alias_uniform_identity():
    g = generators.erdos_renyi(50, 300, seed=4)
    t = build_alias(g)
    assert np.all(t.prob == 1.0)
    assert np.array_equal(t.other, g.out_indices)


def test_alias_weighted_chi2():
    """Sampling through the alias table reproduces edge weights (chi^2)."""
    g = from_edges(np.zeros(4, dtype=np.int64), np.array([1, 2, 3, 4]), 5)
    w = np.array([0.1, 0.2, 0.3, 0.4])
    t = build_alias(g, weights=w)
    rng = np.random.default_rng(5)
    n_samp = 200_000
    j = rng.integers(0, 4, n_samp)
    u = rng.random(n_samp)
    dest = np.where(u < t.prob[j], g.out_indices[j], t.other[j])
    counts = np.bincount(dest, minlength=5)[1:]
    expected = w / w.sum() * n_samp
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 16.3  # chi2_{0.999, df=3}


def test_dataset_io_roundtrip(tmp_path):
    g = generators.karate_club()
    io.save_dataset(g, str(tmp_path), "karate")
    g2 = io.load_dataset(str(tmp_path), "karate", use_cache=False)
    assert g2.n == g.n and g2.m == g.m
    assert np.array_equal(g2.in_src, g.in_src)
    assert np.array_equal(g2.in_dst, g.in_dst)
    # cached load
    g3 = io.load_dataset(str(tmp_path), "karate", use_cache=True)
    g4 = io.load_dataset(str(tmp_path), "karate", use_cache=True)
    assert np.array_equal(g4.out_indices, g.out_indices)


def test_native_parser_matches_numpy(tmp_path):
    from fora._native import native_parse_edges
    if native_parse_edges is None:
        pytest.skip("native library not built")
    p = tmp_path / "graph.txt"
    p.write_text("# comment line\n0 1\n1 2\n 2   3 \n3 0\n")
    src, dst = native_parse_edges(str(p))
    assert src.tolist() == [0, 1, 2, 3]
    assert dst.tolist() == [1, 2, 3, 0]
