"""Sharded FORA+ index build: out-CSR row-sharded over the mesh, one psum
per hop, bit-identical output to the single-device builder (VERDICT
round-1 item 5 — the replicated-CSR memory wall)."""

import jax
import numpy as np
import pytest

from fora import index as widx
from fora.config import ForaConfig
from fora.graph import generators, to_device
from fora.parallel import make_mesh


def _setup(n=300, m=3000, seed=21, weighted=False):
    g = generators.erdos_renyi(n, m, seed=seed)
    if weighted:
        from fora.graph.csr import from_edges
        src = np.repeat(np.arange(g.n, dtype=np.int64),
                        np.asarray(g.out_deg, np.int64))
        w = np.random.default_rng(seed).uniform(0.2, 3.0, g.m)
        g = from_edges(src, np.asarray(g.out_indices, np.int64), n,
                       w=w.astype(np.float32))
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    return g, rcfg


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_build_bit_identical(weighted):
    g, rcfg = _setup(weighted=weighted)
    key = jax.random.key(9)
    want = widx.build_walk_index(to_device(g), rcfg, key, chunk=1 << 12)
    mesh = make_mesh(4, 2)
    got = widx.build_walk_index_sharded(g, mesh, rcfg, key, chunk=1 << 12)
    assert np.array_equal(np.asarray(want.edge_src), np.asarray(got.edge_src))
    assert np.array_equal(np.asarray(want.edge_dst), np.asarray(got.edge_dst))
    assert np.array_equal(want.bucket_offsets, got.bucket_offsets)
    assert np.array_equal(np.asarray(want.counts_cum),
                          np.asarray(got.counts_cum))
    if want.edge_mult is not None:
        assert np.array_equal(np.asarray(want.edge_mult),
                              np.asarray(got.edge_mult))


def test_sharded_build_breaks_memory_wall():
    """Per-shard CSR bytes stay under a simulated per-shard budget that the
    FULL CSR exceeds — the point of sharding the build (SURVEY Sec. 5.7).
    Also checks the skew bound: a shard holds at most its contiguous row
    range's edges, not the whole edge list."""
    g, _ = _setup(n=4000, m=80000)
    stats = widx.sharded_build_bytes(g, 8)
    budget = stats["replicated_bytes"] // 4   # full CSR would NOT fit
    assert stats["replicated_bytes"] > budget
    assert stats["per_shard_bytes"] < budget, stats
    assert stats["ratio"] < 0.5, stats


def test_sharded_build_checkpoint_resume(tmp_path):
    """Chunk checkpoints resume bit-identically across builders (shared
    manifest format: a single-device-resumed build equals a sharded one)."""
    g, rcfg = _setup(n=200, m=1600)
    key = jax.random.key(3)
    mesh = make_mesh(4, 2)
    ck = tmp_path / "ck"
    ref = widx.build_walk_index_sharded(g, mesh, rcfg, key, chunk=1 << 11,
                                        checkpoint_dir=str(ck))
    assert any(ck.glob("chunk_*.npy"))
    # resume from the completed checkpoints (no walks rerun) — same result
    again = widx.build_walk_index(to_device(g), rcfg, key, chunk=1 << 11,
                                  checkpoint_dir=str(ck))
    assert np.array_equal(np.asarray(ref.edge_src), np.asarray(again.edge_src))
    assert np.array_equal(np.asarray(ref.edge_dst), np.asarray(again.edge_dst))
