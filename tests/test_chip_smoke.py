"""chip_smoke.py's checks at a tiny size: its float64 host references
must accept the engine's kernels on the CPU (so a failure on the card is the
card's), and its device check must refuse anything but a GPU."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs

CHUNK = 1 << 12   # several gather chunks per call at this size


@pytest.fixture(scope="module")
def deployment():
    # 2^10 nodes x 16 edges: duplicate merge, a 64-row hub split and
    # chunked gathers all take part, as in the full-size deployment
    g, dg, rcfg = cs.make_deployment(10, hub_rows=64, chunk=CHUNK)
    r = jax.random.uniform(jax.random.key(0), (g.n, 16), jnp.float32)
    r64 = np.asarray(r, np.float64)
    return g, dg, rcfg, r, r64, cs.push_reference(g, r64, rcfg.alpha)


def test_push_superstep_f32_matches_reference(deployment):
    g, dg, rcfg, r, r64, refs = deployment
    assert dg.hub_split and dg.in_w is not None
    ep, er, _, _ = cs.check_push(dg, r, refs, rcfg.alpha, CHUNK)
    assert ep <= cs.F32_TOL and er <= cs.F32_TOL


def test_push_superstep_bf16_matches_reference(deployment):
    g, dg, rcfg, r, r64, refs = deployment
    _, eb, _, _ = cs.check_push(dg, r, refs, rcfg.alpha, CHUNK,
                                gather_dtype=jnp.bfloat16)
    assert eb <= cs.BF16_TOL
    # bf16 rounding is visible: the check compares against f64, not f32
    assert eb > cs.F32_TOL / 100


def test_bucket_spmv_matches_reference(deployment):
    from fora import index as widx
    g, dg, rcfg, r, r64, _ = deployment
    index = cs.host_index(widx.build_walk_index(dg, rcfg,
                                                jax.random.key(1)))
    q, n_edges, err = cs.check_bucket(index, r, r64, g.n, CHUNK)
    assert n_edges == int(np.max(np.diff(index.bucket_offsets)))
    assert n_edges > CHUNK
    assert err <= cs.F32_TOL


def test_check_topk_agrees_and_catches_a_wrong_score(deployment):
    g, dg, rcfg, r, r64, refs = deployment
    scores = np.asarray(refs[1], np.float32)
    assert cs.check_topk(scores, cs.K) == 0
    assert cs.check_answer(3, np.arange(cs.K))
    assert not cs.check_answer(cs.K + 3, np.arange(cs.K))
    assert not cs.check_answer(3, np.zeros(cs.K, int))


def test_require_gpu_refuses_cpu():
    with pytest.raises(cs.PhaseError, match="not a GPU"):
        cs.require_gpu(jax.devices("cpu"))
    gpu = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    cs.require_gpu([gpu])


@pytest.mark.gpu
def test_kernels_on_gpu(gpu_device):
    """The same checks compiled for the card (run with -m gpu)."""
    from fora import index as widx
    with jax.default_device(gpu_device):
        g, dg, rcfg = cs.make_deployment(14, hub_rows=1024, chunk=1 << 16)
        r = jax.random.uniform(jax.random.key(0), (g.n, 128), jnp.float32)
        r64 = np.asarray(r, np.float64)
        refs = cs.push_reference(g, r64, rcfg.alpha)
        ep, er, _, r2 = cs.check_push(dg, r, refs, rcfg.alpha, 1 << 16)
        assert max(ep, er) <= cs.F32_TOL
        _, eb, _, _ = cs.check_push(dg, r, refs, rcfg.alpha, 1 << 16,
                                    gather_dtype=jnp.bfloat16)
        assert eb <= cs.BF16_TOL
        index = cs.host_index(widx.build_walk_index(dg, rcfg,
                                                    jax.random.key(1)))
        assert cs.check_bucket(index, r, r64, g.n, 1 << 16)[2] <= cs.F32_TOL
        assert cs.check_topk(r2, cs.K) == 0
