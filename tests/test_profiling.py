"""Roofline accounting and measurement helper tests (SURVEY.md Sec. 5.1)."""

import types

import jax
import jax.numpy as jnp
import pytest

from fora.utils import profiling


def test_spmv_roofline_accounting():
    r = profiling.SpmvRoofline(edges=1_000_000, batch=128, nodes=65536)
    # indices + gathered rows + accumulator traffic
    expected = 1_000_000 * 8 + 1_000_000 * 128 * 4 + 2 * 65536 * 128 * 4
    assert r.bytes_moved == expected
    assert r.light_speed_secs(bw=1e12) == expected / 1e12
    assert r.efficiency(measured_secs=expected / 1e12, bw=1e12) == 1.0


def test_measure_blocks_and_returns_median():
    def f(x):
        return x * 2.0

    t = profiling.measure(f, jnp.ones((256, 256)), reps=3)
    assert 0 <= t < 5.0


def test_device_hbm_bw_fallback():
    """No fallback: a device kind missing from the table (here the CPU the
    suite runs on) raises instead of borrowing another chip's peak."""
    with pytest.raises(ValueError, match="no HBM bandwidth"):
        profiling.device_hbm_bw(jax.devices()[0])


@pytest.mark.parametrize("kind,bw", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                     ("NVIDIA H100 PCIe", 2.0e12),
                                     ("NVIDIA H100 NVL", 3.9e12)])
def test_device_hbm_bw_h100_kinds(kind, bw):
    dev = types.SimpleNamespace(device_kind=kind)
    assert profiling.device_hbm_bw(dev) == bw


def test_device_hbm_bw_unknown_gpu_raises():
    dev = types.SimpleNamespace(device_kind="NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        profiling.device_hbm_bw(dev)
