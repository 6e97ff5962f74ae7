"""Test harness: the CPU suite runs on a virtual 8-device CPU mesh.

SURVEY.md Sec. 4 (distributed-without-a-cluster): the sharded shard_map
code paths run on one host over 8 virtual CPU devices.  Without
``JAX_PLATFORMS`` in the environment the suite pins JAX to the CPU; with
it (``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` on a machine
with a card) JAX's own choice stands.  Whether a card is present is
decided inside the ``gpu_device`` fixture, never at import.
"""

import os

import jax
import pytest

jax.config.update("jax_num_cpu_devices", 8)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU, or a skip when this process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        pytest.skip(f"no GPU visible to JAX: {e}")
