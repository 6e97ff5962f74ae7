"""Multi-host bring-up (SURVEY.md Sec. 5.8 / M5).

The reference is single-process; the scale-out path here is
``jax.distributed`` + the same shard_map pipeline over a global mesh whose
'graph' axis spans hosts (the network between hosts, NVLink within one).

ShardedForaEngine is multi-host-ready as-is: every process constructs the
same global numpy arrays and ``jax.device_put`` with a NamedSharding over
the global mesh places only the locally-addressable shards.  These helpers
wrap initialization and result gathering.

Validated without a cluster by tests/test_multihost.py: two localhost
processes, 4 virtual CPU devices each, global 8-device mesh — the
distributed-without-a-cluster strategy of SURVEY.md Sec. 4.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def init(coordinator: str, num_processes: int, process_id: int,
         local_cpu_devices: Optional[int] = None) -> None:
    """Initialize jax.distributed.  Must run before any other jax use.

    ``local_cpu_devices``: emulate a multi-host setup on CPUs by giving
    each process this many virtual CPU devices (None = the accelerators
    each process finds).
    """
    import jax

    if local_cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_cpu_devices)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def gather_to_host(x) -> np.ndarray:
    """Gather a (possibly non-addressable) global array to every process."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
