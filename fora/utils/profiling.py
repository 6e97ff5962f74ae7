"""Profiling + roofline accounting (SURVEY.md Sec. 5.1).

The reference self-reports phase timers only; here we add (a) Perfetto/XProf
trace capture via jax.profiler and (b) a bytes-moved roofline model for the
two hot SpMV phases, so a bench run can report achieved vs speed-of-light
HBM bandwidth — the north star's stated target for the push kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Optional

import jax

# Device-memory bandwidth (bytes/s) by the ``device_kind`` JAX reports,
# from NVIDIA's H100 data sheet.  A kind missing here is an error, never a
# default: a roofline share against a guessed peak is meaningless.
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def device_hbm_bw(device=None) -> float:
    kind = (device or jax.devices()[0]).device_kind
    try:
        return HBM_BW[kind]
    except KeyError:
        raise ValueError(
            f"no HBM bandwidth on record for device kind {kind!r}; "
            f"known kinds: {sorted(HBM_BW)}") from None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XProf/Perfetto trace around a block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class SpmvRoofline:
    """Bytes accounting for one gather+segment_sum superstep over E edges
    with batch width B (f32 values, i32 indices)."""

    edges: int
    batch: int
    nodes: int

    @property
    def bytes_moved(self) -> int:
        # read: edge src+dst indices, gathered rows; write+read: accumulator
        return (self.edges * 8                      # indices
                + self.edges * self.batch * 4       # gathered contrib rows
                + 2 * self.nodes * self.batch * 4)  # accumulator update

    def light_speed_secs(self, bw: Optional[float] = None) -> float:
        return self.bytes_moved / (bw or device_hbm_bw())

    def efficiency(self, measured_secs: float,
                   bw: Optional[float] = None) -> float:
        return self.light_speed_secs(bw) / max(measured_secs, 1e-12)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (one
    line per card).  A card set below its maximum power runs slower under
    load, so every recorded number carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def measure(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Median wall time of a completed call (``jax.block_until_ready``)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
