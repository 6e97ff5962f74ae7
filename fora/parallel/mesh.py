"""Mesh construction helpers for the ('graph', 'query') layout.

SURVEY.md Sec. 2.3 / 5.8: graph rows shard on one axis (the TP/SP analog),
batched sources on the other (DP).  Multi-host runs put 'graph' across
hosts; ``jax.distributed.initialize`` is the caller's responsibility
before building the mesh.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence, Tuple

import jax
import numpy as np

GRAPH_AXIS = "graph"
QUERY_AXIS = "query"


def make_mesh(n_graph: Optional[int] = None, n_query: Optional[int] = None,
              devices: Optional[Sequence] = None) -> jax.sharding.Mesh:
    devices = list(devices if devices is not None else jax.devices())
    d = len(devices)
    if n_graph is None and n_query is None:
        n_query = 1
        n_graph = d
    elif n_graph is None:
        n_graph = d // n_query
    elif n_query is None:
        n_query = d // n_graph
    if n_graph * n_query != d:
        raise ValueError(f"mesh {n_graph}x{n_query} != {d} devices")
    arr = np.asarray(devices).reshape(n_graph, n_query)
    return jax.sharding.Mesh(arr, (GRAPH_AXIS, QUERY_AXIS))


def shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map across jax versions (check_vma vs check_rep kwarg)."""
    kw = {}
    params = inspect.signature(jax.shard_map).parameters
    if "check_vma" in params:
        kw["check_vma"] = False
    elif "check_rep" in params:
        kw["check_rep"] = False
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, **kw)
