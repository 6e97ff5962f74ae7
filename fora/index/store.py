"""Walk-index (de)serialization — the engine's persistent artifact.

Mirrors the reference's index files under ``<prefix>/index/<dataset>/``
[R: build.h serialization — reconstruction, SURVEY.md Sec. 5.4]: flat
memory-mappable arrays plus a JSON manifest recording the (alpha, eps,
delta, p_f, rmax, omega) the index was built for — a mismatched config must
refuse to serve, since index sizing is part of the accuracy contract.

Format v2 stores the multi-resolution SpMV layout (see build.py):
  edge_src.npy / edge_dst.npy   endpoint-sorted index edges, bucketed
  counts_cum.npy                per-node visible-pool sizes per depth
  meta.json                     config + bucket offsets
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import ResolvedConfig
from .build import WalkIndex

FORMAT_VERSION = 2


def graph_fingerprint(g) -> str:
    """Content hash of the walk-relevant graph structure (adjacency +
    weights).  (n, m) alone can't tell two graphs apart — an edge rewire
    or a weight change with the same shape would silently serve a stale
    index; walks are distribution-bound to the exact adjacency."""
    import hashlib
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(g.out_indptr).tobytes())
    h.update(np.ascontiguousarray(g.out_indices).tobytes())
    if getattr(g, "out_w", None) is not None:
        h.update(np.ascontiguousarray(g.out_w).tobytes())
    return h.hexdigest()


def save(index: WalkIndex, rcfg: ResolvedConfig, path: str,
         graph=None) -> None:
    """``graph`` (CSRGraph or DeviceGraph, optional): records a content
    fingerprint so load() can refuse a same-shape different graph."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "edge_src.npy", np.asarray(index.edge_src))
    np.save(d / "edge_dst.npy", np.asarray(index.edge_dst))
    np.save(d / "counts_cum.npy", np.asarray(index.counts_cum))
    if index.edge_mult is not None:
        np.save(d / "edge_mult.npy", np.asarray(index.edge_mult))
    meta = {
        "format_version": FORMAT_VERSION,
        "n": rcfg.n, "m": rcfg.m,
        "alpha": rcfg.alpha, "epsilon": rcfg.epsilon, "delta": rcfg.delta,
        "pfail": rcfg.pfail, "rmax": index.rmax_built,
        "omega_unit": index.omega_unit_built,
        "bucket_offsets": [int(x) for x in index.bucket_offsets],
        "total_edges": int(index.total_edges),
    }
    if graph is not None:
        meta["graph_sha"] = graph_fingerprint(graph)
    (d / "meta.json").write_text(json.dumps(meta, indent=1))


def check_compatible(meta: dict, rcfg: ResolvedConfig,
                     graph=None) -> None:
    """An index serves a query config iff graph matches and the index was
    built at least as fine (omega_unit no smaller)."""
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"index format {meta['format_version']} != "
                         f"{FORMAT_VERSION}; rebuild the index")
    if (meta["n"], meta["m"]) != (rcfg.n, rcfg.m):
        raise ValueError("index built for a different graph "
                         f"(n,m)=({meta['n']},{meta['m']}) vs "
                         f"({rcfg.n},{rcfg.m})")
    if graph is not None and meta.get("graph_sha") is not None \
            and graph_fingerprint(graph) != meta["graph_sha"]:
        raise ValueError(
            "index built for a different graph (content fingerprint "
            "mismatch at equal (n, m) — edges or weights changed)")
    if abs(meta["alpha"] - rcfg.alpha) > 1e-12:
        raise ValueError("index alpha mismatch")
    if meta["omega_unit"] < rcfg.omega_unit * (1 - 1e-9):
        raise ValueError(
            "index too coarse for this config: built at "
            f"omega_unit={meta['omega_unit']:.3g}; query needs "
            f">= {rcfg.omega_unit:.3g}")


def load(path: str, rcfg: Optional[ResolvedConfig] = None,
         dedup: bool = True, graph=None, mmap: bool = False) -> WalkIndex:
    """``dedup``: indexes saved before the duplicate-merge layout (no
    edge_mult.npy) are upgraded in memory on load — lossless, and strictly
    cheaper to query (see build.py module docstring).

    ``mmap``: keep the edge arrays as host mmap views instead of device
    arrays.  The staged query path (StagedForaPrograms) device_puts ONE
    per-bucket slice each; with device-resident monolithic arrays those
    slices are device COPIES while the originals stay referenced — a
    duplicate ~2 GB of device memory at LiveJournal scale.  Use mmap=True for
    any large-graph batch/serve engine; the default keeps small-graph
    paths (CLI query, tests) device-resident as before."""
    from .build import dedup_index
    d = Path(path)
    meta = json.loads((d / "meta.json").read_text())
    if rcfg is not None:
        check_compatible(meta, rcfg, graph=graph)
    mult_f = d / "edge_mult.npy"
    arr = ((lambda f: np.load(f, mmap_mode="r")) if mmap
           else (lambda f: jnp.asarray(np.load(f))))
    idx = WalkIndex(
        edge_src=arr(d / "edge_src.npy"),
        edge_dst=arr(d / "edge_dst.npy"),
        bucket_offsets=np.asarray(meta["bucket_offsets"], dtype=np.int64),
        counts_cum=arr(d / "counts_cum.npy"),
        omega_unit_built=meta["omega_unit"],
        rmax_built=meta["rmax"],
        edge_mult=arr(mult_f) if mult_f.exists() else None,
    )
    if dedup and idx.edge_mult is None:
        idx = dedup_index(idx)
    return idx


def load_meta(path: str) -> dict:
    return json.loads((Path(path) / "meta.json").read_text())


# --------------------------------------------------------------------------
# shard-aware persistence (SURVEY.md Sec. 5.4: "shard-aware so each host
# loads only its rows")
# --------------------------------------------------------------------------
#
# The monolithic store above forces every host to materialize the full
# multi-GB index and re-partition it at engine start (an O(E) pass).  The
# sharded store persists the PARTITIONED layout once — per-shard files of
# the exact arrays the sharded engine device_puts — so host h reads only
# its shards' files (mmap slices, ~1/G of the bytes) and no global edge
# array ever exists in host RAM.

SHARDED_FORMAT_VERSION = 1


def _sharded_dir(path, n_shards: int) -> Path:
    return Path(path) / f"shards-G{n_shards}"


def save_sharded(index: WalkIndex, rcfg: ResolvedConfig, path: str,
                 n_shards: int, *, row_multiple: int = 8,
                 graph=None) -> Path:
    """Write the row-sharded layout for an ``n_shards``-way 'graph' axis
    under ``<path>/shards-G<G>/``.  ``row_multiple`` must match the
    engine's ``partition_rows`` padding (default 8) so the stored n_loc
    lines up with the runtime row partition."""
    import math

    from ..parallel.partition import partition_index
    n_loc = math.ceil(rcfg.n / n_shards)
    n_loc = -(-n_loc // row_multiple) * row_multiple
    pi = partition_index(index, n_shards, n_loc)
    d = _sharded_dir(path, n_shards)
    d.mkdir(parents=True, exist_ok=True)
    e = pi.e_loc_total
    for s in range(n_shards):
        # one flat .npy per array (npz members can't be memory-mapped)
        np.save(d / f"shard_{s:04d}.src.npy",
                pi.edge_src_local[s * e:(s + 1) * e])
        np.save(d / f"shard_{s:04d}.dst.npy",
                pi.edge_dst[s * e:(s + 1) * e])
        np.save(d / f"shard_{s:04d}.cc.npy",
                pi.counts_cum[s * n_loc:(s + 1) * n_loc])
        if pi.edge_mult is not None:
            np.save(d / f"shard_{s:04d}.mult.npy",
                    pi.edge_mult[s * e:(s + 1) * e])
    meta = {
        "sharded_format_version": SHARDED_FORMAT_VERSION,
        "n_shards": n_shards, "n_loc": n_loc, "e_loc_total": e,
        "row_multiple": row_multiple,
        "bucket_local_offsets": [int(x) for x in pi.bucket_local_offsets],
        "has_mult": pi.edge_mult is not None,
        # base-index identity (same fields the monolithic meta pins)
        "n": rcfg.n, "m": rcfg.m, "alpha": rcfg.alpha,
        "rmax": index.rmax_built, "omega_unit": index.omega_unit_built,
        "bucket_offsets": [int(x) for x in index.bucket_offsets],
        "format_version": FORMAT_VERSION,
    }
    if graph is not None:
        meta["graph_sha"] = graph_fingerprint(graph)
    (d / "meta.json").write_text(json.dumps(meta, indent=1))
    return d


class ShardedIndexStore:
    """Handle to a per-shard on-disk index.  Duck-types the WalkIndex
    surface the refinement runner needs (omega_unit_built / rmax_built /
    bucket_offsets / depth_for) WITHOUT loading any edge array; shard
    arrays are served per shard id as numpy mmap views."""

    def __init__(self, path: str, n_shards: int,
                 rcfg: Optional[ResolvedConfig] = None, graph=None):
        self.dir = _sharded_dir(path, n_shards)
        mf = self.dir / "meta.json"
        if not mf.exists():
            raise FileNotFoundError(
                f"no {n_shards}-way sharded index at {self.dir}; build one "
                f"with store.save_sharded(index, rcfg, path, {n_shards})")
        self.meta = json.loads(mf.read_text())
        if self.meta["sharded_format_version"] != SHARDED_FORMAT_VERSION:
            raise ValueError("sharded index format "
                             f"{self.meta['sharded_format_version']} != "
                             f"{SHARDED_FORMAT_VERSION}; rebuild")
        if rcfg is not None:
            check_compatible(self.meta, rcfg, graph=graph)
        self.n_shards = n_shards
        self.n_loc = int(self.meta["n_loc"])
        self.e_loc_total = int(self.meta["e_loc_total"])
        self.has_mult = bool(self.meta["has_mult"])
        self.bucket_local_offsets = np.asarray(
            self.meta["bucket_local_offsets"], dtype=np.int64)
        self.bucket_offsets = np.asarray(self.meta["bucket_offsets"],
                                         dtype=np.int64)
        self.omega_unit_built = float(self.meta["omega_unit"])
        self.rmax_built = float(self.meta["rmax"])

    # the same coverage-depth rule as the in-memory index
    depth_for = WalkIndex.depth_for

    def shard(self, s: int) -> dict:
        """Arrays of shard ``s`` (mmap-backed; only this shard's files are
        read).  Keys: edge_src_local, edge_dst, counts_cum[, edge_mult]."""
        p = self.dir / f"shard_{s:04d}"
        out = {
            "edge_src_local": np.load(f"{p}.src.npy", mmap_mode="r"),
            "edge_dst": np.load(f"{p}.dst.npy", mmap_mode="r"),
            "counts_cum": np.load(f"{p}.cc.npy", mmap_mode="r"),
        }
        if self.has_mult:
            out["edge_mult"] = np.load(f"{p}.mult.npy", mmap_mode="r")
        return out

    def bytes_per_shard(self, s: int = 0) -> int:
        return sum((self.dir / f"shard_{s:04d}{ext}").stat().st_size
                   for ext in (".src.npy", ".dst.npy", ".cc.npy")
                   + ((".mult.npy",) if self.has_mult else ()))
