"""Shard-aware GRAPH persistence — each host loads only its rows.

Mirrors the index's sharded store (fora/index/store.py save_sharded /
ShardedIndexStore) for the partitioned graph itself [R: build.h
serialization — reconstruction; SURVEY.md Sec. 5.4 "CSR/ELL/alias/
walk-index ... shard-aware so each host loads only its rows"].

Without this, every engine start ran ``partition.partition_rows`` over the
full in-RAM CSR in EVERY process (``multihost.py``'s contract was "every
process constructs the same global numpy arrays") — at Twitter/Friendster
scale (configs 4-5, 1.4-1.8B edges) that is 10-20 GB of per-host RAM plus
an O(m) partitioning pass per process.  Here the partitioned layout is
persisted ONCE (at build time, on the build host), as one flat .npy per
(shard, array) so a loading host mmaps only the files of the shards it
addresses; ``_ShardedPlacement`` feeds them to
``jax.make_array_from_callback``, which invokes the callback for
ADDRESSABLE devices only — per-host bytes are ~1/H of the graph.

Stored per shard s (under ``<dataset dir>/graph-shards-G<G>/``):

  shard_%04d.insrc.npy    [m_loc] i32   in-edge sources, global ids
  shard_%04d.indst.npy    [m_loc] i32   in-edge destinations, local ids
  shard_%04d.deg.npy      [n_loc] i32   out-degrees of owned rows
  shard_%04d.needed.npy   [G, n_loc] u8 routing mask: needed[t, i] = shard
                          t's in-edges reference my local row i (consumed
                          by the routed exchange; the hier exchange
                          derives its per-HOST mask from this locally)
  shard_%04d.windptr.npy  [n_loc+1] i32 localized out-CSR slice (walks)
  shard_%04d.windices.npy [mo_loc] i32
  weighted graphs add     .inw.npy [m_loc] f32, .wsum.npy [n_loc] f32,
                          .aliasp.npy / .aliaso.npy [mo_loc] (walk alias)
  meta.json               shapes + graph_sha + format version

The layouts are BIT-IDENTICAL to what ``partition_rows`` / ``_shard_csr``
produce at runtime (tested), so a store-backed placement and an in-RAM
placement are interchangeable.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..graph.csr import CSRGraph

GRAPH_STORE_FORMAT_VERSION = 1


def _store_dir(path, n_shards: int) -> Path:
    return Path(path) / f"graph-shards-G{n_shards}"


def save_sharded_graph(g: CSRGraph, path: str, n_shards: int, *,
                       row_multiple: int = 8,
                       with_walk_side: bool = True) -> Path:
    """Partition ``g`` (full CSR in RAM — run once, on the build host) and
    persist the per-shard layout under ``<path>/graph-shards-G<G>/``."""
    from ..index.build_sharded import _shard_csr
    from ..index.store import graph_fingerprint
    from . import partition as part

    pg = part.partition_rows(g, n_shards, row_multiple=row_multiple)
    needed = part.needed_masks(pg).reshape(n_shards, n_shards, pg.n_loc)
    d = _store_dir(path, n_shards)
    d.mkdir(parents=True, exist_ok=True)
    G, n_loc, m_loc = n_shards, pg.n_loc, pg.m_loc

    mo_loc = 0
    if with_walk_side:
        n_loc_w, windptr, windices, _deg, ap, ao = _shard_csr(
            g, G, row_multiple=row_multiple)
        if n_loc_w != n_loc:
            raise AssertionError(f"walk CSR n_loc={n_loc_w} != {n_loc}")
        mo_loc = windices.shape[1]

    for s in range(G):
        p = d / f"shard_{s:04d}"
        np.save(f"{p}.insrc.npy", pg.in_src_global[s * m_loc:(s + 1) * m_loc])
        np.save(f"{p}.indst.npy", pg.in_dst_local[s * m_loc:(s + 1) * m_loc])
        np.save(f"{p}.deg.npy", pg.out_deg_sharded[s * n_loc:(s + 1) * n_loc])
        # shard s's routing block: needed[s][t, i] = shard t's in-edges
        # reference MY (shard s's) local row i — matches the P('graph')
        # layout of partition.needed_masks
        np.save(f"{p}.needed.npy", needed[s].astype(np.uint8))
        if pg.weighted:
            np.save(f"{p}.inw.npy",
                    pg.in_w_sharded[s * m_loc:(s + 1) * m_loc])
            np.save(f"{p}.wsum.npy",
                    pg.out_wsum_sharded[s * n_loc:(s + 1) * n_loc])
        if with_walk_side:
            np.save(f"{p}.windptr.npy", windptr[s])
            np.save(f"{p}.windices.npy", windices[s])
            if pg.weighted:
                np.save(f"{p}.aliasp.npy", ap[s])
                np.save(f"{p}.aliaso.npy", ao[s])

    meta = {
        "graph_store_format_version": GRAPH_STORE_FORMAT_VERSION,
        "n": g.n, "m": g.m, "n_shards": G, "n_loc": n_loc, "m_loc": m_loc,
        "mo_loc": mo_loc, "row_multiple": row_multiple,
        "weighted": bool(pg.weighted), "with_walk_side": with_walk_side,
        "graph_sha": graph_fingerprint(g),
    }
    (d / "meta.json").write_text(json.dumps(meta, indent=1))
    return d


class ShardedGraphStore:
    """Handle to the per-shard on-disk graph.  Serves shard arrays as numpy
    mmap views; exposes the metadata the sharded engine needs (n, m, n_loc,
    weighted, graph_sha) WITHOUT materializing any global array."""

    def __init__(self, path: str, n_shards: int):
        self.dir = _store_dir(path, n_shards)
        mf = self.dir / "meta.json"
        if not mf.exists():
            raise FileNotFoundError(
                f"no {n_shards}-way sharded graph store at {self.dir}; "
                f"write one with save_sharded_graph(g, path, {n_shards})")
        self.meta = json.loads(mf.read_text())
        if (self.meta["graph_store_format_version"]
                != GRAPH_STORE_FORMAT_VERSION):
            raise ValueError(
                f"graph store format "
                f"{self.meta['graph_store_format_version']} != "
                f"{GRAPH_STORE_FORMAT_VERSION}; re-save")
        if self.meta["n_shards"] != n_shards:
            raise ValueError("shard-count mismatch")
        self.n = int(self.meta["n"])
        self.m = int(self.meta["m"])
        self.n_shards = n_shards
        self.n_loc = int(self.meta["n_loc"])
        self.m_loc = int(self.meta["m_loc"])
        self.mo_loc = int(self.meta["mo_loc"])
        self.weighted = bool(self.meta["weighted"])
        self.with_walk_side = bool(self.meta["with_walk_side"])
        self.graph_sha: Optional[str] = self.meta.get("graph_sha")
        self.row_multiple = int(self.meta["row_multiple"])

    _EXT = {"in_src_global": "insrc", "in_dst_local": "indst",
            "out_deg": "deg", "needed": "needed",
            "in_w": "inw", "out_wsum": "wsum",
            "walk_indptr": "windptr", "walk_indices": "windices",
            "alias_prob": "aliasp", "alias_other": "aliaso"}

    def shard(self, s: int) -> dict:
        """mmap-backed arrays of shard ``s`` — only this shard's files are
        opened.  Keys as in ``_EXT`` (subset per weighted/walk-side)."""
        p = self.dir / f"shard_{s:04d}"
        keys = ["in_src_global", "in_dst_local", "out_deg", "needed"]
        if self.weighted:
            keys += ["in_w", "out_wsum"]
        if self.with_walk_side:
            keys += ["walk_indptr", "walk_indices"]
            if self.weighted:
                keys += ["alias_prob", "alias_other"]
        return {k: np.load(f"{p}.{self._EXT[k]}.npy", mmap_mode="r")
                for k in keys}

    def bytes_per_shard(self, s: int = 0) -> int:
        p = self.dir / f"shard_{s:04d}"
        return sum(f.stat().st_size
                   for f in self.dir.glob(f"shard_{s:04d}.*.npy"))
