"""Dataset I/O honoring the reference's on-disk contract.

Contract [R: README / graph.h — reconstruction, SURVEY.md Sec. 2.1]:
  <prefix>/<dataset>/graph.txt       one "src dst" pair per line, 0-indexed;
                                     an optional third column carries a
                                     positive per-edge weight (weighted
                                     graphs, auto-detected)
  <prefix>/<dataset>/attribute.txt   two lines: "n=<N>" and "m=<M>"

A C++ fast path (fora/_native/graph_io.cpp, via ctypes) parses large
edge lists at memory bandwidth; numpy.loadtxt is the fallback.  Packed CSR
arrays are cached next to the dataset as .npz so repeat runs skip parsing.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from .csr import CSRGraph, from_edges
from .._native import (native_parse_edges,  # None if the .so is unavailable
                       native_parse_edges_w)


def load_attribute(dataset_dir: Path) -> tuple[int, int]:
    n = m = None
    for line in (dataset_dir / "attribute.txt").read_text().splitlines():
        line = line.strip()
        if line.startswith("n="):
            n = int(line[2:])
        elif line.startswith("m="):
            m = int(line[2:])
    if n is None or m is None:
        raise ValueError(f"attribute.txt missing n=/m= in {dataset_dir}")
    return n, m


def _detect_weighted(path: Path, sample: int = 1024) -> bool:
    """True if graph.txt carries a third (weight) column.  Scans a sample
    of data lines, not just the first: a mixed-width file (some lines with
    weights, some without) is ambiguous and raises rather than silently
    dropping weights or crashing deep inside the parser."""
    widths = set()
    seen = 0
    with open(path) as f:
        for line in f:
            t = line.strip()
            if not t or t[0] in "#%":
                continue
            widths.add(min(len(t.split()), 3))
            seen += 1
            if seen >= sample:
                break
    if len(widths) > 1:
        raise ValueError(
            f"{path}: mixed column counts {sorted(widths)} in the first "
            f"{seen} data lines — weighted edge lists must carry the third "
            "column on every line")
    return widths == {3}


def load_dataset(prefix: str, dataset: str, use_cache: bool = True) -> CSRGraph:
    """Load <prefix>/<dataset>/graph.txt into packed CSR form.  A third
    column in graph.txt is auto-detected as per-edge weights."""
    ddir = Path(prefix) / dataset
    cache = ddir / "csr_cache.npz"
    if use_cache and cache.exists() and \
            cache.stat().st_mtime >= (ddir / "graph.txt").stat().st_mtime:
        z = np.load(cache)
        return CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})

    n, _ = load_attribute(ddir)
    path = ddir / "graph.txt"
    w = None
    if _detect_weighted(path):
        if native_parse_edges_w is not None:
            src, dst, w = native_parse_edges_w(str(path))
        else:
            e = np.loadtxt(path, dtype=np.float64, ndmin=2)
            src, dst = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
            w = e[:, 2].astype(np.float32)
    elif native_parse_edges is not None:
        src, dst = native_parse_edges(str(path))
    else:
        e = np.loadtxt(path, dtype=np.int64, ndmin=2)
        src, dst = e[:, 0], e[:, 1]
    g = from_edges(src, dst, n, w=w)
    if use_cache:
        try:
            np.savez(cache, **{k: v for k, v in g._asdict().items()
                               if v is not None})
        except OSError:
            pass  # read-only dataset dir: skip caching
    return g


def save_dataset(g: CSRGraph, prefix: str, dataset: str) -> None:
    """Write a graph back out in the reference's format (fixtures, tests);
    weighted graphs emit the third (weight) column."""
    ddir = Path(prefix) / dataset
    os.makedirs(ddir, exist_ok=True)
    (ddir / "attribute.txt").write_text(f"n={g.n}\nm={g.m}\n")
    # out-CSR order: expand indptr to per-edge src; vectorized writer
    # (a per-edge Python loop takes minutes at 10M+ edges)
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.asarray(g.out_deg, dtype=np.int64))
    with open(ddir / "graph.txt", "w") as f:
        if g.weighted:
            np.savetxt(f, np.column_stack(
                [src, np.asarray(g.out_indices, np.int64),
                 np.asarray(g.out_w, np.float64)]), fmt="%d %d %g")
        else:
            np.savetxt(f, np.column_stack(
                [src, np.asarray(g.out_indices, np.int64)]), fmt="%d %d")
