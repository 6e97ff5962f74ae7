"""Time a fresh judged-scale index build.

Levers in place: length-scheduled walk kernel (~10x fewer hop-gather
elements), 2^23-lane chunks (amortize per-program overhead), and 2-deep
dispatch pipelining (host packing / checkpoint IO overlaps device
execution).

Builds into a throwaway dir (never clobbers the bench's cached index).
Usage: python scripts/time_index_build.py [--nlog2 22] [--chunk-log2 23]
"""

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=22)
    ap.add_argument("--edgef", type=int, default=16)
    ap.add_argument("--chunk-log2", type=int, default=23)
    ap.add_argument("--out", default=None, help="optional JSON artifact")
    args = ap.parse_args()

    from fora.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    from fora.config import ForaConfig
    from fora.graph import to_device
    from fora.graph.csr import CSRGraph
    from fora import index as widx

    tag = f"rmat{args.nlog2}x{args.edgef}s7"
    z = np.load(ROOT / "bench_data" / f"{tag}.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True)
    ckpt = ROOT / "bench_data" / f".rebuild_timing_{tag}"
    shutil.rmtree(ckpt, ignore_errors=True)

    t0 = time.time()
    times = []

    def prog(i, n, cached):
        times.append(time.time() - t0)
        if not cached and (i + 1) % 8 == 0 or i + 1 == n:
            print(f"[build] chunk {i+1}/{n} ({times[-1]:.0f}s)",
                  file=sys.stderr, flush=True)

    idx = widx.build_walk_index(dg, rcfg, jax.random.key(7),
                                chunk=1 << args.chunk_log2,
                                checkpoint_dir=str(ckpt), progress=prog)
    build_secs = time.time() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    per_chunk = (np.diff(times).tolist() if len(times) > 1 else [])
    from fora import _native
    rec = {"graph": tag, "n": g.n, "m": g.m,
           "chunk_lanes": 1 << args.chunk_log2,
           "n_chunks": len(times),
           "build_secs": round(build_secs, 1),
           # device walk phase ends at the last chunk's drain; the
           # remainder is the host pack (bucketing + sort-merge)
           "walk_secs": round(times[-1], 1) if times else None,
           "pack_secs": (round(build_secs - times[-1], 1)
                         if times else None),
           "median_chunk_secs": (round(float(np.median(per_chunk)), 2)
                                 if per_chunk else None),
           "index_edges": idx.total_edges,
           "kernel": "scheduled-v1 + pipelined chunks",
           "pack_sort": ("native-parallel-radix"
                         if _native.native_sort_unique_u64 else "numpy")}
    print(json.dumps(rec))
    if args.out:
        (ROOT / args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
