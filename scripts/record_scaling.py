"""Record the functional scaling numbers (one JSON document).

Produces the functional strong-scaling + wire-model numbers the north star's
">= 0.7 efficiency at 4 hosts" axis needs evidence for (BASELINE.md):

  1. in-process: scripts/scaling_test.py over graph shards 1..8 on the
     virtual CPU mesh, indexed, for exchange modes routed and hier;
  2. multi-process: tests/multihost_driver.py bench mode — the SAME
     8-shard indexed hier pipeline split across 1, 2, and 4 localhost
     processes (each process = one "host"; the hier exchange's inter-host
     stage crosses the process boundary as it would cross hosts).

Every child runs on virtual CPU devices (JAX_PLATFORMS=cpu): several JAX
processes cannot share one card.  The numbers validate the code path and
collective volumes, not real link bandwidth — the document records them
as `functional: true`.

Usage: python scripts/record_scaling.py [--out scaling.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# children run concurrently, so none of them may open the card
CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def run_scaling(exchange: str, nlog2=14, edgef=8, batch=32):
    cmd = [sys.executable, str(ROOT / "scripts" / "scaling_test.py"),
           "--nlog2", str(nlog2), "--edgef", str(edgef),
           "--batch", str(batch), "--meshes", "1,2,4,8", "--indexed",
           "--exchange", exchange, "--chips-per-host", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=1200,
                         cwd=ROOT, env=CPU_ENV)
    if out.returncode != 0:
        raise RuntimeError(f"{exchange}: {out.stderr[-2000:]}")
    return [json.loads(l) for l in out.stdout.splitlines()
            if l.startswith("{")]


def run_multihost(nproc: int, local: int, port: int, mode="bench",
                  extra=()):
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "multihost_driver.py"),
         str(p), str(nproc), str(port), mode, str(local), *map(str, extra)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=CPU_ENV)
        for p in range(nproc)]
    outs = [p.communicate(timeout=1800) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"proc failed: {se[-2000:]}")
    line = [l for l in outs[0][0].splitlines() if l.startswith("{")][-1]
    return json.loads(line)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="scaling.json")
    args = ap.parse_args()

    rec = {"functional": True,
           "note": "virtual CPU mesh / localhost processes: validates "
                   "code paths + collective volumes, not ICI/DCN bandwidth",
           "strong_scaling": {}, "multihost": []}
    for exchange in ("routed", "hier"):
        t0 = time.time()
        rows = run_scaling(exchange)
        rec["strong_scaling"][exchange] = rows
        print(f"[scaling] {exchange}: {len(rows)} mesh sizes in "
              f"{time.time()-t0:.0f}s", file=sys.stderr, flush=True)
    # per-collective latency: one psum over the 8-shard mesh per process
    # split — the fixed cost that dominates a toy-scale multihost bench
    # (300 nodes, batch 8: ~zero compute per superstep)
    rec["collective_latency"] = []
    for nproc, local, port in ((1, 8, 18721), (2, 4, 18722), (4, 2, 18723)):
        row = run_multihost(nproc, local, port, mode="collectives")
        rec["collective_latency"].append(row)
        print(f"[scaling] psum x{nproc}proc: {row['psum_us']}us",
              file=sys.stderr, flush=True)
    # multihost bench at a scale where per-superstep compute amortizes the
    # per-collective latency (at batch 8 / 300 nodes it measures only
    # gloo latency growth)
    for nproc, local, port in ((1, 8, 18731), (2, 4, 18732), (4, 2, 18733)):
        t0 = time.time()
        row = run_multihost(nproc, local, port, extra=(16, 64))
        rec["multihost"].append(row)
        print(f"[scaling] multihost x{nproc}: {row['qps']} q/s in "
              f"{time.time()-t0:.0f}s", file=sys.stderr, flush=True)
    base = rec["multihost"][0]["qps"]
    for row in rec["multihost"]:
        row["efficiency_vs_1proc"] = round(row["qps"] / base, 3)
    rec["multihost_note"] = (
        "CPU-device processes over gloo: per-collective latency grows "
        "with the process count (collective_latency rows); functional "
        "evidence only")
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({"wrote": args.out,
                      "hier_eff_4proc":
                          rec["multihost"][-1]["efficiency_vs_1proc"]}))


if __name__ == "__main__":
    main()
