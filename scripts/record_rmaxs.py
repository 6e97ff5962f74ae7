"""Record the rmax_scale trade-off (one JSON document).

rmax_scale > 1 stops push earlier (rmax scaled up by rs, omega unchanged),
shifting work to the indexed walk phase: more throughput, bigger index,
and a precision cost (the Bernstein variance scales with rsum), at bench
scale (n=524K, m=8.4M RMAT, BASELINE config-3 shape at 1/8 size).

Runs bench.py once per rs in {1, 1.5, 2} with the bench-scale cache
(exact oracle + C++ baseline reused across rs; per-rs walk index built on
first use and cached).  The bench children run one at a time and this
parent never touches the card: each JAX process reserves most of the
card's memory, so a second one at once would fail.

Usage: python scripts/record_rmaxs.py [--out rmaxs.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BENCH_ENV = {
    "FORA_BENCH_NLOG2": "19", "FORA_BENCH_EDGEF": "16",
    "FORA_BENCH_BATCH": "256", "FORA_BENCH_POOL": "256",
    "FORA_BENCH_QUERIES": "512", "FORA_BENCH_EVAL": "32",
    "FORA_BENCH_CPPQ": "2",
}


def index_bytes(rs: float) -> int:
    tag = "rmat19x16s7.idx.e0.5" + (f".rs{rs:g}" if rs != 1 else "")
    d = ROOT / "bench_data" / tag
    return sum(f.stat().st_size for f in d.glob("*")) if d.exists() else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="rmaxs.json")
    ap.add_argument("--scales", default="1,1.5,2")
    args = ap.parse_args()

    rows = []
    for rs in [float(x) for x in args.scales.split(",")]:
        env = dict(os.environ, **BENCH_ENV,
                   FORA_BENCH_RMAXS=f"{rs:g}")
        t0 = time.time()
        r = subprocess.run([sys.executable, str(ROOT / "bench.py")],
                           env=env, capture_output=True, text=True,
                           timeout=14400, cwd=ROOT)
        if r.returncode != 0:
            raise RuntimeError(f"rs={rs}: {r.stderr[-2000:]}")
        d = json.loads(r.stdout.strip().splitlines()[-1])
        rows.append({
            "rmax_scale": rs, "qps": d["value"],
            "precision_at_k": d["precision_at_k"], "k": d["k"],
            "epsilon": d["epsilon"], "warmup_secs": d["warmup_secs"],
            "index_bytes": index_bytes(rs),
            "index_rel_size": None,  # filled below
        })
        print(f"[rmaxs] rs={rs}: {d['value']} q/s @ {d['precision_at_k']} "
              f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)
    base = rows[0]["index_bytes"] or 1
    for row in rows:
        row["index_rel_size"] = round(row["index_bytes"] / base, 3)
    rec = {"graph": "rmat19x16s7", "n": 1 << 19, "m": (1 << 19) * 16,
           "queries": 512, "eval_queries": 32, "batch": 256,
           "note": "rmax_scale>1 shifts push work to indexed walks: "
                   "faster, bigger index, measurably lower precision at "
                   "equal omega (Bernstein variance scales with rsum); "
                   "paper-balanced rs=1 stays the default",
           "rows": rows}
    (ROOT / args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({"wrote": args.out,
                      "rows": [(r["rmax_scale"], r["qps"],
                                r["precision_at_k"]) for r in rows]}))


if __name__ == "__main__":
    main()
