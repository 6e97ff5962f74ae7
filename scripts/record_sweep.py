"""Record the relative-error sweep (one JSON document).

BASELINE config 2 ("Web-Stanford, FORA+ precomputed walk index, batched
queries — relative-error sweep vs epsilon") on the bench RMAT stand-in
(real datasets unreachable; SURVEY.md header).  Drives the PRODUCT
surface: the dataset is written in the reference on-disk format and every
step is a `python -m fora.cli` invocation (build once at the finest
epsilon — the multi-resolution index serves all coarser levels — then the
`sweep` action).  The CLI children run one at a time and this parent
never touches the card: each JAX process reserves most of the card's
memory, so a second one at once would fail.

Usage:  python scripts/record_sweep.py [--nlog2 19] [--out sweep.json]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def cli(args, timeout=3600):
    cmd = [sys.executable, "-m", "fora.cli"] + args
    print("[sweep] $", " ".join(args), file=sys.stderr, flush=True)
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=timeout)
    print(f"[sweep]   -> rc={r.returncode} in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-3000:])
    return r.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=19)
    ap.add_argument("--edgef", type=int, default=16)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--eps-grid", default="0.1,0.2,0.35,0.5")
    ap.add_argument("--cache", default="bench_data")
    ap.add_argument("--out", default="sweep.json")
    args = ap.parse_args()

    import numpy as np

    from fora.graph.csr import CSRGraph
    from fora.graph.io import save_dataset

    tag = f"rmat{args.nlog2}x{args.edgef}s7"
    cache = ROOT / args.cache
    prefix = cache / "ds"
    ddir = prefix / tag
    if not (ddir / "graph.txt").exists():
        z = np.load(cache / f"{tag}.npz")
        g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
        print(f"[sweep] writing dataset {ddir} (n={g.n} m={g.m})",
              file=sys.stderr, flush=True)
        save_dataset(g, str(prefix), tag)

    base = ["--prefix", str(prefix), "--dataset", tag]
    if not (ddir / f"{tag}.query").exists():
        cli(["generate-ss-query"] + base +
            ["--query-size", str(args.queries)])
    eps_min = min(float(x) for x in args.eps_grid.split(","))
    if not (prefix / "index" / tag / "meta.json").exists():
        cli(["build"] + base + ["--epsilon", str(eps_min)], timeout=7200)

    out = cli(["sweep"] + base +
              ["--with-idx", "--sweep-eps", args.eps_grid,
               "--batch", str(args.queries), "--k", str(args.k)],
              timeout=7200)
    rows = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    rec = {"config": "BASELINE config 2 (relative-error sweep vs epsilon)",
           "graph": tag, "indexed": True, "index_built_at_eps": eps_min,
           "k": args.k, "queries": args.queries, "rows": rows}
    # sanity: error should not increase as epsilon shrinks
    errs = [r["mean_rel_err"] for r in sorted(rows,
                                              key=lambda r: r["epsilon"])]
    rec["monotone_mean_rel_err"] = all(
        a <= b * 1.5 for a, b in zip(errs, errs[1:]))
    (ROOT / args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({"wrote": args.out,
                      "eps_to_mean_rel_err":
                          {r["epsilon"]: r["mean_rel_err"] for r in rows}}))


if __name__ == "__main__":
    main()
