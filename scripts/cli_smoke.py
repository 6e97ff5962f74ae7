"""Drive the CLI end to end on the accelerator.

Writes an RMAT dataset in the reference on-disk format, then runs
``python -m fora.cli`` the way a user would: generate-ss-query, build (the
FORA+ index), batch-topk in 128-query pools with straggler deferral, and
the serve action answering TCP requests.  Answers are checked against the
exact oracle (precision@50 >= 0.95 on the evaluated sources).

The CLI children run one at a time and this parent never touches the card:
each JAX process reserves most of the card's memory.

Usage: python scripts/cli_smoke.py [--nlog2 20] [--eval 16]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K = 50
PRECISION_FLOOR = 0.95


def cli(*args, timeout=1800):
    cmd = [sys.executable, "-m", "fora.cli", *args]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=timeout)
    print(f"[cli_smoke] {args[0]}: rc={r.returncode} "
          f"{time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    if r.returncode != 0:
        raise SystemExit(f"{args[0]} failed:\n{r.stderr[-3000:]}")
    return r


def serve_and_ask(base, sources):
    proc = subprocess.Popen(
        [sys.executable, "-m", "fora.cli", "serve", *base, "--with-idx",
         "--batch", "128", "--k", str(K), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        if "serving on" not in line:
            raise SystemExit(f"serve did not start: {line!r}")
        port = int(line.rsplit(":", 1)[1])

        def ask(i_s):
            i, s = i_s
            with socket.create_connection(("127.0.0.1", port), 600) as sock:
                f = sock.makefile("rw")
                f.write(json.dumps({"id": i, "source": int(s)}) + "\n")
                f.flush()
                return json.loads(f.readline())

        t0 = time.time()
        with ThreadPoolExecutor(len(sources)) as ex:
            answers = list(ex.map(ask, enumerate(sources)))
        secs = time.time() - t0
        with socket.create_connection(("127.0.0.1", port), 60) as sock:
            f = sock.makefile("rw")
            f.write('{"cmd": "stats"}\n')
            f.flush()
            stats = json.loads(f.readline())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    return answers, stats, secs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlog2", type=int, default=20)
    ap.add_argument("--eval", type=int, default=16)
    args = ap.parse_args()

    from fora.algo import exact
    from fora.eval import metrics, queries as qio
    from fora.graph import generators
    from fora.graph.io import save_dataset

    with tempfile.TemporaryDirectory(prefix="fora_cli_") as d:
        tag = f"rmat{args.nlog2}"
        g = generators.rmat(args.nlog2, (1 << args.nlog2) * 16, seed=7)
        save_dataset(g, d, tag)
        base = ["--prefix", d, "--dataset", tag]
        cli("generate-ss-query", *base, "--query-size", "256")
        sources = qio.load_queries(str(Path(d) / tag / f"{tag}.query"))
        with ThreadPoolExecutor(1) as ex:   # host oracle beside the CLI
            exact_fut = ex.submit(exact.exact_topk_batch, g,
                                  sources[:args.eval], K,
                                  threads=os.cpu_count())
            cli("build", *base, "--epsilon", "0.5")
            out = Path(d) / "out.jsonl"
            r = cli("batch-topk", *base, "--with-idx", "--k", str(K),
                    "--batch", "128", "--pool", "128",
                    "--hub-rows", "131072", "--output", str(out))
            answers, stats, serve_secs = serve_and_ask(
                base, sources[:2 * args.eval])
            exact_ids = exact_fut.result()
        rows = {int(j["source"]): j["ids"]
                for j in map(json.loads, out.read_text().splitlines())}

    ok = len(rows) == len(sources) and all(
        len(ids) == K and s in ids for s, ids in rows.items())
    ok &= all(len(a["nodes"]) == K and int(s) in a["nodes"]
              for s, a in zip(sources, answers))
    p_batch = metrics.batch_precision_at_k(
        np.stack([rows[int(s)] for s in sources[:args.eval]]), exact_ids)
    p_serve = metrics.batch_precision_at_k(
        np.stack([a["nodes"] for a in answers[:args.eval]]), exact_ids)
    qps = [ln for ln in r.stderr.splitlines() if "queries done" in ln]
    print(json.dumps({
        "nodes": g.n, "edges": g.m, "queries": len(rows),
        "batch_topk": qps[-1].strip() if qps else None,
        "precision_batch_topk": round(p_batch, 4),
        "served": len(answers), "serve_secs": round(serve_secs, 2),
        "serve_stats": stats, "precision_served": round(p_serve, 4),
        "ok": bool(ok and min(p_batch, p_serve) >= PRECISION_FLOOR)}))
    return 0 if ok and min(p_batch, p_serve) >= PRECISION_FLOOR else 1


if __name__ == "__main__":
    sys.exit(main())
