"""Persistent serving loop — the M6 surface (SURVEY.md Sec. 7.2).

The reference has no server (its "serving" story is the CLI batch loop);
the north star's config 5 is sustained candidate-retrieval QPS at a fixed
precision SLO, so this module provides a line-oriented TCP JSON server with
micro-batching:

  request:  {"id": any, "source": int, "k": int (optional)}\n
  response: {"id": any, "nodes": [...], "scores": [...]}\n
  also:     {"cmd": "stats"} -> {"queries": N, "qps": ..., "batches": N}

Requests are queued and served in fixed-size batches (padding with repeats)
on the device; a batch is flushed when full or after ``max_wait_ms``.

Throughput/robustness model:
  * BACKPRESSURE — the admission queue is bounded (``max_pending``);
    when it stays full past ``admission_timeout_ms`` the request is shed
    with {"error": "overloaded"} instead of growing an unbounded backlog
    (the SLO story: bounded queueing delay, explicit load shedding).
  * PIPELINING — ``inflight`` batcher tasks (default 2) collect and
    dispatch independently, so batch i+1 assembles and dispatches while
    batch i executes on device (jax dispatch is async; query_fn runs in a
    thread pool sized to match).
  * Stats counters and futures are only touched on the event loop
    (the executor thread runs query_fn alone), so they are race-free by
    construction; ``stats`` reports QPS plus p50/p95/p99 latency over a
    sliding window.
  * PRECISION SLO (BASELINE config 5: sustained QPS at fixed
    precision@k) — ``slo_exact`` maps source -> exact top-k ids; every
    ``slo_sample_every``-th answered query whose source has ground truth
    is scored (set-overlap precision@k, microseconds of numpy on the
    event loop) into a rolling window; ``stats`` reports
    ``precision_at_k`` (rolling mean), ``slo_samples``, and ``slo_k``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import time
from collections import deque
from typing import Optional

import numpy as np


class ForaServer:
    def __init__(self, query_fn, batch: int, k: int, *,
                 max_wait_ms: float = 5.0, seed: int = 0,
                 inflight: int = 2, max_pending: Optional[int] = None,
                 admission_timeout_ms: float = 2000.0,
                 latency_window: int = 2048,
                 slo_exact: Optional[dict] = None,
                 slo_sample_every: int = 16,
                 slo_window: int = 512):
        """query_fn(sources_i32[batch], seed_int) -> (ids [B,k], vals [B,k])
        — a blocking device call (e.g. wrapping TopkRunner.query).

        ``slo_exact``: {source_id: exact top-k node ids} ground truth for
        the precision SLO sampler (see module docstring); queries whose
        source is absent are never scored."""
        self.query_fn = query_fn
        self.batch = batch
        self.k = k
        self.max_wait_ms = max_wait_ms
        self.seed = seed
        self.inflight = max(1, inflight)
        self.admission_timeout = admission_timeout_ms / 1e3
        self.queue: asyncio.Queue = asyncio.Queue(
            maxsize=max_pending if max_pending else 4 * batch)
        self.n_queries = 0
        self.n_batches = 0
        self.n_shed = 0
        self.n_errors = 0
        self.latencies: deque = deque(maxlen=latency_window)
        self.slo_exact = (
            {int(s): np.asarray(ids) for s, ids in slo_exact.items()}
            if slo_exact else None)
        self.slo_sample_every = max(1, slo_sample_every)
        self.slo_scores: deque = deque(maxlen=slo_window)
        self._slo_seen = 0
        self.t_start = time.time()
        self._server: Optional[asyncio.AbstractServer] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.inflight)

    def _slo_score(self, source: int, ids: np.ndarray) -> None:
        """Sample every Nth scorable answer into the rolling precision
        window (event-loop only — no locking needed)."""
        if self.slo_exact is None:
            return
        exact = self.slo_exact.get(int(source))
        if exact is None:
            return
        self._slo_seen += 1
        if self._slo_seen % self.slo_sample_every:
            return
        kk = min(self.k, len(exact))
        hit = len(np.intersect1d(ids[:kk], exact[:kk],
                                 assume_unique=False))
        self.slo_scores.append(hit / max(kk, 1))

    # --- protocol ---

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        while True:
            line = await reader.readline()
            if not line:
                break
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                writer.write(b'{"error": "bad json"}\n')
                await writer.drain()
                continue
            if req.get("cmd") == "stats":
                dt = time.time() - self.t_start
                lat = sorted(self.latencies)
                pct = (lambda q: round(
                    lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3, 2)
                    if lat else None)
                scores = list(self.slo_scores)
                writer.write((json.dumps({
                    "queries": self.n_queries, "batches": self.n_batches,
                    "shed": self.n_shed, "errors": self.n_errors,
                    "qps": self.n_queries / max(dt, 1e-9),
                    "latency_ms_p50": pct(0.50),
                    "latency_ms_p95": pct(0.95),
                    "latency_ms_p99": pct(0.99),
                    "precision_at_k": (round(float(np.mean(scores)), 4)
                                       if scores else None),
                    "slo_samples": len(scores),
                    "slo_k": self.k if self.slo_exact is not None
                    else None}) + "\n").encode())
                await writer.drain()
                continue
            if "source" not in req:
                writer.write(b'{"error": "missing source"}\n')
                await writer.drain()
                continue
            fut = asyncio.get_running_loop().create_future()
            t_enq = time.monotonic()
            try:
                # bounded admission: shed instead of queueing unboundedly
                await asyncio.wait_for(
                    self.queue.put((int(req["source"]), fut)),
                    timeout=self.admission_timeout)
            except asyncio.TimeoutError:
                self.n_shed += 1
                writer.write(b'{"error": "overloaded"}\n')
                await writer.drain()
                continue
            try:
                ids, vals = await fut
            except Exception:
                writer.write(b'{"error": "internal"}\n')
                await writer.drain()
                continue
            self.latencies.append(time.monotonic() - t_enq)
            self._slo_score(int(req["source"]), ids)
            k = min(int(req.get("k", self.k)), self.k)
            writer.write((json.dumps({
                "id": req.get("id"),
                "nodes": ids[:k].tolist(),
                "scores": [float(v) for v in vals[:k]]}) + "\n").encode())
            await writer.drain()
        writer.close()

    async def _batcher(self):
        while True:
            first = await self.queue.get()
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self.queue.get(),
                                                        timeout))
                except asyncio.TimeoutError:
                    break
            sources = np.array([s for s, _ in batch], dtype=np.int32)
            pad = self.batch - len(sources)
            padded = np.concatenate([sources, np.repeat(sources[-1:], pad)])
            self.seed += 1
            loop = asyncio.get_running_loop()
            try:
                ids, vals = await loop.run_in_executor(
                    self._pool, self.query_fn, padded, self.seed)
            except Exception as e:
                # a failed device call must fail THIS batch loudly, not
                # kill the batcher task silently (which would orphan every
                # later request's future and wedge all clients)
                import sys as _sys
                import traceback as _tb
                self.n_errors += 1
                print(f"[fora serve] batch failed: {e!r}",
                      file=_sys.stderr, flush=True)
                _tb.print_exc(file=_sys.stderr)
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError(f"batch failed: {e}"))
                continue
            ids, vals = np.asarray(ids), np.asarray(vals)
            self.n_queries += len(batch)
            self.n_batches += 1
            for i, (_, fut) in enumerate(batch):
                fut.set_result((ids[i], vals[i]))

    async def start(self, host: str = "127.0.0.1", port: int = 8471):
        # ``inflight`` independent batchers: batch i+1 assembles/dispatches
        # while batch i executes on device
        self._tasks = [asyncio.create_task(self._batcher())
                       for _ in range(self.inflight)]
        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self):
        for t in self._tasks:
            t.cancel()
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        self._pool.shutdown(wait=False)


def serve_forever(query_fn, batch: int, k: int, host="127.0.0.1",
                  port: int = 8471, **kw):  # pragma: no cover - CLI wrapper
    async def main():
        s = ForaServer(query_fn, batch, k, **kw)
        p = await s.start(host, port)
        print(f"[fora] serving on {host}:{p}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())
