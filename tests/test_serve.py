"""Serving-loop tests: protocol, micro-batching, stats (SURVEY M6)."""

import asyncio
import json

import numpy as np
import pytest

from fora.serve import ForaServer


def _echo_query_fn(sources, seed):
    """Fake engine: top-3 'nodes' are source, source+1, source+2."""
    B = len(sources)
    ids = np.stack([sources + i for i in range(3)], axis=1)
    vals = np.tile(np.array([0.5, 0.3, 0.2], np.float32), (B, 1))
    return ids, vals


async def _roundtrip(port, requests):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    for req in requests:
        writer.write((json.dumps(req) + "\n").encode())
        await writer.drain()
        out.append(json.loads(await reader.readline()))
    writer.close()
    return out


def test_server_roundtrip_and_batching():
    async def main():
        srv = ForaServer(_echo_query_fn, batch=4, k=3, max_wait_ms=10)
        port = await srv.start(port=0)
        # concurrent clients to exercise batching
        results = await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": 10 + i}])
              for i in range(6)])
        for i, [resp] in enumerate(results):
            assert resp["id"] == i
            assert resp["nodes"] == [10 + i, 11 + i, 12 + i]
            assert resp["scores"] == pytest.approx([0.5, 0.3, 0.2])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["queries"] == 6
        assert stats["batches"] <= 6
        await srv.stop()

    asyncio.run(main())


def test_server_k_clamp_and_errors():
    async def main():
        srv = ForaServer(_echo_query_fn, batch=2, k=3, max_wait_ms=1)
        port = await srv.start(port=0)
        [r1, r2, r3] = await _roundtrip(port, [
            {"id": "a", "source": 5, "k": 2},
            {"not_source": 1},
            {"id": "b", "source": 7, "k": 99},
        ])
        assert r1["nodes"] == [5, 6]
        assert "error" in r2
        assert len(r3["nodes"]) == 3      # clamped to server k
        await srv.stop()

    asyncio.run(main())


def test_server_backpressure_sheds_load():
    """A saturated engine with a bounded queue sheds excess requests with
    an explicit 'overloaded' error instead of queueing unboundedly."""
    import time as _time

    def slow_fn(sources, seed):
        _time.sleep(0.2)
        return _echo_query_fn(sources, seed)

    async def main():
        srv = ForaServer(slow_fn, batch=1, k=3, max_wait_ms=1,
                         inflight=1, max_pending=1,
                         admission_timeout_ms=30.0)
        port = await srv.start(port=0)
        results = await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": i}])
              for i in range(8)])
        flat = [r for [r] in results]
        ok = [r for r in flat if "nodes" in r]
        shed = [r for r in flat if r.get("error") == "overloaded"]
        assert len(ok) + len(shed) == 8
        assert shed, "expected load shedding under saturation"
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["shed"] == len(shed)
        assert stats["latency_ms_p50"] is not None
        await srv.stop()

    asyncio.run(main())


def test_server_pipelined_batchers():
    """Two in-flight batchers overlap device calls: 4 sequential-batch
    seconds of work completes in ~half wall-clock with inflight=2."""
    import time as _time

    def slow_fn(sources, seed):
        _time.sleep(0.15)
        return _echo_query_fn(sources, seed)

    async def run(inflight):
        srv = ForaServer(slow_fn, batch=2, k=3, max_wait_ms=1,
                         inflight=inflight, max_pending=64)
        port = await srv.start(port=0)
        t0 = _time.monotonic()
        results = await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": i}])
              for i in range(8)])
        dt = _time.monotonic() - t0
        for i, [r] in enumerate(results):
            assert r["nodes"][0] == i
        await srv.stop()
        return dt

    async def main():
        seq = await run(1)
        pipe = await run(2)
        assert pipe < seq * 0.85, (seq, pipe)

    asyncio.run(main())


def test_server_precision_slo_sampling():
    """Every Nth scorable answer lands in the rolling precision window;
    stats reports the rolling mean (BASELINE config-5 SLO surface)."""
    # fake engine answers [s, s+1, s+2]; ground truth for even sources
    # matches fully, for odd sources 2-of-3
    exact = {s: np.array([s, s + 1, s + 2]) if s % 2 == 0
             else np.array([s, s + 1, 99999]) for s in range(10, 18)}

    async def main():
        srv = ForaServer(_echo_query_fn, batch=2, k=3, max_wait_ms=1,
                         slo_exact=exact, slo_sample_every=1)
        port = await srv.start(port=0)
        await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": 10 + i}])
              for i in range(8)])
        # an unscorable source (no ground truth) must not be sampled
        await _roundtrip(port, [{"id": "x", "source": 500}])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["slo_samples"] == 8
        assert stats["slo_k"] == 3
        # 4 even sources at 1.0 + 4 odd at 2/3
        assert stats["precision_at_k"] == pytest.approx(
            (4 * 1.0 + 4 * (2 / 3)) / 8, abs=1e-4)
        await srv.stop()

    asyncio.run(main())


def test_server_precision_slo_sampling_stride():
    """slo_sample_every=4 scores every 4th scorable answer only."""
    exact = {s: np.array([s, s + 1, s + 2]) for s in range(10, 26)}

    async def main():
        srv = ForaServer(_echo_query_fn, batch=2, k=3, max_wait_ms=1,
                         slo_exact=exact, slo_sample_every=4)
        port = await srv.start(port=0)
        for i in range(16):
            await _roundtrip(port, [{"id": i, "source": 10 + i}])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["slo_samples"] == 4
        assert stats["precision_at_k"] == pytest.approx(1.0)
        await srv.stop()

    asyncio.run(main())
