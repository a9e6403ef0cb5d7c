"""Closed-loop keep-alive HTTP clients in a process of their own.

A rewrite of ``arxiv_rag_tpu_torch/tools/serve_bench.py``'s ``Load``:
the clients run here, in a child process on one asyncio loop (one
thread), so they take no interpreter time from the server under test.
Each client holds one HTTP/1.1 connection and sends its next request
only when the last reply is complete. A request is timed on this side
from the send to the last byte of its reply. Nothing is retried: a
request that fails (an error, a status other than 200, a reply without
one full list of hits per query) counts as failed, and the client opens
a new connection and goes on.

Phases: warm-up (its own requests; the server's shapes, caches and
allocator), a drain, then the measured window. Every request sent before
the window closes counts, and its reply is awaited (up to ``grace_s``
past the close). Lines on stdout tell the parent ``window_start <t>`` and
``window_end <t>`` (``time.monotonic``, one clock for every process of
the machine).

    python -m benchmark.traffic.http_clients SPEC.json OUT.json

SPEC: host, port, k, warm_s, window_s, grace_s, keep_every, and per
client ``warm`` and ``window`` lists of request bodies (strings), sent
in turn and cycled. OUT: every window request as [client, index, sent,
done, ok, queries], and the replies of the kept ones (index %
keep_every == client % keep_every) as {"client:index": body}.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


class _Conn:
    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self.reader = self.writer = None

    async def open(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(self.host, self.port)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.reader = self.writer = None

    async def post(self, body: bytes) -> tuple[int, bytes]:
        if self.writer is None:
            await self.open()
        head = (f"POST /search HTTP/1.1\r\nHost: {self.host}:{self.port}\r\n"
                f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n\r\n")
        self.writer.write(head.encode() + body)
        await self.writer.drain()
        status_line = await self.reader.readline()
        if not status_line:
            raise ConnectionError("connection closed")
        status = int(status_line.split()[1])
        length = None
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        if length is None:
            raise ConnectionError("reply without Content-Length")
        return status, await self.reader.readexactly(length)


def _valid(status: int, payload: bytes, n_queries: int, k: int) -> bool:
    if status != 200:
        return False
    try:
        results = json.loads(payload)["results"]
    except (ValueError, KeyError, TypeError):
        return False
    return len(results) == n_queries and all(len(hits) == k for hits in results)


async def _client(ci: int, conn: _Conn, bodies: list[bytes], counts: list[int], k: int,
                  until: float, grace_until: float, keep_every: int, rec: list, kept: dict) -> None:
    i = 0
    while time.monotonic() < until:
        j = i % len(bodies)
        t0 = time.monotonic()
        ok, payload = False, b""
        try:
            status, payload = await asyncio.wait_for(
                conn.post(bodies[j]), timeout=max(0.1, grace_until - t0))
            ok = _valid(status, payload, counts[j], k)
        except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError, ValueError,
                IndexError):
            pass
        t1 = time.monotonic()
        if not ok:
            conn.close()
        rec.append([ci, i, t0, t1, ok, counts[j]])
        if ok and keep_every and i % keep_every == ci % keep_every:
            kept[f"{ci}:{i}"] = payload.decode()
        i += 1


async def _phase(conns, bodies, counts, k, start, seconds, grace_s, keep_every):
    until, grace_until = start + seconds, start + seconds + grace_s
    recs = [[] for _ in conns]
    kept: dict = {}
    await asyncio.gather(*(
        _client(ci, c, b, n, k, until, grace_until, keep_every, r, kept)
        for ci, (c, b, n, r) in enumerate(zip(conns, bodies, counts, recs))))
    return start, [x for r in recs for x in r], kept


async def main_async(spec: dict) -> dict:
    conns = [_Conn(spec["host"], spec["port"]) for _ in spec["window"]]
    k = spec["k"]

    def encode(lists):
        return ([[b.encode() for b in bl] for bl in lists],
                [[len(json.loads(b)["queries"]) for b in bl] for bl in lists])

    warm_b, warm_n = encode(spec["warm"])
    win_b, win_n = encode(spec["window"])
    if spec["warm_s"] > 0:
        _, wrec, _ = await _phase(conns, warm_b, warm_n, k, time.monotonic(), spec["warm_s"],
                                  spec["grace_s"], 0)
        warm_failed = sum(1 for r in wrec if not r[4])
    else:
        warm_failed = 0
    start = time.monotonic()
    print(f"window_start {start!r}", flush=True)
    _, rec, kept = await _phase(conns, win_b, win_n, k, start, spec["window_s"],
                                spec["grace_s"], spec["keep_every"])
    end = max([r[3] for r in rec] or [start])
    print(f"window_end {end!r}", flush=True)
    for c in conns:
        c.close()
    return {"start": start, "end": end, "requests": rec, "kept": kept,
            "warm_failed": warm_failed}


def main(argv: list[str]) -> int:
    spec = json.loads(open(argv[0]).read())
    out = asyncio.run(main_async(spec))
    with open(argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
