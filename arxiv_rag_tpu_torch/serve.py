"""HTTP query service — the port's own copy of ``arxiv_rag_tpu/serve.py``.

SURVEY §7 layer 6 ("a thin query API"). stdlib-only (http.server) by
design: zero new dependencies, one process, the engine underneath.
Endpoints:

- ``POST /search``  body: {"queries": [str], "k": int?,
  "categories": [str]?, "hybrid_alpha": float?} → {"results": [[hit]]};
  a reranked hit carries its pre-rerank score as ``dense_score``
- ``POST /admin/reload``  body: {"index_dir": str?, "corpus_dir": str?,
  "bm25_path": str?} → swap in a grown or rebuilt index with no
  downtime: ``engine.prepare_reload`` loads, places and warms it on the
  handler thread while the old index serves (a sharded index onto the
  engine's mesh, ``serve --shard``); the swap runs on the dispatch
  thread behind a completion barrier. Without an admin token
  only the server's own paths reload; with one, every reload needs it
  (``X-Admin-Token``).
- ``GET /healthz``  → {"status": "ok", "rows": N, "dim": D, ...}
- ``GET /metrics``  → the METRICS counters/timers snapshot

Spans (``METRICS`` timers; while a torch profiler records, annotations on
its clock): ``serve.request`` around a ``/search`` request,
``serve.reply`` around each reply's JSON encode and write,
``serve.queue_wait`` from a request's enqueue to its window's dispatch,
and per engine call ``serve.dispatch`` and ``serve.batched_search``,
whose annotations carry ``w=<n>`` (the batcher's n-th engine call) so one
window joins across the batcher and completion threads.

Concurrency: the engine's device state is single-stream, so requests
can't fan out — instead a MICRO-BATCHER coalesces them. Handler threads
enqueue their queries and block; one dispatcher thread drains the queue
every ``batch_window_ms`` (or immediately at ``max_batch``), groups
requests by (k, categories, hybrid_alpha), runs ONE engine.search per
group, and hands each request its slice. A scan reads the whole index
whatever the batch, so coalescing is what turns kernel throughput into
service throughput; a lone request still only waits the window. Set ``batch_window_ms=0`` to serialize directly.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arxiv_rag_tpu_torch.logging_utils import METRICS, get_logger

log = get_logger("serve")


class _Job:
    __slots__ = ("queries", "key", "results", "error", "done", "t_submit")

    def __init__(self, queries, key):
        self.queries = queries
        self.key = key
        self.results = None
        self.error: Exception | None = None
        self.done = threading.Event()
        self.t_submit = time.perf_counter()


class _ControlJob:
    """An admin operation run ON the dispatch thread behind a completion
    barrier, with no window dispatched and unfinished. That makes a live
    engine swap safe with no lock in the engine's hot path: only the
    dispatch thread dispatches (and it is busy running the control), and
    every window dispatched before has finished, closures and all."""

    __slots__ = ("fn", "queries", "result", "error", "done")

    def __init__(self, fn):
        self.fn = fn
        self.queries = ()  # close() drains us like any queued job
        self.result = None
        self.error: Exception | None = None
        self.done = threading.Event()


class MicroBatcher:
    """Coalesces concurrent search requests into batched engine calls."""

    def __init__(self, engine, max_batch: int = 512, batch_window_ms: float = 4.0):
        self.engine = engine
        self.max_batch = max_batch
        self.window = batch_window_ms / 1000.0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: list[_Job] = []
        self._pending = 0
        self._closed = False
        self._calls = 0  # engine calls dispatched: the ``w=<n>`` span tag
        # dispatch/fetch pipeline: the loop thread dispatches device work
        # (engine.search_dispatch) and hands the finish closure to the
        # completion thread, which fetches results and resolves jobs —
        # so window t+1 dispatches while window t's results are still in
        # flight. maxsize bounds the device queue: if
        # fetches fall behind, dispatch blocks (backpressure).
        self._completions: queue.Queue = queue.Queue(maxsize=2)
        self._fetcher = threading.Thread(target=self._completion_loop, daemon=True)
        self._fetcher.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        with self._wake:
            self._closed = True
            self._wake.notify()

    def search(self, queries, k, categories, hybrid_alpha):
        if self.window <= 0:  # direct, serialized
            with self._lock:
                return self.engine.search(
                    queries, k=k, categories=categories, hybrid_alpha=hybrid_alpha
                )
        # preserve [] vs None: an empty list means "match no category"
        # (zero eligible rows), not "no filter"
        key = (k, None if categories is None else tuple(categories), hybrid_alpha)
        job = _Job(list(queries), key)
        with self._wake:
            # reject enqueues that race past close(): the loop thread has
            # (or will have) drained the queue and exited, so a job
            # appended now would block its handler thread forever
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(job)
            self._pending += len(job.queries)
            self._wake.notify()
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.results

    def run_control(self, fn):
        """Run ``fn()`` on the dispatch thread behind a completion barrier
        (:class:`_ControlJob`) and return its result. Blocks the calling
        thread, not serving: search jobs queued before and after it run
        as usual. In direct mode the engine lock serializes it."""
        if self.window <= 0:
            with self._lock:
                return fn()
        job = _ControlJob(fn)
        with self._wake:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(job)
            self._pending += 1
            self._wake.notify()
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def _loop(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._closed:
                    self._wake.wait()
                if self._closed:
                    # resolve anything still queued — an abandoned job
                    # leaves its handler thread blocked forever on
                    # job.done.wait()
                    for job in self._queue:
                        job.error = RuntimeError("batcher closed")
                        job.done.set()
                    self._queue = []
                    # loop thread owns dispatch: once it exits, nothing
                    # else enqueues completions, so the sentinel is last
                    self._completions.put(None)
                    return
                # collect more arrivals for up to one window (or max_batch)
                deadline = time.monotonic() + self.window
                while self._pending < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
                batch, self._queue = self._queue, []
                self._pending = 0
            controls = [j for j in batch if isinstance(j, _ControlJob)]
            # group by identical search params; one engine call per group
            groups: dict[tuple, list[_Job]] = {}
            for job in batch:
                if not isinstance(job, _ControlJob):
                    groups.setdefault(job.key, []).append(job)
            for key, jobs in groups.items():
                k, cats, alpha = key
                all_q = [q for j in jobs for q in j.queries]
                self._calls += 1
                tag = f"w={self._calls}"
                now = time.perf_counter()
                for j in jobs:
                    METRICS.observe_interval("serve.queue_wait", j.t_submit, now)
                try:
                    with METRICS.timer("serve.dispatch", tag):
                        finish = self.engine.search_dispatch(
                            all_q, k=k,
                            categories=None if cats is None else list(cats),
                            hybrid_alpha=alpha,
                        )
                    METRICS.inc("serve.batched_queries", len(all_q))
                    METRICS.inc("serve.engine_calls")
                    self._completions.put((jobs, finish, tag))
                except Exception as exc:  # noqa: BLE001 — per-group isolation
                    for j in jobs:
                        j.error = exc
                        j.done.set()
            for cj in controls:
                # completion barrier: the completion queue is FIFO, so once
                # this empty window's finish has run, every window
                # dispatched above and before has finished
                barrier = threading.Event()
                self._completions.put(([], barrier.set, None))
                barrier.wait()
                try:
                    cj.result = cj.fn()
                except Exception as exc:  # noqa: BLE001 — report, keep serving
                    cj.error = exc
                cj.done.set()

    def _completion_loop(self) -> None:
        while True:
            item = self._completions.get()
            if item is None:
                return
            jobs, finish, tag = item
            if not jobs:  # the completion barrier: not a search, so untimed
                finish()
                continue
            try:
                with METRICS.timer("serve.batched_search", tag):
                    results = finish()
                pos = 0
                for j in jobs:
                    j.results = results[pos : pos + len(j.queries)]
                    pos += len(j.queries)
            except Exception as exc:  # noqa: BLE001 — per-group isolation
                for j in jobs:
                    j.error = exc
            finally:
                for j in jobs:
                    j.done.set()


def make_handler(engine, index_stats: dict, batcher: MicroBatcher,
                 reload_paths: dict | None = None, admin_token: str | None = None):
    reload_lock = threading.Lock()  # one reload at a time; serving unaffected

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: clients reuse the TCP connection across
        # requests instead of paying a handshake each time. Safe because
        # _reply always sends Content-Length.
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict) -> None:
            with METRICS.timer("serve.reply"):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def log_message(self, fmt, *args):  # route through our logger
            log.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", **index_stats})
            elif self.path == "/metrics":
                self._reply(200, METRICS.snapshot())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/admin/reload":
                self._do_reload()
                return
            if self.path != "/search":
                self._reply(404, {"error": "not found"})
                return
            with METRICS.timer("serve.request"):
                self._do_search()

        def _do_search(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                queries = req.get("queries") or []
                if not isinstance(queries, list) or not all(
                    isinstance(q, str) for q in queries
                ):
                    raise ValueError("queries must be a list of strings")
                if not queries:
                    self._reply(200, {"results": []})
                    return
                k = int(req.get("k", 10))
                categories = req.get("categories")
                alpha = req.get("hybrid_alpha")
                results = batcher.search(queries, k, categories, alpha)
                self._reply(
                    200,
                    {
                        "results": [
                            [
                                {
                                    "score": h.score,
                                    "row": h.row,
                                    "chunk_id": h.chunk_id,
                                    "paper_id": h.paper_id,
                                    "category": h.category,
                                    "section": h.section,
                                    "page": h.page,
                                    "text": h.text[:1000],
                                    **({"dense_score": h.extras["dense_score"]}
                                       if "dense_score" in h.extras else {}),
                                }
                                for h in hits
                            ]
                            for hits in results
                        ]
                    },
                )
            except (ValueError, KeyError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — serving must not die
                log.error("search failed: %s", exc)
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

        def _do_reload(self):
            """Zero-downtime reload: ``engine.prepare_reload`` on THIS
            handler thread while the old index serves, then the swap on
            the dispatch thread behind the barrier (``run_control``).
            Body, each key optional where the server has a default path:
            {"index_dir": str, "corpus_dir": str, "bm25_path": str}. 400
            for bad input, 403 for a missing token or a path override
            without one, 500 when the reload fails (the old index keeps
            serving)."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                defaults = reload_paths or {}
                if admin_token is not None:
                    if self.headers.get("X-Admin-Token") != admin_token:
                        self._reply(403, {"error": "bad or missing X-Admin-Token"})
                        return
                else:
                    # without a token only the preconfigured locations
                    # reload: a client-supplied path would let anyone who
                    # reaches the port swap the live index or probe files
                    for key, dflt in (("index_dir", defaults.get("index")),
                                      ("corpus_dir", defaults.get("corpus")),
                                      ("bm25_path", None)):
                        v = req.get(key)
                        if v is not None and str(v) != str(dflt or ""):
                            self._reply(403, {"error": f"{key} override requires the "
                                                       "server's --admin-token"})
                            return
                index_dir = req.get("index_dir") or defaults.get("index")
                if not index_dir:
                    raise ValueError("no index_dir: pass it in the body or start the "
                                     "server with a default index path")
                corpus_dir = req.get("corpus_dir") or defaults.get("corpus")
                with reload_lock:
                    t0 = time.perf_counter()
                    swap = engine.prepare_reload(index_dir, corpus_dir=corpus_dir,
                                                 bm25_path=req.get("bm25_path"))
                    load_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    info = batcher.run_control(swap)
                    swap_s = time.perf_counter() - t0
                    # inside the lock: back-to-back reloads publish their
                    # /healthz stats in swap order
                    index_stats.update({kk: info[kk] for kk in ("rows", "dim", "dtype")
                                        if kk in info})
                METRICS.inc("serve.reloads")
                log.info("index reloaded: %s (load %.1fs, swap %.3fs)", info, load_s, swap_s)
                self._reply(200, {"status": "reloaded", **info, "load_s": load_s,
                                  "swap_s": swap_s})
            except (ValueError, FileNotFoundError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — keep serving the old state
                log.error("reload failed: %s", exc)
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8080,
          index_stats: dict | None = None, max_batch: int = 512,
          batch_window_ms: float = 4.0, reload_paths: dict | None = None,
          admin_token: str | None = None):
    """The HTTP server over ``engine`` (``serve_forever`` runs it).
    ``reload_paths`` ({"index": dir, "corpus": dir}) are /admin/reload's
    default locations; without ``admin_token`` reload takes only those."""
    stats = index_stats or {}
    batcher = MicroBatcher(engine, max_batch=max_batch,
                           batch_window_ms=batch_window_ms)

    class _Server(ThreadingHTTPServer):
        # stdlib default listen backlog is 5: a burst of concurrent
        # clients (the micro-batcher's whole point) gets connection
        # resets before a handler thread ever sees them — measured 94
        # resets out of 1024 requests at 128 concurrent clients
        request_queue_size = 512
        daemon_threads = True

    httpd = _Server((host, port),
                    make_handler(engine, stats, batcher, reload_paths, admin_token))
    httpd.batcher = batcher  # kept for close() in tests
    log.info("serving on http://%s:%d (micro-batch window %.1f ms, max %d)",
             host, port, batch_window_ms, max_batch)
    return httpd


def serve_in_thread(engine, host: str = "127.0.0.1", port: int = 0,
                    index_stats: dict | None = None, max_batch: int = 512,
                    batch_window_ms: float = 4.0, reload_paths: dict | None = None,
                    admin_token: str | None = None):
    """Start in a daemon thread (tests / embedding into other apps).
    Returns (server, thread); server.server_address has the bound port."""
    httpd = serve(engine, host, port, index_stats,
                  max_batch=max_batch, batch_window_ms=batch_window_ms,
                  reload_paths=reload_paths, admin_token=admin_token)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread
