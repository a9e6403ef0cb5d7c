"""The traced slice of a run and its reduction.

``SpanLog`` records the benchmark's own spans: ``span`` wraps a call
into one of the port's layers and logs its name, thread and host
interval (the profiler records host ops only on the thread that starts
it, and the port's work runs on the server's threads). ``Slice`` runs
``torch.profiler`` (CPU and CUDA activities) around a ``bench.slice``
annotation, whose trace time and host time tie the two clocks together,
and exports the Chrome trace. ``summarize`` reduces it:

- ``busy_s``: the union of device intervals (kernels, copies, memsets)
  inside the slice; ``window_s``: the slice's length;
- ``device_ops``: device seconds by name, the ten largest;
- ``idle_gaps``: the ten longest gaps between device intervals, each
  named by the innermost benchmark span open at the gap's middle;
- ``spans``: per benchmark span inside the slice, the device seconds of
  what it launched (the CUDA runtime or driver calls made on its thread
  inside it, matched to device work by correlation id).
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class SpanLog:
    def __init__(self) -> None:
        self.spans: list[tuple[str, int, float, float]] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.append((name, thread_key(threading.get_ident()), t0, t1))


def thread_key(tid: int) -> int:
    """A thread as the trace names its CUDA calls: pthread_self()'s low 32
    bits as a signed integer, without the sign."""
    low = int(tid) & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


def span(log: SpanLog, name_of, fn):
    """``fn`` with each call logged as a span named ``name_of(*args, **kwargs)``."""

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.add(name_of(*args, **kwargs), t0, time.perf_counter())

    return wrapped


class Slice:
    """``with Slice(path, cuda, log) as s:`` profiles the block;
    ``s.finish()``, called once the measured window has closed, exports
    its trace and returns ``summarize`` of it and of ``log``'s spans."""

    def __init__(self, path: Path, cuda: bool, log: SpanLog | None = None) -> None:
        self.path, self.cuda, self.log = Path(path), cuda, log

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.ann = torch.profiler.record_function("bench.slice")
        self.t_enter = time.perf_counter()
        self.ann.__enter__()
        return self

    def __exit__(self, *exc):
        self.ann.__exit__(None, None, None)
        self.prof.stop()
        return False

    def finish(self) -> dict:
        self.prof.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        self.path.unlink()
        return summarize(trace, list(self.log.spans) if self.log is not None else [],
                         self.t_enter)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(trace: dict, spans=(), t_enter: float | None = None) -> dict:
    """``spans``: (name, thread, t0, t1) on ``time.perf_counter``;
    ``t_enter`` that clock just before the slice's annotation opened."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    sl = [e for e in events if e.get("name") == "bench.slice" and e.get("cat") == "user_annotation"]
    if not sl:
        raise ValueError("the trace holds no bench.slice annotation")
    t0, t1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    offset = t0 - t_enter * 1e6 if t_enter is not None else 0.0
    host = [(n, tid, a * 1e6 + offset, b * 1e6 + offset) for n, tid, a, b in spans
            if b * 1e6 + offset > t0 and a * 1e6 + offset < t1]
    dev, by_name = [], {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b > a:
                dev.append((a, b))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    gaps.sort(reverse=True)

    def host_at(t):
        inner = [(b - a, n) for n, _, a, b in host if a <= t <= b]
        return min(inner)[1] if inner else "no benchmark span (HTTP, JSON, batcher, Python)"

    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[host_at((a + b) / 2), d * 1e-6] for d, a, b in gaps[:10]],
        "spans": _span_device_time(events, host, t0, t1),
    }


def _span_device_time(events, host, t0, t1) -> list[dict]:
    """Per benchmark span wholly inside the slice: its name and the device
    seconds of the device work launched on its thread inside it."""
    device = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in DEVICE_CATS and "correlation" in e.get("args", {})}
    launches: dict = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches.setdefault(thread_key(e.get("tid", 0)), []).append(
                (e["ts"], e["args"]["correlation"]))
    for lst in launches.values():
        lst.sort()
    out = []
    for name, tid, a, b in host:
        if a < t0 or b > t1:
            continue
        lst = launches.get(tid, [])
        ts = [x[0] for x in lst]
        dev_s, kernels = 0.0, 0
        for _, corr in lst[bisect.bisect_left(ts, a):bisect.bisect_right(ts, b)]:
            d = device.get(corr)
            if d is not None:
                dev_s += d["dur"] * 1e-6
                kernels += d.get("cat") == "kernel"
        out.append({"name": name, "device_s": dev_s, "kernels": kernels})
    return out
