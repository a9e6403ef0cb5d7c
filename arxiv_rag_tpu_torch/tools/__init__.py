"""The reference's service and scale harnesses (``tools/`` at the repo
root), ported: each runs as ``python -m arxiv_rag_tpu_torch.tools.<name>``
with the reference's flags and environment knobs, on the card unless
``--device cpu`` is given.

- ``serve_bench``: HTTP server + micro-batcher over a 2M × 768 index,
  concurrent keep-alive clients, qps, p50/p95 and per-stage timers;
- ``run_serve_suite``: ``serve_bench``'s recorded modes one after another;
- ``recall_real``: recall@10 of the flat scans and the IVF on encoder
  embeddings against a host fp32 oracle;
- ``ivf_scale``: IVF (host- and device-planned) against the flat int8
  scan on a clustered corpus;
- ``bm25_scale``: the native BM25 build at 2M documents (host only);
- ``scale_proof``: embed output → the ``index`` verb → ``DenseIndex.load``
  → self-retrieval probes; ``--mesh``: the same over an 8-entry CPU mesh.

They share the bench's one-line contract (``bench.py::Run``): each prints
exactly one JSON line, from a ``finally``; a failed part is named in its
``error`` field and the process exits 1. Beside the reference's fields the
line carries ``card`` (``nvidia-smi``'s name and power limit; null off the
card) and ``launches``, the port's kernel launches during the timed part.
Without CUDA and without ``--device cpu`` a tool prints that error and
measures nothing. Caches live under ``build/tools/`` (git-ignored), keyed
by device and seed, never in the reference's ``/tmp`` paths.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from pathlib import Path

from arxiv_rag_tpu_torch.bench import CARD_PEAK_TFLOPS, Run, card_line, launch_counts

__all__ = ["CACHE_DIR", "CARD_PEAK_TFLOPS", "ToolRun", "run_tool"]

REPO = Path(__file__).resolve().parents[2]
CACHE_DIR = REPO / "build" / "tools"


class ToolRun(Run):
    """``Run`` for a tool: no soft deadline and no per-phase launches;
    ``part`` names what is running, so a failure names it."""

    per_phase = False

    def __init__(self, tag: str, result: dict) -> None:
        super().__init__(tag=tag, result={**result, "card": None}, deadline=math.inf)
        self.part = "device"

    def at(self, part: str) -> None:
        self.part = part
        self.log(part)

    def place(self, device: str | None):
        """The tool's device (the card unless ``device`` says otherwise;
        without CUDA that raises), and the card's line when it is one."""
        from arxiv_rag_tpu_torch.device import default_device

        dev = default_device(device)
        if dev.type == "cuda":
            self.result["card"] = card_line()
        return dev

    @contextmanager
    def timed(self):
        """The timed part: its kernel launches become the line's
        ``launches``."""
        before = launch_counts()
        try:
            yield
        finally:
            self.launches = {n: c - before[n] for n, c in launch_counts().items()
                             if c != before[n]}


def run_tool(run: ToolRun, body) -> int:
    """``body(run)``; a failure is recorded under the part it happened in.
    The line prints once whatever happened; 1 when any part failed."""
    try:
        body(run)
    except Exception as exc:  # noqa: BLE001 — recorded; the line still prints
        run.errors.append(f"{run.part}: {exc!r}"[:400])
        run.log(run.errors[-1])
    finally:
        run.emit()
    return 1 if run.errors else 0
