"""The service-level suite: ``serve_bench``'s recorded modes one after
another at one load point, into one JSON file.

The port of the reference's ``tools/run_serve_suite.py``. Every mode runs
on the 2M-row int8 index at 16 clients × 8 requests × 24 queries:

  dense          the int8 scan only
  ivf            the device-planned IVF route, nprobe 8
  hybrid         + BM25 at alpha 0.7
  rerank256      + cross-encoder top-50, 256-token pairs, window cap 2,048
  rerank_cascade + a 64-token first pass, the top 20 rescored at 256
  rerank512      + 512-token pairs, no window cap
  dense_reload   dense, with /admin/reload fired under the load

    python -m arxiv_rag_tpu_torch.tools.run_serve_suite [--round 5]
        [--rows 2000000] [--modes dense,ivf,...] [--out FILE] [--device cpu]

Each mode is a process of its own with a wall-clock cap; a mode that
fails or times out is recorded with its stderr tail and the suite goes
on. The modes share one ``--corpus-dir`` (its parquet store and
``bm25.npz`` are made once). Results accumulate into an existing file of
the same round and rows.

Differences from the reference, on purpose: the file goes to ``--out``
(default ``build/tools/SERVE_r{round}.json``), never to the repo root,
where the reference's own ``SERVE_r*.json`` live; the suite prints one
JSON line and exits 1 when any mode failed or timed out.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from arxiv_rag_tpu_torch.tools import CACHE_DIR, REPO, ToolRun, run_tool

MODES = {
    "dense": [],
    "ivf": ["--nprobe", "8"],
    "hybrid": ["--hybrid-alpha", "0.7"],
    "rerank256": ["--hybrid-alpha", "0.7", "--rerank", "--rerank-pair-len", "256"],
    "rerank_cascade": ["--hybrid-alpha", "0.7", "--rerank", "--rerank-pair-len", "256",
                       "--rerank-cascade", "20"],
    "rerank512": ["--hybrid-alpha", "0.7", "--rerank", "--rerank-pair-len", "512",
                  "--rerank-window-pairs", "0"],
    "dense_reload": ["--reload-mid-run"],
}
LOAD_POINT = ["--clients", "16", "--queries-per-client", "8", "--qbatch", "24",
              "--dtype", "int8"]
TAIL = 1500  # bytes of a failed mode's stderr kept in the file


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--round", type=int, default=4)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--modes", default="dense,hybrid,rerank256,rerank512")
    ap.add_argument("--timeout", type=float, default=2400.0,
                    help="per-mode wall clock cap (set-up + run)")
    ap.add_argument("--out", default=None,
                    help="the suite's JSON file (default build/tools/SERVE_r<round>.json)")
    ap.add_argument("--corpus-dir", default=None,
                    help="the modes' shared corpus dir (default serve_bench's)")
    ap.add_argument("--device", default=None, help="passed to every mode (cuda by default)")
    return ap.parse_args(argv)


def mode_command(args, name: str) -> list[str]:
    cmd = [sys.executable, "-m", "arxiv_rag_tpu_torch.tools.serve_bench",
           "--rows", str(args.rows), *LOAD_POINT, *MODES[name]]
    if args.corpus_dir:
        cmd += ["--corpus-dir", str(args.corpus_dir)]
    if args.device:
        cmd += ["--device", args.device]
    return cmd


def run_mode(cmd: list[str], timeout: float) -> dict:
    """One mode in a process of its own: its rc, wall time, parsed line
    (None when the last line is not JSON) and, unless it succeeded, its
    stderr tail."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        err = exc.stderr or ""
        if isinstance(err, bytes):
            err = err.decode("utf-8", "replace")
        return {"command": " ".join(cmd), "rc": None,
                "wall_s": round(time.perf_counter() - t0, 1), "result": None,
                "stderr_tail": err[-TAIL:]}
    line = (r.stdout.strip().splitlines() or [""])[-1]
    try:
        parsed = json.loads(line)
    except json.JSONDecodeError:
        parsed = None
    rec = {"command": " ".join(cmd), "rc": r.returncode,
           "wall_s": round(time.perf_counter() - t0, 1), "result": parsed}
    if parsed is None or r.returncode != 0 or "error" in parsed:
        rec["stderr_tail"] = r.stderr[-TAIL:]
    return rec


def mode_failure(rec: dict) -> str | None:
    """Why a mode's record is a failure, or None."""
    if rec["rc"] is None:
        return f"timed out after {rec['wall_s']}s"
    if rec["result"] is None:
        return f"exit {rec['rc']}, no JSON line"
    if rec["rc"] != 0 or "error" in rec["result"]:
        return f"exit {rec['rc']}: {rec['result'].get('error')}"
    return None


def body(run: ToolRun, args) -> None:
    run.place(args.device)  # no card and no --device cpu: fail before any mode
    run.at("suite")
    names = args.modes.split(",")
    unknown = [n for n in names if n not in MODES]
    if unknown:
        raise ValueError(f"unknown modes {unknown}; known: {', '.join(MODES)}")
    out = Path(args.out) if args.out else CACHE_DIR / f"SERVE_r{args.round:02d}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    suite = {"round": args.round, "rows": args.rows, "results": {}}
    if out.exists():
        try:
            prev = json.loads(out.read_text())
            if prev.get("round") == args.round and prev.get("rows") == args.rows:
                suite["results"].update(prev.get("results", {}))
        except (json.JSONDecodeError, OSError):
            pass
    run.result.update({"round": args.round, "rows": args.rows, "out": str(out), "modes": {}})
    for name in names:
        cmd = mode_command(args, name)
        run.log(f"{name}: {' '.join(cmd)}")
        rec = run_mode(cmd, args.timeout)
        suite["results"][name] = rec
        out.write_text(json.dumps(suite, indent=1))
        why = mode_failure(rec)
        run.result["modes"][name] = {"rc": rec["rc"], "wall_s": rec["wall_s"],
                                     "value": (rec["result"] or {}).get("value")}
        if why:
            run.errors.append(f"{name}: {why}"[:400])
        run.log(f"{name} done in {rec['wall_s']}s -> {out}"
                + (f" (FAILED: {why})" if why else ""))


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ToolRun("suite", {"metric": "serve_suite"})
    return run_tool(run, lambda r: body(r, args))


if __name__ == "__main__":
    sys.exit(main())
