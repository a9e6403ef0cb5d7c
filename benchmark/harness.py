"""One run of one cell: find its files by name, run its kind, judge its
output, read its metrics and print the result line.

A cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``configs/<file>``), a traffic mix (``traffic/<name>.json``, whose
``kind`` names the driver ``kinds/<kind>.py``), and the limits of its
output check (``limits/<cell>.json``). Per-layer metrics are read by
``metrics/<metric name>.py`` (``read(ctx) -> float | None``). Adding a
configuration, a mix, a cell or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "arxiv_rag_tpu")


@dataclass
class Run:
    """What a kind's driver gets."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # time.monotonic() at process start
    tmp: Path
    control: bool = False  # also judge the control (the reference at float8) on the sample

    def log(self, msg: str) -> None:
        print(f"[{time.monotonic() - self.t_start:8.2f}s] {msg}", file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a kind's driver returns."""

    attempted: int
    failed: int
    e2e: dict  # end-to-end metric name -> value
    checks: dict  # output-check number name -> value
    memory_peak_bytes: int
    ctx: dict  # what the per-layer readers read
    trace: dict | None = None  # trace.summarize of the traced slice


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def bench_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(spec: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration file, traffic file, limits) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return cell, config, traffic, limits


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _finite(x: float) -> float:
    return float(x) if math.isfinite(float(x)) else 1e30


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number at or under its limit; a number without a limit fails."""
    out, ok = {}, True
    for name, value in checks.items():
        lim = limits.get(name)
        out[name] = {"value": _finite(value), "limit": lim}
        ok = ok and lim is not None and _finite(value) <= lim
    return ok and bool(checks), out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             scale: dict | None = None, spec: dict | None = None, t_start: float | None = None,
             tmp: Path | None = None, control: bool = False) -> dict:
    """Run ``workload`` once and return the result line as a dict (also
    used by the tests, on the CPU, with ``scale`` overrides). With
    ``control`` the line also holds ``control_checks``: the same numbers
    for the control on the same sample."""
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    spec = spec or bench_spec()
    cell, config, traffic, limits = resolve(spec, workload)
    for k, v in (scale or {}).get("config", {}).items():
        config[k] = {**config.get(k, {}), **v} if isinstance(v, dict) else v
    traffic = {**traffic, **(scale or {}).get("traffic", {})}
    limits = (scale or {}).get("limits", limits)
    dev = torch.device(device or "cuda")
    tmp = Path(tmp or os.environ.get("TMPDIR") or "/tmp") / f"benchmark-{workload}"
    tmp.mkdir(parents=True, exist_ok=True)
    run = Run(workload, cell, config, traffic, int(seed), float(seconds), bool(trace), dev,
              t_start, tmp, control)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    out: Outcome = kind.run(run)
    correct, checks = judge(out.checks, limits)
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": units[m["name"]]}
    else:
        ctx = {**out.ctx, "trace": out.trace, "config": config, "traffic": traffic}
        for m in spec["per_layer"]:
            if applies(m, workload):
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
                else:
                    print(f"per-layer metric {m['name']}: nothing to read in this run, left out",
                          file=sys.stderr, flush=True)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct and out.failed == 0), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    if "control_checks" in out.ctx:
        result["control_checks"] = out.ctx["control_checks"]
    result["checks"] = checks
    return result


def main(args, t_start: float) -> int:
    import torch

    spec = bench_spec()
    cell = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import arxiv_rag_tpu_torch  # noqa: F401  (the program under test; fails without it)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start,
                      spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']} (attempted {result['attempted']}, "
          f"failed {result['failed']})", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
