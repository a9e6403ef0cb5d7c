"""Readings for the limits of the output check, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 5

For each seed: one run of the cell (a short window at the cell's own
load, the same sample as a benchmark run), its checked numbers (the
program's readings), and the same numbers for the control: the plain
reference computed at float8 (every product's operands rounded to e4m3)
put in the program's place on that sample. One JSON line per seed, then
a summary line: per number the largest program reading and the smallest
control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from benchmark import harness

    prog: dict[str, list] = {}
    ctrl: dict[str, list] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False, t_start=time.monotonic(),
                               control=True)
        line = {"seed": seed, "correct": res["correct"], "failed": res["failed"],
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "control": res.get("control_checks", {}),
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            prog.setdefault(k, []).append(v)
        for k, v in line["control"].items():
            ctrl.setdefault(k, []).append(v)
    print(json.dumps({"summary": {k: {"program_max": max(v), "control_min": min(ctrl.get(k, [0]))}
                                  for k, v in prog.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
