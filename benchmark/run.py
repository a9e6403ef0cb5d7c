"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero and prints no result without enough CUDA cards, without
the port, or when JAX or the JAX package was loaded. The last stdout
line is the result; the last stderr lines are each checked number beside
its limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.monotonic()


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # a library that could load JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from benchmark import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
