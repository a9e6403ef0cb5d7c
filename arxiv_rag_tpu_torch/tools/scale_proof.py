"""The 2M-row scale proof: embed output → the ``index`` verb → a loaded
index → exact self-retrieval at block, batch and shard boundaries.

The port of the reference's ``tools/scale_proof_tpu.py`` (part A) and
``tools/scale_proof_mesh.py`` (part B).

Part A (the card unless ``--device cpu``): 8 batches of ROWS/8 fp32
Gaussian rows (seed 0, not normalized: the build must normalize) written
in the embed verb's format (``embeddings_*.npy``, ``ids_*.json``,
``index.json``); ``python -m arxiv_rag_tpu_torch.cli.main index --dtype
bfloat16 --device-build`` builds the index on the device;
``DenseIndex.load`` reads it; the scan (K1 bf16, through
``SearchEngine``) must return each of 32 probe rows (rows 0, 1, 4095,
4096, the batch boundary, 262,143, 262,144, the middle, the last two,
and 21 drawn ones) as its own first hit with a score above 0.99.

Part B (``--mesh``, on the CPU as in the reference): the index part A
wrote, row-sharded over an 8-entry CPU ``DeviceMesh``; 8 probes across
the shard boundaries must find themselves first, and the sharded route's
scores and rows must equal one CPU device's scan bitwise.

    python -m arxiv_rag_tpu_torch.tools.scale_proof [ROOT] [--rows N]
        [--device cpu] [--mesh]

ROOT defaults to ``build/tools/scale_proof_<device>_<rows>`` (about 9 GB
at 2M rows). ``--rows`` (default 2,000,000, the reference's fixed size)
cuts the corpus; the probes past it are dropped. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from arxiv_rag_tpu_torch.tools import CACHE_DIR, REPO, ToolRun, run_tool

D = 768
BATCHES = 8
K = 10
N_PROBES = 32
INDEX_TIMEOUT_S = 3000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=None)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--mesh", action="store_true",
                    help="part B: the loaded index over an 8-entry CPU mesh")
    ap.add_argument("--device", default=None, help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def boundary_probes(n: int) -> list[int]:
    """Part A's fixed probes (the reference's at 2M rows), those below
    ``n``, without repeats, in order."""
    nb = n // BATCHES
    fixed = [0, 1, 4095, 4096, nb - 1, nb, 262_143, 262_144, n // 2, n - 2, n - 1]
    return list(dict.fromkeys(p for p in fixed if 0 <= p < n))


def mesh_probes(n: int) -> list[int]:
    """Part B's probes (the reference's at 2M rows) below ``n``."""
    fixed = [0, 4096, n // BATCHES, 262_144, n // 2 - 1, 3 * n // 4, n - 2, n - 1]
    return list(dict.fromkeys(p for p in fixed if 0 <= p < n))


def write_embed_output(out: Path, n: int, rng: np.random.Generator, log) -> None:
    """8 batches of n/8 fp32 rows in the embed verb's format; a batch of
    the right size already on disk is kept (its draws are still made, so
    later batches stay the same)."""
    out.mkdir(parents=True, exist_ok=True)
    nb = n // BATCHES
    manifest = {"batches": [], "dim": D, "model": "synthetic"}
    for i in range(BATCHES):
        ep = out / f"embeddings_{i:05d}.npy"
        x = rng.standard_normal((nb, D), dtype=np.float32)
        if not (ep.exists() and ep.stat().st_size == nb * D * 4 + 128):
            np.save(ep, x)  # not normalized: the index build must normalize
        del x
        (out / f"ids_{i:05d}.json").write_text(
            json.dumps([f"c{i * nb + j:07d}" for j in range(nb)]))
        manifest["batches"].append({"file": ep.name, "rows": nb})
        log(f"batch {i} ready")
    manifest["total_rows"] = nb * BATCHES
    (out / "index.json").write_text(json.dumps(manifest))


def probe_queries(emb: Path, n: int, probes: list[int]) -> np.ndarray:
    """The probes' own rows, read back from the batches (memory-mapped),
    L2-normalized."""
    nb = n // BATCHES
    mms = [np.load(emb / f"embeddings_{i:05d}.npy", mmap_mode="r") for i in range(BATCHES)]
    qs = np.stack([np.asarray(mms[p // nb][p % nb], np.float32) for p in probes])
    return qs / np.linalg.norm(qs, axis=1, keepdims=True)


def check_self_retrieval(vals, rows, probes) -> None:
    if not (rows[:, 0] == np.array(probes)).all():
        bad = [(p, int(r)) for p, r in zip(probes, rows[:, 0]) if p != r]
        raise AssertionError(f"self-retrieval failed at (probe, top row) {bad[:8]}")
    if not vals[:, 0].min() > 0.99:
        raise AssertionError(f"a self-similarity of {vals[:, 0].min()} (bf16: ~1 expected)")


def part_a(run: ToolRun, root: Path, n: int, dev) -> None:
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    r = run.result
    t_all = time.perf_counter()
    run.at("embed output")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    write_embed_output(root / "emb", n, rng, run.log)
    r["synth_s"] = round(time.perf_counter() - t0, 1)
    run.log(f"synth embed output: {r['synth_s']}s ({n} rows f32, {n * D * 4 / 1e9:.1f} GB)")

    run.at("index verb")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "arxiv_rag_tpu_torch.cli.main", "index",
                           "--embeddings", str(root / "emb"), "--out", str(root / "idx"),
                           "--dtype", "bfloat16", "--device-build", "--device", dev.type],
                          cwd=REPO, capture_output=True, text=True, timeout=INDEX_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"the index verb exited {proc.returncode}: {proc.stderr[-300:]}")
    r["index_build_s"] = round(time.perf_counter() - t0, 1)
    run.log(f"index --device-build: {r['index_build_s']}s :: {proc.stdout.strip()[-300:]}")

    run.at("load")
    t0 = time.perf_counter()
    idx = DenseIndex.load(root / "idx")
    r["load_s"] = round(time.perf_counter() - t0, 1)
    if not (idx.num_rows == n and idx.dim == D and idx.dtype == "bfloat16"):
        raise ValueError(f"loaded {idx.num_rows} x {idx.dim} {idx.dtype}, not {n} x {D} bf16")
    if not (idx.chunk_ids[0] == "c0000000" and idx.chunk_ids[-1] == f"c{n - 1:07d}"):
        raise ValueError(f"chunk ids {idx.chunk_ids[0]} .. {idx.chunk_ids[-1]}")
    run.log(f"DenseIndex.load: {r['load_s']}s")

    run.at("search")
    probes = (boundary_probes(n) + rng.integers(0, n, 21).tolist())[:N_PROBES]
    qs = probe_queries(root / "emb", n, probes)
    with run.timed():
        t0 = time.perf_counter()
        eng = SearchEngine(idx, device=dev)
        vals, rows = eng.search_embeddings(qs, k=K)
        r["first_search_s"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        vals, rows = eng.search_embeddings(qs, k=K)
        r["steady_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    check_self_retrieval(vals, rows, probes)
    r.update({"probes": len(probes), "self_retrieval": f"{len(probes)}/{len(probes)}",
              "total_s": round(time.perf_counter() - t_all, 1)})
    run.log(f"single-device search: first {r['first_search_s']}s (upload + first call), "
            f"steady {r['steady_ms']} ms/{len(probes)}q; self-retrieval exact at the block, "
            "batch and shard boundaries")


def part_b(run: ToolRun, root: Path, n: int) -> None:
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.parallel import DeviceMesh
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    r = run.result
    run.at("load")
    t0 = time.perf_counter()
    idx = DenseIndex.load(root / "idx")
    r["load_s"] = round(time.perf_counter() - t0, 1)
    if idx.num_rows != n:
        raise ValueError(f"loaded {idx.num_rows} rows, not {n}")
    run.log(f"DenseIndex.load (host bf16): {r['load_s']}s")
    run.at("shard")
    t0 = time.perf_counter()
    mesh = DeviceMesh(["cpu"] * 8)
    idx.to_device(mesh=mesh)
    r["shard_s"] = round(time.perf_counter() - t0, 1)
    run.log(f"row-sharded over {mesh.size} CPU entries: {r['shard_s']}s")
    run.at("search")
    probes = mesh_probes(n)
    qs = probe_queries(root / "emb", n, probes)
    t0 = time.perf_counter()
    vals, rows = SearchEngine(idx).search_embeddings(qs, k=K)
    r["search_s"] = round(time.perf_counter() - t0, 1)
    check_self_retrieval(vals, rows, probes)
    single = DenseIndex.load(root / "idx")
    svals, srows = SearchEngine(single, device="cpu").search_embeddings(qs, k=K)
    same = bool(np.array_equal(rows, srows) and np.array_equal(vals, svals))
    if not same:
        raise AssertionError("the sharded route differs from one CPU device's scan")
    r.update({"shards": mesh.size, "probes": len(probes),
              "self_retrieval": f"{len(probes)}/{len(probes)}", "equal_single_device": same})
    run.log(f"sharded search over {mesh.size} entries: {r['search_s']}s for {len(probes)} "
            "queries; self-retrieval exact across shard boundaries, bitwise one device's scan")


def body(run: ToolRun, args) -> None:
    n = args.rows
    if n % BATCHES:
        raise ValueError(f"--rows {n} is not a multiple of {BATCHES}")
    if args.mesh:
        run.result.update({"part": "B", "rows": n})
        root = Path(args.root or CACHE_DIR / f"scale_proof_{args.device or 'cuda'}_{n}").resolve()
        part_b(run, root, n)
        run.launches = {}  # the CPU's plain versions: no kernel
    else:
        dev = run.place(args.device)
        run.result.update({"part": "A", "rows": n})
        root = Path(args.root or CACHE_DIR / f"scale_proof_{dev.type}_{n}").resolve()
        part_a(run, root, n, dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ToolRun("scale", {})
    return run_tool(run, lambda r: body(r, args))


if __name__ == "__main__":
    sys.exit(main())
