"""IVF against the flat int8 scan at scale, amortized timing.

The port of the reference's ``tools/ivf_scale.py``. The flat scan reads
every row; IVF reads the probed clusters' blocks, a cost per query tile
about independent of N, so its gain grows with the corpus. On a
clustered int8 corpus (blobs made on the device; encoder embeddings are
cluster-dense, isotropic Gaussians an unfairly hard case for IVF) it
measures:

- the flat s8s8 scan (K2): the exact baseline and the recall oracle
  (both paths read the same int8 rows, so recall isolates the pruning);
- per nprobe, the host-planned block-table scan (K5): recall@10, the
  table's width, and the kernel, probe and plan ms; then the device
  plan (K6: probe + plan + scan in one dispatch) and whether it equals
  the host plan (``match_host_plan``).

Times: the median over GROUPS groups of CHAIN calls dispatched back to
back with the last fetched. k-means runs on a 262,144-row sample, the
assignment on the device in 250,000-row slices.

    python -m arxiv_rag_tpu_torch.tools.ivf_scale [--device cpu]

Env (the reference's): ROWS (4,000,000), CLUSTERS (4096), NPROBES
("8,16,32,64"), Q (32), QBLOCK (8), BLOCK_ROWS (1024), CHAIN (8), GROUPS
(3), CENTERS (2048 blob centers), SPREAD (0.025), ITERS (8). The corpus,
centroids and assignments are cached in ``build/tools/`` by device, size
and seed. Prints one JSON line; the phase logs go to stderr.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from arxiv_rag_tpu_torch.tools import CACHE_DIR, ToolRun, run_tool

DIM, K = 768, 10
STEP = 250_000  # rows made, fetched and assigned per slice
SAMPLE_ROWS = 262_144
CORPUS_SEED, CENTER_SEED, QUERY_SEED = 7, 3, 10**9


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def knobs() -> dict:
    env = os.environ.get
    return {
        "rows": int(env("ROWS", 4_000_000)),
        "clusters": int(env("CLUSTERS", 4096)),
        "nprobes": [int(x) for x in env("NPROBES", "8,16,32,64").split(",")],
        "q": int(env("Q", 32)),
        "q_block": int(env("QBLOCK", 8)),
        "block_rows": int(env("BLOCK_ROWS", 1024)),
        "chain": int(env("CHAIN", 8)),
        "groups": int(env("GROUPS", 3)),
        "centers": int(env("CENTERS", 2048)),
        "spread": float(env("SPREAD", 0.025)),
        "iters": int(env("ITERS", 8)),
    }


def blob_slice(centers: torch.Tensor, m: int, spread: float, gen: torch.Generator):
    """``m`` unit rows around random ``centers`` (noise ``spread``),
    quantized to int8 per row on the device: (values, scales)."""
    from arxiv_rag_tpu_torch.ops.quant import quantize_int8

    dev = centers.device
    cid = torch.randint(0, centers.shape[0], (m,), generator=gen, device=dev)
    x = centers[cid] + spread * torch.randn(m, centers.shape[1], generator=gen, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return quantize_int8(x)


def blob_corpus(dev: torch.device, kn: dict):
    """(int8 values [rows, 768], scales [rows], fp32 unit queries [Q, 768])
    on the host: blobs made on ``dev`` slice by slice and fetched; the
    queries are blob members, dequantized and renormalized."""
    cg = torch.Generator(device=dev).manual_seed(CENTER_SEED)
    centers = torch.randn(kn["centers"], DIM, generator=cg, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    gen = torch.Generator(device=dev).manual_seed(CORPUS_SEED)
    v_parts, s_parts = [], []
    for s in range(0, kn["rows"], STEP):
        v, sc = blob_slice(centers, min(STEP, kn["rows"] - s), kn["spread"], gen)
        v_parts.append(v.cpu().numpy())
        s_parts.append(sc.cpu().numpy())
    qv, qs = blob_slice(centers, kn["q"], kn["spread"],
                        torch.Generator(device=dev).manual_seed(QUERY_SEED))
    queries = qv.cpu().numpy().astype(np.float32) * qs.cpu().numpy()[:, None]
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return np.concatenate(v_parts), np.concatenate(s_parts), queries.astype(np.float32)


def train_centroids(values, scales, dev: torch.device, kn: dict) -> np.ndarray:
    """Spherical k-means (seed 0) over a sorted 262,144-row sample of the
    dequantized rows, on ``dev``."""
    from arxiv_rag_tpu_torch.ops.kmeans import spherical_kmeans

    rng = np.random.default_rng(0)
    rows = values.shape[0]
    t_idx = np.sort(rng.choice(rows, size=min(rows, SAMPLE_ROWS), replace=False))
    sample = values[t_idx].astype(np.float32) * scales[t_idx][:, None]
    cents = spherical_kmeans(torch.from_numpy(sample).to(dev), kn["clusters"],
                             iters=kn["iters"], seed=0, sample_rows=None)
    return cents.cpu().numpy()


def assign(values, scales, centroids, dev: torch.device) -> np.ndarray:
    """[rows] int32 nearest-centroid ids on ``dev``: bf16 rows (int8 ×
    scale, rounded to bf16) against bf16 centroids, fp32 scores."""
    from arxiv_rag_tpu_torch.ops.kmeans import _assign_batch

    cbf = torch.from_numpy(centroids).to(dev, torch.bfloat16)
    out = np.empty((values.shape[0],), np.int32)
    for s in range(0, values.shape[0], STEP):
        sl = slice(s, min(s + STEP, values.shape[0]))
        v = torch.from_numpy(values[sl]).to(dev).to(torch.bfloat16)
        sc = torch.from_numpy(scales[sl]).to(dev).to(torch.bfloat16)
        out[sl] = _assign_batch(v * sc[:, None], cbf).to(torch.int32).cpu().numpy()
    return out


def setup(run: ToolRun, dev: torch.device, kn: dict):
    """(values, scales, queries, centroids, assignments), from the cache
    when this device, size and seed made them before."""
    cache = CACHE_DIR / (f"ivf_corpus_{dev.type}_{kn['rows']}_{kn['centers']}_{kn['spread']}_"
                         f"{kn['clusters']}_{kn['iters']}_seed{CORPUS_SEED}.npz")
    if cache.exists():
        z = np.load(cache)
        run.log(f"corpus, queries, centroids and assignments loaded from {cache}")
        return z["values"], z["scales"], z["queries"], z["centroids"], z["assign"]
    t0 = time.perf_counter()
    values, scales, queries = blob_corpus(dev, kn)
    run.log(f"corpus on host: {values.nbytes / 2**30:.2f} GiB int8 "
            f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    centroids = train_centroids(values, scales, dev, kn)
    run.log(f"kmeans trained in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    assignments = assign(values, scales, centroids, dev)
    run.log(f"assignment in {time.perf_counter() - t0:.1f}s")
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npz")  # a killed save leaves no truncated cache
        np.savez(tmp, values=values, scales=scales, queries=queries, centroids=centroids,
                 assign=assignments)
        os.replace(tmp, cache)
        run.log(f"setup cached to {cache}")
    except OSError as exc:
        run.log(f"cache save skipped ({exc})")
    return values, scales, queries, centroids, assignments


def _fetch(out) -> None:
    (out[0] if isinstance(out, tuple) else out).cpu()


def amortize(fn, chain: int, groups: int) -> float:
    """Median seconds a call over ``groups`` groups of ``chain`` calls
    dispatched back to back, the last fetched."""
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        outs = [fn() for _ in range(chain)]
        _fetch(outs[-1])
        times.append((time.perf_counter() - t0) / chain)
    return float(np.median(times))


def body(run: ToolRun, args) -> None:
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    dev = run.place(args.device)
    kn = knobs()
    rows, q_batch, q_block, chain, groups = (kn[n] for n in ("rows", "q", "q_block", "chain",
                                                              "groups"))
    run.log(f"backend={dev.type} rows={rows} clusters={kn['clusters']} nprobes={kn['nprobes']} "
            f"Q={q_batch} q_block={q_block} block={kn['block_rows']}")
    run.at("setup")
    values, scales, queries, centroids, assignments = setup(run, dev, kn)
    qd = torch.tensor(queries, device=dev)

    run.at("ivf layout")
    dense = DenseIndex(values=torch.from_numpy(values), scales=torch.from_numpy(scales),
                       dtype="int8", normalized=True, categories=[], row_masks=None)
    t0 = time.perf_counter()
    ivf = IVFIndex.build(dense, kn["clusters"], block_rows=kn["block_rows"],
                         centroids=centroids, assignments=assignments, device=dev)
    ivf.to_device(dev)
    run.log(f"ivf layout in {time.perf_counter() - t0:.1f}s ({ivf.n_blocks} blocks of "
            f"{kn['block_rows']})")
    del values, scales, dense, assignments
    n_valid = ivf.n_valid

    run.at("flat")
    # one device copy serves both paths: the flat scan over the IVF order
    # is the same corpus permuted
    flat = (lambda: ft.fused_topk_int8(ivf.values, ivf.scales, qd, K, n_valid=n_valid))
    with run.timed():
        t0 = time.perf_counter()
        fv, fr = (t.cpu().numpy() for t in flat())
        run.log(f"flat first call {time.perf_counter() - t0:.1f}s")
        oracle_rows = ivf.perm[np.clip(fr, 0, n_valid - 1)]
        flat_s = amortize(flat, chain, groups)
        run.log(f"flat amortized {flat_s * 1e3:.2f} ms/call = {q_batch / flat_s:.0f} qps")
        results = {"flat_ms": flat_s * 1e3, "flat_qps": q_batch / flat_s, "per_nprobe": {}}
        for nprobe in kn["nprobes"]:
            run.at(f"nprobe {nprobe}")
            # probe + plan once (a fixed query set gives a fixed table); the
            # per-call probe cost is timed on its own below
            t0 = time.perf_counter()
            table = ivf.plan_blocks(ivf.probe(qd, nprobe), q_block)
            plan_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            iv, ir = (t.cpu().numpy() for t in ivf._search_table(qd, table, K, q_block=q_block))
            run.log(f"nprobe={nprobe}: first call {time.perf_counter() - t0:.1f}s, table "
                    f"width {table.shape[1]}")
            found = np.where(ir >= 0, ivf.perm[np.clip(ir, 0, n_valid - 1)], -1)
            rec = recall_at_k(found, oracle_rows, fv, tie_tol=5e-3,
                              candidate_scores=np.where(ir >= 0, iv, -np.inf))
            kern_s = amortize(lambda: ivf._search_table(qd, table, K, q_block=q_block), chain,
                              groups)
            t0 = time.perf_counter()
            outs = [ivf._probe_dispatch(qd, nprobe) for _ in range(chain)]
            outs[-1].cpu()
            probe_s = (time.perf_counter() - t0) / chain
            total_s = kern_s + probe_s + plan_s
            run.log(f"nprobe={nprobe}: recall@10 {rec:.4f}, kernel {kern_s * 1e3:.2f} ms, probe "
                    f"{probe_s * 1e3:.2f} ms, plan {plan_s * 1e3:.1f} ms -> "
                    f"{q_batch / total_s:.0f} qps ({flat_s / total_s:.2f}x flat)")
            entry = results["per_nprobe"][str(nprobe)] = {
                "recall_at_10": rec, "kernel_ms": kern_s * 1e3, "probe_ms": probe_s * 1e3,
                "plan_ms": plan_s * 1e3, "qps": q_batch / total_s,
                "speedup_vs_flat": flat_s / total_s, "table_width": int(table.shape[1]),
            }
            # the device plan: probe + plan + scan in one dispatch, no host sync
            device = (lambda: ivf._search_device(qd, K, nprobe=nprobe, q_block=q_block))
            t0 = time.perf_counter()
            ddv, ddr = (t.cpu().numpy() for t in device())
            run.log(f"nprobe={nprobe}: device-plan first call {time.perf_counter() - t0:.1f}s")
            match = bool(np.array_equal(ddr, ir)) and bool(np.allclose(ddv, iv, atol=1e-4))
            dev_s = amortize(device, chain, groups)
            run.log(f"nprobe={nprobe}: device-plan amortized {dev_s * 1e3:.2f} ms -> "
                    f"{q_batch / dev_s:.0f} qps ({flat_s / dev_s:.2f}x flat), match_host={match}")
            entry["device_plan"] = {"total_ms": dev_s * 1e3, "qps": q_batch / dev_s,
                                    "speedup_vs_flat": flat_s / dev_s, "match_host_plan": match}
    run.result.update({"metric": f"ivf_scale_{rows}x{DIM}_int8", "rows": rows,
                       "clusters": kn["clusters"], "q": q_batch, "q_block": q_block,
                       "block_rows": kn["block_rows"], **results})


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ToolRun("ivf", {})
    return run_tool(run, lambda r: body(r, args))


if __name__ == "__main__":
    sys.exit(main())
