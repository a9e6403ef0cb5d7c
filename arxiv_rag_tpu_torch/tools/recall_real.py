"""int8 / s8s8 and IVF recall on encoder embeddings, up to 2M rows.

The port of the reference's ``tools/recall_real.py``. Synthetic
Gaussians have well-separated scores; mean-pooled MPNet outputs are
tie-dense, which is where int8 quantization and cluster pruning could
start to cost. This tool:

1. embeds an N-row synthetic-text corpus through the full-size encoder
   (seeded random all-mpnet-base-v2: bf16 on the card, fp32 on the CPU)
   in 100k-row slices, each slice cached on disk;
2. computes the fp32 top-k oracle on the host (slice-wise numpy matmul +
   partial-sort merge);
3. measures recall@10 against it at tie_tol 5e-3 and strict for the bf16
   scan (K1), the int8 row scan (K3) and the s8s8 scan (K2);
4. builds the IVF (4096 clusters at ≥ 1M rows, else N / 400; 1024-row
   blocks; int8) and measures the device-planned route's (K6) recall at
   nprobe 8/16/32 (4/8/16 under 1M rows), then its amortized time against
   the flat int8 scan at Q = 32 (dispatch 6 calls, fetch the last).

    python -m arxiv_rag_tpu_torch.tools.recall_real [rows=100000] [--device cpu]

Env: ARAG_RECALL_CACHE (the slice cache; default
``build/tools/recall_real_<device>_<layers>x<width>_seed0``). Prints one
JSON line and writes it to ``build/tools/recall_real_<device>.json``.

Differences from the reference, on purpose: the rows are parsed in
``main()``, not at import; the amortized timing runs on every device
(the reference's ran on the TPU only); the line names the tokenizer it
used (``tokenizer``: ``native`` or ``python``) — the Python one only when
``tokenize/native.py`` reports the library unavailable, and a native
tokenizer that fails to build is an error, not a quiet fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from arxiv_rag_tpu_torch.tools import CACHE_DIR, ToolRun, run_tool

K = 10
SLICE = 100_000
VOCAB_WORDS = 50_000
AMORTIZE_REPS = 6
TIE_TOLS = ((5e-3, "tol5e3"), (0.0, "strict"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows", nargs="?", type=int, default=100_000)
    ap.add_argument("--device", default=None, help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def texts_for_slice(rng: np.random.Generator, n: int) -> list[str]:
    """Zipfian draws from a 50k-word vocab, 30-150 words per chunk (the
    reference's ``_texts_for_slice``, bitwise)."""
    vocab_words = np.array([f"w{i}" for i in range(VOCAB_WORDS)])
    texts = []
    for _ in range(n):
        m = int(rng.integers(30, 150))
        u = rng.random(m)
        ids = np.minimum((np.exp(u * np.log(len(vocab_words))) - 1).astype(np.int64),
                         len(vocab_words) - 1)
        texts.append(" ".join(vocab_words[ids]))
    return texts


def encoder_model(dev: torch.device):
    """The seeded random full-size encoder: bf16 on the card, fp32 off it
    (the reference's dtype on the TPU and off it)."""
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model

    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return random_model(ModelConfig(), seed=0, device=dev, param_dtype=dt, compute_dtype=dt)


def native_tokenizer(tok):
    """(the C++ tokenizer over ``tok``'s vocab, "native"), or (None,
    "python") when ``tokenize/native.py`` reports the library unavailable
    or the vocab has id gaps. A library that is there but fails to build
    the tokenizer raises."""
    from arxiv_rag_tpu_torch.tokenize import native

    if not native.is_available():
        return None, "python"
    nat = native.for_tokenizer(tok)
    return nat, "python" if nat is None else "native"


def build_embedder(dev: torch.device):
    """(Embedder at buckets 128/256 and batch 512, tokenizer name)."""
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    tok = WordPieceTokenizer.toy()
    nat, name = native_tokenizer(tok)
    return Embedder(encoder_model(dev), tok, buckets=(128, 256), batch_size=512,
                    native_tokenizer=nat), name


def embeddings(run: ToolRun, dev: torch.device, n_rows: int, cache: Path):
    """([n_rows, 768] fp32 unit embeddings, chunks/s of the slices embedded
    in this run, tokenizer name or None when every slice was cached)."""
    cache.mkdir(parents=True, exist_ok=True)
    slices, embedder, tok_name = [], None, None
    t_embed, embedded = 0.0, 0
    for start in range(0, n_rows, SLICE):
        n = min(SLICE, n_rows - start)
        path = cache / f"embs_s{start}_n{n}.npy"
        if path.exists():
            slices.append(np.load(path))
            continue
        if embedder is None:
            embedder, tok_name = build_embedder(dev)
            run.log(f"tokenizer: {tok_name}")
            for warm_len in (40, 120):
                t0 = time.perf_counter()
                embedder.encode_texts(["word " * warm_len] * 512)
                run.log(f"encode bucket for ~{warm_len}-word texts warm "
                        f"({time.perf_counter() - t0:.1f}s)")
        # the slice's seed is its start offset: deterministic, order-free
        texts = texts_for_slice(np.random.default_rng(start + 1), n)
        t0 = time.perf_counter()
        embs = np.asarray(embedder.encode_texts(texts), np.float32)
        t_embed += time.perf_counter() - t0
        embedded += n
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, embs)
        tmp.rename(path)
        slices.append(embs)
        run.log(f"slice {start}..{start + n} embedded and cached "
                f"({embedded / max(t_embed, 1e-9):.0f} chunks/s cumulative)")
    out = np.concatenate(slices, axis=0) if len(slices) > 1 else slices[0]
    return out, (embedded / t_embed if t_embed > 0 else 0.0), tok_name


def host_oracle(embs: np.ndarray, queries: np.ndarray, k: int):
    """fp32 top-k on the host: slice-wise matmul + partial sort + stable
    merge (the reference's ``_host_oracle``)."""
    nq = queries.shape[0]
    best_v = np.full((nq, k), -np.inf, np.float32)
    best_i = np.full((nq, k), -1, np.int64)
    for start in range(0, embs.shape[0], SLICE):
        scores = queries @ embs[start:start + SLICE].T
        take = min(k, scores.shape[1])
        part = np.argpartition(-scores, take - 1, axis=1)[:, :take]
        pv = np.take_along_axis(scores, part, axis=1)
        cand_v = np.concatenate([best_v, pv], axis=1)
        cand_i = np.concatenate([best_i, part + start], axis=1)
        sel = np.argsort(-cand_v, axis=1, kind="stable")[:, :k]
        best_v = np.take_along_axis(cand_v, sel, axis=1)
        best_i = np.take_along_axis(cand_i, sel, axis=1)
    return best_v, best_i


def _fetch(out) -> None:
    """A scan's (values, ids) to the host, or a dispatched IVF search's
    ``finish()``."""
    if callable(out):
        out()
    else:
        out[0].cpu()


def amortized_ms(fn, reps: int = AMORTIZE_REPS) -> float:
    """Amortized ms a call: one warm call fetched, then ``reps`` calls
    dispatched back to back and the last fetched (the stream is in order,
    so it bounds them all)."""
    _fetch(fn())
    t0 = time.perf_counter()
    outs = [fn() for _ in range(reps)]
    _fetch(outs[-1])
    return (time.perf_counter() - t0) * 1000.0 / reps


def body(run: ToolRun, args) -> None:
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops.quant import quantize_int8
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    dev = run.place(args.device)
    n_rows = args.rows
    n_q = min(512, n_rows // 4)
    cfg = ModelConfig()
    cache = Path(os.environ.get(
        "ARAG_RECALL_CACHE",
        CACHE_DIR / f"recall_real_{dev.type}_{cfg.num_hidden_layers}x{cfg.hidden_size}_seed0"))
    run.log(f"backend={dev.type} rows={n_rows}")
    run.at("embed")
    rng = np.random.default_rng(0)
    embs, embed_rate, tok_name = embeddings(run, dev, n_rows, cache)
    run.log(f"embeddings ready: {embs.shape}"
            + (f" ({embed_rate:.0f} chunks/s)" if embed_rate else " (cached)"))
    if not np.allclose(np.linalg.norm(embs[:64], axis=1), 1.0, atol=1e-3):
        raise ValueError("embeddings are not unit rows")

    run.at("oracle")
    sample = embs[rng.choice(n_rows, min(n_rows, 2048), replace=False)]
    sims = sample @ sample.T
    off = sims[~np.eye(len(sims), dtype=bool)]
    run.log(f"pairwise cosine: mean {off.mean():.4f} p99 {np.percentile(off, 99):.4f} "
            f"max {off.max():.4f} (Gaussian-768 mean ~0.000)")
    qi = rng.choice(n_rows, n_q, replace=False)
    qf32 = np.ascontiguousarray(embs[qi], dtype=np.float32)
    queries = torch.from_numpy(qf32).to(dev)
    t0 = time.perf_counter()
    ov, oi = host_oracle(embs, qf32, K)
    run.log(f"host fp32 oracle ready in {time.perf_counter() - t0:.1f}s; oracle kth-score "
            f"mean {ov[:, -1].mean():.4f}")
    if not (oi[:, 0] == qi).mean() > 0.99:
        raise ValueError("self-retrieval should top the oracle's lists")

    r = run.result
    r.update({"rows": n_rows, "queries": n_q, "k": K,
              "embed_chunks_per_sec": round(embed_rate, 1),
              "cos_offdiag_mean": round(float(off.mean()), 4),
              "cos_offdiag_p99": round(float(np.percentile(off, 99)), 4),
              "tokenizer": tok_name or "cached"})

    def measure(name, fn):
        v, i = fn()
        v, i = v.cpu().numpy().astype(np.float32), i.cpu().numpy()
        for tol, tag in TIE_TOLS:
            r[f"recall_{name}_{tag}"] = round(float(
                recall_at_k(i, oi, ov, tie_tol=tol, candidate_scores=v)), 4)
        run.log(f"{name}: recall@{K} = {r[f'recall_{name}_tol5e3']:.4f} (tie_tol 5e-3) / "
                f"{r[f'recall_{name}_strict']:.4f} (strict)")

    run.at("flat scans")
    with run.timed():
        emb_d = torch.from_numpy(embs).to(dev)
        i8_vals, i8_scales = quantize_int8(emb_d)
        index_bf16 = emb_d.to(torch.bfloat16)
        del emb_d
        measure("bf16", lambda: ft.fused_topk(index_bf16, queries.to(torch.bfloat16), K))
        del index_bf16  # before the IVF at scale
        measure("int8_row", lambda: ft.fused_topk_int8(i8_vals, i8_scales, queries, K,
                                                       variant="row"))
        measure("int8_s8s8", lambda: ft.fused_topk_int8(i8_vals, i8_scales, queries, K,
                                                        variant="s8s8"))

        run.at("ivf")
        dense = DenseIndex(values=i8_vals.cpu(), scales=i8_scales.cpu(), dtype="int8",
                           normalized=True, categories=[], row_masks=None)
        n_clusters = 4096 if n_rows >= 1_000_000 else max(16, n_rows // 400)
        nprobes = (8, 16, 32) if n_rows >= 1_000_000 else (4, 8, 16)
        t0 = time.perf_counter()
        ivf = IVFIndex.build(dense, n_clusters, block_rows=1024, iters=8, seed=0, device=dev)
        r["ivf_clusters"] = n_clusters
        r["ivf_build_s"] = round(time.perf_counter() - t0, 1)
        run.log(f"IVF built: {n_clusters} clusters in {r['ivf_build_s']}s")
        for nprobe in nprobes:
            v, rows = ivf.search(qf32, K, nprobe=nprobe, plan="device")
            v = np.asarray(v, np.float32)
            for tol, tag in TIE_TOLS:
                r[f"recall_ivf_np{nprobe}_{tag}"] = round(float(
                    recall_at_k(rows, oi, ov, tie_tol=tol, candidate_scores=v)), 4)
            run.log(f"ivf nprobe={nprobe}: recall@{K} = "
                    f"{r[f'recall_ivf_np{nprobe}_tol5e3']:.4f} (tie_tol 5e-3) / "
                    f"{r[f'recall_ivf_np{nprobe}_strict']:.4f} (strict)")

        run.at("amortized")
        q32 = queries[:32]
        flat_ms = amortized_ms(lambda: ft.fused_topk_int8(i8_vals, i8_scales, q32, K))
        ivf_ms = amortized_ms(lambda: ivf.search_dispatch(q32, K, nprobe=nprobes[0]))
    r["flat_int8_ms_q32"] = round(flat_ms, 2)
    r[f"ivf_np{nprobes[0]}_ms_q32"] = round(ivf_ms, 2)
    r["ivf_speedup_vs_flat"] = round(flat_ms / max(ivf_ms, 1e-9), 2)
    run.log(f"amortized @Q=32: flat {flat_ms:.2f} ms vs ivf(np{nprobes[0]}) {ivf_ms:.2f} ms "
            f"-> {r['ivf_speedup_vs_flat']}x")
    out = CACHE_DIR / f"recall_real_{dev.type}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(r))


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ToolRun("recall_real", {})
    return run_tool(run, lambda r: body(r, args))


if __name__ == "__main__":
    sys.exit(main())
