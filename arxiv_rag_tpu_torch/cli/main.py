"""`python -m arxiv_rag_tpu_torch.cli.main` — the port's CLI.

Verbs of the index lifecycle and the serving path, following
``arxiv_rag_tpu/cli/main.py``:

  convert  an HF MPNet checkpoint (``model.safetensors`` + ``config.json``)
           into the reference's native checkpoint, tokenizer files copied
  embed    embed the corpus store's chunks into batch files (resumable)
  index    build the dense index from an embed output directory
           (``--corpus``: categories from the corpus store), with
           ``--ivf-clusters`` an IVF (cluster-pruned) delta beside it;
           ``--append`` grows an existing index and refreshes its delta
  search   query an index with text (``--categories``, ``--nprobe``; with
           ``--corpus``: hydrated text, ``--hybrid-alpha`` BM25 + dense,
           ``--rerank-checkpoint`` / ``--rerank-random-init`` the
           cross-encoder, ``--rerank-cascade`` its two-stage form)
  eval     recall@k, MRR@k and hit@1 with paper titles as queries
  serve    HTTP query service over an index (the same options; POST
           /admin/reload swaps in a grown index with no downtime)
  train    contrastive fine-tune of the encoder on (title -> chunk) pairs
           from the corpus store (``--checkpoint-every``/``--resume``:
           TrainState snapshots under ``--out/state``)

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run on the
CPU. ``--shard`` (search, eval, serve) row-shards the index over every
visible card (with ``--device cpu``: the CPU, one shard); launched by
``torchrun`` (or with ``ARAG_COORDINATOR``, ``WORLD_SIZE`` and ``RANK``
set), one process per card, every rank on the same arguments, it
row-shards over the processes (``parallel/distributed.py``) and rank 0
prints. ``--shard-batches`` (embed, train) splits each batch over every
visible card of the one process. Without
``--checkpoint`` the query encoder is a seeded random bf16
all-mpnet-base-v2 (smoke runs), as in the reference; ``embed`` asks for
``--random-init`` to say so. ``--corpus`` reads the Parquet corpus
store, which needs pyarrow.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from pathlib import Path


def _native_tokenizer_or_none(vocab_path):
    """The C++ batch tokenizer when a real vocab exists and the native
    library builds; None (announced) otherwise."""
    if not (vocab_path and Path(vocab_path).exists()):
        return None
    from arxiv_rag_tpu_torch.tokenize.native import NativeWordPieceTokenizer

    try:
        return NativeWordPieceTokenizer(vocab_path)
    except RuntimeError as exc:
        print(f"note: native tokenizer unavailable ({exc}); using Python", file=sys.stderr)
        return None


def _tokenizer_or_toy(vocab_path):
    """Real vocab when available; the toy char-level vocab is for smoke
    runs only and is announced."""
    from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

    if vocab_path and Path(vocab_path).exists():
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    print("WARNING: no vocab.txt found - using the toy char-level vocab "
          "(fine for random-init smoke runs, wrong for real checkpoints)",
          file=sys.stderr)
    return WordPieceTokenizer.toy()


def _add_convert(sub) -> None:
    p = sub.add_parser("convert", help="convert an HF MPNet checkpoint")
    p.add_argument("--hf-dir", required=True, help="dir with model.safetensors + config.json")
    p.add_argument("--out", required=True)


def cmd_convert(args) -> int:
    from arxiv_rag_tpu_torch.models.convert import (
        from_safetensors,
        load_model_config,
        save_checkpoint,
    )

    cfg = load_model_config(args.hf_dir)
    save_checkpoint(args.out, from_safetensors(args.hf_dir, cfg), cfg)
    # embed, search and serve look for vocab.txt beside the checkpoint
    copied = []
    for name in ("vocab.txt", "tokenizer.json", "tokenizer_config.json",
                 "special_tokens_map.json"):
        src = Path(args.hf_dir) / name
        if src.exists():
            (Path(args.out) / name).write_bytes(src.read_bytes())
            copied.append(name)
    print(json.dumps({"saved": args.out, "hidden": cfg.hidden_size,
                      "layers": cfg.num_hidden_layers, "tokenizer_files": copied}))
    return 0


def _add_embed(sub) -> None:
    p = sub.add_parser("embed", help="embed corpus chunks")
    p.add_argument("--corpus", required=True)
    p.add_argument("--out", required=True, help="output embeddings dir")
    p.add_argument("--checkpoint", default=None, help="native checkpoint dir")
    p.add_argument("--vocab", default=None, help="tokenizer vocab.txt")
    p.add_argument("--random-init", action="store_true", help="random weights (smoke runs)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--min-quality", type=float, default=0.9)
    p.add_argument("--shard-batches", action="store_true",
                   help="split each batch over every visible card (data parallel; the "
                        "batch size a multiple of their count)")
    p.add_argument("--device", default="cuda")


def cmd_embed(args) -> int:
    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.embed.runner import embed_batches
    from arxiv_rag_tpu_torch.models.convert import load_model
    from arxiv_rag_tpu_torch.models.mpnet import random_model
    from arxiv_rag_tpu_torch.store.corpus import CorpusReader

    if not args.checkpoint and not args.random_init:
        print("need --checkpoint or --random-init", file=sys.stderr)
        return 2
    dev = default_device(args.device)
    if args.checkpoint:  # the bf16 encoder, as the reference's verb runs it
        model, _ = load_model(args.checkpoint, device=dev)
        vocab_path = args.vocab or str(Path(args.checkpoint) / "vocab.txt")
    else:
        model = random_model(seed=0, device=dev)
        vocab_path = args.vocab
    mesh = None
    if args.shard_batches:
        from arxiv_rag_tpu_torch.parallel import data_mesh

        mesh = data_mesh(device=dev)
    embedder = Embedder(model, _tokenizer_or_toy(vocab_path), batch_size=args.batch_size,
                        native_tokenizer=_native_tokenizer_or_none(vocab_path), mesh=mesh)
    batches = ((b.column("chunk_id").to_pylist(), b.column("text").to_pylist())
               for b in CorpusReader(args.corpus).iter_batches(
                   batch_size=8192, columns=["chunk_id", "text"],
                   min_quality=args.min_quality))
    print(json.dumps(embed_batches(embedder, batches, args.out,
                                   model=args.checkpoint or "random-init")))
    return 0


def _add_index(sub) -> None:
    p = sub.add_parser("index", help="build the dense search index")
    p.add_argument("--embeddings", required=True, help="embed output dir")
    p.add_argument("--corpus", default=None,
                   help="corpus store dir: each chunk's category for the row masks")
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"])
    p.add_argument("--device", default="cuda", help="where the index is built")
    p.add_argument("--append", action="store_true",
                   help="append these embeddings to the existing index at --out (new "
                        "shards; dtype and normalization follow its manifest) and refresh "
                        "its IVF delta from the trained centroids")
    p.add_argument("--ivf-clusters", type=int, default=0,
                   help="also train an IVF (cluster-pruned) delta with this many "
                        "clusters; search probes it via --nprobe (with --append, only "
                        "onto an index that has no delta yet)")
    p.add_argument("--ivf-block-rows", type=int, default=1024,
                   help="IVF layout block size; a multiple of 128, as the reference "
                        "requires, so a delta serves both packages")
    p.add_argument("--ivf-iters", type=int, default=10)


def cmd_index(args) -> int:
    import numpy as np

    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import build_index, build_index_device

    if args.ivf_clusters and args.ivf_block_rows % 128:
        print(f"error: --ivf-block-rows {args.ivf_block_rows} must be a multiple of 128 "
              "(the reference's IVF kernel tiles its scale/mask sidecars by 128)",
              file=sys.stderr)
        return 2
    if args.append and args.ivf_clusters and IVFIndex.exists(args.out):
        print(f"error: --ivf-clusters {args.ivf_clusters} with --append: {args.out} already has "
              "an IVF delta, which the append extends with its trained centroids; rebuild "
              "the index to retrain it", file=sys.stderr)
        return 2
    src = Path(args.embeddings)
    manifest = json.loads((src / "index.json").read_text())
    parts = [np.load(src / b["file"]) for b in manifest["batches"]]
    ids: list[str] = []
    for i in range(len(manifest["batches"])):
        ids.extend(json.loads((src / f"ids_{i:05d}.json").read_text()))
    embs = (np.concatenate(parts, axis=0) if parts
            else np.zeros((0, manifest["dim"]), np.float32))
    categories = None
    if args.corpus:
        from arxiv_rag_tpu_torch.store.corpus import CorpusReader

        cat_of: dict[str, str] = {}
        for batch in CorpusReader(args.corpus).iter_batches(columns=["chunk_id", "category"]):
            cat_of.update(zip(batch.column("chunk_id").to_pylist(),
                              batch.column("category").to_pylist()))
        categories = [cat_of.get(cid, "") for cid in ids]
    dev = default_device(args.device)
    ivf_meta = {}
    if args.append:
        from arxiv_rag_tpu_torch.index.store import append_index

        idx = append_index(args.out, embs, categories=categories,
                           chunk_ids=ids if ids else None, device=dev)
        if IVFIndex.exists(args.out):
            ivf = IVFIndex.extend(args.out, idx, device=dev)
            ivf_meta = {"ivf_clusters": ivf.n_clusters, "ivf_block_rows": ivf.block_rows,
                        "ivf_refreshed": True}
    else:
        kw = dict(categories=categories, dtype=args.dtype, chunk_ids=ids)
        # on the card: divided and quantized there with numpy's row norms,
        # bitwise the host build
        idx = (build_index(embs, **kw) if dev.type == "cpu"
               else build_index_device(embs, device=dev, **kw))
        idx.model = manifest.get("model", "")
        idx.save(args.out)
    if args.ivf_clusters and not ivf_meta:
        ivf = IVFIndex.build(idx, args.ivf_clusters, block_rows=args.ivf_block_rows,
                             iters=args.ivf_iters, device=dev)
        ivf.save(args.out)
        ivf_meta = {"ivf_clusters": ivf.n_clusters, "ivf_block_rows": ivf.block_rows}
    print(json.dumps({"rows": idx.num_rows, "dim": idx.dim, "dtype": idx.dtype,
                      "categories": idx.categories, **ivf_meta}))
    return 0


def _add_common(p) -> None:
    p.add_argument("--index", required=True)
    p.add_argument("--corpus", default=None,
                   help="corpus store dir: hydrates chunk metadata and text (needs pyarrow)")
    p.add_argument("--checkpoint", default=None, help="native checkpoint dir")
    p.add_argument("--vocab", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--shard", action="store_true",
                   help="row-shard the index over every visible card (an IVF delta: "
                        "cluster-partitioned); with --device cpu, the CPU")
    p.add_argument("--hybrid-alpha", type=float, default=None,
                   help="hybrid retrieval at this dense weight (the reference config "
                        "uses 0.7); builds BM25 over --corpus, aligned to index rows")
    p.add_argument("--rerank-checkpoint", default=None,
                   help="cross-encoder checkpoint dir (config.json + state.npz + "
                        "vocab.txt): rerank the top rerank_top_k candidates")
    p.add_argument("--rerank-random-init", action="store_true",
                   help="a small random cross-encoder (smoke runs)")
    p.add_argument("--rerank-cascade", type=int, default=None,
                   help="cascade depth: score all candidate pairs at a 64-token "
                        "truncation, rescore the top N per query at full pair length "
                        "(0/absent: single stage)")


def _add_search(sub) -> None:
    p = sub.add_parser("search", help="query the index")
    _add_common(p)
    p.add_argument("--query", action="append", required=True)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--categories", default=None, help="comma-separated category filter")
    p.add_argument("--nprobe", type=int, default=None,
                   help="probe this many IVF clusters (approximate search; needs an "
                        "index built with --ivf-clusters)")
    p.add_argument("--json", action="store_true",
                   help="one JSON line per query: its scores (exact fp32 values) and rows")


def build_engine(args):
    """Index (+ its IVF delta when probing) + query embedder (+ corpus,
    BM25, cross-encoder) + engine, as the reference's ``_build_engine``
    does; ``--shard`` joins the process group when one is configured
    (``init_distributed``, as the reference's :612-615) and row-shards the
    index over ``data_mesh()``, every process's shard on its own device."""
    import dataclasses

    import torch

    from arxiv_rag_tpu_torch.config import load_config
    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.models.convert import load_model
    from arxiv_rag_tpu_torch.models.mpnet import random_model
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    # callers may pass a namespace without the corpus, hybrid and rerank flags
    corpus_dir = getattr(args, "corpus", None)
    alpha = getattr(args, "hybrid_alpha", None)
    cascade = getattr(args, "rerank_cascade", None)
    rerank_ck = getattr(args, "rerank_checkpoint", None)
    rerank_random = getattr(args, "rerank_random_init", False)
    shard = getattr(args, "shard", False)
    mesh = None
    if shard:
        from arxiv_rag_tpu_torch.parallel import data_mesh, init_distributed
        from arxiv_rag_tpu_torch.parallel.distributed import describe

        if init_distributed(device=args.device):
            print(f"process group: {describe()}", file=sys.stderr)
        mesh = data_mesh(device=args.device)
    dev = mesh.home if mesh is not None else default_device(args.device)
    rcfg = load_config().retrieval
    if args.nprobe is not None:
        rcfg = dataclasses.replace(rcfg, nprobe=args.nprobe)
    if alpha is not None:
        rcfg = dataclasses.replace(rcfg, hybrid_alpha=alpha)
    if cascade is not None:
        rcfg = dataclasses.replace(rcfg, rerank_cascade_depth=cascade)
    idx = DenseIndex.load(args.index)
    if shard:
        idx.to_device(mesh=mesh)
    else:
        idx.to_device(dev)
    # the delta's layout is a second copy of the values: loaded only when
    # the engine will probe it, on the device, or on the host for a mesh
    # (the engine copies each shard's clusters from there to its card)
    ivf = (IVFIndex.load(args.index, idx, device="cpu" if shard else dev)
           if rcfg.nprobe and IVFIndex.exists(args.index) else None)
    if args.checkpoint:
        model, _ = load_model(args.checkpoint, device=dev)
        vocab_path = args.vocab or str(Path(args.checkpoint) / "vocab.txt")
    else:
        model = random_model(seed=0, device=dev)
        vocab_path = args.vocab
    tokenizer = _tokenizer_or_toy(vocab_path)
    # serving windows are small and varied: small padded heights beside the bulk one
    embedder = Embedder(model, tokenizer, batch_sizes=(64, 512),
                        native_tokenizer=_native_tokenizer_or_none(vocab_path))

    corpus = None
    if corpus_dir:
        from arxiv_rag_tpu_torch.store.corpus import CorpusReader

        # the lazy-hydration row-group cache holds the whole corpus: 1.5x
        # its Parquet bytes (decompression headroom), within [512 MB, 4 GB],
        # unless --hydration-cache-mb says otherwise
        mb = getattr(args, "hydration_cache_mb", None)
        if mb is None:
            disk = sum(p.stat().st_size for p in Path(corpus_dir).glob("*.parquet"))
            cache = max(512 << 20, min(4 << 30, int(disk * 1.5)))
        else:
            cache = int(mb) << 20
        corpus = CorpusReader(corpus_dir, cache_bytes=cache)
    bm25 = None
    if alpha is not None:
        if corpus is None:
            print("--hybrid-alpha needs --corpus (BM25 is built over its texts)",
                  file=sys.stderr)
            raise SystemExit(2)
        from arxiv_rag_tpu_torch.search.engine import bm25_for_index

        bm25 = bm25_for_index(idx, corpus)  # in index row order
    reranker = None
    if rerank_ck or rerank_random:
        from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
        from arxiv_rag_tpu_torch.models.convert import load_bert_checkpoint
        from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker
        from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

        if rerank_ck:
            ck = Path(rerank_ck)
            bmodel, _ = load_bert_checkpoint(ck, device=dev)
            btok = WordPieceTokenizer.from_vocab_file(ck / "vocab.txt")
        else:  # the reference's toy shape: fp32 weights, bf16 compute
            btok = tokenizer
            bcfg = BertConfig(vocab_size=max(tokenizer.vocab.values()) + 1,
                              hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=128,
                              pad_token_id=tokenizer.pad_id)
            bmodel = random_bert(bcfg, seed=2, param_dtype=torch.float32, device=dev)
        reranker = CrossEncoderReranker(bmodel, btok,
                                        max_pair_len=rcfg.rerank_max_pair_len or None)
    return SearchEngine(idx, embedder=embedder, corpus=corpus, cfg=rcfg, bm25=bm25,
                        reranker=reranker, ivf=ivf, device=dev)


def cmd_search(args) -> int:
    from arxiv_rag_tpu_torch.parallel import is_primary

    engine = build_engine(args)
    cats = args.categories.split(",") if args.categories else None
    results = engine.search(args.query, k=args.k, categories=cats,
                            hybrid_alpha=args.hybrid_alpha)
    if not is_primary():  # every rank holds the same results
        return 0
    for qi, hits in enumerate(results):
        if args.json:
            print(json.dumps({"query": args.query[qi], "scores": [h.score for h in hits],
                              "rows": [h.row for h in hits]}))
            continue
        print(f"query[{qi}]: {args.query[qi]}")
        for h in hits:
            line = f"  {h.score:.4f} row={h.row}"
            if h.chunk_id:
                line += f" {h.chunk_id} [{h.category}] {h.section}"
            if h.text:
                line += f" :: {h.text[:100]}"
            print(line)
    return 0


def _add_eval(sub) -> None:
    p = sub.add_parser("eval", help="retrieval quality (recall@k, MRR@k, hit@1) with paper "
                                    "titles as queries")
    _add_common(p)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max-queries", type=int, default=256)
    p.add_argument("--nprobe", type=int, default=None)


def cmd_eval(args) -> int:
    from arxiv_rag_tpu_torch.evaluate import evaluate_engine, load_paper_titles, title_queries
    from arxiv_rag_tpu_torch.parallel import is_primary

    if not args.corpus:
        print("eval needs --corpus", file=sys.stderr)
        return 2
    engine = build_engine(args)
    queries, relevant = title_queries(engine.corpus, load_paper_titles(args.corpus),
                                      args.max_queries)
    if not queries:
        print("no usable (title, chunks) pairs in the corpus", file=sys.stderr)
        return 2
    report = evaluate_engine(engine, queries, relevant, k=args.k).to_dict()
    if is_primary():  # every rank holds the same report
        print(json.dumps(report))
    return 0


def _add_serve(sub) -> None:
    p = sub.add_parser("serve", help="HTTP query service over an index")
    _add_common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--nprobe", type=int, default=None,
                   help="serve with IVF probing (approximate retrieval)")
    p.add_argument("--batch-window-ms", type=float, default=4.0,
                   help="micro-batch coalescing window (0 = serialize directly)")
    p.add_argument("--max-batch", type=int, default=512,
                   help="dispatch immediately once this many queries are queued")
    p.add_argument("--warmup", action="store_true",
                   help="run every query-window shape once before listening, so kernel "
                        "builds and first launches never stall a live window")
    p.add_argument("--hydration-cache-mb", type=int, default=None,
                   help="row-group text cache for lazy hydration (default: 1.5x the "
                        "corpus's Parquet bytes, within [512 MB, 4 GB])")
    p.add_argument("--admin-token", default=None,
                   help="shared secret (X-Admin-Token header) for POST /admin/reload; "
                        "without it reload takes only this server's --index/--corpus")


def _warm_texts(tokenizer, buckets) -> dict[int, str]:
    """Per token bucket, a text whose MEASURED token count nearly fills
    it (a chars-per-token guess misses the larger buckets with a real
    vocab), leaving room for the per-query suffix."""
    out = {}
    for b in buckets:
        target = max(1, b - 8)
        words = ["warm"]
        while len(tokenizer.encode(" ".join(words))) < target and len(words) < 8 * target:
            words = words + words
        while len(words) > 1 and len(tokenizer.encode(" ".join(words[:-1]))) >= target:
            words = words[:-1]
        out[b] = " ".join(words)
    return out


def warmup(engine, max_batch: int) -> None:
    """Every (window size, token bucket) shape the micro-batcher can give
    the engine, once; past 512 the engine pads windows to multiples of
    128, so a larger ``max_batch`` adds those sizes."""
    qs = [1, 32, 64, 128, 256, 384, 512] + list(range(640, max_batch + 1, 128))
    texts = _warm_texts(engine.embedder.tokenizer, engine.embedder.buckets)
    for qn in qs:
        if qn > max_batch and qn != 1:
            continue
        for text in texts.values():
            engine.search([f"{text} {i}" for i in range(qn)], k=10)
        print(f"warmed shapes for {qn}-query windows", file=sys.stderr)


def cmd_serve(args) -> int:
    from arxiv_rag_tpu_torch.serve import serve

    engine = build_engine(args)
    if args.warmup:
        warmup(engine, args.max_batch)
    groups = engine.warm_hydration()
    if groups:
        print(f"hydration cache prewarmed ({groups} row groups)", file=sys.stderr)
    if engine.reranker is not None:
        print(f"rerank buckets warmed: {engine.reranker.warm()}", file=sys.stderr)
    httpd = serve(
        engine, args.host, args.port,
        index_stats={"rows": engine.index.num_rows, "dim": engine.index.dim,
                     "dtype": engine.index.dtype},
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        # POST /admin/reload picks up `index --append` growth from here
        reload_paths={"index": args.index, "corpus": args.corpus},
        admin_token=args.admin_token,
    )
    print(f"serving on http://{args.host}:{args.port}", file=sys.stderr)

    def _term(signum, frame):
        raise KeyboardInterrupt

    old = signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (draining in-flight windows)", file=sys.stderr)
    finally:
        signal.signal(signal.SIGTERM, old)
        httpd.batcher.close()
        httpd.server_close()
    return 0


def _add_train(sub) -> None:
    p = sub.add_parser("train", help="contrastive fine-tune of the encoder")
    p.add_argument("--corpus", required=True)
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--checkpoint", default=None, help="starting checkpoint (else random init)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--max-pairs", type=int, default=50000)
    p.add_argument("--shard-batches", action="store_true",
                   help="data-parallel training over every visible card of this process "
                        "(in-batch negatives across the global batch; the batch size a "
                        "multiple of their count)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="TrainState snapshot under --out/state every N steps (0=off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest snapshot under --out/state")
    p.add_argument("--small-model", action="store_true",
                   help="tiny ModelConfig for smoke runs")
    p.add_argument("--device", default="cuda")


def cmd_train(args, corpus=None) -> int:
    """Fine-tune the embedder on (paper title -> chunk) pairs mined from
    the corpus store, as the reference's verb does; the result is a
    native checkpoint either package loads. ``corpus`` stands in for the
    store at ``--corpus`` (any object with its ``iter_batches(columns=)``,
    as where pyarrow is missing); titles come from ``--corpus``'s
    ``papers.jsonl`` either way."""
    import numpy as np
    import torch

    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.models.convert import load_checkpoint, save_checkpoint
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
    from arxiv_rag_tpu_torch.pipeline.repair import load_paper_titles
    from arxiv_rag_tpu_torch.train import make_train_step
    from arxiv_rag_tpu_torch.train.checkpoint import restore_train_state, save_train_state

    dev = default_device(args.device)
    mesh = None
    if args.shard_batches:
        from arxiv_rag_tpu_torch.parallel import data_mesh

        mesh = data_mesh(device=dev)
        if args.batch_size % mesh.size:
            print(f"--batch-size {args.batch_size} does not split over {mesh.size} devices",
                  file=sys.stderr)
            return 2
    if corpus is None:
        from arxiv_rag_tpu_torch.store.corpus import CorpusReader

        corpus = CorpusReader(args.corpus)
    # --- mine pairs: query = paper title, positive = a chunk of it ---
    titles = load_paper_titles(args.corpus)
    pairs: list[tuple[str, str]] = []
    for batch in corpus.iter_batches(columns=["paper_id", "text"]):
        for row in batch.to_pylist():
            title = titles.get(row["paper_id"], "")
            if len(title) > 10 and len(row["text"]) > 100:
                pairs.append((title, row["text"]))
            if len(pairs) >= args.max_pairs:
                break
        if len(pairs) >= args.max_pairs:
            break
    if len(pairs) < args.batch_size:
        print(f"not enough pairs ({len(pairs)}) for batch {args.batch_size}",
              file=sys.stderr)
        return 2

    state_dict = None
    if args.checkpoint:
        state_dict, mcfg = load_checkpoint(args.checkpoint)
        vocab_path = args.vocab or str(Path(args.checkpoint) / "vocab.txt")
    else:
        mcfg, vocab_path = ModelConfig(), args.vocab
    tokenizer = _tokenizer_or_toy(vocab_path)
    if args.small_model:
        mcfg = ModelConfig(
            vocab_size=max(tokenizer.vocab.values()) + 1, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=args.seq_len + 2, pad_token_id=tokenizer.pad_id,
        )
        state_dict = None
    if state_dict is None:  # seeded random fp32 weights
        state_dict = random_model(mcfg, seed=0, param_dtype=torch.float32,
                                  compute_dtype=torch.float32, device=dev).state_dict()
    init_state, train_step = make_train_step(
        mcfg, learning_rate=args.lr, device=None if mesh else dev, mesh=mesh,
        compute_dtype=torch.float32 if args.small_model else torch.bfloat16,
    )
    state = init_state(state_dict)
    del state_dict
    state_dir = Path(args.out) / "state"
    if args.resume:
        restored = restore_train_state(state_dir, state)
        if restored is not None:
            state = restored
            print(f"resumed at step {state.step}", file=sys.stderr)

    rng = np.random.default_rng(0)
    order = rng.permutation(len(pairs))
    bs, sl = args.batch_size, args.seq_len
    losses = []
    for step in range(args.steps):
        sel = order[(step * bs) % len(pairs):][:bs]
        if len(sel) < bs:
            sel = np.concatenate([sel, order[: bs - len(sel)]])
        q_ids, q_mask = tokenizer.encode_batch([pairs[i][0] for i in sel], max_len=sl)
        p_ids, p_mask = tokenizer.encode_batch([pairs[i][1] for i in sel], max_len=sl)
        state, metrics = train_step(state, q_ids, q_mask, p_ids, p_mask)
        losses.append(float(metrics["loss"]))
        if (step + 1) % 10 == 0:
            print(f"step {step+1}/{args.steps} loss={losses[-1]:.4f} "
                  f"acc={float(metrics['in_batch_acc']):.3f}", file=sys.stderr)
        if args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
            save_train_state(state_dir, state)

    save_checkpoint(args.out, state.params, mcfg)
    if vocab_path and Path(vocab_path).exists():
        (Path(args.out) / "vocab.txt").write_text(Path(vocab_path).read_text())
    print(json.dumps({
        "steps": args.steps, "pairs": len(pairs),
        "first_loss": round(losses[0], 4), "last_loss": round(losses[-1], 4),
        "saved": args.out,
    }))
    return 0


COMMANDS = {"convert": cmd_convert, "embed": cmd_embed, "index": cmd_index,
            "search": cmd_search, "eval": cmd_eval, "serve": cmd_serve, "train": cmd_train}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="arag-torch", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for adder in (_add_convert, _add_embed, _add_index, _add_search, _add_eval, _add_serve,
                  _add_train):
        adder(sub)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
