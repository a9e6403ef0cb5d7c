"""`python -m arxiv_rag_tpu_torch.cli.main` — the port's CLI.

Verbs of the dense serving path, following ``arxiv_rag_tpu/cli/main.py``:

  index   build the dense index from an embed output directory
  search  query an index with text
  serve   HTTP query service over an index

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run on the
CPU. Without ``--checkpoint`` the encoder is a seeded random bf16
all-mpnet-base-v2 (smoke runs), as in the reference.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from pathlib import Path


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


def _add_index(sub) -> None:
    p = sub.add_parser("index", help="build the dense search index")
    p.add_argument("--embeddings", required=True, help="embed output dir")
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"])
    p.add_argument("--device", default="cuda", help="where the index is built")


def cmd_index(args) -> int:
    import numpy as np
    import torch

    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.index.store import build_index

    src = Path(args.embeddings)
    manifest = json.loads((src / "index.json").read_text())
    parts = [np.load(src / b["file"]) for b in manifest["batches"]]
    ids: list[str] = []
    for i in range(len(manifest["batches"])):
        ids.extend(json.loads((src / f"ids_{i:05d}.json").read_text()))
    embs = (np.concatenate(parts, axis=0) if parts
            else np.zeros((0, manifest["dim"]), np.float32))
    dev = default_device(args.device)
    data = embs if dev.type == "cpu" else torch.from_numpy(embs).to(dev)
    idx = build_index(data, dtype=args.dtype, chunk_ids=ids)
    idx.model = manifest.get("model", "")
    idx.save(args.out)
    print(json.dumps({"rows": idx.num_rows, "dim": idx.dim, "dtype": idx.dtype,
                      "categories": idx.categories}))
    return 0


def _add_common(p) -> None:
    p.add_argument("--index", required=True)
    p.add_argument("--checkpoint", default=None, help="native checkpoint dir")
    p.add_argument("--vocab", default=None)
    p.add_argument("--device", default="cuda")


def _add_search(sub) -> None:
    p = sub.add_parser("search", help="query the index")
    _add_common(p)
    p.add_argument("--query", action="append", required=True)
    p.add_argument("--k", type=int, default=10)


def build_engine(args):
    """Index + query embedder + engine, as the reference's ``_build_engine``
    does for the dense route."""
    from arxiv_rag_tpu_torch.config import load_config
    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.models.convert import load_model
    from arxiv_rag_tpu_torch.models.mpnet import random_model
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    dev = default_device(args.device)
    rcfg = load_config().retrieval
    idx = DenseIndex.load(args.index).to_device(dev)
    if args.checkpoint:
        model, _ = load_model(args.checkpoint, device=dev)
        vocab_path = args.vocab or str(Path(args.checkpoint) / "vocab.txt")
    else:
        model = random_model(seed=0, device=dev)
        vocab_path = args.vocab
    tokenizer = _tokenizer_or_toy(vocab_path)
    # serving windows are small and varied: small padded heights beside the bulk one
    embedder = Embedder(model, tokenizer, batch_sizes=(64, 512))
    return SearchEngine(idx, embedder=embedder, cfg=rcfg, device=dev)


def cmd_search(args) -> int:
    engine = build_engine(args)
    results = engine.search(args.query, k=args.k)
    for qi, hits in enumerate(results):
        print(f"query[{qi}]: {args.query[qi]}")
        for h in hits:
            print(f"  {h.score:.4f} row={h.row}")
    return 0


def _add_serve(sub) -> None:
    p = sub.add_parser("serve", help="HTTP query service over an index")
    _add_common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-window-ms", type=float, default=4.0,
                   help="micro-batch coalescing window (0 = serialize directly)")
    p.add_argument("--max-batch", type=int, default=512,
                   help="dispatch immediately once this many queries are queued")


def cmd_serve(args) -> int:
    from arxiv_rag_tpu_torch.serve import serve

    engine = build_engine(args)
    httpd = serve(
        engine, args.host, args.port,
        index_stats={"rows": engine.index.num_rows, "dim": engine.index.dim,
                     "dtype": engine.index.dtype},
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
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


COMMANDS = {"index": cmd_index, "search": cmd_search, "serve": cmd_serve}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="arag-torch", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for adder in (_add_index, _add_search, _add_serve):
        adder(sub)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
