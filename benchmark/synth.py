"""Synthetic inputs of the benchmark, all made here from seeds.

- ``Vocab``: a WordPiece vocabulary at a published size (specials,
  single characters, whole words and ``##`` pieces), made from the fixed
  ``DATA_SEED``, as a BERT list (30,522 entries) and the MPNet list built
  on it (``<s> <pad> </s> <unk>``, the BERT list, ``<mask>``: 30,527).
- ``Lexicon``: what texts are written in: whole words, words with a
  ``##`` suffix and words followed by a period, drawn by a Zipf law, each
  with its exact WordPiece token count (the reference tokenizer's).
- ``make_texts``: texts of the chunk length mix (``LengthMix``) and their
  raw token counts; ``make_queries``: queries of 4-12 lexicon entries.
- ``ensure_corpus``: the 2M-chunk corpus in the port's store format
  (Parquet shards and ``corpus.json``), written once per checkout into a
  fixed directory under ``build/benchmark/``, with its token counts.
- ``unit_rows``, ``make_weights`` (over ``mpnet_spec`` or ``bert_spec``):
  index rows and model weights on the device from ``--seed``, in a few
  large calls.

Texts are lowercase ASCII, so a character is a byte.
"""

from __future__ import annotations

import json
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark.reference.wordpiece import WordPiece

DATA_SEED = 20_261_018  # vocabulary and corpus: one data set for every run
ROOT = Path(__file__).resolve().parents[1]
DATA_DIR = ROOT / "build" / "benchmark"
BERT_VOCAB = 30_522
MPNET_VOCAB = 30_527
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
_BERT_SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
BERT_SPECIALS = ("[CLS]", "[SEP]", "[PAD]", "[UNK]", "[MASK]")  # cls, sep, pad, unk, mask
MPNET_SPECIALS = ("<s>", "</s>", "<pad>", "[UNK]", "<mask>")


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of ``seed`` (any whole number)."""
    return int(np.random.SeedSequence([abs(int(seed)), stream]).generate_state(2, np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


def _random_words(rng, n: int, lo: int, hi: int, mean: float) -> list[str]:
    """``n`` distinct lowercase strings of length lo..hi (Poisson around mean)."""
    out: list[str] = []
    seen: set[str] = set()
    while len(out) < n:
        m = 2 * (n - len(out)) + 64
        lens = np.clip(rng.poisson(mean - lo, m) + lo, lo, hi)
        letters = _LETTERS[rng.integers(0, 26, (m, hi))]
        for row, ln in zip(letters, lens):
            w = row[:ln].tobytes().decode()
            if w not in seen:
                seen.add(w)
                out.append(w)
                if len(out) == n:
                    break
    return out


@dataclass
class Vocab:
    bert: list[str]  # id -> token, 30,522
    words: list[str]  # whole words, in vocabulary order
    pieces: list[str]  # ## stems (without the ##)

    @property
    def mpnet(self) -> list[str]:
        return ["<s>", "<pad>", "</s>", "<unk>"] + self.bert + ["<mask>"]

    @classmethod
    def make(cls, size: int = BERT_VOCAB, seed: int = DATA_SEED) -> "Vocab":
        rng = np.random.default_rng([seed, 1])
        toks = [_BERT_SPECIALS.get(i, f"[unused{i}]") for i in range(104)]
        singles = [chr(c) for c in b"abcdefghijklmnopqrstuvwxyz0123456789.,"]
        toks += singles + ["##" + c for c in singles[:36]]
        room = size - len(toks)
        n_pieces = room * 27 // 100
        words = _random_words(rng, room - n_pieces, 2, 11, 4.2)
        taken = set(words) | set(singles)
        pieces = [p for p in _random_words(rng, n_pieces + 4096, 2, 6, 3.0)
                  if p not in taken][:n_pieces]
        toks += words + ["##" + p for p in pieces]
        assert len(toks) == size
        return cls(bert=toks, words=words, pieces=pieces)

    def write(self, directory: Path) -> tuple[Path, Path]:
        """(bert vocab file, mpnet vocab file) under ``directory``, written
        once (their names carry the size, the contents follow the seed)."""
        directory.mkdir(parents=True, exist_ok=True)
        paths = []
        for name, toks in (("bert", self.bert), ("mpnet", self.mpnet)):
            path = directory / f"vocab-{name}-{len(toks)}.txt"
            text = "\n".join(toks) + "\n"
            if not path.exists() or path.read_text() != text:
                tmp = path.with_suffix(".tmp")
                tmp.write_text(text)
                tmp.replace(path)
            paths.append(path)
        return paths[0], paths[1]

    def tokenizer(self, kind: str) -> WordPiece:
        if kind == "bert":
            return WordPiece({t: i for i, t in enumerate(self.bert)}, BERT_SPECIALS)
        return WordPiece({t: i for i, t in enumerate(self.mpnet)}, MPNET_SPECIALS)


@dataclass
class Lexicon:
    """Text entries (in draw order of their Zipf rank), their bytes and
    exact raw token counts."""

    entries: list[str]
    probs: np.ndarray  # draw probability of each entry
    nbytes: np.ndarray  # int64 length of each entry
    tokens: np.ndarray  # int64 WordPiece tokens of each entry (no specials)
    buffer: np.ndarray  # uint8: every entry followed by a space
    starts: np.ndarray  # int64 offset of each entry in ``buffer``
    sampler: np.ndarray  # int64 [2^20]: entry ids laid out by their probability

    @classmethod
    def make(cls, vocab: Vocab, tok: WordPiece, seed: int = DATA_SEED,
             zipf: float = 1.05) -> "Lexicon":
        rng = np.random.default_rng([seed, 2])
        words = vocab.words
        n_comp = len(words) // 3
        base = rng.choice(len(words), n_comp)
        suf = rng.choice(len(vocab.pieces), n_comp)
        comp = [words[b] + vocab.pieces[s] for b, s in zip(base, suf)]
        dotted = [w + "." for w in words[: len(words) // 10]]
        entries = list(dict.fromkeys(words + comp + dotted))
        # frequent entries short, as in prose: Zipf rank by length plus noise
        lens = np.array([len(e) for e in entries])
        order = np.argsort(lens + rng.exponential(3.0, len(entries)), kind="stable")
        entries = [entries[i] for i in order]
        ranks = np.arange(1, len(entries) + 1, dtype=np.float64)
        probs = 1.0 / (ranks + 20.0) ** zipf
        probs /= probs.sum()
        tokens = np.array([len(tok.tokenize(e)) for e in entries], np.int64)
        nbytes = np.array([len(e) for e in entries], np.int64)
        buffer = np.frombuffer(" ".join(entries).encode() + b" ", np.uint8)
        starts = np.cumsum(nbytes + 1) - (nbytes + 1)
        cdf = np.cumsum(probs)
        slots = (np.arange(1 << 20) + 0.5) / (1 << 20)
        sampler = np.minimum(np.searchsorted(cdf, slots), len(entries) - 1).astype(np.int64)
        return cls(entries, probs, nbytes, tokens, buffer, starts, sampler)


@dataclass(frozen=True)
class LengthMix:
    """Chunk lengths in characters: ``full_share`` of the chunks full
    (``full_lo``..``full_hi``), the rest section tails (``tail_lo``..
    ``full_lo``), each uniform."""

    full_share: float = 0.7
    full_lo: int = 1800
    full_hi: int = 2000
    tail_lo: int = 200

    @classmethod
    def from_dict(cls, d: dict) -> "LengthMix":
        return cls(**{k: d[k] for k in ("full_share", "full_lo", "full_hi", "tail_lo")})

    def draw(self, rng, n: int) -> np.ndarray:
        full = rng.random(n) < self.full_share
        lens = np.where(full, rng.integers(self.full_lo, self.full_hi + 1, n),
                        rng.integers(self.tail_lo, self.full_lo, n))
        return lens.astype(np.int64)


def _join(lex: Lexicon, stream: np.ndarray, counts: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Texts of ``counts[i]`` consecutive entries of ``stream`` joined by
    single spaces: (all bytes, int64 offsets [n + 1])."""
    stream = stream[: int(counts.sum())]
    lens = lex.nbytes[stream] + 1  # each entry and its space
    ends = (np.cumsum(counts) - 1)[counts > 0]
    lens[ends] -= 1  # no space after a text's last entry
    out_start = np.cumsum(lens) - lens
    idx = np.repeat(lex.starts[stream] - out_start, lens) + np.arange(int(lens.sum()))
    per_text = np.add.reduceat(lens, np.concatenate([[0], np.cumsum(counts)[:-1]]))
    offsets = np.zeros(len(counts) + 1, np.int64)
    offsets[1:] = np.cumsum(per_text)
    return lex.buffer[idx].tobytes(), offsets


def draw(lex: Lexicon, rng, n: int) -> np.ndarray:
    """``n`` entry ids by the Zipf law (a 2^20-slot inverse-CDF table)."""
    return lex.sampler[rng.integers(0, lex.sampler.shape[0], n)]


def make_texts(lex: Lexicon, rng, char_lens: np.ndarray) -> tuple[list[str], np.ndarray]:
    """Texts of at most ``char_lens[i]`` characters (at least one entry),
    whole entries joined by spaces; (texts, raw token counts)."""
    n = len(char_lens)
    mean = float((lex.probs * (lex.nbytes + 1)).sum())
    stream = draw(lex, rng, int(char_lens.sum() / mean * 1.2) + 64)
    cum = np.cumsum(lex.nbytes[stream] + 1)
    counts = np.empty(n, np.int64)
    s, base = 0, 0
    for i, target in enumerate(char_lens.tolist()):
        if s >= len(stream) - 1:
            extra = draw(lex, rng, len(stream))
            stream = np.concatenate([stream, extra])
            cum = np.cumsum(lex.nbytes[stream] + 1)
        e = int(np.searchsorted(cum, base + target + 1, side="right"))
        e = min(max(e, s + 1), len(stream))
        counts[i] = e - s
        s, base = e, int(cum[e - 1])
    data, offsets = _join(lex, stream, counts)
    toks = np.add.reduceat(lex.tokens[stream[: int(counts.sum())]],
                           np.concatenate([[0], np.cumsum(counts)[:-1]]))
    texts = [data[offsets[i]:offsets[i + 1]].decode() for i in range(n)]
    return texts, toks.astype(np.int64)


def make_queries(lex: Lexicon, rng, n: int, lo: int, hi: int) -> tuple[list[str], np.ndarray]:
    """``n`` queries of ``lo``..``hi`` entries; (queries, raw token counts)."""
    counts = rng.integers(lo, hi + 1, n).astype(np.int64)
    stream = draw(lex, rng, int(counts.sum()))
    data, offsets = _join(lex, stream, counts)
    toks = np.add.reduceat(lex.tokens[stream], np.concatenate([[0], np.cumsum(counts)[:-1]]))
    return [data[offsets[i]:offsets[i + 1]].decode() for i in range(n)], toks.astype(np.int64)


# -- the corpus on disk --------------------------------------------------------

CATEGORIES = ("cs.LG", "cs.CL", "cs.CV", "cs.AI", "cs.IR", "cs.DS", "cs.CR", "stat.ML")
CHUNKS_PER_PAPER = 20
COLUMNS = (  # the port's store schema (store/corpus.py), in its order
    ("chunk_id", "string"), ("paper_id", "string"), ("category", "string"),
    ("year_month", "string"), ("section", "string"), ("page", "int32"),
    ("chunk_index", "int32"), ("quality", "float32"), ("token_count", "int32"),
    ("char_count", "int32"), ("text", "string"),
)


def chunk_id(row: int) -> str:
    return f"p{row // CHUNKS_PER_PAPER:07d}#{row % CHUNKS_PER_PAPER}"


def _corpus_block(lex: Lexicon, mix: LengthMix, start: int, n: int):
    """Rows [start, start + n) of the corpus as a pyarrow table, and their
    raw token counts. Each block has its own generator, so any block can
    be made again alone."""
    import pyarrow as pa

    rng = np.random.default_rng([DATA_SEED, 3, start])
    texts, toks = make_texts(lex, rng, mix.draw(rng, n))
    rows = np.arange(start, start + n)
    papers = rows // CHUNKS_PER_PAPER
    idx = rows % CHUNKS_PER_PAPER
    cols = {
        "chunk_id": [chunk_id(r) for r in rows.tolist()],
        "paper_id": [f"p{p:07d}" for p in papers.tolist()],
        "category": [CATEGORIES[p % len(CATEGORIES)] for p in papers.tolist()],
        "year_month": [f"{2001 + p % 24:04d}"[2:] + f"{1 + p % 12:02d}" for p in papers.tolist()],
        "section": [f"section {i // 4 + 1}" for i in idx.tolist()],
        "page": (idx // 3 + 1).astype(np.int32),
        "chunk_index": idx.astype(np.int32),
        "quality": np.ones(n, np.float32),
        "token_count": toks.astype(np.int32),
        "char_count": np.array([len(t) for t in texts], np.int32),
        "text": texts,
    }
    schema = pa.schema([pa.field(name, getattr(pa, kind)()) for name, kind in COLUMNS])
    return pa.table(cols, schema=schema), toks


def corpus_dir(rows: int) -> Path:
    return DATA_DIR / f"corpus-{DATA_SEED}-{rows}"


def _write_shard(lex: Lexicon, mix: LengthMix, path: Path, s0: int, n: int,
                 row_group: int) -> tuple[int, np.ndarray]:
    """One Parquet shard of rows [s0, s0 + n): (its bytes, token counts)."""
    import pyarrow.parquet as pq

    toks_all, writer = [], None
    try:
        for b0 in range(s0, s0 + n, row_group):
            tbl, toks = _corpus_block(lex, mix, b0, min(row_group, s0 + n - b0))
            if writer is None:
                writer = pq.ParquetWriter(path, tbl.schema)
            writer.write_table(tbl, row_group_size=row_group)
            toks_all.append(toks)
    finally:
        if writer is not None:
            writer.close()
    return path.stat().st_size, np.concatenate(toks_all)


def ensure_corpus(lex: Lexicon, mix: LengthMix, rows: int, *, rows_per_shard: int = 65_536,
                  row_group: int = 8192, max_bytes: int = 6 << 30, workers: int = 0,
                  log=print) -> Path:
    """The corpus of ``rows`` chunks in the port's store format, written
    once into ``corpus_dir(rows)`` (a ``_complete`` file marks it whole;
    an incomplete one is written again), shards in parallel processes.
    Raises if the files outgrow ``max_bytes``. Raw token counts go to
    ``token_counts.npy`` beside it."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    out = corpus_dir(rows)
    if (out / "_complete").exists():
        return out
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    starts = list(range(0, rows, rows_per_shard))
    names = [f"chunks-{si:05d}.parquet" for si in range(len(starts))]
    sizes = [min(rows_per_shard, rows - s0) for s0 in starts]
    workers = workers or max(1, min(8, (os.cpu_count() or 2) - 1, len(starts)))
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(_write_shard, lex, mix, out / name, s0, n, row_group)
                for name, s0, n in zip(names, starts, sizes)]
        results = [f.result() for f in futs]
    written = sum(r[0] for r in results)
    if written > max_bytes:
        raise RuntimeError(f"the corpus took {written} bytes, over {max_bytes}")
    shards = [{"file": name, "num_rows": n, "row_offset": s0}
              for name, s0, n in zip(names, starts, sizes)]
    cats: dict[str, int] = {}
    for p in range((rows + CHUNKS_PER_PAPER - 1) // CHUNKS_PER_PAPER):
        c = CATEGORIES[p % len(CATEGORIES)]
        cats[c] = cats.get(c, 0) + min(CHUNKS_PER_PAPER, rows - p * CHUNKS_PER_PAPER)
    manifest = {"format": "arag-corpus-v1", "num_rows": rows, "shards": shards,
                "categories": cats, "updated_at": 0.0}
    (out / "corpus.json").write_text(json.dumps(manifest, indent=1))
    np.save(out / "token_counts.npy", np.concatenate([r[1] for r in results]).astype(np.int32))
    (out / "_complete").write_text(json.dumps({"bytes": written}))
    log(f"corpus: {rows} rows, {written} bytes of Parquet in {out}")
    return out


def read_corpus_rows(directory: Path, rows, columns=("chunk_id", "text")) -> dict:
    """The benchmark's own read of corpus rows (the raw files, not the
    port's reader): {column: [values in ``rows`` order]}. Of each shard
    only the row groups that hold them are read (pyarrow's threads)."""
    import pyarrow.parquet as pq

    manifest = json.loads((directory / "corpus.json").read_text())
    shards = manifest["shards"]
    offsets = [s["row_offset"] for s in shards]
    by_shard: dict[int, list[tuple[int, int]]] = {}
    for pos, r in enumerate(rows):
        si = int(np.searchsorted(offsets, r, side="right") - 1)
        by_shard.setdefault(si, []).append((r - offsets[si], pos))
    out = {c: [None] * len(rows) for c in columns}
    for si, items in by_shard.items():
        pf = pq.ParquetFile(directory / shards[si]["file"])
        starts = np.cumsum([0] + [pf.metadata.row_group(g).num_rows
                                  for g in range(pf.metadata.num_row_groups)])
        groups = sorted({int(np.searchsorted(starts, i, side="right") - 1) for i, _ in items})
        base = {g: int(sum(starts[h + 1] - starts[h] for h in groups if h < g)) for g in groups}
        tbl = pf.read_row_groups(groups, columns=list(columns), use_threads=True)
        idx = []
        for i, _ in items:
            g = int(np.searchsorted(starts, i, side="right") - 1)
            idx.append(base[g] + i - int(starts[g]))
        taken = tbl.take(idx)
        for c in columns:
            for (_, pos), v in zip(items, taken.column(c).to_pylist()):
                out[c][pos] = v
    return out


# -- device tensors from --seed ------------------------------------------------


def unit_rows(n: int, dim: int, seed: int, device, block: int = 262_144):
    """[n, dim] fp32 rows of unit length, made on ``device`` from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 10))
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for s in range(0, n, block):
        x = torch.randn((min(block, n - s), dim), generator=gen, device=device)
        out[s:s + x.shape[0]] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def _layer_spec(prefix: str, h: int, f: int) -> list[tuple[str, tuple, str]]:
    spec = []
    for name in ("q", "k", "v", "o"):
        spec += [(f"{prefix}attn.{name}.weight", (h, h), "w"), (f"{prefix}attn.{name}.bias", (h,), "b")]
    spec += [(f"{prefix}attn.ln.weight", (h,), "g"), (f"{prefix}attn.ln.bias", (h,), "b"),
             (f"{prefix}ffn.inp.weight", (f, h), "w"), (f"{prefix}ffn.inp.bias", (f,), "b"),
             (f"{prefix}ffn.out.weight", (h, f), "w"), (f"{prefix}ffn.out.bias", (h,), "b"),
             (f"{prefix}ffn.ln.weight", (h,), "g"), (f"{prefix}ffn.ln.bias", (h,), "b")]
    return spec


def mpnet_spec(c: dict) -> list[tuple[str, tuple, str]]:
    h, f = c["hidden_size"], c["intermediate_size"]
    spec = [("word.weight", (c["vocab_size"], h), "w"),
            ("position.weight", (c["max_position_embeddings"], h), "w"),
            ("emb_ln.weight", (h,), "g"), ("emb_ln.bias", (h,), "b"),
            ("rel_bias", (c["relative_attention_num_buckets"], c["num_attention_heads"]), "w")]
    for i in range(c["num_hidden_layers"]):
        spec += _layer_spec(f"layers.{i}.", h, f)
    return spec


def bert_spec(c: dict) -> list[tuple[str, tuple, str]]:
    h, f = c["hidden_size"], c["intermediate_size"]
    spec = [("word.weight", (c["vocab_size"], h), "w"),
            ("position.weight", (c["max_position_embeddings"], h), "w"),
            ("token_type.weight", (c["type_vocab_size"], h), "w"),
            ("emb_ln.weight", (h,), "g"), ("emb_ln.bias", (h,), "b")]
    for i in range(c["num_hidden_layers"]):
        spec += _layer_spec(f"layers.{i}.", h, f)
    spec += [("pooler.weight", (h, h), "w"), ("pooler.bias", (h,), "b"),
             ("classifier.weight", (c["num_labels"], h), "w"), ("classifier.bias", (c["num_labels"],), "b")]
    return spec


def make_weights(spec, seed: int, stream: int, device, std: float, dtype=None) -> dict:
    """Every parameter of ``spec`` from one normal draw on ``device``:
    weights, embeddings and biases N(0, std); LayerNorm scales 1 + N(0,
    std). Views into one buffer of ``dtype`` (bfloat16 by default)."""
    import torch

    dtype = dtype or torch.bfloat16
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, stream))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32) * std
    pos = 0
    for (_, _, kind), size in zip(spec, sizes):
        if kind == "g":
            flat[pos:pos + size] += 1.0
        pos += size
    flat = flat.to(dtype)
    out, pos = {}, 0
    for (name, shape, _), size in zip(spec, sizes):
        out[name] = flat[pos:pos + size].view(shape)
        pos += size
    return out
