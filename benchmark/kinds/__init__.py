"""Drivers, one per traffic ``kind``: ``run(Run) -> Outcome``.

Shared here: the synthetic vocabulary and lexicon, the port's models
built on the benchmark's weights, and window deltas of the port's
``METRICS`` counters and timers.
"""

from __future__ import annotations

import dataclasses
import gc
from functools import lru_cache

from benchmark import synth


@lru_cache(maxsize=1)
def vocab_and_lexicon() -> tuple[synth.Vocab, synth.Lexicon]:
    vocab = synth.Vocab.make()
    return vocab, synth.Lexicon.make(vocab, vocab.tokenizer("bert"))


def _fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def port_encoder(enc: dict, weights: dict):
    """The port's MPNet on the benchmark's weights (``enc``: a config's
    ``encoder`` section)."""
    import torch
    from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig

    with torch.device("meta"):
        model = MPNet(ModelConfig(**_fields(ModelConfig, enc["config"])), torch.bfloat16)
    model.load_state_dict(weights, assign=True)
    return model.eval()


def port_cross_encoder(ce: dict, weights: dict):
    import torch
    from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig

    with torch.device("meta"):
        model = Bert(BertConfig(**_fields(BertConfig, ce["config"])), torch.bfloat16)
    model.load_state_dict(weights, assign=True)
    return model.eval()


def port_tokenizers(vocab: synth.Vocab, kind: str):
    """(the port's Python WordPiece tokenizer, its native one) over the
    synthetic vocabulary file, as the CLI builds them from a vocab.txt."""
    from arxiv_rag_tpu_torch.tokenize.native import NativeWordPieceTokenizer
    from arxiv_rag_tpu_torch.tokenize.wordpiece import SpecialTokens, WordPieceTokenizer

    bert_path, mpnet_path = vocab.write(synth.DATA_DIR / "vocab")
    if kind == "mpnet":
        specials, path = SpecialTokens(), mpnet_path
    else:
        specials, path = SpecialTokens(cls="[CLS]", sep="[SEP]", pad="[PAD]", unk="[UNK]",
                                       mask="[MASK]"), bert_path
    return (WordPieceTokenizer.from_vocab_file(path, specials=specials),
            NativeWordPieceTokenizer(path, specials=specials))


def metrics_now() -> dict:
    from arxiv_rag_tpu_torch.logging_utils import METRICS

    snap = METRICS.snapshot()
    return {"counters": dict(snap["counters"]),
            "timers": {k: (t["count"], t["total_s"]) for k, t in snap["timers"].items()}}


def metrics_delta(before: dict, after: dict) -> dict:
    """Counters and timer (count, total seconds) over a window."""
    counters = {k: v - before["counters"].get(k, 0.0) for k, v in after["counters"].items()}
    timers = {}
    for k, (n, s) in after["timers"].items():
        n0, s0 = before["timers"].get(k, (0, 0.0))
        timers[k] = {"count": n - n0, "total_s": s - s0}
    return {"counters": counters, "timers": timers}


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
