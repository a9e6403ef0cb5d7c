"""WordPiece tokenizer (MPNet/BERT flavor), the port's own copy.

Same code as ``arxiv_rag_tpu/tokenize/wordpiece.py``, kept here so the
port imports nothing from the JAX package: basic tokenization (clean →
CJK isolation → lowercase + accent strip → punctuation split) followed
by greedy longest-match WordPiece with ``##`` continuations.

MPNet specials (HF MPNetTokenizer defaults): cls=``<s>``, sep=``</s>``,
pad=``<pad>``, unk=``[UNK]``, mask=``<mask>``; single sequences encode
as ``<s> ... </s>``. Parity with HF's slow MPNetTokenizer is tested in
tests/test_tokenizer.py over punctuation/accent/CJK/long-word cases.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class SpecialTokens:
    cls: str = "<s>"
    sep: str = "</s>"
    pad: str = "<pad>"
    unk: str = "[UNK]"
    mask: str = "<mask>"


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode disagrees ($, ^, `)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        specials: SpecialTokens = SpecialTokens(),
        do_lower_case: bool = True,
        max_chars_per_word: int = 100,
    ) -> None:
        self.vocab = vocab
        self.specials = specials
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.cls_id = vocab[specials.cls]
        self.sep_id = vocab[specials.sep]
        self.pad_id = vocab[specials.pad]
        self.unk_id = vocab[specials.unk]
        self._never_split = {specials.cls, specials.sep, specials.pad,
                             specials.unk, specials.mask}

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str | Path, **kwargs) -> "WordPieceTokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kwargs)

    @classmethod
    def toy(cls, **kwargs) -> "WordPieceTokenizer":
        """Character-level fallback vocab (specials + printable ASCII +
        ## continuations). Every text tokenizes; for smoke runs and
        random-init flows where no real vocab file is available."""
        sp = SpecialTokens()
        tokens = [sp.pad, sp.cls, sp.sep, sp.unk, sp.mask]
        chars = [chr(c) for c in range(0x21, 0x7F)]
        tokens += chars + [f"##{ch}" for ch in chars]
        return cls({t: i for i, t in enumerate(tokens)}, **kwargs)

    # -- basic tokenization ---------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _pad_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, token: str) -> list[str]:
        if token in self._never_split:
            return [token]
        pieces: list[list[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: list[str] = []
        for token in text.split():
            if token not in self._never_split and self.do_lower_case:
                token = self._strip_accents(token.lower())
            tokens.extend(self._split_punct(token))
        return [t for t in tokens if t]

    # -- wordpiece -----------------------------------------------------------

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.specials.unk]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.specials.unk]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in self.basic_tokenize(text):
            if word in self._never_split:
                out.append(word)
            else:
                out.extend(self.wordpiece(word))
        return out

    # -- encoding ------------------------------------------------------------

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """``<s> tokens </s>``, truncated to max_len with </s> kept."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if max_len is not None and len(ids) > max_len - 2:
            ids = ids[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(
        self,
        texts: Sequence[str],
        max_len: int,
        pad_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode + right-pad a batch → (input_ids, attention_mask) int32.

        ``pad_to`` pins the padded width (length-bucket shape discipline —
        SURVEY §7 hard part 5); default pads to max_len.
        """
        width = pad_to or max_len
        ids = np.full((len(texts), width), self.pad_id, np.int32)
        mask = np.zeros((len(texts), width), np.int32)
        for row, text in enumerate(texts):
            enc = self.encode(text, max_len=min(max_len, width))
            ids[row, : len(enc)] = enc
            mask[row, : len(enc)] = 1
        return ids, mask

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        toks = []
        special_ids = {self.cls_id, self.sep_id, self.pad_id}
        for i in ids:
            if skip_special and i in special_ids:
                continue
            toks.append(self.inv_vocab.get(int(i), self.specials.unk))
        text = " ".join(toks).replace(" ##", "")
        return text
