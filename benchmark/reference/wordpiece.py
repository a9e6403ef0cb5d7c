"""Plain WordPiece tokenizer: BERT basic tokenization (clean, CJK
isolation, lowercase and accent strip, punctuation split) and greedy
longest-match WordPiece with ``##`` continuations. A frozen copy of the
algorithm that the port's tokenizers implement, written for checking
them; it imports nothing of the port."""

from __future__ import annotations

import re
import unicodedata

# ASCII text: control characters go, runs of letters and digits are words,
# every other printable character is punctuation (a word of its own)
_ASCII_DROP = {c: None for c in list(range(0, 9)) + [11, 12] + list(range(14, 32)) + [127]}
_ASCII_WORD = re.compile(r"[a-z0-9]+|[!-/:-@\[-`{-~]")


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in ("\t", "\n", "\r") and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


class WordPiece:
    """``vocab`` token -> id; ``specials`` (cls, sep, pad, unk, mask)."""

    def __init__(self, vocab: dict[str, int], specials: tuple[str, str, str, str, str],
                 max_chars_per_word: int = 100) -> None:
        self.vocab = vocab
        self.specials = specials
        cls, sep, pad, unk, _ = specials
        self.cls_id, self.sep_id, self.pad_id, self.unk_id = (
            vocab[cls], vocab[sep], vocab[pad], vocab[unk])
        self.unk = unk
        self.never_split = set(specials)
        self.max_chars_per_word = max_chars_per_word
        self._pieces: dict[str, list[str]] = {}

    def basic(self, text: str) -> list[str]:
        if text.isascii() and "[" not in text and "<" not in text:  # no special can occur
            return _ASCII_WORD.findall(text.translate(_ASCII_DROP).lower())
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            ch = " " if _is_whitespace(ch) else ch
            chars.append(f" {ch} " if _is_cjk(cp) else ch)
        out: list[str] = []
        for tok in "".join(chars).split():
            if tok in self.never_split:
                out.append(tok)
                continue
            tok = "".join(c for c in unicodedata.normalize("NFD", tok.lower())
                          if unicodedata.category(c) != "Mn")
            piece = ""
            for ch in tok:
                if _is_punctuation(ch):
                    if piece:
                        out.append(piece)
                    out.append(ch)
                    piece = ""
                else:
                    piece += ch
            if piece:
                out.append(piece)
        return out

    def _word(self, word: str) -> list[str]:
        got = self._pieces.get(word)
        if got is None:
            got = self._split(word)
            if len(self._pieces) < 1_000_000:
                self._pieces[word] = got
        return got

    def _split(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    pieces.append(sub)
                    break
                end -= 1
            if end == start:
                return [self.unk]
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for w in self.basic(text):
            out.extend([w] if w in self.never_split else self._word(w))
        return out

    def raw_ids(self, text: str) -> list[int]:
        return [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]

    def encode(self, text: str, max_len: int) -> list[int]:
        """``cls ids sep`` within ``max_len`` tokens."""
        return [self.cls_id] + self.raw_ids(text)[: max_len - 2] + [self.sep_id]

    def encode_pair(self, query: str, passage: str, pair_len: int) -> tuple[list[int], list[int]]:
        """The ms-marco cross-encoder pair within ``pair_len`` tokens: the
        query keeps at most a quarter of it, each text at most
        ``pair_len - 2`` tokens of its own; (ids, token types)."""
        q = self.raw_ids(query)[: pair_len - 2][: pair_len // 4]
        p = self.raw_ids(passage)[: pair_len - 2][: pair_len - len(q) - 3]
        ids = [self.cls_id] + q + [self.sep_id] + p + [self.sep_id]
        return ids, [0] * (len(q) + 2) + [1] * (len(p) + 1)
