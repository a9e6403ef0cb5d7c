"""The port's C++ WordPiece binding (``tokenize/native.py``) against the
port's Python tokenizer and the JAX package's, on the cases of
tests/test_native_tokenizer.py: ids and masks equal exactly. The library
builds with g++ into build/native/ and writes nothing into native/."""

from pathlib import Path

import numpy as np
import pytest
import torch

from arxiv_rag_tpu.tokenize.wordpiece import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.tokenize import native
from arxiv_rag_tpu_torch.tokenize.native import NativeWordPieceTokenizer
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

REPO = Path(__file__).resolve().parents[1]

VOCAB = (
    "<pad> <s> </s> [UNK] <mask> the quick brown fox jump ##s over lazy dog "
    "un ##believ ##able caf ##e deep learn ##ing model trans ##form ##er "
    ", . ! ? ( ) [ ] - 1 2 3 a b c d e f g h i j k l m n o p q r s t u v w x y z"
).split()

CASES = [
    "The quick brown fox jumps over the lazy dog",
    "unbelievable!",
    "café",                          # accent folding
    "Deep Learning models, transformers.",
    "word-with-hyphens (and parens) [brackets]",
    "",
    "   spaces\t\tand\nnewlines   ",
    "zzz unknownword123 qqq",        # UNK paths
    "a" * 150,                       # max_chars_per_word overflow -> UNK
    "123 (1) [2]",
]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    native.build_native(require=True)
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return path


@pytest.fixture(scope="module")
def pair(vocab_path):
    py = WordPieceTokenizer.from_vocab_file(vocab_path)
    cc = NativeWordPieceTokenizer(vocab_path)
    assert cc.vocab_size == len(VOCAB)
    return py, cc


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_parity_case(pair, vocab_path, idx):
    py, cc = pair
    text = CASES[idx]
    got = cc.encode_batch([text], max_len=64)
    _same(got, py.encode_batch([text], max_len=64))
    _same(got, JaxTokenizer.from_vocab_file(vocab_path).encode_batch([text], max_len=64))


def test_separator_whitespace_parity(pair):
    """Zl/Zp (U+2028/U+2029) and other separators split words natively
    as str.split() does in Python."""
    py, cc = pair
    for sep in ("\u2028", "\u2029", "\u2003", "\u3000"):
        text = f"hello{sep}world"
        _same(cc.encode_batch([text], max_len=64), py.encode_batch([text], max_len=64))


def test_batch_parity_and_padding(pair, vocab_path):
    py, cc = pair
    got = cc.encode_batch(CASES, max_len=32, pad_to=48)
    assert got[0].shape == (len(CASES), 48) and got[0].dtype == np.int32
    _same(got, py.encode_batch(CASES, max_len=32, pad_to=48))
    _same(got, JaxTokenizer.from_vocab_file(vocab_path).encode_batch(CASES, max_len=32,
                                                                      pad_to=48))
    empty = cc.encode_batch([], max_len=8)
    assert empty[0].shape == (0, 8)


def test_truncation_keeps_sep(pair):
    py, cc = pair
    long_text = "the quick brown fox " * 50
    ids, mask = cc.encode_batch([long_text], max_len=16)
    assert mask[0].sum() == 16
    assert ids[0, 15] == VOCAB.index("</s>")
    _same((ids, mask), py.encode_batch([long_text], max_len=16))


def _parity_sweep(texts, tmp_path, max_len=24):
    """A vocab holding every Python-folded word, so any fold divergence
    of the native tokenizer shows as a different id."""
    py_probe = WordPieceTokenizer.toy()
    words = set()
    for t in texts:
        words.update(py_probe.basic_tokenize(t))
    sp = py_probe.specials
    vocab = [sp.pad, sp.cls, sp.sep, sp.unk, sp.mask] + sorted(words)
    path = tmp_path / "sweep_vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    py = WordPieceTokenizer.from_vocab_file(path)
    cc = NativeWordPieceTokenizer(path)
    ids_py, mask_py = py.encode_batch(texts, max_len=max_len)
    ids_cc, mask_cc = cc.encode_batch(texts, max_len=max_len)
    bad = np.nonzero((ids_cc != ids_py).any(axis=1))[0]
    assert bad.size == 0, (
        f"{bad.size} texts tokenize differently; first: {texts[bad[0]]!r} "
        f"py={ids_py[bad[0]].tolist()} cc={ids_cc[bad[0]].tolist()}"
    )
    np.testing.assert_array_equal(mask_cc, mask_py)


def test_fold_parity_latin_sweep(pair, tmp_path):
    """Every code point U+00A0-U+024F through both tokenizers."""
    _parity_sweep([chr(cp) for cp in range(0xA0, 0x250)], tmp_path)


def test_fold_parity_greek_cyrillic_extended(pair, tmp_path):
    cps = (
        list(range(0x370, 0x400))        # Greek incl. accented forms
        + list(range(0x400, 0x460))      # Cyrillic incl. ё/й decompositions
        + list(range(0x1E00, 0x1F00))    # Latin Extended Additional
        + list(range(0x1F00, 0x1F70))    # Greek Extended (polytonic)
    )
    _parity_sweep([chr(cp) for cp in cps], tmp_path)


def test_fold_parity_words(pair, tmp_path):
    """Author-name shapes, Hangul, CJK compatibility ideographs."""
    _parity_sweep(
        [
            "Łukasz Škoda Čech Øre Þór Đorđe Ñandú",
            "Müller-Straße naïve façade œuvre Ævar",
            "ΛΌΓΟΣ λόγος Ψυχή", "Ёлка Йорк",
            "İstanbul ẞtraße ŉdebele",
            "한글 조합 テスト 豈",
            "mixed ΣΊΣΥΦΟΣ and ASCII-text.",
        ],
        tmp_path,
        max_len=64,
    )


def test_fold_parity_random_bmp(pair, tmp_path):
    """A seeded random BMP sweep: whitespace, control and punctuation
    classes and the fold map agree everywhere."""
    rng = np.random.default_rng(1234)
    cps = rng.integers(0xA0, 0xFFFF, 4000)
    texts = ["".join(chr(c) for c in cps[i : i + 4] if not 0xD800 <= c <= 0xDFFF)
             for i in range(0, len(cps), 4)]
    _parity_sweep(texts, tmp_path, max_len=48)


def test_library_builds_under_build_and_not_in_native(pair):
    assert native.is_available()
    lib = native.lib_path()
    assert lib.exists() and lib.parent == REPO / "build" / "native"
    # native/ holds its sources; libarag_native.so, if present, is the
    # reference's own `make -C native` output
    present = {p.name for p in (REPO / "native").iterdir()} - {"libarag_native.so"}
    assert present <= {"Makefile", "bm25.cpp", "gen_unicode_tables.py",
                       "unicode_tables.inc", "wordpiece.cpp"}


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """require=True raises with g++'s output; otherwise the caller is told
    the library is unavailable (and the Python path serves)."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES + native.HEADERS:
        (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(native, "NATIVE_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*expected unqualified-id"):
        native.build_native(require=True)
    assert native.build_native() is False
    assert native.load() is None and not native.is_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        NativeWordPieceTokenizer(src / "vocab.txt")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_embedder_native_path_matches_python(pair):
    """Embedder with the native tokenizer == Embedder with the Python one
    (bucketed batches and the serving window's device handoff)."""
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model

    py, cc = pair
    cfg = ModelConfig(vocab_size=len(VOCAB) + 8, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=96, pad_token_id=py.pad_id)
    model = random_model(cfg, seed=3, param_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu")
    kw = dict(buckets=(16, 32), batch_size=4)
    e_py = Embedder(model, py, **kw)
    e_cc = Embedder(model, py, native_tokenizer=cc, **kw)
    texts = [c for c in CASES if c.strip()]
    np.testing.assert_array_equal(e_cc.encode_texts(texts), e_py.encode_texts(texts))
    assert e_cc.stats.tokens == e_py.stats.tokens
    got, n = e_cc.encode_window_device(texts[:4])
    want, _ = e_py.encode_window_device(texts[:4])
    assert n == 4
    assert torch.equal(got, want)
