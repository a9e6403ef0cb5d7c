"""Font encoding tables for simple-font glyph decoding.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/encodings.py``.

Compact, programmatically-derived equivalents of the Adobe encoding
vectors (StandardEncoding, WinAnsiEncoding, MacRomanEncoding, Symbol)
plus a working subset of the Adobe Glyph List for /Differences names.
These cover the glyph names that actually occur in arXiv PDFs produced
by pdfTeX/dvips/ghostscript; anything unknown degrades to ''.
"""

from __future__ import annotations


def _from_codec(codec: str) -> dict[int, str]:
    out: dict[int, str] = {}
    for b in range(32, 256):
        try:
            ch = bytes([b]).decode(codec)
            if ch.isprintable() or ch == " ":
                out[b] = ch
        except UnicodeDecodeError:
            pass
    return out


WINANSI_ENCODING = _from_codec("cp1252")
MACROMAN_ENCODING = _from_codec("mac_roman")

# Adobe StandardEncoding: ASCII 32..126 plus the high-region specials
STANDARD_ENCODING: dict[int, str] = {b: chr(b) for b in range(32, 127)}
STANDARD_ENCODING.update(
    {
        0x27: "’",  # quoteright
        0x60: "‘",  # quoteleft
        0xA1: "¡", 0xA2: "¢", 0xA3: "£", 0xA4: "⁄",
        0xA5: "¥", 0xA6: "ƒ", 0xA7: "§", 0xA8: "¤",
        0xA9: "'", 0xAA: "“", 0xAB: "«", 0xAC: "‹",
        0xAD: "›", 0xAE: "ﬁ", 0xAF: "ﬂ",
        0xB1: "–", 0xB2: "†", 0xB3: "‡", 0xB4: "·",
        0xB6: "¶", 0xB7: "•", 0xB8: "‚", 0xB9: "„",
        0xBA: "”", 0xBB: "»", 0xBC: "…", 0xBD: "‰",
        0xBF: "¿",
        0xC1: "`", 0xC2: "´", 0xC3: "ˆ", 0xC4: "˜",
        0xC5: "¯", 0xC6: "˘", 0xC7: "˙", 0xC8: "¨",
        0xCA: "˚", 0xCB: "¸", 0xCD: "˝", 0xCE: "˛",
        0xCF: "ˇ",
        0xD0: "—",
        0xE1: "Æ", 0xE3: "ª", 0xE8: "Ł", 0xE9: "Ø",
        0xEA: "Œ", 0xEB: "º",
        0xF1: "æ", 0xF5: "ı", 0xF8: "ł", 0xF9: "ø",
        0xFA: "œ", 0xFB: "ß",
    }
)

_GREEK_LOWER = {
    "alpha": "α", "beta": "β", "gamma": "γ", "delta": "δ", "epsilon": "ε",
    "zeta": "ζ", "eta": "η", "theta": "θ", "iota": "ι", "kappa": "κ",
    "lambda": "λ", "mu": "μ", "nu": "ν", "xi": "ξ", "omicron": "ο",
    "pi": "π", "rho": "ρ", "sigma": "σ", "tau": "τ", "upsilon": "υ",
    "phi": "φ", "chi": "χ", "psi": "ψ", "omega": "ω",
}
_GREEK_UPPER = {
    "Alpha": "Α", "Beta": "Β", "Gamma": "Γ", "Delta": "Δ", "Epsilon": "Ε",
    "Zeta": "Ζ", "Eta": "Η", "Theta": "Θ", "Iota": "Ι", "Kappa": "Κ",
    "Lambda": "Λ", "Mu": "Μ", "Nu": "Ν", "Xi": "Ξ", "Omicron": "Ο",
    "Pi": "Π", "Rho": "Ρ", "Sigma": "Σ", "Tau": "Τ", "Upsilon": "Υ",
    "Phi": "Φ", "Chi": "Χ", "Psi": "Ψ", "Omega": "Ω",
}

# Symbol font: code points follow Latin letter positions for Greek
SYMBOL_MAP: dict[int, str] = {0x20: " "}
_symbol_letters = {
    0x61: "α", 0x62: "β", 0x63: "χ", 0x64: "δ", 0x65: "ε", 0x66: "φ",
    0x67: "γ", 0x68: "η", 0x69: "ι", 0x6A: "ϕ", 0x6B: "κ", 0x6C: "λ",
    0x6D: "μ", 0x6E: "ν", 0x6F: "ο", 0x70: "π", 0x71: "θ", 0x72: "ρ",
    0x73: "σ", 0x74: "τ", 0x75: "υ", 0x76: "ϖ", 0x77: "ω", 0x78: "ξ",
    0x79: "ψ", 0x7A: "ζ",
    0x41: "Α", 0x42: "Β", 0x43: "Χ", 0x44: "Δ", 0x45: "Ε", 0x46: "Φ",
    0x47: "Γ", 0x48: "Η", 0x49: "Ι", 0x4A: "ϑ", 0x4B: "Κ", 0x4C: "Λ",
    0x4D: "Μ", 0x4E: "Ν", 0x4F: "Ο", 0x50: "Π", 0x51: "Θ", 0x52: "Ρ",
    0x53: "Σ", 0x54: "Τ", 0x55: "Υ", 0x56: "ς", 0x57: "Ω", 0x58: "Ξ",
    0x59: "Ψ", 0x5A: "Ζ",
}
SYMBOL_MAP.update(_symbol_letters)
SYMBOL_MAP.update({b: chr(b) for b in range(0x30, 0x3A)})  # digits
SYMBOL_MAP.update(
    {
        0x2B: "+", 0x3D: "=", 0x2D: "−", 0x2F: "/", 0x28: "(", 0x29: ")",
        0x5B: "[", 0x5D: "]", 0x7B: "{", 0x7D: "}", 0x2C: ",", 0x2E: ".",
        0xA5: "∞", 0xB1: "±", 0xB4: "×", 0xB8: "÷", 0xB9: "≠", 0xBA: "≡",
        0xBB: "≈", 0xC5: "⊕", 0xC6: "∅", 0xC7: "∩", 0xC8: "∪", 0xCE: "∈",
        0xCF: "∉", 0xD1: "∇", 0xD5: "∏", 0xD6: "√", 0xD7: "⋅", 0xD9: "∧",
        0xDA: "∨", 0xE5: "∑", 0xF2: "∫", 0xA3: "≤", 0xB3: "≥", 0xAE: "→",
        0xAC: "←", 0xAD: "↑", 0xAF: "↓", 0xDB: "⇔", 0xDE: "⇒", 0x22: "∀",
        0x24: "∃", 0x27: "∋", 0x40: "≅", 0x5E: "⊥", 0x7E: "∼", 0xB6: "∂",
    }
)

# Adobe Glyph List subset (+TeX-ish names) for /Differences decoding
GLYPH_LIST: dict[str, str] = {}
for _ch in range(ord("A"), ord("Z") + 1):
    GLYPH_LIST[chr(_ch)] = chr(_ch)
for _ch in range(ord("a"), ord("z") + 1):
    GLYPH_LIST[chr(_ch)] = chr(_ch)
for _i, _name in enumerate(
    "zero one two three four five six seven eight nine".split()
):
    GLYPH_LIST[_name] = str(_i)
GLYPH_LIST.update(
    {
        "space": " ", "exclam": "!", "quotedbl": '"', "numbersign": "#",
        "dollar": "$", "percent": "%", "ampersand": "&", "quotesingle": "'",
        "parenleft": "(", "parenright": ")", "asterisk": "*", "plus": "+",
        "comma": ",", "hyphen": "-", "period": ".", "slash": "/",
        "colon": ":", "semicolon": ";", "less": "<", "equal": "=",
        "greater": ">", "question": "?", "at": "@", "bracketleft": "[",
        "backslash": "\\", "bracketright": "]", "asciicircum": "^",
        "underscore": "_", "grave": "`", "braceleft": "{", "bar": "|",
        "braceright": "}", "asciitilde": "~",
        "quoteleft": "‘", "quoteright": "’",
        "quotedblleft": "“", "quotedblright": "”",
        "quotesinglbase": "‚", "quotedblbase": "„",
        "endash": "–", "emdash": "—", "ellipsis": "…",
        "bullet": "•", "dagger": "†", "daggerdbl": "‡",
        "minus": "−", "periodcentered": "·",
        "fi": "ﬁ", "fl": "ﬂ", "ff": "ﬀ",
        "ffi": "ﬃ", "ffl": "ﬄ",
        "germandbls": "ß", "ae": "æ", "AE": "Æ", "oe": "œ", "OE": "Œ",
        "oslash": "ø", "Oslash": "Ø", "aring": "å", "Aring": "Å",
        "ccedilla": "ç", "Ccedilla": "Ç", "ntilde": "ñ", "Ntilde": "Ñ",
        "eacute": "é", "egrave": "è", "ecircumflex": "ê", "edieresis": "ë",
        "aacute": "á", "agrave": "à", "acircumflex": "â", "adieresis": "ä",
        "atilde": "ã", "iacute": "í", "igrave": "ì", "icircumflex": "î",
        "idieresis": "ï", "oacute": "ó", "ograve": "ò", "ocircumflex": "ô",
        "odieresis": "ö", "otilde": "õ", "uacute": "ú", "ugrave": "ù",
        "ucircumflex": "û", "udieresis": "ü", "yacute": "ý",
        "dotlessi": "ı", "Lslash": "Ł", "lslash": "ł",
        "degree": "°", "plusminus": "±", "multiply": "×", "divide": "÷",
        "infinity": "∞", "partialdiff": "∂", "summation": "∑",
        "product": "∏", "integral": "∫", "radical": "√", "approxequal": "≈",
        "notequal": "≠", "lessequal": "≤", "greaterequal": "≥",
        "element": "∈", "gradient": "∇", "proportional": "∝",
        "arrowright": "→", "arrowleft": "←", "arrowup": "↑",
        "arrowdown": "↓", "arrowboth": "↔", "arrowdblright": "⇒",
        "circlemultiply": "⊗", "circleplus": "⊕", "emptyset": "∅",
        "intersection": "∩", "union": "∪", "propersubset": "⊂",
        "propersuperset": "⊃", "reflexsubset": "⊆", "reflexsuperset": "⊇",
        "logicaland": "∧", "logicalor": "∨", "logicalnot": "¬",
        "perpendicular": "⊥", "similar": "∼", "congruent": "≅",
        "equivalence": "≡", "existential": "∃", "universal": "∀",
        "section": "§", "paragraph": "¶", "copyright": "©",
        "registered": "®", "trademark": "™", "sterling": "£", "yen": "¥",
        "cent": "¢", "florin": "ƒ", "fraction": "⁄", "percent": "%",
        "perthousand": "‰", "exclamdown": "¡", "questiondown": "¿",
        "guillemotleft": "«", "guillemotright": "»",
        "guilsinglleft": "‹", "guilsinglright": "›",
        "circumflex": "ˆ", "tilde": "˜", "macron": "¯", "breve": "˘",
        "dotaccent": "˙", "dieresis": "¨", "ring": "˚", "cedilla": "¸",
        "hungarumlaut": "˝", "ogonek": "˛", "caron": "ˇ", "acute": "´",
    }
)
GLYPH_LIST.update(_GREEK_LOWER)
GLYPH_LIST.update(_GREEK_UPPER)
GLYPH_LIST.update({f"{k}1": v for k, v in _GREEK_LOWER.items()})  # phi1 etc.
