"""Text cleaning pipelines.

Behavioral parity with the reference (reference: preprocess/cleaners.py):
basic / transliteration / english cleaners with abbreviation + number
expansion.  ASCII transliteration is implemented natively (NFKD decomposition
plus a small Latin supplement table) instead of the external ``unidecode``.
"""

import re
import unicodedata

from .numbers_norm import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

# Characters NFKD alone cannot decompose to ASCII.
_LATIN_SUPPLEMENT = {
    "æ": "ae", "Æ": "AE", "ø": "o", "Ø": "O", "ß": "ss", "þ": "th",
    "Þ": "Th", "ð": "d", "Ð": "D", "œ": "oe", "Œ": "OE", "đ": "d",
    "Đ": "D", "ł": "l", "Ł": "L", "ħ": "h", "Ħ": "H", "ı": "i",
    "“": '"', "”": '"', "‘": "'", "’": "'", "—": "-", "–": "-",
    "…": "...", "«": '"', "»": '"',
}


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    text = "".join(_LATIN_SUPPLEMENT.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
