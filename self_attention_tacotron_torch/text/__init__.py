from .symbols import symbols, text_to_sequence, sequence_to_text
from .cleaners import basic_cleaners, transliteration_cleaners, english_cleaners

__all__ = [
    "symbols",
    "text_to_sequence",
    "sequence_to_text",
    "basic_cleaners",
    "transliteration_cleaners",
    "english_cleaners",
]
