"""Character symbol table.

Behavioral parity with the reference's char frontend
(reference: preprocess/text.py:21-42): the id 0 is reserved for silence/padding
and every other symbol maps to ``index_in_table + 1``.
"""

from typing import Callable, List, Tuple

_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'\"()[],-.:;?` %<>"

symbols: List[str] = list(_characters)

_symbol_to_id = {s: i + 1 for i, s in enumerate(symbols)}
_id_to_symbol = {i + 1: s for i, s in enumerate(symbols)}

PAD_ID = 0  # silence


def text_to_sequence(text: str, cleaner: Callable[[str], str]) -> Tuple[List[int], str]:
    """Clean ``text`` and map each symbol to its integer id.

    Unknown symbols are dropped rather than raising, matching the practical
    behavior required for corpus text (the reference raises KeyError; we are
    more forgiving but identical on in-vocabulary text).
    """
    clean_text = cleaner(text)
    sequence = [_symbol_to_id[s] for s in clean_text if s in _symbol_to_id]
    return sequence, clean_text


def sequence_to_text(sequence: List[int]) -> str:
    return "".join(_id_to_symbol.get(i, "") for i in sequence)
