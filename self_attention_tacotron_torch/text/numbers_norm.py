"""Number normalization for English text.

Behavioral parity with the reference's number expansion
(reference: preprocess/numbers.py) without the external ``inflect``
dependency: a native integer-to-words engine covering cardinals and ordinals
up to the decillions, plus the same currency/decimal/comma handling.
"""

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion",
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    word = _TENS[tens]
    return f"{word}-{_UNITS[unit]}" if unit else word


def _three_digits(n: int, andword: str) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_UNITS[hundreds]} hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """Spell out an integer.

    ``group=2`` reads the number in two-digit pairs (used for years, e.g.
    1984 -> "nineteen eighty-four"), mirroring ``inflect``'s group mode as the
    reference uses it (reference: preprocess/numbers.py:73).
    """
    if n < 0:
        return "minus " + number_to_words(-n, andword, zero, group)
    if group == 2:
        digits = str(n)
        if len(digits) % 2:
            digits = "0" + digits
        pairs = [int(digits[i:i + 2]) for i in range(0, len(digits), 2)]
        words = []
        for p in pairs:
            if p == 0:
                words.append("hundred" if words else zero)
            elif p < 10:
                words.append(zero + " " + _UNITS[p])
            else:
                words.append(_two_digits(p))
        return " ".join(words)
    if n == 0:
        return zero
    chunks = []
    scale_idx = 0
    while n > 0:
        n, chunk = divmod(n, 1000)
        if chunk:
            words = _three_digits(chunk, andword if scale_idx == 0 else "")
            if scale_idx:
                words += f" {_SCALES[scale_idx]}"
            chunks.append(words)
        scale_idx += 1
    return ", ".join(reversed(chunks)) if len(chunks) > 1 else chunks[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n, andword="")
    head, sep, last = words.rpartition(" ")
    prefix = head + sep
    if "-" in last:
        tens, _, unit = last.rpartition("-")
        if unit in _ORDINAL_IRREGULAR:
            return prefix + tens + "-" + _ORDINAL_IRREGULAR[unit]
        return prefix + tens + "-" + unit + "th"
    if last in _ORDINAL_IRREGULAR:
        return prefix + _ORDINAL_IRREGULAR[last]
    if last.endswith("y"):
        return prefix + last[:-1] + "ieth"
    if last.endswith("t") and not last.endswith("st"):
        return prefix + last + "h"
    return prefix + last + "th"


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars_match(m: "re.Match") -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number_match(m: "re.Match") -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, andword="", zero="oh", group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars_match, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number_match, text)
    return text
