"""WER text normalization, behavior-compatible with the reference normalizer.

The port's copy of ``avsr_tpu/data/norm_text.py``.

Re-implements the classification + rewrite semantics of
the reference's ``src/tokenizer/norm_text.py:121`` (``norm_string``): each
whitespace-separated word containing punctuation/symbols is classified
(contraction, hyphenation, percentage, currency, decimal, domain,
abbreviation, whisper-special-token, ...) and rewritten accordingly; plain
words are stripped of all non-alphanumeric characters. Output is uppercase
with single spaces. WER comparisons against the reference depend on exact
parity here, so the classification patterns are kept identical.
"""

from __future__ import annotations

import re

_STRIP = ".,!?;:'\"-][~+"
_SYMBOLS = set("%$!\"&*+:£|<>/])~[_(-.,';?=@#^\\`{}’")

# Ordered classification rules: first regex (on the stripped lowercase word)
# that matches decides the rewrite type. Order matches the reference's
# if-ladder in is_valid_word (:57-119).
_CLASS_RULES: list[tuple[str, re.Pattern[str], bool]] = [
    # (type, pattern, strip_before_match)
    ("word_end_with_punct", re.compile(r"^\w+[.,!?;:]+$"), False),
    (
        "word_with_contractions",
        re.compile(r"^[A-Za-z]?[a-z]+(?:['’](?:[a-z]{1,2}|m|re|ve|ll|s|t))?$"),
        True,
    ),
    ("word_with_hyphen", re.compile(r"^[a-zA-Z]+(?:-[a-zA-Z]+)+$"), True),
    ("number_and_percentage", re.compile(r"^[0-9]+(?:\.[0-9]+)?%$"), True),
    (
        "number_and_dollar",
        re.compile(r"\d{1,10}[\.,]*(?:,\d{3})*\d*\$$|^\$\d{1,10}[\.,]*(?:,\d{3})*\d*$"),
        True,
    ),
    (
        "pound_and_number",
        re.compile(r"\d{1,10}[\.,]*(?:,\d{3})*\d*£$|^£\d{1,10}[\.,]*(?:,\d{3})*\d*$"),
        True,
    ),
    (
        "special_whisper",
        re.compile(r"^[a-zA-Z]+[.,?!']*<\|\w+\|><\|(translate|transcribe)\|>$"),
        True,
    ),
    ("float_number", re.compile(r"^[0-9]+[\.,]+[0-9]+$"), True),
    ("abbreviation", re.compile(r"[a-z]{1}(\.[a-z]{1})+$"), True),
    ("domain_name", re.compile(r"^[a-zA-Z0-9]+(?:\.[a-zA-Z0-9]+)+$"), True),
]


def classify_word(word: str) -> str:
    w = word.lower()
    for w_type, pattern, strip in _CLASS_RULES:
        target = w.strip(_STRIP) if strip else w
        if pattern.match(target):
            return w_type
    return "unknown"


def _strip_num(word: str) -> str:
    if "," in word:
        word = word.replace(",", "")
    if "." in word:
        word = word.replace(".", " point ")
    return word


def format_word(word: str, w_type: str) -> str:
    w = word.upper()
    if w_type == "special_whisper":
        w = w.split("<")[0].strip(_STRIP)
    else:
        w = w.strip(_STRIP)
        if w_type == "word_with_hyphen":
            w = w.replace("-", " ")
        elif w_type == "number_and_percentage":
            w = _strip_num(w.replace(",", "")).replace("%", " percent")
        elif w_type == "number_and_dollar":
            w = _strip_num(w.replace("$", "")) + " dollar"
        elif w_type == "pound_and_number":
            w = _strip_num(w.replace("£", "")) + " pound"
        elif w_type == "float_number":
            w = _strip_num(w)
        elif w_type == "domain_name":
            w = w.replace(".", " dot ")
        elif w_type == "abbreviation":
            w = w.replace(".", "")
        elif w_type in ("word_end_with_punct", "word_with_contractions"):
            pass
        else:
            w = re.sub(r"[^a-zA-Z0-9' ]", " ", w)
    return re.sub(r"\s+", " ", w).upper()


def norm_string(text: str) -> str:
    """Normalize a transcript for WER scoring (uppercase, rewrites applied)."""
    out = []
    for word in text.strip().split():
        w_type = classify_word(word) if set(word) & _SYMBOLS else "unknown"
        out.append(format_word(word, w_type))
    return " ".join(out)
