"""IVDetect-style subtoken tokenizer.

A copy of ``tokenise`` from the JAX package's ``deepdfa_tpu/data/
tokenise.py``: split on any non-alphanumeric character, then split camelCase
boundaries (lower→Upper and ACRONYMWord boundaries), drop single-character
tokens, join with spaces.
"""

from __future__ import annotations

import re

__all__ = ["tokenise"]

_NON_ALNUM = re.compile(r"[^a-zA-Z0-9]+")
_CAMEL = re.compile(
    r".+?(?:(?<=[a-z])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])|$)"
)


def tokenise(s: str) -> str:
    words = [w for w in _NON_ALNUM.split(s) if w]
    subtokens = [m.group(0) for w in words for m in _CAMEL.finditer(w)]
    return " ".join(t for t in subtokens if len(t) > 1)
