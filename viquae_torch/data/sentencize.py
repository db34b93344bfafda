"""Rule-based sentence segmentation + word tokenization.

The reference uses spaCy's `English` + "sentencizer" pipe for
sentence-preserving passage splitting (meerqat/data/loading.py:309-370,
:414-417). spaCy is not a dependency of this framework, so this module
implements the same contract: split text into sentences on terminal
punctuation, and count tokens roughly the way spaCy's tokenizer does
(punctuation split from words). Exact spaCy parity is a non-goal; passage
boundaries may differ on pathological punctuation, which only shifts
100-word chunk edges.
"""
from __future__ import annotations

import re
from typing import List

# spaCy-like terminal punctuation: . ! ? … plus closing quotes/brackets after
_SENT_END = re.compile(
    r"""
    (?<=[.!?…])        # a sentence-terminal char
    ["')\]”’]*    # optional closing quotes/brackets
    \s+                     # the whitespace we split on
    (?=[^\s])               # something follows
    """,
    re.VERBOSE,
)

# common abbreviations that should not end a sentence
_ABBREV = re.compile(
    r"(?:\b(?:Mr|Mrs|Ms|Dr|Prof|Sr|Jr|St|Mt|vs|etc|e\.g|i\.e|cf|al|Inc|Ltd|Co|No"
    r"|Jan|Feb|Mar|Apr|Jun|Jul|Aug|Sep|Sept|Oct|Nov|Dec|[A-Z])\.)$"
)

_TOKEN = re.compile(r"\w+|[^\w\s]")


def tokenize(text: str) -> List[str]:
    """Word-level tokens (words + punctuation marks), spaCy-count-like."""
    return _TOKEN.findall(text)


def count_tokens(text: str) -> int:
    return len(tokenize(text))


def sentences(text: str) -> List[str]:
    """Split text into sentences."""
    if not text.strip():
        return []
    pieces = _SENT_END.split(text)
    # re-merge splits that follow an abbreviation (false boundaries)
    merged: List[str] = []
    for piece in pieces:
        if merged and _ABBREV.search(merged[-1].rstrip()):
            merged[-1] = merged[-1].rstrip() + " " + piece
        else:
            merged.append(piece)
    return [s.strip() for s in merged if s.strip()]
