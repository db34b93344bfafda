"""The general traffic generator: every mix under ``perfbench/traffic/`` is a
file of parameters that these functions read.

Sizes and arrivals come from fixed quantiles of their distributions, and
the run's ``--seed`` only permutes them and draws the token ids, so every
seed gives the same work in another order. Frozen copies, each marked with
its origin in ``chip_smoke.py``: the question lengths of
``lognormal_questions`` (l. 599), the passage lengths of ``passage_lengths``
(l. 3279) and the vocabulary of ``bert_vocab_tokenizer`` (l. 2921).
"""
from __future__ import annotations

import math
import os
import statistics
import tempfile
from pathlib import Path
from typing import List, Sequence

import numpy as np

# tokens "w<j>" of the synthetic text are ids j in [WORD_LO, WORD_HI)
WORD_LO, WORD_HI = 1000, 10_000
VOCAB_SIZE = 30_522
_SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
             103: "[MASK]"}


def quantile_sizes(n: int, dist: dict) -> np.ndarray:
    """``n`` sizes at the quantiles (i + 0.5) / n of ``dist``, rounded and
    clipped to [lo, hi]: the same multiset for every seed.
    ``dist``: {"kind": "lognormal", "median", "sigma"} or {"kind":
    "normal", "mean", "sd"}, with "lo" and "hi"."""
    gauss = statistics.NormalDist()
    z = np.array([gauss.inv_cdf((i + 0.5) / n) for i in range(n)])
    if dist["kind"] == "lognormal":
        x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif dist["kind"] == "normal":
        x = dist["mean"] + dist["sd"] * z
    else:
        raise ValueError(f"unknown size distribution {dist['kind']!r}")
    return np.clip(np.round(x), dist["lo"], dist["hi"]).astype(np.int64)


def words(ids) -> str:
    return " ".join(f"w{int(j)}" for j in ids)


def questions(rng: np.random.Generator, n: int, dist: dict,
              special: int = 2) -> List[str]:
    """``n`` questions whose token counts, ``special`` tokens included,
    are ``quantile_sizes(n, dist)`` in the order of a permutation by
    ``rng``; word ids uniform in [WORD_LO, WORD_HI) (lognormal_questions,
    with quantiles in place of draws)."""
    lengths = rng.permutation(quantile_sizes(n, dist)) - special
    return [words(rng.integers(WORD_LO, WORD_HI, m)) for m in lengths]


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of an open loop at ``rate`` a second:
    the exponential gaps' quantiles, permuted by ``rng`` and scaled to sum
    to ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u))
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])]) / gaps.sum() \
        * seconds


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64's finaliser on uint64 arrays (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class LazyPassages:
    """A KB of ``n`` pre-tokenized passages that holds none of them: item
    ``i`` is ``{key: ids}`` with normal(mean, sd) tokens clipped to [lo,
    hi] and ids in [WORD_LO, WORD_HI), all a hash of (seed, i), computed
    when asked for (SyntheticPassages of chip_smoke, with the lengths of
    ``passage_lengths``)."""

    def __init__(self, n: int, seed: int, dist: dict,
                 key: str = "passage_tokens"):
        self.n, self.dist, self.key = n, dist, key
        self.base = _mix64(np.array([seed & (2**64 - 1)], np.uint64))[0]

    def __len__(self):
        return self.n

    def tokens(self, i: int) -> np.ndarray:
        with np.errstate(over="ignore"):
            h = _mix64(np.uint64(self.base) + np.uint64(i) * np.uint64(
                0x9E3779B97F4A7C15) + np.arange(1, 3, dtype=np.uint64))
            u1, u2 = (h >> np.uint64(11)).astype(np.float64) / 2.0**53
            z = math.sqrt(-2.0 * math.log1p(-u1)) * math.cos(2 * math.pi * u2)
            d = self.dist
            m = int(min(max(round(d["mean"] + d["sd"] * z), d["lo"]),
                        d["hi"]))
            ids = _mix64(h[0] + np.arange(3, 3 + m, dtype=np.uint64))
        return (WORD_LO + ids % np.uint64(WORD_HI - WORD_LO)).astype(np.int32)

    def __getitem__(self, i: int) -> dict:
        if not 0 <= int(i) < self.n:
            raise IndexError(i)
        return {self.key: self.tokens(int(i))}


def vocab_dir(vocab_size: int = VOCAB_SIZE) -> Path:
    """A directory under TMPDIR holding ``vocab.txt``, whose "w<j>" is id
    j and whose specials are BERT's ids 0 and 100-103; written once, at a
    fixed path, by a rename (bert_vocab_tokenizer)."""
    path = Path(tempfile.gettempdir()) / f"perfbench_vocab_{vocab_size}"
    vocab = path / "vocab.txt"
    if not vocab.exists():
        path.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path, prefix=".vocab-")
        with os.fdopen(fd, "w") as f:
            f.write("\n".join(_SPECIALS.get(i, f"w{i}")
                              for i in range(vocab_size)))
        os.replace(tmp, vocab)
    return path


def tokenizer(vocab_size: int = VOCAB_SIZE):
    """The ``BertTokenizerFast`` over :func:`vocab_dir`'s vocabulary: real
    WordPiece, as users run it."""
    from transformers import BertTokenizerFast

    return BertTokenizerFast(vocab_file=str(vocab_dir(vocab_size) /
                                            "vocab.txt"), do_lower_case=True)


def token_count(text: str, special: int = 2) -> int:
    """The tokens of a synthetic text: one a word, plus ``special``."""
    return len(text.split()) + special


def cycle(pool: Sequence, i: int):
    return pool[i % len(pool)]
