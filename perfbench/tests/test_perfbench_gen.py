"""The traffic generator: the same seed gives the same inputs, and every
seed the same work in another order."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import entries, gen, weights

Q = {"kind": "lognormal", "median": 18, "sigma": 0.35, "lo": 8, "hi": 64}
P = {"kind": "normal", "mean": 125, "sd": 8, "lo": 100, "hi": 160}
BIG_SEED = 2**32 + 12345


def lengths(texts):
    return sorted(gen.token_count(t) for t in texts)


def test_questions_repeat_by_seed_and_keep_their_sizes():
    a = gen.questions(entries.rng_of(BIG_SEED, "questions"), 500, Q)
    b = gen.questions(entries.rng_of(BIG_SEED, "questions"), 500, Q)
    c = gen.questions(entries.rng_of(7, "questions"), 500, Q)
    assert a == b and a != c
    assert lengths(a) == lengths(c)
    assert 8 <= min(lengths(a)) and max(lengths(a)) <= 64
    assert abs(np.median(lengths(a)) - 18) <= 1


def test_passages_are_a_function_of_seed_and_id():
    kb = gen.LazyPassages(1000, 99, P)
    again = gen.LazyPassages(1000, 99, P)
    other = gen.LazyPassages(1000, 98, P)
    assert np.array_equal(kb[17]["passage_tokens"],
                          again[17]["passage_tokens"])
    assert not np.array_equal(kb[17]["passage_tokens"],
                              other[17]["passage_tokens"])
    sizes = [len(kb.tokens(i)) for i in range(1000)]
    assert 100 <= min(sizes) and max(sizes) <= 160
    assert abs(np.mean(sizes) - 125) < 1.5
    ids = np.concatenate([kb.tokens(i) for i in range(50)])
    assert ids.min() >= gen.WORD_LO and ids.max() < gen.WORD_HI


def test_arrivals_keep_rate_and_gaps_across_seeds():
    a = gen.poisson_arrivals(entries.rng_of(1, "arrivals"), 500.0, 4.0)
    b = gen.poisson_arrivals(entries.rng_of(2, "arrivals"), 500.0, 4.0)
    assert len(a) == len(b) == 2000
    assert a[0] == 0.0 and (np.diff(a) > 0).all() and a[-1] < 4.0
    assert np.allclose(np.sort(np.diff(np.append(a, 4.0))),
                       np.sort(np.diff(np.append(b, 4.0))))


def test_weights_repeat_by_seed():
    shapes = weights.bert_shapes(dict(
        vocab_size=64, hidden_size=8, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=16,
        max_position_embeddings=16, type_vocab_size=2))
    a = weights.draw(shapes, BIG_SEED, "cpu", torch.bfloat16)
    b = weights.draw(shapes, BIG_SEED, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["layers.0.attention.q.weight"].shape == (8, 8)
    assert float(a["layers.0.output_ln.weight"].float().mean()) > 0.9


def test_tokenizer_is_wordpiece_over_the_made_up_vocabulary():
    tok = gen.tokenizer()
    assert tok("w1000 w9999")["input_ids"] == [101, 1000, 9999, 102]
