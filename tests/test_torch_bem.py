"""The port's BEM scorer (viquae_torch/models/bem.py) and the Encyclopedic-
VQA protocol (viquae_torch/data/evqa.py) against the JAX package's on the
same weights and inputs: the cases of tests/test_builders.py (:286-345,
:457) and tests/test_port_adversarial.py (:387) at tiny widths (2 layers,
width 16, 3 token types), JAX on the CPU.

Weights: a JAX ``bem.init`` tree with N(0, 0.3) added to every leaf goes
to both packages (so that the probabilities spread away from 0.5).
Tolerances: logits in f32 within 2e-5 of the output scale,
probabilities within 1e-5; a thresholded score may differ only where the
probability lies within 1e-5 of 0.5 (none does here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import flat_leaves, perturbed
from viquae_torch.data import evqa as tevqa
from viquae_torch.models import bem as tbem
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_tpu.data import evqa as jevqa
from viquae_tpu.models import bem as jbem
from viquae_tpu.models import bert as jbert

torch.set_num_threads(2)

VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + [f"w{i}" for i in range(50)])
BERT = dict(vocab_size=len(VOCAB) + 10, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=64, type_vocab_size=3, add_pooler=True)
JCFG = jbem.BEMConfig(bert=jbert.BertConfig(**BERT), max_length=64)
TCFG = tbem.BEMConfig(bert=tbert.BertConfig(**BERT), max_length=64)
RTOL = 2e-5


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def tree():
    return perturbed(jax.tree.map(np.asarray,
                                  jbem.init(jax.random.key(0), JCFG)),
                     scale=0.3)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("bem_tok")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                             do_lower_case=True)


@pytest.mark.parametrize("max_length", [16, 9, 7],
                         ids=["padded", "loses_last_sep", "cut_in_question"])
def test_combine_segments_equals_jax(max_length):
    """Truncation after concatenation: a long input loses its final
    [SEP], as tf.text.combine_segments does."""
    args = ([10, 11], [20], [30, 31, 32])
    got = tbem.combine_segments(*args, cls_id=2, sep_id=3,
                                max_length=max_length)
    ref = jbem.combine_segments(*args, cls_id=2, sep_id=3,
                                max_length=max_length)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
    if max_length == 16:
        assert list(got["input_ids"][:10]) == [2, 10, 11, 3, 20, 3, 30, 31,
                                               32, 3]
        assert list(got["segment_ids"][:10]) == [0, 0, 0, 0, 1, 1, 2, 2, 2,
                                                 2]
    else:
        assert got["input_ids"][-1] != 3


def test_apply_logits_match_jax(tree):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, BERT["vocab_size"], (3, 12)).astype(np.int32)
    segs = np.array([[0] * 4 + [1] * 4 + [2] * 4] * 3, np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 9:] = 0
    ref = jbem.apply(tree, JCFG, *map(jnp.asarray, (ids, segs, mask)))
    model = tbem.from_jax(tree, TCFG, device="cpu")
    got = tbem.apply(model, TCFG, *map(torch.from_numpy, (ids, segs, mask)))
    assert got.shape == (3, 2)
    close(got, ref)


def _hf_state_dict(seed=0):
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForSequenceClassification

    torch.manual_seed(seed)
    hf_cfg = HFBertConfig(**{k: v for k, v in BERT.items()
                             if k != "add_pooler"}, num_labels=2)
    sd = BertForSequenceClassification(hf_cfg).eval().state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            if v.is_floating_point() else v for k, v in sd.items()}


def test_params_from_state_dict_matches_jax():
    """A BertForSequenceClassification layout with 3 token types: every
    leaf equals the JAX port's, and so do the logits."""
    sd = _hf_state_dict()
    ref_tree = jbem.params_from_state_dict(sd, JCFG)
    model = tbem.params_from_state_dict(sd, TCFG, device="cpu")
    got, want = (flat_leaves(convert.tree_from_module(model)),
                 flat_leaves(jax.tree.map(np.asarray, ref_tree)))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    rng = np.random.default_rng(7)
    ids = rng.integers(5, 20, (1, 12)).astype(np.int32)
    segs = np.array([[0] * 4 + [1] * 4 + [2] * 4], np.int32)
    mask = np.ones((1, 12), np.int32)
    close(tbem.apply(model, TCFG, *map(torch.from_numpy, (ids, segs, mask))),
          jbem.apply(ref_tree, JCFG, *map(jnp.asarray, (ids, segs, mask))))


def _examples():
    long = " ".join(f"w{i % 50}" for i in range(80))  # truncated at 64
    return [
        {"question": "w1 w2 w3", "reference": "w4 w5", "candidate": "w6"},
        {"question": "w7", "reference": "w8 w9 w10", "candidate": "w8 w9"},
        {"question": long, "reference": "w11", "candidate": "w12 w13"},
        {"question": "w14 w15", "reference": long, "candidate": long},
    ]


def test_scorer_score_and_call_equal_jax(tree, tokenizer):
    ours = tbem.BEMScorer(cfg=TCFG, params=tbem.from_jax(tree, TCFG,
                                                         device="cpu"),
                          tokenizer=tokenizer, max_length=64, device="cpu")
    ref = jbem.BEMScorer(cfg=JCFG, params=jax.tree.map(jnp.asarray, tree),
                         tokenizer=tokenizer, max_length=64)
    examples = _examples()
    got, want = ours.score(examples), ref.score(examples)
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want - 0.5).min() > 1e-5
    for ex, p in zip(examples, want):
        assert ours(ex) == ref(ex) == float(p >= 0.5)
        np.testing.assert_allclose(ours(ex, threshold_score=False), p,
                                   atol=1e-5)
    # one example at a time scores as in a batch
    np.testing.assert_allclose(ours.score(examples[:1]), got[:1], atol=1e-6)


def test_evqa_protocol_with_bem_equals_jax(tree, tokenizer):
    """Exact Match first, BEM for the misses, '|' alternatives take the
    maximum, '&&' multi-answer references are comma-joined for BEM: the
    port's protocol and scorer give the JAX package's score on each."""
    ours = tevqa.initialize_bem_scoring_function(scorer=tbem.BEMScorer(
        cfg=TCFG, params=tbem.from_jax(tree, TCFG, device="cpu"),
        tokenizer=tokenizer, max_length=64, device="cpu"))
    ref = jevqa.initialize_bem_scoring_function(scorer=jbem.BEMScorer(
        cfg=JCFG, params=jax.tree.map(jnp.asarray, tree),
        tokenizer=tokenizer, max_length=64))
    cases = [
        {"question": "q", "reference": "two", "candidate": "2",
         "question_type": "single_answer"},
        {"question": "w1 w2", "reference": "w3 w4", "candidate": "w5",
         "question_type": "single_answer"},
        {"question": "w1", "reference": "w6|w7 w8", "candidate": "w9"},
        {"question": "w2", "reference": "w10&&w11", "candidate": "w12",
         "question_type": "multi_answer"},
    ]
    for ex in cases:
        assert (tevqa.encyclopedic_vqa_evaluation_function(ex, ours)
                == jevqa.encyclopedic_vqa_evaluation_function(ex, ref)), ex
        if "|" not in ex["reference"]:
            np.testing.assert_allclose(ours(ex, threshold_score=False),
                                       ref(ex, threshold_score=False),
                                       atol=1e-5)
    assert tevqa.encyclopedic_vqa_evaluation_function(cases[0], ours) == 1.0


def test_bem_scoring_function_rejects_non_callable():
    for module in (tevqa, jevqa):
        with pytest.raises(TypeError, match="callable"):
            module.initialize_bem_scoring_function("https://tfhub.dev/bem")
        with pytest.raises(ValueError, match="BEMScorer"):
            module.initialize_bem_scoring_function()


def test_scorer_needs_a_tokenizer():
    with pytest.raises(ValueError, match="tokenizer"):
        tbem.BEMScorer(cfg=TCFG, device="cpu")


def test_jax_tree_round_trips_through_the_port():
    tree = jax.tree.map(np.asarray, jbem.init(jax.random.key(3), JCFG))
    module = tbem.from_jax(tree, TCFG, device="cpu")
    back, want = flat_leaves(convert.tree_from_module(module)), \
        flat_leaves(tree)
    assert back.keys() == want.keys()
    for path in want:
        assert np.array_equal(back[path], want[path]), path


def test_seeded_scorer_runs_the_protocol(tokenizer):
    """Without params the scorer draws seeded weights (not JAX's values):
    probabilities in [0, 1], thresholded scores in {0, 1}."""
    scorer = tbem.BEMScorer(cfg=TCFG, tokenizer=tokenizer, max_length=64,
                            device="cpu")
    fn = tevqa.initialize_bem_scoring_function(scorer=scorer)
    ex = {"question": "w1", "reference": "w2 w3", "candidate": "w4"}
    assert 0.0 <= fn(ex, threshold_score=False) <= 1.0
    assert fn(ex) in (0.0, 1.0)
