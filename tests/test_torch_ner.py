"""The port's neural NER (viquae_torch/models/ner.py) against the JAX
package's (viquae_tpu/models/ner.py) on the same weights and texts: the
cases of tests/test_ner.py at tiny widths (2 layers, width 32, 5 BIO
labels), JAX on the CPU.

Weights: a JAX ``ner.init`` tree with N(0, 0.3) added to every leaf (a
spread that moves the label margins away from 0) goes to both packages.
Tolerances: f32 logits within 2e-5 of the output scale and labels, hence
spans, equal everywhere; bf16 logits within rtol = atol = 2e-2 and labels
equal wherever the JAX logits' top-2 margin exceeds 2 x 2e-2 times the
logit scale (two bf16 roundings apart), spans equal for every text none
of whose tokens falls under that margin.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import flat_leaves, perturbed
from viquae_torch.data import kilt2vqa as tkilt2vqa
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import ner as tner
from viquae_tpu.data import kilt2vqa as jkilt2vqa
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import ner as jner

torch.set_num_threads(2)

BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=2, add_pooler=False)
LABELS = ("O", "B-PER", "I-PER", "B-LOC", "I-LOC")
JCFG = jner.NERConfig(bert=jbert.BertConfig(**BERT), num_labels=5,
                      id2label=LABELS)
TCFG = tner.NERConfig(bert=tbert.BertConfig(**BERT), num_labels=5,
                      id2label=LABELS)
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who", "wrote", "the",
     "opera", "carmen", "in", "paris", "george", "bi", "##zet", "?", "was",
     "a", "of", "painting"]
    + [f"w{i}" for i in range(40)]
)
TEXTS = [
    "who wrote the opera carmen ?",
    "bizet was a painting of paris",
    "paris carmen george",
    "who was who",
    "george bizet wrote carmen in paris w1 w2 w3",
]
RTOL = 2e-5
BF16_TOL = 2e-2


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def tree():
    return perturbed(jax.tree.map(np.asarray,
                                  jner.init(jax.random.key(0), JCFG)),
                     scale=0.3)


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("ner_tok")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                             do_lower_case=True)


def test_logits_match_jax(tree):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 7:] = 0
    ref = jner.apply(tree, JCFG, jnp.asarray(ids), jnp.asarray(mask))
    got = tner.apply(tner.from_jax(tree, TCFG, device="cpu"), TCFG,
                     torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 10, 5)
    close(got, ref)


def test_dropout_runs_from_explicit_seeds(tree):
    """deterministic=False draws its masks from the CPU generator: the
    same seed gives the same logits, another seed others."""
    model = tner.from_jax(tree, TCFG, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 8)))

    def run(seed):
        return tner.apply(model, TCFG, ids, deterministic=False,
                          generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    assert not torch.equal(run(0), tner.apply(model, TCFG, ids))


@pytest.fixture(scope="module")
def hf_model():
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForTokenClassification

    torch.manual_seed(3)
    id2label = dict(enumerate(LABELS))
    hf_cfg = HFBertConfig(
        **{k: v for k, v in BERT.items() if k != "add_pooler"},
        num_labels=5, id2label=id2label,
        label2id={v: k for k, v in id2label.items()})
    return hf_cfg, BertForTokenClassification(hf_cfg).eval()


@pytest.mark.parametrize("keys", ["int", "str"])
def test_config_and_params_from_hf_match_jax(hf_model, keys):
    """config_from_hf with int id2label keys (in process) and str keys (a
    config.json read as a dict); params_from_hf leaf for leaf."""
    hf_cfg, model = hf_model
    src = hf_cfg
    if keys == "str":
        src = types.SimpleNamespace(**{
            **hf_cfg.to_dict(),
            "id2label": {str(k): v for k, v in hf_cfg.id2label.items()},
            "num_labels": 5})
    jcfg, tcfg = jner.config_from_hf(src), tner.config_from_hf(src)
    assert tcfg.id2label == jcfg.id2label == LABELS
    assert tcfg.num_labels == jcfg.num_labels == 5
    for name in BERT:
        assert getattr(tcfg.bert, name) == getattr(jcfg.bert, name), name
    sd = model.state_dict()
    ref = jner.params_from_hf(sd, jcfg)
    got = tner.params_from_hf(sd, tcfg, device="cpu")
    got, want = (flat_leaves(convert.tree_from_module(got)),
                 flat_leaves(jax.tree.map(np.asarray, ref)))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_save_pretrained_hf_round_trips(tree, tmp_path):
    """The port's BertForTokenClassification directory loads back through
    the HF config and raw state dict, as `kilt2vqa ner` reads it."""
    from transformers import AutoConfig

    model = tner.from_jax(tree, TCFG, device="cpu")
    tner.save_pretrained_hf(model, TCFG, tmp_path / "ner")
    cfg = tner.config_from_hf(AutoConfig.from_pretrained(tmp_path / "ner"))
    assert cfg == TCFG
    back = tner.params_from_hf(tbert.load_hf_state_dict(tmp_path / "ner"),
                               cfg, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name


def _port_and_jax(tree, tok, dtype, batch_size):
    jdt, tdt = ((np.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ours = tner.NeuralNER(tner.from_jax(tree, TCFG, device="cpu"), TCFG, tok,
                          max_length=16, batch_size=batch_size,
                          compute_dtype=tdt, device="cpu")
    ref = jner.NeuralNER(jax.tree.map(jnp.asarray, tree), JCFG, tok,
                         max_length=16, batch_size=batch_size,
                         compute_dtype=jdt)
    return ours, ref


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_predict_batch_spans_equal_jax(tree, tok, dtype):
    """5 texts at batch 2: the last batch is padded with an empty row."""
    ours, ref = _port_and_jax(tree, tok, dtype, batch_size=2)
    got, want = ours.predict_batch(TEXTS), ref.predict_batch(TEXTS)
    assert len(got) == len(want) == len(TEXTS)
    if dtype == "f32":
        assert got == want
        assert any(got)
        return
    enc = tok(TEXTS, padding="max_length", truncation=True, max_length=16,
              return_tensors="np")
    ids, mask = enc["input_ids"], enc["attention_mask"]
    ref_logits = np.asarray(jner.apply(
        jax.tree.map(jnp.asarray, tree), JCFG, jnp.asarray(ids),
        jnp.asarray(mask), compute_dtype=jnp.bfloat16))
    got_logits = tner.apply(ours._params, TCFG, torch.from_numpy(ids),
                            torch.from_numpy(mask),
                            compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got_logits, ref_logits, rtol=BF16_TOL,
                               atol=BF16_TOL)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]
             > 2 * BF16_TOL * np.abs(ref_logits).max())
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_logits.argmax(-1)[clear],
                                  ref_logits.argmax(-1)[clear])
    real = mask.astype(bool)
    decided = (clear | ~real).all(axis=1)
    assert decided.any()
    for i in np.flatnonzero(decided):
        assert got[i] == want[i], TEXTS[i]


def test_padding_rows_do_not_change_real_labels(tree, tok):
    """The fixed-shape padding of the last batch changes no real row:
    batch 2 (one pad row), batch 8 (three) and one text at a time give the
    same spans, in f32."""
    spans = [tner.NeuralNER(tner.from_jax(tree, TCFG, device="cpu"), TCFG,
                            tok, max_length=16, batch_size=bs,
                            compute_dtype=torch.float32,
                            device="cpu").predict_batch(TEXTS)
             for bs in (2, 8)]
    assert spans[0] == spans[1]
    ours, _ = _port_and_jax(tree, tok, "f32", batch_size=2)
    assert [ours(t) for t in TEXTS] == spans[0]
    assert ours.predict_batch([]) == []


def test_neural_ner_is_kilt2vqa_pluggable(tree, tok):
    """As the ner_fn of kilt2vqa.item2placeholder, the port's NeuralNER
    builds the JAX package's placeholders."""
    ours, ref = _port_and_jax(tree, tok, "f32", batch_size=2)
    for question in TEXTS:
        got = tkilt2vqa.item2placeholder({"input": question}, ner_fn=ours)
        want = jkilt2vqa.item2placeholder({"input": question}, ner_fn=ref)
        assert got == want
        for ph in got["placeholder"]:
            assert "{mention}" in ph["input"]
            ent = ph["entity"]
            assert question[ent["start"]:ent["end"]] == ent["text"]


def test_decode_bio_equals_jax():
    cases = [
        ([0, 0, 0, 1, 0, 3, 0, 0],
         [(0, 0), (0, 3), (4, 9), (10, 16), (17, 19), (20, 25), (26, 27),
          (0, 0)], [None, 0, 1, 2, 3, 4, 5, None],
         "who wrote carmen in paris ?"),
        ([0, 1, 0, 0, 0], [(0, 0), (0, 2), (2, 5), (6, 11), (0, 0)],
         [None, 0, 0, 1, None], "bizet wrote"),
        ([2, 1, 1, 4], [(0, 1), (2, 3), (4, 5), (6, 7)], [0, 1, 2, 3],
         "a b c d"),
    ]
    for labels, offsets, word_ids, text in cases:
        assert tner.decode_bio(labels, offsets, word_ids, LABELS, text) == \
            jner.decode_bio(labels, offsets, word_ids, LABELS, text)


def test_jax_tree_round_trips_through_the_port():
    tree = jax.tree.map(np.asarray, jner.init(jax.random.key(3), JCFG))
    module = tner.from_jax(tree, TCFG, device="cpu")
    back, want = flat_leaves(convert.tree_from_module(module)), \
        flat_leaves(tree)
    assert back.keys() == want.keys()
    for path in want:
        assert np.array_equal(back[path], want[path]), path
