"""The heads the port builds on its multimodal encoders: the ECA and
Flamant re-rankers (viquae_torch/models/rr.py) and the multi-passage ECA
reader (viquae_torch/models/qa.py ``eca_reader_*``) against the JAX
package's on the same weights and inputs: the cases of
tests/test_mm_qa.py (:260-324) at tiny widths (2 layers, width 24), JAX on
the CPU, with the helpers of tests/test_torch_mm.py.

Weights: the JAX inits' trees with every tanh gate set non-zero (a gate
at its initial 0 hides the visual path) and the heads' kernels and biases
perturbed by N(0, 0.05). Tolerance: f32, outputs within 2e-5 of the
output scale; the loss within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mm import cfgs, close, inputs, jx, np_tree, set_gates, tt
from torch_helpers import flat_leaves, perturbed
from viquae_torch.models import convert
from viquae_torch.models import mm as tmm
from viquae_torch.models import qa as tqa
from viquae_torch.models import rr as trr
from viquae_tpu.models import qa as jqa
from viquae_tpu.models import rr as jrr

torch.set_num_threads(2)

FLAMANT = dict(cls="FlamantConfig", image_dims=(("clip", 10),), gating=True,
               multimodal_attention_every=1, image_num_attention_heads=2,
               image_intermediate_size=48)


def with_head(tree, name, seed):
    """Gates non-zero and the ``name`` head perturbed."""
    tree = set_gates(np_tree(tree))
    tree[name] = perturbed(tree[name], seed=seed)
    return tree


@pytest.mark.parametrize("case", ["default", "gating", "two_images"])
def test_eca_reranker_matches_jax(case):
    kw = {"default": {}, "gating": {"gating": True},
          "two_images": {"n_images": 2, "gating": True}}[case]
    jcfg, tcfg = cfgs(**kw)
    tree = with_head(jrr.eca_reranker_init(jax.random.key(0), jcfg),
                     "classifier", 0)
    text, face, image = inputs(n_images=jcfg.n_images, seed=1)
    text["attention_mask"][1, 4:] = 0
    ref = jrr.eca_reranker_apply(tree, jcfg, jx(text), jx(face), jx(image))
    model = tmm.from_jax(trr.ECAReRanker, tcfg, tree, device="cpu")
    got = trr.eca_reranker_apply(model, tcfg, tt(text), tt(face), tt(image))
    assert got.logits.shape == (3,) and got.moe_aux is None
    close(got.logits, ref.logits)


def test_eca_reranker_reads_the_visual_tokens():
    """With gates set, an unmasked face moves its row's logit and a masked
    one does not."""
    jcfg, tcfg = cfgs(gating=True)
    tree = with_head(jrr.eca_reranker_init(jax.random.key(0), jcfg),
                     "classifier", 0)
    model = tmm.from_jax(trr.ECAReRanker, tcfg, tree, device="cpu")
    text, face, image = inputs()
    base = trr.eca_reranker_apply(model, tcfg, tt(text), tt(face),
                                  tt(image)).logits
    face["face"][0] += 3.0
    face["face"][2] += 3.0
    moved = trr.eca_reranker_apply(model, tcfg, tt(text), tt(face),
                                   tt(image)).logits
    assert abs(float(moved[0] - base[0])) > 1e-5
    assert float(moved[2]) == float(base[2])


@pytest.mark.parametrize("gating", [True, False])
def test_flamant_reranker_matches_jax(gating):
    jcfg, tcfg = cfgs(**{**FLAMANT, "gating": gating})
    tree = with_head(jrr.flamant_reranker_init(jax.random.key(1), jcfg),
                     "classifier", 1)
    text, face, image = inputs(seed=2, image_dims=(("clip", 10),))
    text["attention_mask"][2, 3:] = 0
    ref = jrr.flamant_reranker_apply(tree, jcfg, jx(text), jx(face),
                                     jx(image))
    model = tmm.from_jax(trr.FlamantReRanker, tcfg, tree, device="cpu")
    got = trr.flamant_reranker_apply(model, tcfg, tt(text), tt(face),
                                     tt(image))
    assert got.logits.shape == (3,)
    close(got.logits, ref.logits)


def _reader_batch(n, m, length, answers, seed=0):
    text, face, image = inputs(b=n * m, l=length, seed=seed,
                               image_dims=(("clip", 10),))
    rng = np.random.default_rng(seed)
    face["attention_mask"] = (rng.random((n * m, 1, 2)) < 0.6).astype(
        np.int32)
    text["attention_mask"][:, length - 2:] = 0
    text["attention_mask"][0, 3:] = 0
    start = rng.integers(1, length - 2, (n, m, answers)).astype(np.int32)
    end = np.minimum(start + rng.integers(0, 2, start.shape),
                     length - 3).astype(np.int32)
    answer_mask = np.ones((n, m, answers), np.int32)
    answer_mask[0, :, 1] = 0
    return text, face, image, start, end, answer_mask


@pytest.mark.parametrize("gating", [True, False])
def test_eca_reader_matches_jax(gating):
    """MultiPassageECA: span logits over the text portion only, the
    global log-probs and the loss on (n, m, A) answers."""
    jcfg, tcfg = cfgs(gating=gating, image_dims=(("clip", 10),))
    tree = with_head(jqa.eca_reader_init(jax.random.key(2), jcfg),
                     "qa_outputs", 2)
    n, m, length, answers = 2, 3, 7, 2
    text, face, image, start, end, answer_mask = _reader_batch(
        n, m, length, answers)
    ref = jqa.eca_reader_apply(
        tree, jcfg, jx(text), jx(face), jx(image),
        start_positions=jnp.asarray(start), end_positions=jnp.asarray(end),
        answer_mask=jnp.asarray(answer_mask), m_passages=m)
    model = tmm.from_jax(tqa.ECAReader, tcfg, tree, device="cpu")
    got = tqa.eca_reader_apply(
        model, tcfg, tt(text), tt(face), tt(image),
        start_positions=torch.from_numpy(start),
        end_positions=torch.from_numpy(end),
        answer_mask=torch.from_numpy(answer_mask), m_passages=m)
    assert got.start_logits.shape == (n * m, length)
    assert got.moe_aux is None
    for field in ("start_logits", "end_logits", "start_log_probs",
                  "end_log_probs"):
        close(getattr(got, field), getattr(ref, field))
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-5)


def test_eca_reader_refuses_no_text_and_runs_moe():
    """no_text has no text span to read; a MoE BERT runs and its reader
    output carries the load-balance term, equal to the JAX reader's on
    the same tree."""
    _, tcfg = cfgs(no_text=True)
    with pytest.raises(AssertionError, match="no_text"):
        tqa.eca_reader_init(tcfg, device="cpu")
    jcfg, tcfg = cfgs(image_dims=(("clip", 10),))
    jcfg = dataclasses.replace(jcfg, bert=dataclasses.replace(
        jcfg.bert, moe_experts=2, moe_capacity_factor=2.0))
    tcfg = dataclasses.replace(tcfg, bert=dataclasses.replace(
        tcfg.bert, moe_experts=2, moe_capacity_factor=2.0))
    tree = with_head(jqa.eca_reader_init(jax.random.key(3), jcfg),
                     "qa_outputs", 3)
    n, m, length, answers = 2, 2, 7, 2
    text, face, image, start, end, answer_mask = _reader_batch(
        n, m, length, answers)
    ref = jqa.eca_reader_apply(
        tree, jcfg, jx(text), jx(face), jx(image),
        start_positions=jnp.asarray(start), end_positions=jnp.asarray(end),
        answer_mask=jnp.asarray(answer_mask), m_passages=m)
    model = tmm.from_jax(tqa.ECAReader, tcfg, tree, device="cpu")
    got = tqa.eca_reader_apply(
        model, tcfg, tt(text), tt(face), tt(image),
        start_positions=torch.from_numpy(start),
        end_positions=torch.from_numpy(end),
        answer_mask=torch.from_numpy(answer_mask), m_passages=m)
    close(got.start_logits, ref.start_logits)
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-5)
    assert float(got.moe_aux) == pytest.approx(float(ref.moe_aux), rel=1e-5)


@pytest.mark.parametrize("kind", ["eca_reranker", "flamant_reranker",
                                  "eca_reader"])
def test_jax_tree_round_trips_through_the_port(kind):
    jinit, cls, kw = {
        "eca_reranker": (jrr.eca_reranker_init, trr.ECAReRanker,
                         {"gating": True}),
        "flamant_reranker": (jrr.flamant_reranker_init, trr.FlamantReRanker,
                             FLAMANT),
        "eca_reader": (jqa.eca_reader_init, tqa.ECAReader, {}),
    }[kind]
    jcfg, tcfg = cfgs(**kw)
    tree = set_gates(np_tree(jinit(jax.random.key(4), jcfg)))
    module = tmm.from_jax(cls, tcfg, tree, device="cpu")
    back = flat_leaves(convert.tree_from_module(module))
    want = flat_leaves(tree)
    assert back.keys() == want.keys()
    for path in want:
        assert np.array_equal(back[path], want[path]), path


def test_seeded_heads_start_with_closed_gates():
    _, tcfg = cfgs(gating=True)
    for model in (trr.eca_reranker_init(tcfg, device="cpu"),
                  tqa.eca_reader_init(tcfg, device="cpu")):
        assert float(model.face_gate.gate) == 0.0
        assert not any(p.requires_grad for p in model.parameters())
