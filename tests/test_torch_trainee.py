"""The port's trainees (viquae_torch/train/trainee.py, run.py, save_ptm.py,
callbacks.py) against the JAX package's on the same weights and batches:
the counterparts of tests/test_trainee.py and of the trainee cases of
tests/test_mm_qa.py, and for every trainee kind the loss, the gradients
and the parameters after AdamW steps (warmup, clipping, a freeze regex).

Weights are drawn by the port and handed to JAX as trees
(``models.convert.tree_from_module``), at std 0.2 rather than BERT's 0.02
(:func:`spread`): at 0.02 the [CLS] states of a 16-wide tower are nearly
equal, the in-batch softmax is flat, and its gradient is a difference of
near-equal terms that cancels to ~1e-3 of them in either package's f32.
Dropout cannot match JAX's bits,
so parity runs with ``deterministic=True``. Tolerances: loss 1e-5
relative; every gradient entry within 1e-4 of the largest entry of the
whole gradient (f32 sums in another order through two to three layers:
a leaf whose entries cancel, a LayerNorm bias, carries that absolute
error on a small value); parameters
after 2 steps within 1e-6 where the gradient is well above its own
tolerance. Adam moves an entry by ~lr whatever its gradient's size, so
an entry whose gradient is rounding noise (the attention key bias, whose
true gradient is 0: softmax ignores a constant added to every score)
moves by up to lr in either direction in either package: each entry is
held to 1e-6 + 2 * sum(lr) * min(1, tol / |g|), tol the gradient
tolerance and |g| its smallest JAX gradient over the steps.

The JAX tests that need the 8-device mesh (a sharded batch or
``param_spec``) have no counterpart here: sharded training is A17.
The MoE trainees' parity runs are in test_torch_moe_trainee.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_helpers import jax_layout
from viquae_torch.models import bert as tbert
from viquae_torch.models import clip as tclip
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import mm as tmm
from viquae_torch.models import qa as tqa
from viquae_torch.models import rr as trr
from viquae_torch.models.convert import tree_from_module
from viquae_torch.train import data as tdata
from viquae_torch.train import optim as toptim
from viquae_torch.train import save_ptm as tsave
from viquae_torch.train import trainee as ttrainee
from viquae_torch.train.callbacks import test_after_fit as run_test_after_fit
from viquae_torch.train.trainer import Trainer, TrainerConfig
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import clip as jclip
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import mm as jmm
from viquae_tpu.models import qa as jqa
from viquae_tpu.models import rr as jrr
from viquae_tpu.train import optim as joptim
from viquae_tpu.train import trainee as jtrainee

torch.set_num_threads(2)

TINY = dict(
    vocab_size=120, hidden_size=16, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=32,
    max_position_embeddings=64, add_pooler=False,
)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6, grad_clip=0.5,
           weight_decay=0.01)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"ent{i}" for i in range(20)] + [f"fact{i}" for i in range(20)]
             + ["question", "about", "passage", "the", "answer", "is",
                "sentence", "of", "doc"]
             + letters + [f"##{c}" for c in letters])
    d = tmp_path_factory.mktemp("tok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                             do_lower_case=True)


def jflat(tree) -> dict:
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jtree(module):
    return jax.tree.map(jnp.asarray, tree_from_module(module))


def to_jax(batch):
    """A host batch as JAX arrays (strings and ragged lists dropped)."""
    from viquae_torch.core.device import _is_host_only

    if isinstance(batch, dict):
        return {k: to_jax(v) for k, v in batch.items()
                if not _is_host_only(v)}
    return jnp.asarray(np.asarray(batch))


def check_parity(tt, jt, batch, freeze=None, steps=2, rel=1e-5):
    """loss, gradients and the parameters after ``steps`` AdamW steps of
    the port trainee ``tt`` against the JAX trainee ``jt`` (whose params
    tree is ``tt``'s weights), on one host batch, dropout off."""
    from viquae_torch.core.device import upload_batch

    module = tt.params.requires_grad_(True)
    jparams = jt.params
    assert sorted(jax_layout(module)) == sorted(jflat(jparams))
    spec = toptim.make_optimizer(module, freeze_regex=freeze, **OPT)
    opt = spec.build(module)
    tx = joptim.make_optimizer(jparams, freeze_regex=freeze, **OPT)
    state = tx.init(jparams)
    tbatch, jbatch = upload_batch(batch, torch.device("cpu")), to_jax(batch)

    def jloss(p):
        return jt.loss_fn(p, jbatch, jax.random.key(0), deterministic=True)

    smallest, lr_sum = {}, 0.0
    for step in range(steps):
        for p in module.parameters():
            p.grad = None
        loss, aux = tt.loss_fn(module, tbatch, None, deterministic=True)
        loss.backward()
        (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
        assert float(loss.detach()) == pytest.approx(float(jl), rel=rel), step
        got, ref = jax_layout(module, grads=True), jflat(jgrads)
        tol = 1e-4 * max(np.abs(g).max() for g in ref.values())
        for path, g in ref.items():
            smallest[path] = np.minimum(smallest.get(path, np.inf),
                                        np.abs(g) / tol)
            if step == 0:
                np.testing.assert_allclose(got[path], g, rtol=0, atol=tol,
                                           err_msg=path)
        if step == 0:
            if not isinstance(aux, dict):
                aux, jaux = {"aux": aux}, {"aux": jaux}
            for key, value in aux.items():
                if isinstance(value, torch.Tensor) and \
                        value.is_floating_point():
                    np.testing.assert_allclose(
                        value.detach().numpy(), np.asarray(jaux[key]),
                        rtol=1e-4, atol=1e-5, err_msg=key)
        lr_sum += opt.adamw.param_groups[0]["lr"]
        opt.step()
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got, ref = jax_layout(module), jflat(jparams)
    for path in ref:
        bound = 1e-6 + 2 * lr_sum * np.minimum(
            1.0, 1.0 / np.maximum(smallest[path], 1e-30))
        assert (np.abs(got[path] - ref[path]) <= bound).all(), path
    return float(loss.detach())


# --------------------------------------------------------------------------
# model builders: the same weights in both packages
# --------------------------------------------------------------------------
def spread(module, seed):
    """Redraw ``module``'s weights at std 0.2 (see the module docstring);
    LayerNorm scales stay 1, biases 0."""
    from viquae_torch.models.layers import init_weights_

    return init_weights_(module, seed, linear_std=0.2, embed_std=0.2,
                         truncated=True)


def dpr_pair(seed):
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**TINY))
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**TINY))
    t = tdpr.DPREncoder(cfg=tcfg, params=spread(
        tdpr.init(tcfg, seed, device="cpu"), seed))
    return t, jdpr.DPREncoder(cfg=jcfg, params=jtree(t.params))


MM_KW = dict(n_faces=1, face_dim=6, bbox_dim=7,
             image_dims=(("clip", 8), ("imagenet", 9)))


def mm_pair(kind, seed, **kw):
    kw = {**MM_KW, **kw}
    tcfg = tmm.MMConfig(bert=tbert.BertConfig(**TINY), **kw)
    jcfg = jmm.MMConfig(bert=jbert.BertConfig(**TINY), **kw)
    tcls, jcls = {"eca": (tmm.ECAEncoder, jmm.ECAEncoder),
                  "ilf": (tmm.IntermediateLinearFusion,
                          jmm.IntermediateLinearFusion)}[kind]
    t = tcls(cfg=tcfg, seed=seed, device="cpu")
    spread(t.params, seed)
    with torch.no_grad():   # non-zero gates, so the visual side counts
        for mod in t.params.modules():
            if isinstance(mod, tmm.TanhGate):
                mod.gate.fill_(0.5)
    return t, jcls(cfg=jcfg, params=jtree(t.params))


def biencoder_batch(n=4, m=2, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "question_inputs": {
            "input_ids": rng.integers(5, 120, (n, length)).astype(np.int32),
            "attention_mask": np.ones((n, length), np.int32)},
        "context_inputs": {
            "input_ids": rng.integers(5, 120, (n * m, length)).astype(
                np.int32),
            "attention_mask": np.ones((n * m, length), np.int32)},
        "labels": (np.arange(n) * m).astype(np.int32),
    }


def kb_items(n=4):
    kb = [{"passage": f"passage about ent{i} the answer is fact{i}",
           "index": i} for i in range(12)]
    items = [{"id": f"q{i}", "input": f"question about ent{i}",
              "output": {"original_answer": f"fact{i}",
                         "answer": [f"fact{i}"]},
              "search_provenance_indices": [i],
              "search_irrelevant_indices": [(i + 5) % 12],
              "search_indices": [i, (i + 5) % 12],
              "search_scores": [3.0, 1.0]}
             for i in range(n)]
    return kb, items


def ict_batch(tokenizer, packed, needs_vis=True, n=4):
    feats = tdata.PreComputedImageFeatures(
        n_faces=1, face_dim=6, bbox_dim=7,
        image_dims={"clip": 8, "imagenet": 9})
    rng = np.random.default_rng(1)
    items = []
    for i in range(n):
        item = {"sentences": [{"text": f"sentence {j} of doc ent{i}."}
                              for j in range(5)], "title": f"doc{i}"}
        for prefix in ("", "context_"):
            item[f"{prefix}clip"] = rng.standard_normal(8).tolist()
            item[f"{prefix}imagenet"] = rng.standard_normal(9).tolist()
            if i != 2:   # one sample without a face
                item[f"{prefix}face_embedding"] = [
                    rng.standard_normal(6).tolist()]
                item[f"{prefix}face_box"] = [rng.uniform(size=7).tolist()]
        items.append(item)
    coll = tdata.ICTCollator(
        tokenizer, M=2, max_length=16, seed=0, image_features=feats,
        sentences_per_target=2, packed=packed, text_mask_rate=0.5,
        image_mask_rate=0.5, mm_packed_needs_vis=needs_vis)
    return coll.collate_fn(items)


# --------------------------------------------------------------------------
# parity by trainee kind
# --------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True])
def test_biencoder_dense_parity(tokenizer, packed):
    (tq, jq), (tc, jc) = dpr_pair(0), dpr_pair(1)
    kb, items = kb_items()
    batch = tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, max_length=16, seed=0,
        packed=packed).collate_fn(items)
    check_parity(ttrainee.BiEncoderTrainee(tq, tc),
                 jtrainee.BiEncoderTrainee(jq, jc), batch,
                 freeze=r".*/layers/1/.*")


def test_biencoder_shared_parity():
    tq, jq = dpr_pair(0)
    tt = ttrainee.BiEncoderTrainee(tq, shared_encoders=True)
    jt = jtrainee.BiEncoderTrainee(jq, shared_encoders=True)
    assert list(tt.params._modules) == ["question"]
    check_parity(tt, jt, biencoder_batch())


@pytest.mark.parametrize("kind,packed", [("eca", False), ("eca", True),
                                         ("ilf", False), ("ilf", True)])
def test_biencoder_multimodal_parity(tokenizer, kind, packed):
    """ECA / ILF towers on both sides, padded and packed ICT batches
    (ECA's canvas reserves the visual-token slots, ILF's does not)."""
    (tq, jq), (tc, jc) = mm_pair(kind, 0, gating=kind == "eca"), \
        mm_pair(kind, 1, gating=kind == "eca")
    batch = ict_batch(tokenizer, packed, needs_vis=kind == "eca")
    check_parity(ttrainee.BiEncoderTrainee(tq, tc),
                 jtrainee.BiEncoderTrainee(jq, jc), batch)


def test_ict_eca_question_with_text_only_context(tokenizer):
    """configs/experiments/ict/eca.yaml's pairing: an ECA question tower
    and a DPR context tower over packed ICT batches. The DPR tower reads
    the context canvas with its visual slots masked out, which equals the
    JAX DPR over the padded context text (the JAX trainee itself fails on
    this batch: it hands DPR the visual inputs)."""
    tq, _ = mm_pair("eca", 0)
    tc, jc = dpr_pair(1)
    batch = ict_batch(tokenizer, packed=True)
    tt = ttrainee.BiEncoderTrainee(tq, tc, remat_layers=True)
    tparams = tt.params.requires_grad_(True)
    from viquae_torch.core.device import upload_batch

    tb = upload_batch(batch, torch.device("cpu"))
    q, c, _ = tt._encode_pair(tparams, tb, None, True)
    text = batch["context_inputs"]["text_inputs"]
    ref = jdpr.apply(jc.params, jc.cfg, text["input_ids"],
                     text["attention_mask"])["pooler_output"]
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    loss, _ = tt.loss_fn(tparams, tb, torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss)


CLIP_TEXT = dict(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_positions=16, projection_dim=8,
                 eos_token_id=49)
CLIP_VISION = dict(hidden_size=16, num_layers=1, num_heads=2,
                   intermediate_size=32, image_size=16, patch_size=8,
                   projection_dim=8)


def clip_pairs():
    """Fresh (port, JAX) CLIP text and vision towers on the same
    weights."""
    tt_ = tclip.CLIPTextTower(cfg=tclip.CLIPTextConfig(**CLIP_TEXT),
                              seed=0, device="cpu")
    tv = tclip.CLIPVisionTower(cfg=tclip.CLIPVisionConfig(**CLIP_VISION),
                               seed=1, device="cpu")
    spread(tt_.params, 0), spread(tv.params, 1)
    return (tt_, jclip.CLIPTextTower(cfg=jclip.CLIPTextConfig(**CLIP_TEXT),
                                     params=jtree(tt_.params)),
            tv, jclip.CLIPVisionTower(
                cfg=jclip.CLIPVisionConfig(**CLIP_VISION),
                params=jtree(tv.params)))


@pytest.mark.parametrize("kind", ["crossmodal", "jcm"])
def test_crossmodal_parity(kind):
    rng = np.random.default_rng(0)
    n = 3
    ids = rng.integers(1, 48, (n, 6)).astype(np.int32)
    ids[:, 4] = 49
    batch = {
        "pixel_values": rng.standard_normal((n, 16, 16, 3)).astype(
            np.float32),
        "paired_pixel_values": rng.standard_normal((n, 16, 16, 3)).astype(
            np.float32),
        "text_inputs": {"input_ids": ids,
                        "attention_mask": np.ones((n, 6), np.int32)},
        "labels": np.arange(n, dtype=np.int32),
    }
    tt_, jt_, tv, jv = clip_pairs()
    if kind == "crossmodal":
        check_parity(ttrainee.CrossModalTrainee(tt_, tv),
                     jtrainee.CrossModalTrainee(jt_, jv), batch)
        return
    tj = ttrainee.JointMonoAndCrossModalTrainee(tt_, tv, learn_weights=False)
    jj = jtrainee.JointMonoAndCrossModalTrainee(jt_, jv, learn_weights=False)
    assert tj.freeze_weights_regex() == jj.freeze_weights_regex()
    check_parity(tj, jj, batch, freeze=tj.freeze_weights_regex())


def test_joint_mono_cross_modal_trainee(tmp_path):
    """The JAX test's case (tests/test_mm_qa.py): finite loss, the image /
    cm metrics, frozen fusion weights; and the export's mm_weights.json
    equals the JAX trainee's on the same weights."""
    tcfg = tclip.CLIPTextConfig(
        vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
        intermediate_size=32, max_positions=16, projection_dim=8,
        eos_token_id=49)
    vcfg = tclip.CLIPVisionConfig(
        hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
        image_size=16, patch_size=8, projection_dim=8)
    text = tclip.CLIPTextTower(cfg=tcfg, seed=0, device="cpu")
    vision = tclip.CLIPVisionTower(cfg=vcfg, seed=1, device="cpu")
    trainee = ttrainee.JointMonoAndCrossModalTrainee(text, vision)
    rng = np.random.default_rng(0)
    n = 3
    batch = {
        "pixel_values": torch.from_numpy(
            rng.standard_normal((n, 16, 16, 3)).astype(np.float32)),
        "paired_pixel_values": torch.from_numpy(
            rng.standard_normal((n, 16, 16, 3)).astype(np.float32)),
        "text_inputs": {"input_ids": torch.tensor([[0, 5, 49, 1]] * n),
                        "attention_mask": torch.ones((n, 4),
                                                     dtype=torch.int32)},
        "labels": torch.arange(n),
    }
    loss, aux = trainee.loss_fn(trainee.params, batch,
                                torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    metrics = trainee.eval_fn([{k: v.detach().numpy()
                                for k, v in aux.items()}])
    assert "image_MRR@N*M" in metrics and "cm_MRR@N*M" in metrics
    assert trainee.freeze_weights_regex() is not None
    trainee.export(tmp_path / "t")
    jt = jtrainee.JointMonoAndCrossModalTrainee(
        jclip.CLIPTextTower(cfg=jclip.CLIPTextConfig(
            **tcfg.__dict__), params=jtree(text.params)),
        jclip.CLIPVisionTower(cfg=jclip.CLIPVisionConfig(
            **vcfg.__dict__), params=jtree(vision.params)))
    jt.export(tmp_path / "j")
    got = json.loads((tmp_path / "t" / "mm_weights.json").read_text())
    ref = json.loads((tmp_path / "j" / "mm_weights.json").read_text())
    assert got == pytest.approx(ref, rel=1e-6)
    with np.load(tmp_path / "t" / "params.npz") as a, \
            np.load(tmp_path / "j" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


def test_joint_biencoder_and_clip_parity():
    tt_cfg = dict(vocab_size=120, hidden_size=16, num_layers=1,
                  num_heads=2, intermediate_size=32, max_positions=16,
                  projection_dim=16, eos_token_id=119)
    vt_cfg = dict(hidden_size=16, num_layers=1, num_heads=2,
                  intermediate_size=32, image_size=16, patch_size=8,
                  projection_dim=16)
    ctext = tclip.CLIPTextTower(cfg=tclip.CLIPTextConfig(**tt_cfg), seed=2,
                                device="cpu")
    cvis = tclip.CLIPVisionTower(cfg=tclip.CLIPVisionConfig(**vt_cfg),
                                 seed=3, device="cpu")
    spread(ctext.params, 2), spread(cvis.params, 3)
    (tq, jq), (tc, jc) = dpr_pair(0), dpr_pair(1)
    tt = ttrainee.JointBiEncoderAndClipTrainee(tq, tc, ctext, cvis)
    jt = jtrainee.JointBiEncoderAndClipTrainee(
        jq, jc,
        jclip.CLIPTextTower(cfg=jclip.CLIPTextConfig(**tt_cfg),
                            params=jtree(ctext.params)),
        jclip.CLIPVisionTower(cfg=jclip.CLIPVisionConfig(**vt_cfg),
                              params=jtree(cvis.params)))
    rng = np.random.default_rng(0)
    batch = biencoder_batch()
    titles = rng.integers(1, 118, (8, 6)).astype(np.int32)
    titles[:, 5] = 119
    batch["context_inputs"]["titles"] = {
        "input_ids": titles, "attention_mask": np.ones((8, 6), np.int32)}
    batch["question_pixel_values"] = rng.standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    batch["context_pixel_values"] = rng.standard_normal(
        (8, 16, 16, 3)).astype(np.float32)
    assert tt.freeze_weights_regex() == jt.freeze_weights_regex()
    check_parity(tt, jt, batch, freeze=tt.freeze_weights_regex())


@pytest.mark.parametrize("packed", [False, True])
def test_reranker_parity(tokenizer, packed):
    tcfg = trr.BertReRankerConfig(bert=tbert.BertConfig(**TINY))
    jcfg = jrr.BertReRankerConfig(bert=jbert.BertConfig(**TINY))
    params = spread(trr.bert_reranker_init(tcfg, 0, device="cpu"), 0)

    class TModel:
        def __init__(self):
            self.params = params

        def apply_fn(self, p, **kw):
            return trr.bert_reranker_apply(p, tcfg, **kw)

        def packed_apply_fn(self, p, *args, **kw):
            return trr.bert_reranker_apply_packed(p, tcfg, *args, **kw)

    class JModel:
        def __init__(self):
            self.params = jtree(params)

        def apply_fn(self, p, **kw):
            return jrr.bert_reranker_apply(p, jcfg, **kw)

        def packed_apply_fn(self, p, *args, **kw):
            return jrr.bert_reranker_apply_packed(p, jcfg, *args, **kw)

    kb, items = kb_items(2)
    batch = tdata.ReRankerCollator(
        tokenizer, kb=kb, M=2, max_length=24, seed=0, train=True,
        packed=packed).collate_fn(items)
    check_parity(ttrainee.ReRankerTrainee(TModel(), m_passages=2),
                 jtrainee.ReRankerTrainee(JModel(), m_passages=2), batch)


@pytest.mark.parametrize("packed,fuse", [(False, False), (True, False),
                                         (False, True)])
def test_reader_parity(tokenizer, packed, fuse):
    tcfg = tqa.ReaderConfig(bert=tbert.BertConfig(**TINY),
                            fuse_ir_score=fuse)
    jcfg = jqa.ReaderConfig(bert=jbert.BertConfig(**TINY),
                            fuse_ir_score=fuse)
    params = spread(tqa.init(tcfg, 0, device="cpu"), 0)
    if fuse:
        with torch.no_grad():
            params.score_proj_w.fill_(0.7)
            params.score_proj_b.fill_(0.1)
    kb, items = kb_items(2)
    batch = tdata.ReaderCollator(
        tokenizer, kb=kb, M=2, max_length=24, max_n_answers=3, seed=0,
        train=True, packed=packed).collate_fn(items)
    if fuse:
        batch["passage_scores"] = np.linspace(1, 2, 4).astype(np.float32)
    check_parity(ttrainee.ReaderTrainee(tcfg, params, tokenizer, 2),
                 jtrainee.ReaderTrainee(jcfg, jtree(params), tokenizer, 2),
                 batch, freeze=r"bert/embeddings")


# --------------------------------------------------------------------------
# counterparts of tests/test_trainee.py
# --------------------------------------------------------------------------
def make_biencoder():
    return ttrainee.BiEncoderTrainee(dpr_pair(0)[0], dpr_pair(1)[0])


def test_biencoder_trainee_with_trainer(tmp_path):
    be = make_biencoder()
    tx = toptim.make_optimizer(be.params, lr=1e-3, total_steps=6)
    trainer = Trainer(be.loss_fn, be.params, tx, TrainerConfig(
        max_steps=4, log_every=2, eval_every=2, ckpt_dir=str(tmp_path / "c"),
        monitor="MRR@N*M"), eval_fn=be.eval_fn)
    result = trainer.fit([biencoder_batch(seed=s) for s in range(3)],
                         eval_batches=lambda: [biencoder_batch(seed=9)])
    assert result["final_step"] == 4
    assert result["best_metric"] is not None
    metrics = run_test_after_fit(trainer, lambda: [biencoder_batch(seed=9)])
    assert "MRR@N*M" in metrics
    out = tsave.save_ptm(tmp_path / "c", tmp_path / "export", trainer.state)
    assert any("question_model" in e for e in out["exported"])
    # the export loads in the JAX package by the JAX init's names
    from viquae_tpu.train.checkpoint import import_params

    restored = import_params(tmp_path / "export" / "question_model",
                             dpr_pair(0)[1].params)
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(dpr_pair(0)[1].params)


def reader_batch(n=2, m=2, length=10, answers=2, scores=True):
    rng = np.random.default_rng(0)
    batch = {
        "input_ids": rng.integers(5, 60, (n * m, length)).astype(np.int32),
        "attention_mask": np.ones((n * m, length), np.int32),
        "start_positions": rng.integers(1, length - 1, (n, m, answers)),
        "end_positions": rng.integers(1, length - 1, (n, m, answers)),
        "answer_mask": np.ones((n, m, answers), np.int32),
        "answer_strings": [["ent7"]] * (n * m),
    }
    if scores:
        batch["passage_scores"] = rng.uniform(1, 2, n * m).astype(np.float32)
    return batch


def test_reader_trainee_eval_and_m_tuning(tokenizer, tmp_path):
    """The full test protocol writes the same files, predictions and
    metrics as the JAX trainee's on the same weights."""
    tcfg = tqa.ReaderConfig(bert=tbert.BertConfig(**TINY))
    jcfg = jqa.ReaderConfig(bert=jbert.BertConfig(**TINY))
    params = tqa.init(tcfg, 0, device="cpu")
    rt = ttrainee.ReaderTrainee(tcfg, params, tokenizer, m_passages=2,
                                tune_M=True)
    jt = jtrainee.ReaderTrainee(jcfg, jtree(params), tokenizer,
                                m_passages=2, tune_M=True)
    batch = reader_batch()
    result = rt.test(params, [batch], tmp_path / "log")
    ref = jt.test(jt.params, [batch], tmp_path / "jlog")
    for name in ("metrics.json", "predictions.json",
                 "weighted_predictions.json", "metrics_wrt_m.json"):
        assert (tmp_path / "log" / name).exists(), name
        assert json.loads((tmp_path / "log" / name).read_text()) == \
            json.loads((tmp_path / "jlog" / name).read_text()), name
    assert len(result["predictions"]) == 2
    sweep = rt.m_tuning([rt.eval_batch(params, batch)], tmp_path / "log")
    assert [s["@M"] for s in sweep] == [1, 2]
    assert result["predictions"] == ref["predictions"]


def test_power_range():
    assert list(ttrainee.power_range(24)) == [1, 2, 4, 8, 16, 24]
    assert list(ttrainee.power_range(4)) == [1, 2, 4]


def test_biencoder_packed_training(tokenizer):
    """The packed loss equals the padded loss (CLS pooling, block-diagonal
    attention): 1e-5 relative; token types refuse packing."""
    be = make_biencoder()
    kb, items = kb_items()
    from viquae_torch.core.device import upload_batch

    losses = []
    for packed in (True, False):
        batch = tdata.BiEncoderCollator(
            tokenizer, kb=kb, M=2, max_length=16, seed=0,
            packed=packed).collate_fn(items)
        assert ("canvas_input_ids" in batch["question_inputs"]) == packed
        loss, _ = be.loss_fn(be.params, upload_batch(batch, "cpu"),
                             deterministic=True)
        losses.append(float(loss))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    with pytest.raises(ValueError):
        tdata.BiEncoderCollator(tokenizer, kb=kb, M=2, max_length=16,
                                packed=True, passage_type_ids=True)


def test_reader_trainee_eval_fn_with_trainer(tokenizer):
    """The two-argument eval_fn (outputs + host batches) surfaces
    exact_match / f1 from Trainer.evaluate, equal to the JAX trainer's
    evaluation on the same weights."""
    tcfg = tqa.ReaderConfig(bert=tbert.BertConfig(**TINY))
    params = tqa.init(tcfg, 0, device="cpu")
    rt = ttrainee.ReaderTrainee(tcfg, params, tokenizer, m_passages=2)
    t = Trainer(rt.loss_fn, params, toptim.make_optimizer(params),
                TrainerConfig(log_every=0), eval_fn=rt.eval_fn)
    batch = reader_batch(scores=False)
    metrics = t.evaluate([batch])
    assert set(metrics) >= {"loss", "exact_match", "f1"}
    assert 0.0 <= metrics["f1"] <= 1.0
    jcfg = jqa.ReaderConfig(bert=jbert.BertConfig(**TINY))
    jt = jtrainee.ReaderTrainee(jcfg, jtree(params), tokenizer,
                                m_passages=2)
    loss, aux = jt.loss_fn(jt.params, to_jax(batch), jax.random.key(0),
                           deterministic=True)
    assert metrics["loss"] == pytest.approx(float(loss), rel=1e-5)
    ref = jt.eval_fn([aux], [batch])
    assert {k: metrics[k] for k in ref} == pytest.approx(ref)


def test_moe_biencoder_packed_training(tokenizer):
    """MoE towers through the packed trainee path (tests/test_trainee.py's
    case): with the aux weight zeroed, packed == padded loss (ample
    capacity: per-token routing does not see the other pad-token sets);
    with it on, the loss carries the term; equal to the JAX trainee on the
    same weights."""
    from viquae_torch.core.device import upload_batch

    moe = dict(moe_experts=2, moe_capacity_factor=8.0)
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**TINY, **moe))
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**TINY, **moe))
    towers = [tdpr.DPREncoder(cfg=tcfg, seed=s, device="cpu")
              for s in (0, 1)]
    jtowers = [jdpr.DPREncoder(cfg=jcfg, params=jtree(t.params))
               for t in towers]
    kb, items = kb_items()
    b_packed, b_padded = (tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, max_length=16, seed=0,
        packed=packed).collate_fn(items) for packed in (True, False))
    cpu = torch.device("cpu")
    be0 = ttrainee.BiEncoderTrainee(*towers, moe_aux_weight=0.0)
    lp, op = be0.loss_fn(be0.params, upload_batch(b_packed, cpu),
                         deterministic=True)
    lu, _ = be0.loss_fn(be0.params, upload_batch(b_padded, cpu),
                        deterministic=True)
    assert float(lp) == pytest.approx(float(lu), rel=1e-5)
    assert "moe_aux" in op
    be = ttrainee.BiEncoderTrainee(*towers, moe_aux_weight=0.05)
    lw, ow = be.loss_fn(be.params, upload_batch(b_packed, cpu),
                        deterministic=True)
    aux = float(ow["moe_aux"])
    assert aux > 0.0
    assert float(lw) == pytest.approx(float(lp) + aux, rel=1e-6)
    jbe = jtrainee.BiEncoderTrainee(*jtowers, moe_aux_weight=0.05)
    jl, jo = jbe.loss_fn(jbe.params, to_jax(b_packed), jax.random.key(0),
                         deterministic=True)
    assert float(lw) == pytest.approx(float(jl), rel=1e-5)
    assert aux == pytest.approx(float(jo["moe_aux"]), rel=1e-5)


def test_ilf_remat_through_trainee():
    """BiEncoderTrainee(remat_layers=True) on the unpacked ILF path, in
    training mode (dropout on): finite loss, gradients equal to the
    un-rematted run under the same generator seed."""
    (tq, _), (tc, _) = mm_pair("ilf", 0), mm_pair("ilf", 1)
    rng = np.random.default_rng(0)
    n = 4

    def side():
        return {
            "text_inputs": {
                "input_ids": torch.from_numpy(
                    rng.integers(0, 60, (n, 8)).astype(np.int32)),
                "attention_mask": torch.ones((n, 8), dtype=torch.int32)},
            "face_inputs": {
                "face": torch.randn(n, 1, 1, 6),
                "bbox": torch.randn(n, 1, 1, 7),
                "attention_mask": torch.ones((n, 1, 1), dtype=torch.int32)},
            "image_inputs": {
                "clip": {"input": torch.randn(n, 1, 8),
                         "attention_mask": torch.ones((n, 1),
                                                      dtype=torch.int32)},
                "imagenet": {"input": torch.randn(n, 1, 9),
                             "attention_mask": torch.ones(
                                 (n, 1), dtype=torch.int32)}},
        }

    batch = {"question_inputs": side(), "context_inputs": side(),
             "labels": torch.arange(n)}
    grads = []
    for remat in (True, False):
        be = ttrainee.BiEncoderTrainee(tq, tc, remat_layers=remat)
        params = be.params.requires_grad_(True)
        for p in params.parameters():
            p.grad = None
        loss, _ = be.loss_fn(params, batch, torch.Generator().manual_seed(3))
        assert torch.isfinite(loss)
        loss.backward()
        grads.append([p.grad.clone() for p in params.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_trainee_export_formats(tmp_path):
    """export: split question/context dirs in the JAX package's format
    (loadable by the port's bundles), the HF BertModel dirs with hf=True
    (loadable by transformers), the reader's single dir."""
    from transformers import BertModel

    be = make_biencoder()
    be.export(tmp_path / "be", hf=True)
    back = tdpr.DPREncoder.from_pretrained(
        tmp_path / "be" / "context_model", device="cpu",
        cfg=be.context_model.cfg)
    for a, b in zip(back.params.state_dict().values(),
                    be.params["context"].state_dict().values()):
        assert torch.equal(a, b)
    hf = BertModel.from_pretrained(str(tmp_path / "be" / "question_model_hf"),
                                   add_pooling_layer=False)
    ids = torch.tensor([[5, 6, 7, 8]])
    ours = tdpr.apply(be.params["question"], be.question_model.cfg,
                      ids)["last_hidden_state"]
    np.testing.assert_allclose(hf(ids).last_hidden_state.detach().numpy(),
                               ours.detach().numpy(), rtol=1e-4, atol=1e-5)
    tcfg = tqa.ReaderConfig(bert=tbert.BertConfig(**TINY))
    params = tqa.init(tcfg, 0, device="cpu")
    ttrainee.ReaderTrainee(tcfg, params, None).export(tmp_path / "rd")
    again = tqa.MultiPassageBERTReader.from_pretrained(
        tmp_path / "rd", device="cpu", cfg=tcfg)
    for a, b in zip(again.params.state_dict().values(),
                    params.state_dict().values()):
        assert torch.equal(a, b)
