"""MoE groups on rows split over ``data`` without gradients (ops/moe.py
with core.mesh.row_block): ``Trainer.evaluate`` and the data-split
embedders group the global batch's tokens, as the JAX package's single
program does, on a gloo world of 2 CPU processes at data = 2
(tests/torch_train_helpers.py ``moe_rows_program``).

The MoE DPR towers (4 experts, top 2) run at capacity 1.25, where choices
drop (held below: capacity 8 gives other outputs), on 14-token rows:
groups of 14 are whole on each rank's 4 or 8 rows; groups of at most 24
(23 long) straddle the ranks' halves, and every call raises there, with
gradients and without. Before the mark, the calls without gradients
grouped each rank's own tokens, and the straddling case silently differed
from one device. Tolerances: one device's numbers within 1e-5 (the same
f32 products on fewer rows), the JAX package's within 1e-4 relative and
absolute (tests/test_torch_moe.py's MoE BERT tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
import torch_train_helpers as tth
from viquae_torch.ir.embedding import PackedTextEmbedder, TextEmbedder
from viquae_torch.models import bert, dpr
from viquae_torch.models.convert import tree_from_module
from viquae_torch.train import optim
from viquae_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
LENGTH = 14
MOE = dict(tth.MOE, moe_capacity_factor=1.25, moe_group_size=14,
           moe_aux_weight=0.05)
STRADDLE = dict(MOE, moe_group_size=24)


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("moe_rows")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                "[MASK]"] + [f"w{i}" for i in range(100)]))
    rng = np.random.default_rng(3)
    # 12 words + [CLS] and [SEP]: each text fills one 14-token canvas row
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 100, LENGTH - 2))
             for _ in range(8)]
    q = rng.integers(5, 110, (8, LENGTH))
    c = rng.integers(5, 110, (16, LENGTH))
    for i in range(8):
        c[2 * i, :6] = q[i, :6]
    # 2 words + [CLS] and [SEP]: three texts a 14-token row, the eight
    # texts on 3 of the canvas's 4 rows (rows 0-1 on rank 0: six texts)
    short = [" ".join(f"w{j}" for j in rng.integers(0, 100, 2))
             for _ in range(8)]
    batch = {"question_inputs": {"input_ids": q, "attention_mask":
                                 np.ones((8, LENGTH), np.int64)},
             "context_inputs": {"input_ids": c, "attention_mask":
                                np.ones((16, LENGTH), np.int64)},
             "labels": (np.arange(8) * 2).astype(np.int64)}
    ranks = tdh.run_world("moe_rows", 2, d, vocab=str(vocab), moe=MOE,
                          batch=batch, texts=texts, short_texts=short,
                          max_length=LENGTH,
                          row_len=LENGTH, straddle=STRADDLE)
    tok = BertTokenizerFast(vocab_file=str(vocab))
    return dict(tok=tok, texts=texts, short=short, batch=batch,
                ranks=ranks)


def one_device(setting, kw=MOE):
    """The trainee, its one-device Trainer, and the question tower's
    TextEmbedder (no mesh)."""
    tt = tth.make_trainee("dpr", **kw)
    trainer = Trainer(tt.loss_fn, tt.params,
                      optim.make_optimizer(tt.params, **tth.OPT),
                      TrainerConfig(max_steps=0))
    cfg = tt.question_model.cfg
    q = trainer.state.params["question"]
    text = TextEmbedder(lambda p, **a: bert.apply(p, cfg.bert, **a), q,
                        setting["tok"], output_key="last_hidden_state",
                        max_length=LENGTH, batch_size=8, device="cpu")
    return tt, trainer, text


def jax_models(tt):
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import dpr as jdpr

    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(
        **vars(tt.question_model.cfg.bert)))
    trees = {n: jax.tree.map(jnp.asarray, tree_from_module(tt.params[n]))
             for n in ("question", "context")}
    return jcfg, trees


def test_choices_drop_at_this_capacity(setting):
    """The drops are real: capacity 8 (no drop) embeds otherwise."""
    _, _, text = one_device(setting)
    _, _, ample = one_device(setting, dict(MOE, moe_capacity_factor=8.0))
    a = text.embed_texts(setting["texts"])
    b = ample.embed_texts(setting["texts"])
    assert not np.allclose(a, b, atol=1e-5)


def test_evaluate_groups_the_global_batch_without_gradients(setting):
    """Trainer.evaluate (no gradients) on data = 2: each rank's rows of
    both towers are whole groups of the global batch's, so the loss with
    the aux is one device's and the JAX trainee's."""
    from viquae_tpu.models import dpr as jdpr
    from viquae_tpu.train import trainee as jtrainee

    tt, trainer, _ = one_device(setting)
    ref = trainer.evaluate([setting["batch"]])["loss"]
    jcfg, trees = jax_models(tt)
    jt = jtrainee.BiEncoderTrainee(
        jdpr.DPREncoder(cfg=jcfg, params=trees["question"]),
        jdpr.DPREncoder(cfg=jcfg, params=trees["context"]),
        moe_aux_weight=MOE["moe_aux_weight"])
    jbatch = jax.tree.map(jnp.asarray, setting["batch"])
    jloss, _ = jt.loss_fn(jt.params, jbatch, jax.random.key(0),
                          deterministic=True)
    for r in setting["ranks"]:
        np.testing.assert_allclose(r[("whole", "eval")], ref, rtol=1e-5)
        np.testing.assert_allclose(r[("whole", "eval")], float(jloss),
                                   rtol=1e-4, atol=1e-4)


def test_data_split_text_embedder_groups_the_global_batch(setting):
    """TextEmbedder on data = 2 (4 rows a rank, 56 tokens: 4 groups of
    14): one device's last hidden states, and the JAX TextEmbedder's on a
    JAX data = 2 mesh."""
    from viquae_tpu.core import mesh as jmesh
    from viquae_tpu.ir.embedding import TextEmbedder as JTextEmbedder
    from viquae_tpu.models import bert as jbert

    tt, _, text = one_device(setting)
    ref = text.embed_texts(setting["texts"])
    jcfg, trees = jax_models(tt)
    ctx = jmesh.make_mesh(data=2, devices=jax.devices()[:2])
    with jmesh.use(ctx):
        jref = JTextEmbedder(lambda p, **a: jbert.apply(p, jcfg.bert, **a),
                             trees["question"], setting["tok"],
                             output_key="last_hidden_state",
                             max_length=LENGTH, batch_size=8,
                             mesh_ctx=ctx).embed_texts(setting["texts"])
    for r in setting["ranks"]:
        got = r[("whole", "text")]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("call, texts, rows", [
    ("packed", "texts", 8), ("packed_short", "short", 4)])
def test_data_split_packed_embedder_groups_the_global_canvas(setting, call,
                                                              texts, rows):
    """PackedTextEmbedder on data = 2 packs the whole batch into one
    canvas, as one device does, and splits its rows (2 or 4 a rank, whole
    groups of 14): the CLS vectors are one device's and the JAX
    PackedTextEmbedder's, with each text one canvas row and with three
    texts a row (where packing each rank's block of the texts on its own
    canvas would lay the tokens out otherwise)."""
    from viquae_tpu.ir.embedding import PackedTextEmbedder as JPacked
    from viquae_tpu.models import dpr as jdpr

    tt, trainer, _ = one_device(setting)
    cfg = tt.question_model.cfg
    texts = setting[texts]
    ref = PackedTextEmbedder(
        dpr.make_packed_apply(cfg), trainer.state.params["question"],
        setting["tok"], row_len=LENGTH, batch_size=8,
        compute_dtype=torch.float32, fixed_rows=rows,
        device="cpu").embed_texts(texts).numpy()
    jcfg, trees = jax_models(tt)
    jref = JPacked(jdpr.make_packed_apply(jcfg), trees["question"],
                   setting["tok"], row_len=LENGTH, batch_size=8,
                   compute_dtype=jnp.float32, fixed_rows=rows).embed_texts(
                       texts)
    for r in setting["ranks"]:
        got = r[("whole", call)]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("call", ["eval", "text", "packed", "grad"])
def test_a_straddling_group_that_can_drop_raises(setting, call):
    """Groups of 23 of the global 112 tokens straddle the ranks' 56: each
    call raises on every rank (no rank waits in a collective), without
    gradients (evaluation, both embedders) as with them."""
    for r in setting["ranks"]:
        got = r[("straddle", call)]
        assert isinstance(got, str) and "not whole groups of 23" in got, got
