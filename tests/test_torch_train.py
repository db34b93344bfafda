"""The port's training harness (viquae_torch/train/: prng, optim,
objectives, checkpoint, prefetch, trainer) against the JAX package's on
the same inputs: the counterparts of the single-device cases of
tests/test_train.py, the optimizer chain against optax step by step,
the decayed and frozen parameter sets of every shipped training config by
name, dropout and remat with dropout on.

Tolerances: host-side draws (SeedBundle.host, step-indexed batches) are
bitwise equal; schedules equal in f32; losses 1e-5 relative; AdamW
parameters after k steps on the same gradients within 1e-6 of optax (both
take the same f32 formula in another order). A resumed port run equals an
uninterrupted one bitwise on the CPU.
"""
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_helpers import jax_layout
from viquae_torch.core import prng as tprng
from viquae_torch.core.device import upload_batch
from viquae_torch.models import bert as tbert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import layers as tL
from viquae_torch.models.convert import jax_paths, tree_from_module
from viquae_torch.train import checkpoint as tckpt
from viquae_torch.train import metrics as ttmetrics
from viquae_torch.train import objectives as tobj
from viquae_torch.train import optim as toptim
from viquae_torch.train.trainer import Trainer, TrainerConfig
from viquae_tpu.core import prng as jprng
from viquae_tpu.train import metrics as jtmetrics
from viquae_tpu.train import objectives as jobj
from viquae_tpu.train import optim as joptim

torch.set_num_threads(2)

TINY = dict(
    vocab_size=50, hidden_size=16, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=32,
    max_position_embeddings=32, add_pooler=False,
)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def jflat(tree) -> dict:
    """{path: numpy leaf} of a JAX tree, paths as export_params names."""
    return {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tiny_dpr(seed=0, **kw):
    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(**{**TINY, **kw}))
    return cfg, tdpr.DPREncoder(cfg=cfg, seed=seed, device="cpu")


class SGD:
    """A plain SGD spec for the trainer (the JAX tests' optax.sgd)."""

    def __init__(self, lr):
        self.lr = lr

    def build(self, params):
        spec = self

        class _Opt:
            def __init__(self):
                self.sgd = torch.optim.SGD(params.parameters(), lr=spec.lr)

            def step(self):
                self.sgd.step()

            def state_dict(self):
                return self.sgd.state_dict()

            def load_state_dict(self, state):
                self.sgd.load_state_dict(state)

        return _Opt()


class Weights(torch.nn.Module):
    """A bare parameter tree for the trainer's refusal cases."""

    def __init__(self, **tensors):
        super().__init__()
        for k, v in tensors.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.as_tensor(v, dtype=torch.float32)))


# --------------------------------------------------------------------------
# seeds, schedule, objectives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 42, 12345])
def test_seed_bundle_host_stream_is_bitwise_the_jax_one(seed):
    """The host generator (batch order, ICT masking, passage sampling) is
    the JAX package's, draw for draw; the named device generators are
    deterministic per name and differ across names."""
    t, j = tprng.SeedBundle(seed), jprng.SeedBundle(seed)
    np.testing.assert_array_equal(t.host.integers(0, 1 << 30, 64),
                                  j.host.integers(0, 1 << 30, 64))
    np.testing.assert_array_equal(t.host.permutation(97),
                                  j.host.permutation(97))
    assert tprng._stable_hash("step3") == jprng._stable_hash("step3")
    a = torch.rand(8, generator=t.split("step3"))
    assert torch.equal(a, torch.rand(8, generator=t.split("step3")))
    assert not torch.equal(a, torch.rand(8, generator=t.split("step4")))


def test_linear_warmup_schedule():
    """Equal to the JAX schedule in f32 at every step, first lr 0."""
    for lr, warm, total in ((1.0, 10, 100), (2e-5, 100, 40000),
                            (1e-3, 0, 50), (2e-3, 4, 4)):
        t = toptim.linear_warmup_schedule(lr, warm, total)
        j = joptim.linear_warmup_schedule(lr, warm, total)
        for step in list(range(0, 12)) + [total // 2, total - 1, total,
                                          total + 3]:
            assert np.float32(t(step)) == np.float32(j(step)), (lr, step)
    sched = toptim.linear_warmup_schedule(1.0, warmup_steps=10,
                                          total_steps=100)
    assert sched(0) == 0.0
    assert sched(5) == pytest.approx(0.5)
    assert sched(55) == pytest.approx(0.5)


def test_multi_passage_rc_loss_matches_torch_reference():
    """The port's loss (already held by tests/test_torch_qa.py) against
    the JAX one on the same inputs, both branches: 1e-5 relative."""
    n, m, L, A = 2, 3, 12, 2
    rng = np.random.default_rng(0)
    sl = rng.standard_normal((n * m, L)).astype(np.float32)
    el = rng.standard_normal((n * m, L)).astype(np.float32)
    sp = rng.integers(0, L + 2, (n * m, A))
    ep = rng.integers(0, L + 2, (n * m, A))
    mask = rng.integers(0, 2, (n * m, A))
    for max_pooling in (False, True):
        got = toptim.multi_passage_rc_loss(
            *(torch.from_numpy(x) for x in (sl, el, sp, ep, mask)),
            m_passages=m, max_pooling=max_pooling)
        ref = joptim.multi_passage_rc_loss(
            *(jnp.asarray(x) for x in (sl, el, sp, ep, mask)),
            m_passages=m, max_pooling=max_pooling)
        assert float(got[0]) == pytest.approx(float(ref[0]), rel=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-6)


def test_biencoder_loss_and_ignore_index():
    """Every objective against the JAX one (1e-5 relative), and the
    IGNORE_INDEX rows out of the mean."""
    assert tobj.IGNORE_INDEX == jobj.IGNORE_INDEX
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    c = rng.standard_normal((8, 8)).astype(np.float32)
    labels = np.array([0, 3, 5, tobj.IGNORE_INDEX], np.int32)
    t, j = torch.from_numpy, jnp.asarray
    got, aux = tobj.biencoder_loss(t(q), t(c), t(labels))
    ref, jaux = jobj.biencoder_loss(j(q), j(c), j(labels))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    np.testing.assert_allclose(aux["log_probs"].numpy(),
                               np.asarray(jaux["log_probs"]), rtol=1e-5,
                               atol=1e-6)
    m = ttmetrics.batch_retrieval(aux["log_probs"].numpy(), labels)
    assert m["ignored_predictions"] == 1
    # identity similarities rank the right context first
    eye = np.eye(4, 8, dtype=np.float32)
    ctx = np.concatenate([eye, 0.1 * np.ones((4, 8), np.float32)])
    eye_labels = np.array([0, 1, 2, tobj.IGNORE_INDEX], np.int32)
    _, aux = tobj.biencoder_loss(t(eye), t(ctx), t(eye_labels))
    acc = ttmetrics.accumulate_batch_metrics([ttmetrics.batch_retrieval(
        aux["log_probs"].numpy(), eye_labels)])
    assert acc["hits@1"] == 1.0
    # CLIP, joint and reranker objectives
    img = rng.standard_normal((4, 8)).astype(np.float32)
    got, _ = tobj.clip_contrastive_loss(t(q), t(img), torch.tensor(3.0))
    ref, _ = jobj.clip_contrastive_loss(j(q), j(img), jnp.float32(3.0))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    ci, ct = (rng.standard_normal((8, 8)).astype(np.float32)
              for _ in range(2))
    w = [np.array([x], np.float32) for x in (0.2, 0.3, 0.5, 1.5)]
    got, _ = tobj.joint_mono_cross_modal_loss(
        t(q), t(c), t(img), t(ci), t(ct), t(labels), *map(t, w))
    ref, _ = jobj.joint_mono_cross_modal_loss(
        j(q), j(c), j(img), j(ci), j(ct), j(labels), *map(j, w))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    logits = rng.standard_normal((4, 3)).astype(np.float32)
    rl = np.array([0, 2, tobj.IGNORE_INDEX, 1], np.int32)
    got, _ = tobj.reranker_loss(t(logits), t(rl))
    ref, _ = jobj.reranker_loss(j(logits), j(rl))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_squad_metrics():
    for args in ((["the Cat", "dog"], [["cat!", "kitten"], ["bird"]]),
                 (["x b c"], [["x b d"]])):
        assert ttmetrics.squad(*args) == jtmetrics.squad(*args)
        assert (ttmetrics.squad_per_question(*args)
                == jtmetrics.squad_per_question(*args))


# --------------------------------------------------------------------------
# masks: the decayed and frozen sets of every shipped config, by name
# --------------------------------------------------------------------------
def test_freeze_mask():
    """The JAX test's cases on a module: '/'-joined paths and `search`,
    so the shipped interior-segment regexes freeze what they name."""
    _, q = tiny_dpr(num_hidden_layers=8)
    tree = torch.nn.ModuleDict({"question": q.params})
    mask = toptim.freeze_mask(tree, r".*/layers/(6|7|8|9|10|11)/.*")
    assert mask["question.layers.6.attention.q.weight"] is False
    assert mask["question.layers.7.mlp.out.bias"] is False
    assert mask["question.layers.2.attention.q.weight"] is True
    assert mask["question.embeddings.word.weight"] is True
    decay = toptim.decay_mask(tree)
    assert decay["question.layers.0.attention.q.weight"] is True
    assert decay["question.layers.0.attention.q.bias"] is False
    assert decay["question.layers.0.attention_ln.weight"] is False
    assert decay["question.embeddings.word.weight"] is True
    assert toptim.freeze_mask(tree, None) == {
        n: True for n, _ in tree.named_parameters()}


SHIPPED = ("configs/dpr_train.yaml", "configs/reader_train.yaml",
           "configs/experiments/dpr/triviaqa.yaml",
           "configs/experiments/dpr/viquae.yaml",
           "configs/experiments/ict/eca.yaml",
           "configs/experiments/ict/ilf.yaml",
           "configs/experiments/mm/eca.yaml",
           "configs/experiments/mm/ilf.yaml",
           "configs/experiments/rc/triviaqa.yaml",
           "configs/experiments/rc/viquae.yaml",
           "configs/experiments/jcm.yaml")
ROOT = Path(__file__).resolve().parent.parent


def _meta_model(spec):
    """(port module on the meta device, JAX tree of shapes) of one model
    node of a trainee config, at the config's full width."""
    from viquae_torch.models import clip as tclip
    from viquae_torch.models import mm as tmm
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import clip as jclip
    from viquae_tpu.models import mm as jmm

    spec = {k: v for k, v in spec.items()
            if k not in ("seed", "pretrained_model_name_or_path")}
    name = spec.pop("class_name")
    key = jax.random.key(0)
    with torch.device("meta"):
        if name == "DPREncoder":
            cfg = tbert.BertConfig(**spec.get("bert_config", {}),
                                   add_pooler=False)
            return (tbert.Bert(cfg), jax.eval_shape(
                lambda: jbert.init(key, jbert.BertConfig(
                    **spec.get("bert_config", {}), add_pooler=False))))
        if name in ("ECAEncoder", "IntermediateLinearFusion"):
            cls, init = ((tmm.ECA, jmm.eca_init) if name == "ECAEncoder"
                         else (tmm.ILF, jmm.ilf_init))
            tcfg = tmm.mm_config(**spec)
            jspec = dict(spec)
            jspec["image_dims"] = tuple(spec["image_dims"].items())
            return cls(tcfg), jax.eval_shape(
                lambda: init(key, jmm.MMConfig(**jspec)))
        if name == "CLIPTextTower":
            return (tclip.CLIPText(tclip.CLIPTextConfig()), jax.eval_shape(
                lambda: jclip.text_init(key, jclip.CLIPTextConfig())))
        if name == "CLIPVisionTower":
            return (tclip.CLIPVision(tclip.CLIPVisionConfig()),
                    jax.eval_shape(lambda: jclip.vit_init(
                        key, jclip.CLIPVisionConfig())))
    raise AssertionError(name)


def _meta_trainee(cfg):
    """(port ParamTree on meta, JAX params tree of shapes, trainee kind's
    own freeze regex) for a shipped config's trainee block."""
    from viquae_torch.models import qa as tqa
    from viquae_torch.train.trainee import ParamTree
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import qa as jqa

    kind = cfg["kind"]
    if kind == "reader":
        bcfg = cfg.get("bert_config", {})
        with torch.device("meta"):
            module = tqa.Reader(tqa.ReaderConfig(
                bert=tbert.BertConfig(**bcfg, add_pooler=False),
                fuse_ir_score=cfg.get("fuse_ir_score", False)))
        jcfg = jqa.ReaderConfig(
            bert=jbert.BertConfig(**bcfg, add_pooler=False),
            fuse_ir_score=cfg.get("fuse_ir_score", False))
        tree = jax.eval_shape(lambda: jqa.init(jax.random.key(0), jcfg))
        return module, tree, None
    if kind == "biencoder":
        mods, trees = {}, {}
        for role, key in (("question", "question_model"),
                          ("context", "context_model")):
            mods[role], trees[role] = _meta_model(cfg[key])
        return ParamTree(mods), trees, None
    assert kind == "jcm", kind
    (tm, tt), (vm, vt) = (_meta_model(cfg["text_model"]),
                          _meta_model(cfg["vision_model"]))
    scalars = {"image_weight": torch.zeros(1, device="meta"),
               "cm_weight": torch.zeros(1, device="meta"),
               "logit_scale": torch.zeros((), device="meta")}
    tree = {"text": tt, "vision": vt, "image_weight": jnp.zeros(1),
            "cm_weight": jnp.zeros(1), "logit_scale": jnp.zeros(())}
    freeze = (None if cfg.get("learn_weights")
              else r"(image_weight|cm_weight)")
    return ParamTree({"text": tm, "vision": vm}, scalars), tree, freeze


@pytest.mark.parametrize("path", SHIPPED)
def test_decay_and_freeze_sets_equal_jax_for_shipped_configs(path):
    """For every shipped training config, at its full width: the port's
    parameters map one to one onto the JAX trainee's leaves, and the
    decayed and the trainable sets are the JAX package's, leaf by leaf."""
    from viquae_torch.core.config import load_config

    config = load_config(ROOT / path)
    module, tree, auto_freeze = _meta_trainee(dict(config["trainee"]))
    regex = config.get("optimizer", {}).get("freeze_regex")
    if auto_freeze:
        regex = f"(?:{regex})|(?:{auto_freeze})" if regex else auto_freeze
    paths = jax_paths(module)
    assert sorted(paths.values()) == sorted(jflat(tree))
    for ours, ref in ((toptim.decay_mask(module), joptim.decay_mask(tree)),
                      (toptim.freeze_mask(module, regex),
                       joptim.freeze_mask(tree, regex))):
        ref = jflat(jax.tree_util.tree_map(np.bool_, ref))
        assert {paths[n]: v for n, v in ours.items()} == {
            k: bool(v) for k, v in ref.items()}
    if "layers/(6" in (regex or ""):
        frozen = [p for n, p in paths.items()
                  if not toptim.freeze_mask(module, regex)[n]]
        assert frozen and all("/layers/" in p for p in frozen)


# --------------------------------------------------------------------------
# the optimizer chain against optax
# --------------------------------------------------------------------------
@pytest.mark.parametrize("clip,freeze,wd", [
    (1.0, None, 0.0), (0.05, r".*/layers/1/.*", 0.1), (None, "embeddings",
                                                        0.01)])
def test_adamw_steps_match_optax(clip, freeze, wd):
    """k = 5 steps on the same gradients (some large enough to clip) with
    warmup: the port's AdamW + LambdaLR + clipping over the trainable
    leaves equals optax's chain within 1e-6; frozen leaves never move and
    hold no Adam state."""
    _, q = tiny_dpr()
    module = q.params.requires_grad_(True)
    tree = tree_from_module(module)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=clip,
              freeze_regex=freeze, weight_decay=wd)
    opt = toptim.make_optimizer(module, **kw).build(module)
    tx = joptim.make_optimizer(tree, **kw)
    state = tx.init(tree)
    start = jax_layout(module)
    rng = np.random.default_rng(0)
    named = dict(module.named_parameters())
    paths = jax_paths(module)
    for step in range(5):
        scale = 10.0 if step % 2 else 0.01
        grads = {n: (rng.standard_normal(p.shape) * scale).astype(np.float32)
                 for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n].copy())
        opt.step()
        jgrads = jax_layout(module, grads=True)
        jgrad_tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jgrads[k] for k in jflat(tree)])
        updates, state = tx.update(jgrad_tree, state, tree)
        tree = optax.apply_updates(tree, updates)
    got, ref = jax_layout(module), jflat(tree)
    trainable = toptim.freeze_mask(module, freeze)
    for name, path in paths.items():
        np.testing.assert_allclose(got[path], ref[path], rtol=0, atol=1e-6,
                                   err_msg=path)
        if not trainable[name]:
            np.testing.assert_array_equal(got[path], start[path])
            assert named[name] not in opt.adamw.state
    assert opt.adamw.param_groups[0]["lr"] == pytest.approx(
        toptim.linear_warmup_schedule(1e-2, 2, 8)(5))


# --------------------------------------------------------------------------
# dropout and remat
# --------------------------------------------------------------------------
def test_dropout_rate_scaling_sites_and_determinism():
    """Inverted dropout: kept entries scaled by 1/(1-p), the kept share
    ~ 1-p, masks a function of the seed; every BERT site draws (the
    output changes with each rate alone) and deterministic=True is the
    identity."""
    x = torch.ones(200, 500)
    y = tL.dropout(x, 0.1, seed=7)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.equal(y, tL.dropout(x, 0.1, seed=7))
    assert not torch.equal(y, tL.dropout(x, 0.1, seed=8))
    assert tL.dropout(x, 0.1, None) is x and tL.dropout(x, 0.0, 3) is x
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, 50, (3, 10)))

    def out(seed=0, deterministic=False, **rates):
        cfg, m = tiny_dpr(**{**NO_DROPOUT, **rates})
        return tdpr.apply(m.params, cfg, ids, deterministic=deterministic,
                          generator=torch.Generator().manual_seed(seed)
                          )["last_hidden_state"]

    base = out()
    assert torch.equal(base, out(deterministic=True))
    for rates in ({"hidden_dropout_prob": 0.1},
                  {"attention_probs_dropout_prob": 0.1}):
        assert not torch.allclose(out(**rates), base)
        assert torch.equal(out(**rates), out(**rates))
        assert not torch.equal(out(**rates), out(seed=1, **rates))
    cfg, m = tiny_dpr()
    with pytest.raises(ValueError, match="Generator"):
        tdpr.apply(m.params, cfg, ids, deterministic=False)


@pytest.mark.parametrize("packed", [False, True])
def test_remat_gradients_match(packed):
    """Per-layer remat (torch.utils.checkpoint) gives the plain gradients
    WITH DROPOUT ON under the same generator seed: the seeds are drawn
    before each checkpointed layer, so the recomputed masks are the same.
    Bitwise equal on the CPU."""
    cfg, m = tiny_dpr()
    params = m.params.requires_grad_(True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 50, (2, 8)))
    seg = torch.tensor([[1] * 5 + [2] * 3, [1] * 8])
    pos = torch.tensor([[0, 1, 2, 3, 4, 0, 1, 2], list(range(8))])

    def grads(remat):
        for p in params.parameters():
            p.grad = None
        gen = torch.Generator().manual_seed(5)
        if packed:
            out = tdpr.apply_packed(
                params, cfg, ids, seg, pos, torch.tensor([0, 0, 1]),
                torch.tensor([0, 5, 0]), deterministic=False,
                generator=gen, remat_layers=remat)
        else:
            out = tdpr.apply(params, cfg, ids, deterministic=False,
                             generator=gen,
                             remat_layers=remat)["pooler_output"]
        (out ** 2).sum().backward()
        return {n: p.grad.clone() for n, p in params.named_parameters()}

    plain, rematted = grads(False), grads(True)
    for name in plain:
        assert torch.equal(plain[name], rematted[name]), name
    # and the optim.remat wrapper around a whole apply
    fn = toptim.remat(lambda p, i: tdpr.apply(
        p, cfg, i, deterministic=True)["pooler_output"].sum())
    fn(params, ids).backward()


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------
def biencoder_setup(dropout=False):
    rates = {} if dropout else NO_DROPOUT
    cfg, q = tiny_dpr(seed=0, **rates)
    _, c = tiny_dpr(seed=1, **rates)
    params = torch.nn.ModuleDict({"question": q.params, "context": c.params})

    def loss_fn(params, batch, generator=None, deterministic=False):
        qe = tdpr.apply(params["question"], cfg, batch["q_ids"],
                        batch["q_mask"], deterministic=deterministic,
                        generator=generator)["pooler_output"]
        ce = tdpr.apply(params["context"], cfg, batch["c_ids"],
                        batch["c_mask"], deterministic=deterministic,
                        generator=generator)["pooler_output"]
        return tobj.biencoder_loss(qe, ce, batch["labels"])

    def make_batch(seed):
        rng = np.random.default_rng(seed)
        n, m, L = 8, 2, 12
        q_ids = rng.integers(5, 50, (n, L))
        c_ids = rng.integers(5, 50, (n * m, L))
        for i in range(n):
            c_ids[m * i, :6] = q_ids[i, :6]
        return {
            "q_ids": q_ids.astype(np.int32),
            "q_mask": np.ones((n, L), np.int32),
            "c_ids": c_ids.astype(np.int32),
            "c_mask": np.ones((n * m, L), np.int32),
            "labels": (np.arange(n) * m).astype(np.int32),
        }

    return cfg, params, loss_fn, make_batch


def test_train_loop_loss_decreases(tmp_path):
    _, params, loss_fn, make_batch = biencoder_setup()
    tx = toptim.make_optimizer(params, lr=5e-3, warmup_steps=2,
                               total_steps=60)
    trainer = Trainer(loss_fn, params, tx, TrainerConfig(
        max_steps=40, log_every=5, ckpt_dir=str(tmp_path / "ckpt"),
        ckpt_every=20))
    result = trainer.fit([make_batch(s) for s in range(8)])
    losses = [h["loss"] for h in result["history"] if "loss" in h]
    assert losses[-1] < losses[0] * 0.8, losses
    assert result["final_step"] == 40
    assert (tmp_path / "ckpt" / "step_40" / "state.pt").exists()
    assert (tmp_path / "ckpt" / "log.jsonl").exists()


def test_checkpoint_resume(tmp_path):
    """10 steps, checkpoint, resume to 20 (dropout on): the losses and the
    final parameters equal an uninterrupted 20-step run bitwise."""
    _, params, loss_fn, make_batch = biencoder_setup(dropout=True)
    tx = toptim.make_optimizer(params, lr=1e-3, warmup_steps=3,
                               total_steps=20, grad_clip=1.0)
    batches = [make_batch(s) for s in range(4)]
    base = dict(ckpt_dir=str(tmp_path / "c"), ckpt_every=10, log_every=1)
    Trainer(loss_fn, params, tx, TrainerConfig(max_steps=10, **base)).fit(
        batches)
    t2 = Trainer(loss_fn, params, tx, TrainerConfig(max_steps=20, **base))
    out = t2.fit(batches, resume=True)
    assert out["final_step"] == 20
    t3 = Trainer(loss_fn, params, tx, TrainerConfig(max_steps=20,
                                                    log_every=1))
    out3 = t3.fit(batches)
    l2 = [h["loss"] for h in out["history"]]
    l3 = [h["loss"] for h in out3["history"]][-len(l2):]
    assert l2 == l3
    for a, b in zip(t2.state["params"].parameters(),
                    t3.state["params"].parameters()):
        assert torch.equal(a, b)


def test_export_import_params(tmp_path):
    """An export of the port loads in the JAX package (by the JAX init's
    own names and shapes) and back into the port, leaf for leaf."""
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import dpr as jdpr
    from viquae_tpu.train import checkpoint as jckpt

    cfg, q = tiny_dpr()
    tckpt.export_params(tmp_path / "enc", tree_from_module(q.params),
                        {"a": 1})
    template = jdpr.init(jax.random.key(0), jdpr.DPRConfig(
        bert=jbert.BertConfig(**TINY)))
    restored = jflat(jckpt.import_params(tmp_path / "enc", template))
    ref = jax_layout(q.params)
    assert restored.keys() == ref.keys() == jflat(template).keys()
    for k in ref:
        np.testing.assert_array_equal(restored[k], ref[k])
    back = tdpr.DPREncoder.from_pretrained(tmp_path / "enc", device="cpu",
                                           cfg=cfg)
    for a, b in zip(q.params.state_dict().values(),
                    back.params.state_dict().values()):
        assert torch.equal(a, b)


def test_prefetch_loader():
    from viquae_torch.train.prefetch import CollatorLoader, PrefetchIterable

    def slow_batches():
        for i in range(5):
            time.sleep(0.01)
            yield {"x": np.full((2,), i)}

    out = [b["x"][0] for b in PrefetchIterable(slow_batches(), buffer_size=2)]
    assert out == [0, 1, 2, 3, 4]
    dataset = [{"v": i} for i in range(10)]
    loader = CollatorLoader(
        dataset, lambda items: {"v": np.array([it["v"] for it in items])},
        batch_size=3, shuffle=True, seed=0)
    epoch1 = [b["v"].tolist() for b in loader]
    assert len(epoch1) == 3 and all(len(b) == 3 for b in epoch1)
    epoch2 = [b["v"].tolist() for b in loader]
    assert epoch1 != epoch2

    def bad():
        yield {"x": 1}
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(PrefetchIterable(bad()))


def test_prefetch_early_break_stops_producer():
    from viquae_torch.train.prefetch import PrefetchIterable

    def batches():
        for i in range(1000):
            yield {"x": np.full((2,), i)}

    for _ in PrefetchIterable(batches(), buffer_size=2):
        break
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "viquae-prefetch" and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, "producer thread leaked after consumer break"


def _regression_setup():
    cfg, m = tiny_dpr(**NO_DROPOUT)

    def loss_fn(params, batch, generator=None, deterministic=False):
        out = tdpr.apply(params, cfg, batch["ids"], deterministic=True
                         )["pooler_output"]
        return torch.mean((out - batch["target"]) ** 2), {}

    return cfg, m.params, loss_fn


def test_grad_accum_matches_full_batch():
    """grad_accum=4 on batch B equals grad_accum=1 on the same B (a mean
    per-example loss) after one SGD(1.0) step, to 2e-6."""
    _, params, loss_fn = _regression_setup()
    rng = np.random.default_rng(0)
    batch = {"ids": rng.integers(5, 50, (16, 8)).astype(np.int32),
             "target": rng.normal(size=(16, 16)).astype(np.float32)}
    results = {}
    for accum in (1, 4):
        t = Trainer(loss_fn, params, SGD(1.0), TrainerConfig(
            max_steps=1, grad_accum=accum, log_every=0))
        t.fit([batch])
        results[accum] = list(t.state["params"].parameters())
    for a, b in zip(results[1], results[4]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-6, atol=2e-6)


def test_step_indexed_resume_is_o1(tmp_path):
    """A step-indexed source resumes without re-collating skipped batches
    and reproduces the uninterrupted losses exactly."""
    from viquae_torch.train.data import step_indexed_batches

    _, params, loss_fn, make_batch = biencoder_setup()
    tx = toptim.make_optimizer(params, lr=1e-3, total_steps=20)
    dataset = list(range(6))
    calls = []

    def collate(items):
        calls.append(tuple(items))
        return make_batch(sum(items))

    def source():
        return step_indexed_batches(dataset, collate, batch_size=3, seed=7)

    out1 = Trainer(loss_fn, params, tx, TrainerConfig(
        max_steps=20, log_every=1)).fit(source())
    calls.clear()
    base = dict(ckpt_dir=str(tmp_path / "s"), ckpt_every=10, log_every=1)
    Trainer(loss_fn, params, tx, TrainerConfig(max_steps=10, **base)).fit(
        source())
    assert len(calls) == 10
    calls.clear()
    out3 = Trainer(loss_fn, params, tx, TrainerConfig(
        max_steps=20, **base)).fit(source(), resume=True)
    assert len(calls) == 10, len(calls)
    l1 = [h["loss"] for h in out1["history"]][-10:]
    assert l1 == [h["loss"] for h in out3["history"]]


def test_grad_accum_divisibility_error():
    _, params, loss_fn = _regression_setup()
    t = Trainer(loss_fn, params, SGD(0.1), TrainerConfig(
        max_steps=1, grad_accum=3, log_every=0))
    with pytest.raises(ValueError, match="divisible"):
        t.fit([{"ids": np.ones((16, 8), np.int32),
                "target": np.zeros((16, 16), np.float32)}])


def test_step_indexed_batches_small_dataset_fills_batch():
    from viquae_torch.train.data import step_indexed_batches
    from viquae_tpu.train.data import step_indexed_batches as jsib

    dataset = list(range(10))
    src = step_indexed_batches(dataset, lambda items: np.asarray(items),
                               batch_size=32, seed=0)
    ref = jsib(dataset, lambda items: np.asarray(items), batch_size=32,
               seed=0)
    for step in range(3):
        batch = src(step)
        assert batch.shape == (32,)
        assert set(batch.tolist()) == set(range(10))
        np.testing.assert_array_equal(batch, ref(step))


def test_grad_accum_rejects_packed_canvases():
    params = Weights(w=np.zeros(4))

    def loss_fn(p, batch, generator=None):
        return torch.sum(p.w ** 2), {}

    batch = {"canvas_input_ids": np.zeros((8, 4), np.int32),
             "canvas_cls_rows": np.zeros((8,), np.int32),
             "labels": np.zeros((8,), np.int32)}
    tr = Trainer(loss_fn, params, toptim.make_optimizer(
        params, lr=1e-3, total_steps=2), TrainerConfig(max_steps=1,
                                                       grad_accum=2))
    with pytest.raises(ValueError, match="canvas"):
        tr.fit([batch])


def test_grad_accum_packed_microbatched():
    """Packing composes with accumulation: accum=2 with one packed canvas
    per microbatch equals accum=1 with every sequence on one canvas, for
    ragged canvases too (3e-5)."""
    from viquae_torch.train.data import (microbatch_collate,
                                         pack_text_inputs, stack_microbatches)

    cfg, m = tiny_dpr(**NO_DROPOUT)
    rng = np.random.default_rng(3)
    n = 16
    lens = np.concatenate([rng.integers(3, 6, n // 2),
                           rng.integers(20, 30, n // 2)])
    ids = np.zeros((n, 32), np.int32)
    mask = np.zeros((n, 32), np.int32)
    for i, ln in enumerate(lens):
        ids[i, :ln] = rng.integers(5, 50, ln)
        mask[i, :ln] = 1
    target = rng.normal(size=(n, TINY["hidden_size"])).astype(np.float32)
    items = [{"ids": ids[i], "mask": mask[i], "target": target[i]}
             for i in range(n)]

    def collate(group):
        sub = {"input_ids": np.stack([it["ids"] for it in group]),
               "attention_mask": np.stack([it["mask"] for it in group])}
        return {**pack_text_inputs(sub, row_len=32),
                "target": np.stack([it["target"] for it in group])}

    def loss_fn(params, batch, generator=None):
        out = tdpr.apply_packed(
            params, cfg, batch["canvas_input_ids"],
            batch["canvas_segment_ids"], batch["canvas_position_ids"],
            batch["canvas_cls_rows"], batch["canvas_cls_cols"],
        )[: batch["target"].shape[0]]
        return torch.mean((out - batch["target"]) ** 2), {}

    results = {}
    for accum in (1, 2):
        t = Trainer(loss_fn, m.params, SGD(1.0), TrainerConfig(
            max_steps=1, grad_accum=accum, microbatched=accum > 1,
            log_every=0))
        if accum == 1:
            t.fit([collate(items)])
        else:
            batch = microbatch_collate(collate, accum)(items)
            assert batch["canvas_input_ids"].ndim == 3
            t.fit([batch])
        results[accum] = list(t.state["params"].parameters())
    for a, b in zip(results[1], results[2]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=3e-5, atol=3e-5)
    s = stack_microbatches([{"a": np.ones((2, 3)), "s": "x"},
                            {"a": np.ones((4, 3)), "s": "y"}])
    assert s["a"].shape == (2, 4, 3) and s["s"] == ["x", "y"]
    assert (s["a"][0, 2:] == 0).all()


def test_microbatch_collate_validation():
    from viquae_torch.train.data import microbatch_collate

    with pytest.raises(ValueError, match="divisible"):
        microbatch_collate(lambda g: {}, 3)([1, 2, 3, 4])
    with pytest.raises(ValueError, match=">= 1"):
        microbatch_collate(lambda g: {}, 0)


def test_trainer_config_validation():
    """A monitor_mode typo and microbatched with accum 1 are __init__
    errors; the JAX trainer's mesh arguments are taken (a world of one, an
    empty spec), and a param_spec naming no parameter is an error."""
    params = Weights(w=np.ones(2))

    def loss_fn(p, b, g=None):
        return torch.mean(p.w ** 2), {}

    with pytest.raises(ValueError, match="monitor_mode"):
        Trainer(loss_fn, params, SGD(0.1), TrainerConfig(monitor_mode="Max"))
    with pytest.raises(ValueError, match="microbatched"):
        Trainer(loss_fn, params, SGD(0.1),
                TrainerConfig(microbatched=True, grad_accum=1))
    from viquae_torch.core import mesh

    for kw in ({"mesh_ctx": mesh.make_mesh(device="cpu")},
               {"param_spec": {}}, {"batch_spec": {}}):
        t = Trainer(loss_fn, params, SGD(0.1), TrainerConfig(), **kw)
        assert not t.mesh_ctx.distributed
    with pytest.raises(ValueError, match="names no parameter"):
        Trainer(loss_fn, params, SGD(0.1), TrainerConfig(),
                param_spec={"v": None})


def test_trainer_donation_does_not_clobber_caller_params():
    """The trainer trains its own copy: the caller's module is unchanged
    and shares no storage with it."""
    caller = Weights(w=np.ones((8, 4)))

    def loss_fn(p, b, g=None):
        return torch.mean((p.w - b["x"]) ** 2), {}

    t = Trainer(loss_fn, caller, SGD(0.5), TrainerConfig(max_steps=2,
                                                         log_every=0))
    t.fit([{"x": np.zeros((8, 4), np.float32)}] * 2)
    np.testing.assert_array_equal(caller.w.detach().numpy(), 1.0)
    assert not np.allclose(t.state["params"].w.detach().numpy(), 1.0)
    assert t.state["params"].w.data_ptr() != caller.w.data_ptr()


def test_shard_batch_keeps_rectangular_lists():
    """upload_batch keeps plain nested numeric lists and drops only
    string / ragged host-side leaves."""
    batch = {"labels": [[1, 2], [3, 4]], "answers": ["a", "b"],
             "ragged": [[1], [2, 3]], "ids": np.ones((8, 4), np.int32),
             "nested": {"s": np.array(["x"]), "v": np.zeros(3)}}
    out = upload_batch(batch, torch.device("cpu"))
    assert set(out) == {"labels", "ids", "nested"}
    assert set(out["nested"]) == {"v"}
    np.testing.assert_array_equal(out["labels"].numpy(), [[1, 2], [3, 4]])


def test_accumulate_batch_metrics_all_ignored():
    out = ttmetrics.accumulate_batch_metrics([
        {"MRR@N*M": 0.0, "hits@1": 0, "ignored_predictions": 3,
         "batch_size": 3}])
    assert out == {"MRR@N*M": 0.0, "hits@1": 0.0}
    assert ttmetrics.accumulate_batch_metrics([]) == {}


def test_grad_accum_rejects_inbatch_labels():
    rng = np.random.default_rng(0)
    batch = {"question": rng.normal(size=(8, 16)).astype(np.float32),
             "context": rng.normal(size=(16, 16)).astype(np.float32),
             "labels": np.arange(8, dtype=np.int32)}

    def loss_fn(params, batch, generator=None):
        sims = batch["question"] @ batch["context"].T * params.w
        return tobj.biencoder_loss(sims, torch.eye(16), batch["labels"])

    t = Trainer(loss_fn, Weights(w=np.ones(())), SGD(0.1), TrainerConfig(
        max_steps=1, grad_accum=2, log_every=0))
    with pytest.raises(ValueError, match="in-batch `labels`"):
        t.fit([batch])


def test_run_from_config_always_microbatches_accum():
    from viquae_torch.train.data import microbatch_collate

    wrapped = microbatch_collate(lambda items: {}, 2)
    assert wrapped.__qualname__.startswith("microbatch_collate")


def test_debug_nans_fails_fast():
    """debug_nans: a non-finite loss stops the run at its step."""
    params = Weights(w=np.ones(2))

    def loss_fn(p, b, g=None):
        return torch.sum(p.w * b["x"]), {}

    t = Trainer(loss_fn, params, SGD(0.1), TrainerConfig(
        max_steps=3, log_every=0, debug_nans=True))
    with pytest.raises(FloatingPointError, match="step 1"):
        t.fit([{"x": np.array([np.inf, 1.0], np.float32)}])
