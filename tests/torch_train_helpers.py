"""Training on small gloo worlds of CPU processes: the tiny models, the
optimizer and the rank programs of ``tests/test_torch_train_mesh*.py``
(run by ``torch_dist_helpers.run_world``).

Imports no JAX: the ranks import torch, numpy and the port only. The test
processes import the same builders for the one-device runs and convert
their weights to JAX trees for the JAX trainers. Every model is drawn from
a seed on the CPU, so each rank and the test process hold the same
weights; the batches are built by the test process and handed over.
Dropout is off in the parity models (the rates are 0): the JAX package's
masks cannot be matched bit for bit, and the mesh's dropout is held by its
own case.
"""
from __future__ import annotations

# 4 heads and 32 units, so that a model axis of 2 keeps two whole heads
TINY = dict(vocab_size=120, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=32,
            max_position_embeddings=64, add_pooler=False,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8, grad_clip=0.5,
           weight_decay=0.01)
MM_KW = dict(n_faces=1, face_dim=6, bbox_dim=7,
             image_dims=(("clip", 8), ("imagenet", 9)))
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=8.0)
CLIP_TEXT = dict(vocab_size=120, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_positions=16, projection_dim=16,
                 eos_token_id=119)
CLIP_VISION = dict(hidden_size=16, num_layers=1, num_heads=2,
                   intermediate_size=32, image_size=16, patch_size=8,
                   projection_dim=16)


def _np(t):
    return t.detach().cpu().numpy()


def spread(module, seed):
    """Weights at std 0.2 (tests/test_torch_trainee.py's ``spread``: at
    BERT's 0.02 the tiny towers' in-batch softmax is flat)."""
    from viquae_torch.models.layers import init_weights_

    return init_weights_(module, seed, linear_std=0.2, embed_std=0.2,
                         truncated=True)


def bert_config(**kw):
    from viquae_torch.models import bert

    return bert.BertConfig(**{**TINY, **kw})


def dpr_encoder(seed, **bert_kw):
    from viquae_torch.models import dpr

    cfg = dpr.DPRConfig(bert=bert_config(**bert_kw))
    return dpr.DPREncoder(cfg=cfg, params=spread(
        dpr.init(cfg, seed, device="cpu"), seed))


def eca_encoder(seed):
    import torch

    from viquae_torch.models import mm

    cfg = mm.MMConfig(bert=bert_config(), gating=True, **MM_KW)
    enc = mm.ECAEncoder(cfg=cfg, seed=seed, device="cpu")
    spread(enc.params, seed)
    with torch.no_grad():    # open gates, so the visual side counts
        for mod in enc.params.modules():
            if isinstance(mod, mm.TanhGate):
                mod.gate.fill_(0.5)
    return enc


def clip_towers(seed=2):
    """CLIP text and vision towers (tests/test_torch_trainee.py's)."""
    from viquae_torch.models import clip

    text = clip.CLIPTextTower(cfg=clip.CLIPTextConfig(**CLIP_TEXT),
                              seed=seed, device="cpu")
    vision = clip.CLIPVisionTower(cfg=clip.CLIPVisionConfig(**CLIP_VISION),
                                  seed=seed + 1, device="cpu")
    spread(text.params, seed), spread(vision.params, seed + 1)
    return text, vision


class ReRanker:
    """A BERT re-ranker bundle (``rr.bert_reranker_*``) for
    ``ReRankerTrainee``."""

    def __init__(self, seed: int = 0):
        from viquae_torch.models import rr

        self.cfg = rr.BertReRankerConfig(bert=bert_config())
        self.params = spread(rr.bert_reranker_init(self.cfg, seed,
                                                   device="cpu"), seed)

    def apply_fn(self, params, **kw):
        from viquae_torch.models import rr

        return rr.bert_reranker_apply(params, self.cfg, **kw)

    def packed_apply_fn(self, params, *args, **kw):
        from viquae_torch.models import rr

        return rr.bert_reranker_apply_packed(params, self.cfg, *args, **kw)


def make_trainee(kind: str, seed: int = 0, **kw):
    """The trainees of the world cases: ``dpr`` (a DPR biencoder, its
    BERT kwargs in ``kw``, ``remat`` its per-layer remat), ``eca`` (ECA
    towers), ``ict`` (an ECA question tower, DPR contexts), ``regression``
    (:class:`PackedRegression`), ``reranker`` (:class:`ReRanker`, M = 2),
    ``crossmodal`` / ``jcm`` (CLIP towers), ``joint`` (DPR and CLIP),
    ``reader`` (the multi-passage reader: ``m`` passages a question,
    ``fuse`` the IR score, ``vocab`` a tokenizer's vocab.txt for its
    eval)."""
    from viquae_torch.models import qa
    from viquae_torch.train import trainee

    if kind == "dpr":
        aux = kw.pop("moe_aux_weight", 0.01)
        remat = kw.pop("remat", False)
        return trainee.BiEncoderTrainee(dpr_encoder(seed, **kw),
                                        dpr_encoder(seed + 1, **kw),
                                        moe_aux_weight=aux,
                                        remat_layers=remat)
    if kind == "eca":       # ECA towers on both sides
        return trainee.BiEncoderTrainee(eca_encoder(seed),
                                        eca_encoder(seed + 1))
    if kind == "ict":       # configs/experiments/ict/eca.yaml's pairing
        return trainee.BiEncoderTrainee(eca_encoder(seed),
                                        dpr_encoder(seed + 1))
    if kind == "regression":
        return PackedRegression(seed)
    if kind == "reranker":
        return trainee.ReRankerTrainee(ReRanker(seed), m_passages=2)
    if kind == "crossmodal":
        return trainee.CrossModalTrainee(*clip_towers(seed))
    if kind == "jcm":
        return trainee.JointMonoAndCrossModalTrainee(*clip_towers(seed))
    if kind == "joint":
        return trainee.JointBiEncoderAndClipTrainee(
            dpr_encoder(seed), dpr_encoder(seed + 1), *clip_towers(seed + 2))
    if kind == "reader":
        cfg = qa.ReaderConfig(bert=bert_config(),
                              fuse_ir_score=kw.get("fuse", False))
        tokenizer = None
        if kw.get("vocab"):
            from transformers import BertTokenizerFast

            tokenizer = BertTokenizerFast(vocab_file=kw["vocab"],
                                          do_lower_case=True)
        return trainee.ReaderTrainee(cfg, spread(qa.init(cfg, seed,
                                                         device="cpu"), seed),
                                     tokenizer, m_passages=kw.get("m", 2))
    raise ValueError(kind)


class PackedRegression:
    """tests/test_train.py::test_grad_accum_packed_microbatched's loss as
    a trainee: the packed DPR tower's CLS states against targets, a mean
    squared error over the global rows (the CLS states gathered over
    ``data``, the targets as the batch holds them)."""

    def __init__(self, seed: int = 0):
        self.encoder = dpr_encoder(seed)
        self.params = self.encoder.params

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        import torch

        from viquae_torch.train.data_parallel import packed_read

        out, _ = packed_read(
            self.encoder.packed_apply_fn, params,
            (batch["canvas_input_ids"], batch["canvas_segment_ids"],
             batch["canvas_position_ids"]),
            (batch["canvas_cls_rows"], batch["canvas_cls_cols"]),
            deterministic=True)
        target = batch["target"]
        return torch.mean((out[: target.shape[0]] - target) ** 2), {}


def trainee_spec(tt):
    """The port's param_spec of a world trainee's parameter tree: each
    BERT tensor-parallel (``bert.param_spec``), the rest replicated."""
    from viquae_torch.models import bert, qa

    if isinstance(tt, PackedRegression):
        return bert.param_spec(tt.params.cfg)
    if hasattr(tt, "model"):        # a re-ranker: its BERT split
        return {"bert": bert.param_spec(tt.model.cfg.bert)}
    if not hasattr(tt, "question_model"):
        return qa.param_spec(tt.cfg) if hasattr(tt, "cfg") else {}
    spec = {}
    for name in ("question", "context"):
        if name in tt.params:
            module = tt.params[name]
            spec[name] = (bert.param_spec(module.cfg)
                          if isinstance(module, bert.Bert)
                          else {"bert": bert.param_spec(module.bert.cfg)})
    return spec


class SGD:
    """Plain SGD (p -= lr * grad): one step shows the gradient itself."""

    def __init__(self, lr):
        self.lr = lr

    def build(self, params):
        import torch

        lr, plist = self.lr, list(params.parameters())

        class Opt:
            def step(self):
                with torch.no_grad():
                    for p in plist:
                        if p.grad is not None:
                            p -= lr * p.grad

            def state_dict(self):
                return {}

            def load_state_dict(self, state):
                pass

        return Opt()


def train(tt, batches, steps, mesh_ctx=None, spec=None, opt=None,
          trainer_kw=None, eval_fn=None):
    """A trainer over ``tt`` for ``steps`` steps on ``batches`` (a list,
    cycled): (trainer, fit result)."""
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    opt = opt if opt is not None else optim.make_optimizer(tt.params, **OPT)
    trainer = Trainer(tt.loss_fn, tt.params, opt,
                      TrainerConfig(max_steps=steps, log_every=1,
                                    **(trainer_kw or {})),
                      mesh_ctx=mesh_ctx, param_spec=spec, eval_fn=eval_fn)
    return trainer, trainer.fit(batches)


def replicated_equal(trainer, axes=None) -> bool:
    """Whether every parameter is bit-equal on every rank of each of
    ``axes`` (default: ``model``) that it is not split over (one
    all-gather each)."""
    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models.sharding import parameter_axes

    same = True
    split = parameter_axes(trainer.state.params)
    for name, p in trainer.state.params.named_parameters():
        for axis in axes or (mesh.MODEL_AXIS,):
            if split[name] != axis:
                parts = mesh.all_gather(trainer.mesh_ctx, p.detach(), axis)
                same &= all(torch.equal(parts[0], q) for q in parts[1:])
    return bool(same)


def _summary(trainer, out):
    params = trainer.full_params()
    return {"losses": [h["loss"] for h in out["history"] if "loss" in h],
            "grad_norms": [h["grad_norm"] for h in out["history"]
                           if "grad_norm" in h],
            "params": {n: _np(p) for n, p in params.named_parameters()},
            "replicated_equal": replicated_equal(trainer)}


def log_by_kind(log):
    """{(op, axis): [bytes, ...]} of a collective log."""
    out = {}
    for op, axis, nbytes in log:
        out.setdefault(f"{op}/{axis}", []).append(nbytes)
    return out


# ---- rank programs ----------------------------------------------------------
def cases_program(rank, tmp, cases):
    """Each case trains a trainee on a mesh of the world and returns its
    losses, grad norms, full parameters after the steps, whether the
    replicated parameters agree bit for bit over ``model``, and the
    collectives of its last step. A case: ``name``, ``trainee`` (kind,
    kwargs), ``mesh`` (make_mesh kwargs), ``spec`` (shard by param_spec),
    ``batches``, ``steps``, optional ``opt`` (make_optimizer kwargs,
    default :data:`OPT`) or ``sgd`` (an lr: plain SGD), ``trainer``
    (TrainerConfig kwargs; ``ckpt`` a directory name under the world's),
    ``resume_at`` (train to that step, then resume in a fresh trainer),
    ``export`` (a directory name: rank 0 exports the full parameters),
    ``evaluate`` (Trainer.evaluate with the trainee's eval_fn after the
    steps), ``batch_spec``."""
    from pathlib import Path

    from viquae_torch.core import mesh
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    out = {}
    for case in cases:
        ctx = mesh.make_mesh(device="cpu", **case["mesh"])
        kind, kw = case["trainee"]
        tt = make_trainee(kind, **kw)
        spec = trainee_spec(tt) if case.get("spec") else None
        trainer_kw = dict(case.get("trainer", {}))
        if "ckpt" in trainer_kw:
            trainer_kw["ckpt_dir"] = str(Path(tmp) / trainer_kw.pop("ckpt"))
        opt_kw = case.get("opt", OPT)
        opt = (SGD(case["sgd"]) if "sgd" in case
               else optim.make_optimizer(tt.params, **opt_kw))
        trainer = Trainer(tt.loss_fn, tt.params, opt,
                          TrainerConfig(max_steps=case["steps"], log_every=1,
                                        **trainer_kw),
                          mesh_ctx=ctx, param_spec=spec,
                          batch_spec=case.get("batch_spec"))
        steps, result = case["steps"], None
        if case.get("resume_at"):
            # train to resume_at, then a fresh trainer resumes to the end
            trainer.cfg.max_steps = case["resume_at"]
            trainer.fit(case["batches"])
            trainer = Trainer(tt.loss_fn, tt.params,
                              optim.make_optimizer(tt.params, **opt_kw),
                              TrainerConfig(max_steps=steps, log_every=1,
                                            **trainer_kw),
                              mesh_ctx=ctx, param_spec=spec)
            result = trainer.fit(case["batches"], resume=True)
        else:
            ctx.collective_log.clear()
            result = trainer.fit(case["batches"])
        res = _summary(trainer, result)
        if case.get("evaluate"):
            trainer.eval_fn = tt.eval_fn
            res["eval"] = trainer.evaluate(case["batches"])
        res["log"] = list(ctx.collective_log)
        res["route"] = mesh.collective_route(ctx)
        res["sizes"] = dict(ctx.sizes)
        if case.get("export") and ctx.rank == 0:
            tt.export(Path(tmp) / case["export"],
                      params=trainer.full_params())
        elif case.get("export"):
            trainer.full_params()
        out[case["name"]] = res
    return out


def encoder_program(rank, tmp, tree, ids, mask):
    """A BERT from a JAX tree on a data = 2 x model = 2 mesh: the
    tensor-parallel forward (the rows split over data), the
    sequence-parallel seam with replicated and with split weights (and
    their collectives), and the gradients of a summed output through the
    tensor- and sequence-parallel encoder, summed over ``data`` and
    gathered over ``model``."""
    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models import bert, sharding
    from viquae_torch.models.convert import params_from_jax

    cfg = bert.BertConfig(**{**TINY, "vocab_size": 99})
    full = params_from_jax(tree, cfg, device="cpu")
    ctx = mesh.make_mesh(data=2, model=2, device="cpu")
    split = sharding.shard_module(full, bert.param_spec(cfg), ctx)
    ids_t, mask_t = (mesh.split_rows(ctx, torch.from_numpy(a))
                     for a in (ids, mask))
    seam = (mesh.DATA_AXIS, mesh.MODEL_AXIS, None)
    back = dict(sharding.gather_module(split, ctx).named_parameters())
    out = {"rank": rank, "coords": dict(ctx.coords),
           "gathered_equal": list(back) == [n for n, _ in
                                            full.named_parameters()]
           and all(torch.equal(back[n], p)
                   for n, p in full.named_parameters())}
    with mesh.use(ctx):
        for name, module, kw in (("tp", split, {}),
                                 ("sp", full, {"activation_sharding": seam}),
                                 ("sp_tp", split,
                                  {"activation_sharding": seam})):
            ctx.collective_log.clear()
            with torch.no_grad():
                h = bert.apply(module, cfg, ids_t, mask_t,
                               **kw)["last_hidden_state"]
            out[name] = _np(mesh.gather_rows(ctx, h, len(ids)))
            out[f"{name}_log"] = list(ctx.collective_log)
        grads = {}
        for name, kw in (("tp", {}), ("sp_tp", {"activation_sharding":
                                                seam})):
            module = sharding.shard_module(full, bert.param_spec(cfg), ctx)
            h = bert.apply(module.requires_grad_(True), cfg, ids_t, mask_t,
                           **kw)["last_hidden_state"]
            weight = torch.linspace(-1, 1, h.shape[-1])
            (h.square() * weight).sum().backward()
            for p in module.parameters():
                p.grad = mesh.all_reduce(ctx, p.grad, mesh.DATA_AXIS)
            # the gradients as a full module: gather them like parameters
            with torch.no_grad():
                for p in module.parameters():
                    p.copy_(p.grad)
            grads[name] = {n: _np(p) for n, p in sharding.gather_module(
                module, ctx).named_parameters()}
        out["grads"] = grads
    return out


def moe_program(rank, tmp, tree, x, mask, configs):
    """ops/moe.py's expert parallelism on a data = 2 x model = 2 mesh:
    the experts of a MoE FFN from a JAX tree split over model, the tokens
    replicated (over data too: under the view that holds data whole); for
    each config (moe_apply kwargs) the output and aux, and the gradients
    of sum(w * y^2) + aux (experts gathered over model)."""
    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models import sharding
    from viquae_torch.models.convert import module_from_tree
    from viquae_torch.ops import moe

    ctx = mesh.make_mesh(data=2, model=2, device="cpu")
    dim, hidden = tree["in"]["kernel"].shape[1:]
    full = module_from_tree(moe.moe_init, dim, hidden,
                            len(tree["in"]["kernel"]), tree=tree,
                            device="cpu")
    out = {}
    with mesh.use(mesh.whole(ctx, mesh.DATA_AXIS)):
        for name, kw in configs.items():
            split = sharding.shard_module(full, moe.moe_spec(), ctx)
            split.requires_grad_(True)
            xt = torch.from_numpy(x).requires_grad_(True)
            y, aux = moe.moe_apply(split, xt, token_mask=torch.from_numpy(
                mask), **kw)
            weight = torch.linspace(-1, 1, y.shape[-1])
            ((y.square() * weight).sum() + aux).backward()
            with torch.no_grad():
                for p in split.parameters():
                    p.copy_(p.grad)
            out[name] = {"y": _np(y), "aux": float(aux.detach()), "x_grad": _np(
                xt.grad), "grads": {n: _np(p) for n, p in
                                    sharding.gather_module(
                                        split, ctx).named_parameters()},
                "log": list(ctx.collective_log)}
            ctx.collective_log.clear()
    return out


PROGRAMS = {"cases": cases_program, "encoder": encoder_program,
            "moe": moe_program}


# ---- pipeline parallelism (tests/test_torch_pipeline.py) ---------------------
# tests/test_pipeline.py's tiny config: 4 layers, hidden 16, 2 heads
PIPE_BERT = dict(vocab_size=97, hidden_size=16, num_hidden_layers=4,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32, add_pooler=False)
PIPE_LAYOUTS = ((1, 4, 8), (1, 4, 4), (2, 2, 2))   # (data, pipe, n_micro)


def pipe_config(**kw):
    from viquae_torch.models import bert

    return bert.BertConfig(**{**PIPE_BERT, **kw})


def staged_shard(tree, ctx, pipe):
    """A JAX staged BERT tree (``bert.pipeline_params`` of ``pipe``
    stages) as the port's staged module, this rank's stage kept
    (``pipeline_param_spec``), requiring grad."""
    from viquae_torch.models import bert, sharding
    from viquae_torch.models.convert import staged_from_jax

    cfg = pipe_config()
    return sharding.shard_module(
        staged_from_jax(tree, cfg, pipe, device="cpu"),
        bert.pipeline_param_spec(cfg, pipe), ctx).requires_grad_(True)


def _pipe_grads(ctx, shard, hidden, mask, tgt, n_micro, remat):
    """(loss, input gradient, per-layer parameter gradients) of
    mean((out - tgt)^2) through the pipelined encoder: each rank's
    gradients averaged over ``data`` (the trainer's mean), the stages'
    gathered over ``pipe`` into the per-layer names."""
    import copy

    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models import bert, sharding

    for p in shard.parameters():
        p.grad = None
    h = torch.from_numpy(hidden).requires_grad_(True)
    out = bert.encode_pipelined(shard, pipe_config(), h,
                                torch.from_numpy(mask), n_micro=n_micro,
                                mesh_ctx=ctx, remat_layers=remat)
    loss = torch.mean((out - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    gh = mesh.all_reduce(ctx, h.grad, mesh.DATA_AXIS, op="mean")
    # the gradients as a shard module, gathered like parameters
    grads = copy.deepcopy(shard)
    with torch.no_grad():
        for p, q in zip(grads.parameters(), shard.parameters()):
            p.copy_(torch.zeros_like(p) if q.grad is None else
                    mesh.all_reduce(ctx, q.grad, mesh.DATA_AXIS, op="mean"))
    named = dict(sharding.gather_module(grads, ctx).named_parameters())
    return float(loss), _np(gh), {n: _np(named[n]) for n in named
                                  if n.startswith("layers.")}


def pipeline_program(rank, tmp, trees, hidden, mask, seg, tgt, layouts):
    """tests/test_pipeline.py's encoder cases on every layout (data, pipe,
    n_micro) of this world, from ``trees[pipe]`` (the JAX staged tree of
    that many stages): the forward (padded mask and packed
    segments), the loss, the input and layer gradients with and without
    remat, dropout with seeds 0, 1, 0; the ring shift and the point-to-
    point calls over pipe; the collectives of one forward."""
    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models import bert, sharding

    cfg = pipe_config()
    out = {}
    for data, pipe, n_micro in layouts:
        ctx = mesh.make_mesh(data=data, pipe=pipe, device="cpu")
        shard = staged_shard(trees[pipe], ctx, pipe)
        res = {"coords": dict(ctx.coords),
               "held": shard.layers.held(),
               "axes": sorted(set(sharding.parameter_axes(shard).values()),
                              key=str)}
        h, m = torch.from_numpy(hidden), torch.from_numpy(mask)
        ctx.collective_log.clear()
        with torch.no_grad():
            res["forward"] = _np(bert.encode_pipelined(
                shard, cfg, h, m, n_micro=n_micro, mesh_ctx=ctx))
            res["forward_log"] = log_by_kind(ctx.collective_log)
            res["packed"] = _np(bert.encode_pipelined(
                shard, cfg, h, n_micro=n_micro, mesh_ctx=ctx,
                segment_ids=torch.from_numpy(seg)))
            res["dropout"] = [_np(bert.encode_pipelined(
                shard, cfg, h, m, n_micro=n_micro, mesh_ctx=ctx,
                deterministic=False,
                generator=torch.Generator().manual_seed(s)))
                for s in (0, 1, 0)]
        for remat in (False, True):
            res[f"grads_remat{int(remat)}"] = _pipe_grads(
                ctx, shard, hidden, mask, tgt, n_micro, remat)
        x = torch.full((3,), float(ctx.coordinate(mesh.PIPE_AXIS)))
        res["ring"] = _np(mesh.ring_shift(ctx, x, mesh.PIPE_AXIS))
        res["ring_back"] = _np(mesh.ring_shift(ctx, x, mesh.PIPE_AXIS, -1))
        c = ctx.coordinate(mesh.PIPE_AXIS)
        if c == 0:
            mesh.send_to(ctx, x + 10, mesh.PIPE_AXIS, pipe - 1)
        if c == pipe - 1:
            res["recv"] = _np(mesh.recv_from(ctx, x, mesh.PIPE_AXIS, 0))
        res["route"] = mesh.collective_route(ctx, p2p=True)
        out[(data, pipe, n_micro)] = res
    return out


def pp_loss_fn(cfg, n_micro=None, ctx=None, frozen_embeddings=False):
    """__graft_entry__.py's pp_loss: each tower's embeddings, the encoder
    (pipelined over ``ctx`` with ``n_micro`` microbatches, or sequential
    without), the CLS states and the in-batch biencoder loss.
    ``frozen_embeddings`` takes the embeddings without gradients (the
    encoder's input requires none)."""
    from viquae_torch.models import bert
    from viquae_torch.train import objectives

    def tower(p, ids, mask):
        x = bert.embed(p, cfg, ids)
        if frozen_embeddings:
            x = x.detach()
        if n_micro is None:
            return bert.encode(p, cfg, x, mask)[:, 0]
        return bert.encode_pipelined(p, cfg, x, mask, n_micro=n_micro,
                                     mesh_ctx=ctx)[:, 0]

    def loss_fn(params, batch, generator=None, deterministic=False):
        q = tower(params["question"], batch["q_ids"], batch["q_mask"])
        c = tower(params["context"], batch["c_ids"], batch["c_mask"])
        loss, _ = objectives.biencoder_loss(q, c, batch["labels"])
        return loss, {}

    return loss_fn


def towers_from_trees(trees, stages=None):
    """The question and context BERTs of two JAX trees (staged into
    ``stages`` when given) as one ``ModuleDict``."""
    from torch import nn

    from viquae_torch.models import bert
    from viquae_torch.models.convert import params_from_jax

    cfg = pipe_config()
    out = {}
    for name, tree in zip(("question", "context"), trees):
        m = params_from_jax(tree, cfg, device="cpu")
        out[name] = bert.pipeline_params(m, stages) if stages else m
    return nn.ModuleDict(out)


def pipeline_trainer_program(rank, tmp, trees, batches, steps, n_micro):
    """The pipelined biencoder on data = 2 x pipe = 2: ``steps`` AdamW
    steps (losses, grad norms, the per-layer parameters after them,
    replicated parameters bit-equal over pipe and data), the evaluation
    loss of the first batch after them, a checkpoint
    written at step 1 and a fresh trainer resuming from it (bit-equal
    state), the export of full_params, and the frozen-embedding variant
    (its stages move, its embeddings do not)."""
    import shutil
    from pathlib import Path

    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models import bert
    from viquae_torch.models.convert import tree_from_module
    from viquae_torch.train import checkpoint as ckpt_lib
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    cfg = pipe_config()
    ctx = mesh.make_mesh(data=2, pipe=2, device="cpu")
    spec = {n: bert.pipeline_param_spec(cfg, 2)
            for n in ("question", "context")}

    def trainer(frozen=False, **kw):
        params = towers_from_trees(trees, 2)
        return Trainer(pp_loss_fn(cfg, n_micro, ctx, frozen), params,
                       optim.make_optimizer(params, **OPT),
                       TrainerConfig(max_steps=steps, log_every=1, **kw),
                       mesh_ctx=ctx, param_spec=spec)

    ckpt = str(Path(tmp) / "pipe_ckpt")
    t = trainer(ckpt_dir=ckpt, ckpt_every=1)
    ctx.collective_log.clear()
    fit = t.fit(batches)
    res = _summary(t, fit)
    res["replicated_equal"] = replicated_equal(
        t, (mesh.DATA_AXIS, mesh.PIPE_AXIS))
    res["log"] = log_by_kind(ctx.collective_log)
    res["held"] = t.state.params["question"].layers.held()
    # evaluation: the forward schedule without a graph, the same
    # collectives on every rank
    res["eval_loss"] = t.evaluate(batches[:1])["loss"]
    res["ckpt_files"] = sorted(p.name for p in (Path(ckpt) / "step_1"
                                                ).iterdir())
    # a fresh trainer resumes from this rank's checkpoint of step 1
    resume_dir = Path(tmp) / "pipe_resume" / "step_1"
    resume_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(ckpt) / "step_1" / f"rank{ctx.rank}.pt", resume_dir)
    r = trainer(ckpt_dir=str(resume_dir.parent))
    r_fit = r.fit(batches, resume=True)
    res["resume_bit_equal"] = r.state.step == steps and all(
        torch.equal(p, q) for p, q in zip(
            t.state.params.parameters(), r.state.params.parameters()))
    res["resume_losses"] = [h["loss"] for h in r_fit["history"]
                            if "loss" in h]
    if ctx.rank == 0:
        full = t.full_params()
        for name in ("question", "context"):
            ckpt_lib.export_params(Path(tmp) / f"export_{name}",
                                   tree_from_module(full[name]))
    else:
        t.full_params()
    frozen = trainer(frozen=True)
    before = {n: p.detach().clone() for n, p in
              frozen.state.params.named_parameters()}
    frozen.fit(batches)
    res["frozen_moved"] = {
        n: not torch.equal(before[n], p) for n, p in
        frozen.state.params.named_parameters()}
    return res


PROGRAMS.update({"pipeline": pipeline_program,
                 "pipeline_trainer": pipeline_trainer_program})


# ---- MoE groups on split rows without gradients (test_torch_moe_mesh.py) ------
def moe_rows_program(rank, tmp, vocab, moe, batch, texts, short_texts,
                     max_length, row_len, straddle):
    """ops/moe.py on a data = 2 mesh of the world's two ranks, at a
    capacity where choices drop: ``Trainer.evaluate`` of an MoE DPR
    biencoder, the data-split ``TextEmbedder`` (last hidden states) and
    ``PackedTextEmbedder`` on the question tower (``texts``: each text one
    canvas row, the canvas pinned at one row a text; ``short_texts``:
    several texts a row, the canvas pinned at half the texts' count), each
    with ``moe`` (groups that are whole on each rank) and ``straddle`` (a
    global group spans the ranks: the error each call raised, with
    gradients and without)."""
    import torch
    from transformers import BertTokenizerFast

    from viquae_torch.core import mesh
    from viquae_torch.core.device import upload_batch
    from viquae_torch.ir.embedding import PackedTextEmbedder, TextEmbedder
    from viquae_torch.models import bert, dpr
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    ctx = mesh.make_mesh(data=2, device="cpu")
    tok = BertTokenizerFast(vocab_file=vocab)
    out = {}
    for name, kw in (("whole", moe), ("straddle", straddle)):
        tt = make_trainee("dpr", **kw)
        trainer = Trainer(tt.loss_fn, tt.params,
                          optim.make_optimizer(tt.params, **OPT),
                          TrainerConfig(max_steps=0), mesh_ctx=ctx)
        q = trainer.state.params["question"]
        cfg = tt.question_model.cfg
        text = TextEmbedder(lambda p, **a: bert.apply(p, cfg.bert, **a), q,
                            tok, output_key="last_hidden_state",
                            max_length=max_length, batch_size=len(texts),
                            device="cpu", mesh_ctx=ctx)

        def packed(rows, texts):
            return _np(PackedTextEmbedder(
                dpr.make_packed_apply(cfg), q, tok, row_len=row_len,
                batch_size=len(texts), compute_dtype=torch.float32,
                fixed_rows=rows, device="cpu", mesh_ctx=ctx,
            ).embed_texts(texts))

        calls = {"eval": lambda: trainer.evaluate([batch])["loss"],
                 "text": lambda: text.embed_texts(texts),
                 "packed": lambda: packed(len(texts), texts),
                 "packed_short": lambda: packed(len(short_texts) // 2,
                                                short_texts)}
        for call, fn in calls.items():
            try:
                out[(name, call)] = fn()
            except ValueError as e:
                out[(name, call)] = f"ValueError: {e}"
        if name == "straddle":      # with gradients, as in training
            dev = upload_batch(batch, torch.device("cpu"))
            try:
                with mesh.use(ctx):
                    tt.loss_fn(trainer.state.params, dev, None,
                               deterministic=True)
                out[(name, "grad")] = "ran"
            except ValueError as e:
                out[(name, "grad")] = f"ValueError: {e}"
    return out


PROGRAMS["moe_rows"] = moe_rows_program
