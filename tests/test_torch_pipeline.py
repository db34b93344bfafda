"""Pipeline parallelism in the port (viquae_torch/ops/pipeline.py,
models/bert.py's staged encoder, core/mesh.py's ring, the Trainer on a
data x pipe mesh) against the JAX package (viquae_tpu/ops/pipeline.py,
bert.encode_pipelined, tests/test_pipeline.py).

A counterpart of each of tests/test_pipeline.py's cases at its tiny config
(4 layers, hidden 16, 2 heads, B 8, L 12 with a ragged tail), from the
JAX init's weights carried over through ``convert.staged_from_jax``. The
multi-rank cases run on gloo worlds of 4 CPU processes
(tests/torch_train_helpers.py ``pipeline_program`` and
``pipeline_trainer_program``) at (data, pipe, n_micro) = (1, 4, 8), the
reference's own, (1, 4, 4), which stands in for its (2, 4, 4) (the same
stage ring at 4 microbatches; ``data`` needs 8 ranks there), and
(2, 2, 2), which stands in for its (4, 2, 2) (data x pipe composed); each
is compared with the JAX function on a JAX mesh of the same shape.

Tolerances are the reference's: forward 2e-5 / 2e-5, input gradients
2e-5 / 2e-6, layer gradients 5e-5 / 1e-6, remat against no remat 2e-5 /
1e-7, the pipelined loss 1e-6 of the port's sequential one (and the
forward's 2e-5 of the JAX losses: the packages round the forward
apart). The Trainer's losses within 1e-5 of the JAX
Trainer's at the first step and 1e-4 over AdamW steps
(tests/test_torch_train_mesh_steps.py's tolerance); bit for bit: the
replicated parameters over ``pipe`` and ``data``, a resume from a stage
checkpoint, ``pipe = 1, n_micro = 1`` against ``bert.encode``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
import torch_train_helpers as tth
from viquae_torch.core import mesh
from viquae_torch.models import bert, convert, sharding
from viquae_torch.ops import pipeline as pl
from viquae_torch.train import optim
from viquae_tpu.core import mesh as jmesh
from viquae_tpu.models import bert as jbert
from viquae_tpu.ops import pipeline as jpl

torch.set_num_threads(1)
JCFG = jbert.BertConfig(**tth.PIPE_BERT)
CFG = tth.pipe_config()
LAYOUTS = tth.PIPE_LAYOUTS
IDS = ["data{}_pipe{}_micro{}".format(*layout) for layout in LAYOUTS]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """tests/test_pipeline.py's _setup: the JAX init, hidden states with a
    ragged tail, a target, and the packed segments."""
    rng = np.random.default_rng(0)
    params = jbert.init(jax.random.key(0), JCFG)
    hidden = rng.standard_normal((8, 12, 16)).astype(np.float32)
    mask = np.ones((8, 12), np.int32)
    mask[:, 9:] = 0
    seg = np.zeros((8, 12), np.int32)
    seg[:, :5] = 1
    seg[:, 5:9] = 2
    tgt = np.random.default_rng(1).standard_normal(
        hidden.shape).astype(np.float32)
    staged = {pipe: _np_tree(jbert.pipeline_params(params, pipe))
              for pipe in (1, 2, 4)}
    return dict(params=params, hidden=hidden, mask=mask, seg=seg, tgt=tgt,
                staged=staged)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    return tdh.run_world(
        "pipeline", 4, tmp_path_factory.mktemp("pipeline"),
        trees=setup["staged"], hidden=setup["hidden"], mask=setup["mask"],
        seg=setup["seg"], tgt=setup["tgt"], layouts=LAYOUTS)


def _jax_mesh(data, pipe):
    return jmesh.make_mesh(data=data, pipe=pipe,
                           devices=jax.devices()[: data * pipe])


def _ranks(world, layout):
    return [r[layout] for r in world]


# ---- no world -----------------------------------------------------------------
def test_stack_unstack_roundtrip(setup):
    """The port's modules into Stages and back (the same modules, layer
    s * per + j at stages[s][j]); the stacked arrays of the reference's
    stack_stages through the port's layout and back (bit-equal)."""
    model = convert.params_from_jax(_np_tree(setup["params"]), CFG,
                                    device="cpu")
    stages = pl.stack_stages(list(model.layers), 2)
    assert stages[1][0] is model.layers[2]
    assert list(pl.unstack_stages(stages)) == list(model.layers)
    tree = dict(_np_tree(setup["params"]))
    tree["layers"] = _np_tree(jpl.stack_stages(setup["params"]["layers"], 2))
    back = convert.staged_tree_from_module(
        convert.staged_from_jax(tree, CFG, 2, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back["layers"]),
                    jax.tree_util.tree_leaves(tree["layers"])):
        np.testing.assert_array_equal(a, b)


def test_stack_rejects_uneven_split(setup):
    model = convert.params_from_jax(_np_tree(setup["params"]), CFG,
                                    device="cpu")
    with pytest.raises(ValueError, match="equal stages"):
        pl.stack_stages(list(model.layers), 3)
    with pytest.raises(ValueError, match="equal stages"):
        bert.pipeline_params(model, 3)
    with pytest.raises(ValueError, match="not divisible"):
        pl.microbatch(torch.zeros(6, 2), 4)


def test_staged_tree_converts_both_ways(setup):
    """convert.staged_from_jax / staged_tree_from_module: the JAX staged
    tree in, the same tree out, and the port's staged module equal to
    pipeline_params of the per-layer module."""
    staged = convert.staged_from_jax(setup["staged"][2], CFG, 2,
                                     device="cpu")
    plain = bert.pipeline_params(convert.params_from_jax(
        _np_tree(setup["params"]), CFG, device="cpu"), 2)
    assert [n for n, _ in staged.named_parameters()] == [
        n for n, _ in plain.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(staged.parameters(),
                                                 plain.parameters()))
    back = convert.staged_tree_from_module(staged)
    ref = setup["staged"][2]
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        got = back
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(got, leaf)


def test_pipe1_one_microbatch_is_encode_bit_for_bit(setup):
    """Without a process group (pipe = 1), one microbatch: the output,
    the input gradient and every layer gradient equal bert.encode's bit
    for bit; at four microbatches the forward is per row (equal here) and
    the gradients within the reordering bound."""
    model = convert.params_from_jax(_np_tree(setup["params"]), CFG,
                                    device="cpu").requires_grad_(True)
    staged = bert.pipeline_params(model, 1)
    mask = torch.from_numpy(setup["mask"])
    tgt = torch.from_numpy(setup["tgt"])

    def run(encode):
        for p in list(model.parameters()) + list(staged.parameters()):
            p.grad = None
        h = torch.from_numpy(setup["hidden"]).requires_grad_(True)
        out = encode(h)
        torch.mean((out - tgt) ** 2).backward()
        params = staged if encode is not seq else model
        return out.detach(), h.grad, [p.grad for p in params.parameters()
                                      if p.grad is not None]

    def seq(h):
        return bert.encode(model, CFG, h, mask)

    ref = run(seq)
    for n_micro in (1, 4):
        got = run(lambda h: bert.encode_pipelined(staged, CFG, h, mask,
                                                  n_micro=n_micro))
        if n_micro == 1:
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1])
            assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
        else:
            np.testing.assert_allclose(got[0], ref[0], rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got[1], ref[1], rtol=2e-5, atol=2e-6)
            for a, b in zip(got[2], ref[2]):
                np.testing.assert_allclose(a, b, rtol=5e-5, atol=1e-6)


def test_moe_layers_are_refused():
    """The reference's guard: pp x ep is a non-goal."""
    cfg = tth.pipe_config(moe_experts=2)
    model = bert.pipeline_params(bert.Bert(cfg), 2)
    with pytest.raises(NotImplementedError, match="MoE"):
        bert.encode_pipelined(model, cfg, torch.zeros(4, 6, 16),
                              n_micro=2)


def test_staged_decay_and_freeze_masks_are_the_per_layer_ones(setup):
    """AdamW's masks match by JAX path: a staged module, and each shard
    holding one stage, gets the flags of the same tensors per layer."""
    model = convert.params_from_jax(_np_tree(setup["params"]), CFG,
                                    device="cpu")
    staged = bert.pipeline_params(model, 2)
    regex = r".*layers/(1|2)/.*"
    for mask in (optim.decay_mask, lambda m: optim.freeze_mask(m, regex)):
        ref = list(mask(model).values())
        assert list(mask(staged).values()) == ref
        assert sum(ref) not in (0, len(ref))
    paths = convert.jax_paths(staged)
    assert paths["layers.1.0.attention.q.weight"] == \
        "layers/2/attention/q/kernel"
    for coord in (0, 1):
        ctx = mesh.MeshContext({**{a: 1 for a in mesh.AXES}, "pipe": 2},
                               {**{a: 0 for a in mesh.AXES}, "pipe": coord})
        shard = sharding.shard_module(staged,
                                      bert.pipeline_param_spec(CFG, 2), ctx)
        assert shard.layers.held() == [coord]
        axes = sharding.parameter_axes(shard)
        assert {n for n, a in axes.items() if a == "pipe"} == {
            n for n in axes if n.startswith("layers.")}
        full_flags = dict(zip(convert.jax_paths(model).values(),
                              optim.freeze_mask(model, regex).values()))
        for name, flag in optim.freeze_mask(shard, regex).items():
            assert flag == full_flags[convert.jax_paths(shard)[name]]


# ---- the world: tests/test_pipeline.py's encoder cases ------------------------
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_forward_parity(setup, world, layout):
    """The pipelined forward on every rank equals the JAX pipelined
    forward on a JAX mesh of the layout's shape and the JAX sequential
    encoder (each rank held its own stage; the ring went both ways)."""
    data, pipe, n_micro = layout
    ref = np.asarray(jbert.encode(setup["params"], JCFG, setup["hidden"],
                                  setup["mask"]))
    ctx = _jax_mesh(data, pipe)
    with jmesh.use(ctx):
        jout = np.asarray(jax.jit(lambda p, h, m: jbert.encode_pipelined(
            p, JCFG, h, m, n_micro=n_micro, mesh_ctx=ctx))(
                jax.tree.map(jnp.asarray, setup["staged"][pipe]),
                setup["hidden"], setup["mask"]))
    for r in _ranks(world, layout):
        assert r["held"] == [r["coords"]["pipe"]]
        assert r["axes"] == [None, "pipe"]
        np.testing.assert_allclose(r["forward"], ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["forward"], jout, rtol=2e-5, atol=2e-5)
        c = r["coords"]["pipe"]
        np.testing.assert_array_equal(r["ring"], [(c - 1) % pipe] * 3)
        np.testing.assert_array_equal(r["ring_back"], [(c + 1) % pipe] * 3)
        if c == pipe - 1:
            np.testing.assert_array_equal(r["recv"], [10.0] * 3)
        assert r["route"] == "gloo"
    # one forward's collectives: each stage but the last sends each of
    # its microbatches on, the last broadcasts the outputs, data gathers
    mb_bytes = 8 // data // n_micro * 12 * 16 * 4
    for r in _ranks(world, layout):
        log = r["forward_log"]
        if r["coords"]["pipe"] < pipe - 1:
            assert log["send/pipe"] == [mb_bytes] * n_micro
        else:
            assert "send/pipe" not in log
        assert log["broadcast/pipe"] == [8 // data * 12 * 16 * 4]
        assert log.get("all_gather/data", []) == (
            [8 * 12 * 16 * 4] if data > 1 else [])


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_gradient_parity(setup, world, layout):
    """The loss, the input gradient and every layer's gradient through the
    pipelined backward (the reverse ring, the data gather's summed
    cotangent, the trainer's mean over data) against the JAX pipelined
    gradients on the same layout and the JAX sequential ones."""
    data, pipe, n_micro = layout
    params, mask = setup["params"], setup["mask"]
    tgt = jnp.asarray(setup["tgt"])

    def seq_loss(p, h):
        return jnp.mean((jbert.encode(p, JCFG, h, mask) - tgt) ** 2)

    ref_loss, (ref_gp, ref_gh) = jax.value_and_grad(
        seq_loss, argnums=(0, 1))(params, setup["hidden"])
    ctx = _jax_mesh(data, pipe)

    def pipe_loss(p, h):
        out = jbert.encode_pipelined(p, JCFG, h, mask, n_micro=n_micro,
                                     mesh_ctx=ctx)
        return jnp.mean((out - tgt) ** 2)

    with jmesh.use(ctx):
        jloss, (jgp, jgh) = jax.jit(jax.value_and_grad(
            pipe_loss, argnums=(0, 1)))(
                jax.tree.map(jnp.asarray, setup["staged"][pipe]),
                setup["hidden"])
    jlayers = jpl.unstack_stages(jgp["layers"])
    model = convert.params_from_jax(_np_tree(params), CFG, device="cpu")
    paths = convert.jax_paths(model)
    with torch.no_grad():
        port_loss = float(torch.mean((bert.encode(
            model, CFG, torch.from_numpy(setup["hidden"]),
            torch.from_numpy(mask)) - torch.from_numpy(setup["tgt"])) ** 2))
    for r in _ranks(world, layout):
        loss, gh, grads = r["grads_remat0"]
        # the reference's 1e-6 holds the pipelined loss to the sequential
        # one in one package; across the packages, the forward's 2e-5
        np.testing.assert_allclose(loss, port_loss, rtol=1e-6)
        np.testing.assert_allclose(loss, float(ref_loss), rtol=2e-5)
        np.testing.assert_allclose(loss, float(jloss), rtol=2e-5)
        np.testing.assert_allclose(gh, np.asarray(ref_gh), rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(gh, np.asarray(jgh), rtol=2e-5,
                                   atol=2e-6)
        assert len(grads) == 16 * CFG.num_hidden_layers
        for name, g in grads.items():
            _, i, *rest = paths[name].split("/")
            for tree in (ref_gp["layers"][int(i)], jlayers[int(i)]):
                leaf = tree
                for k in rest:
                    leaf = leaf[k]
                want = np.asarray(leaf)
                if rest[-1] == "kernel":
                    want = want.T
                np.testing.assert_allclose(g, want, rtol=5e-5, atol=1e-6,
                                           err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_gradient_parity_remat(world, layout):
    """remat_layers checkpoints each layer inside its stage: recomputed in
    the Function's inner backward under the forward's mesh, the same
    gradients as without."""
    for r in _ranks(world, layout):
        plain, remat = r["grads_remat0"], r["grads_remat1"]
        np.testing.assert_allclose(remat[1], plain[1], rtol=2e-5,
                                   atol=1e-7)
        for name, g in plain[2].items():
            np.testing.assert_allclose(remat[2][name], g, rtol=2e-5,
                                       atol=1e-7, err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_packed_segment_parity(setup, world, layout):
    """segment_ids (packed-canvas) mode pipelines as the sequential
    encoder: the block-diagonal bias built once, microbatched with the
    hidden states."""
    ref = np.asarray(jbert.encode(setup["params"], JCFG, setup["hidden"],
                                  segment_ids=setup["seg"]))
    for r in _ranks(world, layout):
        np.testing.assert_allclose(r["packed"], ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_dropout_runs_and_is_stochastic(world, layout):
    """Dropout seeds per (microbatch, global layer, site) from the step's
    generator: finite, seeded (seed 0 twice: the same bits) and stochastic
    (seed 1 differs), the same output on every rank."""
    ranks = _ranks(world, layout)
    for r in ranks:
        a, b, a2 = r["dropout"]
        assert np.isfinite(a).all()
        assert not np.allclose(a, b)
        np.testing.assert_array_equal(a, a2)
        np.testing.assert_array_equal(a, ranks[0]["dropout"][0])


# ---- the world: the Trainer on data = 2 x pipe = 2 ----------------------------
def pp_batch(seed, n=8, m=2, length=12):
    """__graft_entry__.py's pipelined biencoder batch: questions share
    their first tokens with passage m * i; a ragged question tail."""
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 90, (n, length))
    c = rng.integers(5, 90, (n * m, length))
    for i in range(n):
        c[m * i, :6] = q[i, :6]
    q_mask = np.ones((n, length), np.int64)
    q_mask[:, 10:] = 0
    return {"q_ids": q, "q_mask": q_mask, "c_ids": c,
            "c_mask": np.ones((n * m, length), np.int64),
            "labels": (np.arange(n) * m).astype(np.int64)}


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    """Two towers drawn at std 0.2 (the tiny towers' in-batch softmax is
    flat at BERT's 0.02), three batches, and the world's results."""
    trees = [convert.init_tree(CFG, seed, 0.2) for seed in (0, 1)]
    batches = [pp_batch(s) for s in range(3)]
    tmp = tmp_path_factory.mktemp("pipeline_trainer")
    res = tdh.run_world("pipeline_trainer", 4, tmp, trees=trees,
                        batches=batches, steps=3, n_micro=2)
    return dict(trees=trees, batches=batches, ranks=res, tmp=tmp)


def test_train_step_with_trainer(trainer_world):
    """tests/test_pipeline.py::test_train_step_with_trainer at data = 2 x
    pipe = 2: the pipelined biencoder takes 3 AdamW steps; the losses and
    grad norms equal one device's sequential Trainer and the losses the
    JAX Trainer's on a JAX (2, 2) mesh with pipeline_param_spec, and so
    does Trainer.evaluate after the steps (no graph kept); every rank
    reads the same numbers and ends with the same per-layer
    parameters (full_params), the replicated ones bit-equal over pipe and
    data throughout."""
    from viquae_torch.train.trainer import Trainer, TrainerConfig
    from viquae_tpu.train import objectives as jobj
    from viquae_tpu.train import optim as joptim
    from viquae_tpu.train.trainer import Trainer as JTrainer
    from viquae_tpu.train.trainer import TrainerConfig as JTrainerConfig

    trees, batches = trainer_world["trees"], trainer_world["batches"]
    params = tth.towers_from_trees(trees)
    one = Trainer(tth.pp_loss_fn(CFG), params,
                  optim.make_optimizer(params, **tth.OPT),
                  TrainerConfig(max_steps=3, log_every=1))
    hist = one.fit(batches)["history"]
    ref_eval = one.evaluate(batches[:1])["loss"]
    ref_l = [h["loss"] for h in hist]
    ref_g = [h["grad_norm"] for h in hist]

    ctx = _jax_mesh(2, 2)
    staged = {n: jbert.pipeline_params(jax.tree.map(jnp.asarray, t), 2)
              for n, t in zip(("question", "context"), trees)}
    spec = {n: jbert.pipeline_param_spec(JCFG, 2)
            for n in ("question", "context")}

    def pp_loss(p, b, _rng):
        def tower(tp, ids, mask):
            x = jbert.embed(tp, JCFG, ids)
            return jbert.encode_pipelined(tp, JCFG, x, mask, n_micro=2,
                                          mesh_ctx=ctx)[:, 0]
        return jobj.biencoder_loss(tower(p["question"], b["q_ids"],
                                         b["q_mask"]),
                                   tower(p["context"], b["c_ids"],
                                         b["c_mask"]), b["labels"])

    with jmesh.use(ctx):
        jt = JTrainer(pp_loss, staged,
                      joptim.make_optimizer(staged, **tth.OPT),
                      JTrainerConfig(max_steps=3, log_every=1),
                      mesh_ctx=ctx, param_spec=spec)
        jhist = jt.fit([jax.tree.map(jnp.asarray, b)
                        for b in batches])["history"]
    jl = [h["loss"] for h in jhist if "loss" in h]
    for r in trainer_world["ranks"]:
        np.testing.assert_allclose(r["losses"][0], ref_l[0], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], ref_l, rtol=1e-4)
        np.testing.assert_allclose(r["grad_norms"], ref_g, rtol=1e-4)
        np.testing.assert_allclose(r["losses"][0], jl[0], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-4)
        assert r["losses"] == trainer_world["ranks"][0]["losses"]
        np.testing.assert_allclose(r["eval_loss"], ref_eval, rtol=1e-4)
        assert r["eval_loss"] == trainer_world["ranks"][0]["eval_loss"]
        assert r["replicated_equal"] is True
        assert sorted(r["params"]) == sorted(
            n for n, _ in one.state.params.named_parameters())
        for n, p in r["params"].items():
            np.testing.assert_array_equal(
                p, trainer_world["ranks"][0]["params"][n])
    assert [r["held"] for r in trainer_world["ranks"]] == [[0], [1], [0],
                                                           [1]]


def test_stage_checkpoint_resumes_bit_for_bit(trainer_world):
    """Each rank writes its stage's shard (step_<n>/rank<r>.pt); a fresh
    trainer restoring step 1 reaches step 3 bit-equal to the
    uninterrupted run, with the same losses."""
    for r in trainer_world["ranks"]:
        assert r["ckpt_files"] == [f"rank{i}.pt" for i in range(4)]
        assert r["resume_bit_equal"] is True
        assert r["resume_losses"] == r["losses"][1:]


def test_export_of_full_params_is_the_per_layer_tree(trainer_world):
    """full_params gathers the stages back in global layer order: the
    export holds one device's params.npz names and the JAX package's
    per-layer tree layout."""
    from viquae_torch.train.checkpoint import import_params

    per_layer = _np_tree(jbert.init(jax.random.key(0), JCFG))
    for name in ("question", "context"):
        tree = import_params(trainer_world["tmp"].glob(
            f"world_pipeline_trainer_*/export_{name}").__next__())
        assert len(tree["layers"]) == CFG.num_hidden_layers
        assert jax.tree.structure(tree) == jax.tree.structure(per_layer)
        got = convert.params_from_jax(tree, CFG, device="cpu")
        want = dict(got.named_parameters())
        for n, p in trainer_world["ranks"][0]["params"].items():
            if n.startswith(name + "."):
                np.testing.assert_array_equal(
                    want[n[len(name) + 1:]].detach().numpy(), p)


def test_frozen_embeddings_still_train_the_stages(trainer_world):
    """Hazard: the pipelined Function's input requires no grad (the
    embeddings taken without gradients). Its anchor input still runs the
    backward schedule on every rank: every stage parameter moves, no
    embedding does."""
    for r in trainer_world["ranks"]:
        moved = r["frozen_moved"]
        assert moved and all(v == (".layers." in n) for n, v in
                             moved.items()), moved
