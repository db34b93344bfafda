"""The port's Trainer on a mesh (viquae_torch/train/{trainer,
data_parallel,checkpoint,optim}.py): the trainer cases of
tests/test_train.py that need the 8-device mesh, on one gloo world of 4
CPU processes (tests/torch_dist_helpers.py), against the port's one-device
trainer and the JAX Trainer on a JAX mesh of the same shape, on the same
weights (drawn by the port, converted to JAX trees) and batches.

Tolerances: losses and gradient global norms within 1e-4 relative over
AdamW steps (f32 sums in another order: the data split, the model
all-reduces; tests/test_torch_cli.py holds ``train fit`` to 1e-4 over 4
steps), 1e-5 relative at the first step; gradients through one SGD(1.0)
step (parameters after minus before) within 1e-4 relative and 1e-5
absolute, PR 9's parameter tolerance. Parameters after AdamW steps are not
held entry by entry here: Adam moves an entry whose gradient is rounding
noise (the attention key bias and the last LayerNorm bias of a context
tower, whose true gradients are 0) by ~lr either way.

Bit for bit: the replicated parameters on every ``model`` rank, a resume
on the same mesh against an uninterrupted run on every rank, and the
export of a mesh's parameters against one device's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_helpers as tdh
import torch_train_helpers as tth
from viquae_torch.core import mesh
from viquae_torch.models.convert import tree_from_module
from viquae_torch.train import data as tdata
from viquae_torch.train.trainer import Trainer, TrainerConfig
from viquae_tpu.core import mesh as jmesh
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.train import optim as joptim
from viquae_tpu.train import trainee as jtrainee
from viquae_tpu.train.trainer import Trainer as JTrainer
from viquae_tpu.train.trainer import TrainerConfig as JTrainerConfig

torch.set_num_threads(2)


def biencoder_batch(seed, n=8, m=2, length=12, ignore=()):
    """tests/test_train.py's biencoder batch in the trainee's layout:
    questions share their first tokens with passage m * i."""
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 50, (n, length))
    c = rng.integers(5, 50, (n * m, length))
    for i in range(n):
        c[m * i, :6] = q[i, :6]
    labels = (np.arange(n) * m).astype(np.int64)
    labels[list(ignore)] = -100
    return {"question_inputs": {"input_ids": q, "attention_mask":
                                np.ones((n, length), np.int64)},
            "context_inputs": {"input_ids": c, "attention_mask":
                               np.ones((n * m, length), np.int64)},
            "labels": labels}


def packed_items(n=16):
    """tests/test_train.py::test_grad_accum_packed_microbatched's items:
    lengths so different that the two microbatch canvases differ."""
    rng = np.random.default_rng(3)
    lens = np.concatenate([rng.integers(3, 6, n // 2),
                           rng.integers(20, 30, n // 2)])
    ids = np.zeros((n, 32), np.int64)
    mask = np.zeros((n, 32), np.int64)
    for i, ln in enumerate(lens):
        ids[i, :ln] = rng.integers(5, 50, ln)
        mask[i, :ln] = 1
    target = rng.normal(size=(n, 16)).astype(np.float32)
    return [{"ids": ids[i], "mask": mask[i], "target": target[i]}
            for i in range(n)]


def packed_collate(group):
    sub = {"input_ids": np.stack([it["ids"] for it in group]),
           "attention_mask": np.stack([it["mask"] for it in group])}
    return {**tdata.pack_text_inputs(sub, row_len=32),
            "target": np.stack([it["target"] for it in group])}


BATCHES = [biencoder_batch(s) for s in range(4)]
LOOP_OPT = dict(tth.OPT, lr=5e-3, total_steps=20)
DM = dict(data=2, model=2)
ITEMS = packed_items()
PACKED = {1: [packed_collate(ITEMS)],
          2: [tdata.microbatch_collate(packed_collate, 2)(ITEMS)]}
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
CASES = [
    dict(name="loop_dm", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=BATCHES, steps=8, opt=LOOP_OPT),
    dict(name="loop_d4", trainee=("dpr", {}), mesh=dict(data=4),
         batches=BATCHES, steps=8, opt=LOOP_OPT),
    dict(name="one_step", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=BATCHES[:1], steps=1),
    dict(name="sgd_d2", trainee=("dpr", {}), mesh=DM, batches=BATCHES[:1],
         steps=1, sgd=1.0),
    dict(name="sgd_dm", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=BATCHES[:1], steps=1, sgd=1.0),
    dict(name="ignore", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=[biencoder_batch(7, ignore=(0, 1, 2))], steps=1, sgd=1.0),
    dict(name="replicated", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=[biencoder_batch(8, n=3)], steps=1, sgd=1.0),
    dict(name="replicated_dropout", trainee=("dpr", dict(
        DROPOUT, **dict(tth.MOE, moe_capacity_factor=1.25),
        moe_group_size=16)),
        mesh=dict(data=4), batches=[biencoder_batch(8, n=3)], steps=1,
        sgd=1.0),
    dict(name="straight", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=BATCHES, steps=4),
    dict(name="resumed", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=BATCHES, steps=4, resume_at=2,
         trainer=dict(ckpt="resume", ckpt_every=2)),
    dict(name="export", trainee=("dpr", {}), mesh=DM, spec=True,
         batches=BATCHES, steps=0, export="export"),
    dict(name="packed_1", trainee=("regression", {}), mesh=DM, spec=True,
         batches=PACKED[1], steps=1, sgd=1.0),
    dict(name="packed_2", trainee=("regression", {}), mesh=DM, spec=True,
         batches=PACKED[2], steps=1, sgd=1.0,
         trainer=dict(grad_accum=2, microbatched=True)),
    dict(name="remat", trainee=("dpr", {"remat": True}), mesh=DM,
         spec=True, batches=BATCHES[:1], steps=1, sgd=1.0),
    dict(name="dropout_a", trainee=("dpr", DROPOUT), mesh=DM, spec=True,
         batches=BATCHES, steps=2),
    dict(name="dropout_b", trainee=("dpr", DROPOUT), mesh=DM, spec=True,
         batches=BATCHES, steps=2),
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's directory, each rank's results)."""
    tmp = tmp_path_factory.mktemp("steps")
    results = tdh.run_world("cases", 4, tmp, cases=CASES, timeout=120)
    return next(tmp.glob("world_cases_*")), results


def make(name):
    case = BY_NAME[name]
    kind, kw = case["trainee"]
    return tth.make_trainee(kind, **kw)


def one_device(name):
    """(trainer, fit result) of a case on one device, no mesh."""
    from viquae_torch.train import optim

    case = BY_NAME[name]
    tt = make(name)
    opt = (tth.SGD(case["sgd"]) if "sgd" in case else
           optim.make_optimizer(tt.params, **case.get("opt", tth.OPT)))
    return tth.train(tt, case["batches"], case["steps"], opt=opt,
                     trainer_kw={k: v for k, v in case.get(
                         "trainer", {}).items() if k != "ckpt"})


def jax_batches(batches):
    return [jax.tree.map(jnp.asarray, b) for b in batches]


def jax_trainer(name, tx, mesh_kw, spec=True, **config):
    """The JAX Trainer of a case on a JAX mesh of ``mesh_kw``'s shape on 4
    of the 8 virtual devices, from the port's weights: (history, final
    parameter tree)."""
    case = BY_NAME[name]
    tt = make(name)
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**tth.TINY))
    if case["trainee"][0] == "regression":
        params = jax.tree.map(jnp.asarray, tree_from_module(tt.params))

        def loss_fn(p, b, r):
            out = jdpr.apply_packed(
                p, jcfg, b["canvas_input_ids"], b["canvas_segment_ids"],
                b["canvas_position_ids"], b["canvas_cls_rows"],
                b["canvas_cls_cols"], deterministic=True,
            )[: b["target"].shape[0]]
            return jnp.mean((out - b["target"]) ** 2), {}
        jspec = jdpr.param_spec(jcfg)
    else:
        towers = [jdpr.DPREncoder(cfg=jcfg, params=jax.tree.map(
            jnp.asarray, tree_from_module(tt.params[tower])))
            for tower in ("question", "context")]
        jt = jtrainee.BiEncoderTrainee(*towers)
        params = jt.params

        def loss_fn(p, b, r):
            return jt.loss_fn(p, b, r, deterministic=True)
        jspec = {"question": jdpr.param_spec(jcfg),
                 "context": jdpr.param_spec(jcfg)}
    ctx = jmesh.make_mesh(devices=jax.devices()[:4], **mesh_kw)
    with jmesh.use(ctx):
        t = JTrainer(loss_fn, params, tx(params),
                     JTrainerConfig(max_steps=max(case["steps"], 1),
                                    log_every=1, **config),
                     mesh_ctx=ctx, param_spec=jspec if spec else None)
        out = t.fit(jax_batches(case["batches"]))
    return out["history"], t.state["params"]


def ranks(world, name):
    return [r[name] for r in world[1]]


def sgd_grads(name, params):
    """{name: gradient} of an SGD(1.0) step from a case's initial
    weights: the parameters before minus after."""
    start = dict(make(name).params.named_parameters())
    return {n: start[n].detach().numpy() - np.asarray(p)
            for n, p in params.items()}


def assert_grads_equal(got, ref, label=""):
    """Gradients within 1e-4 relative and 1e-5 absolute."""
    assert sorted(got) == sorted(ref)
    for n, g in ref.items():
        np.testing.assert_allclose(got[n], g, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{label} {n}")


def port_names_of_jax(tree, module) -> dict:
    """A JAX param tree's leaves under the port's parameter names, in the
    port's layouts (dense kernels transposed)."""
    from viquae_torch.models.convert import KERNEL_AXES, jax_paths

    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for name, path in jax_paths(module).items():
        a = flat[path]
        if path.endswith("kernel"):
            a = a.transpose(np.argsort(KERNEL_AXES[a.ndim]))
        out[name] = a
    return out


def test_train_loop_loss_decreases(world):
    """tests/test_train.py::test_train_loop_loss_decreases at data = 2 x
    model = 2 with the towers' param_spec, and at data = 4: the loss falls
    by a fifth in 8 steps, and each step's loss and gradient norm equal
    the one-device trainer's and the JAX Trainer's on a JAX mesh of the
    same shape (1e-5 at step 1, 1e-4 after)."""
    _, ref = one_device("loop_dm")
    ref_l = [h["loss"] for h in ref["history"]]
    ref_g = [h["grad_norm"] for h in ref["history"]]
    for name, mesh_kw, spec in (("loop_dm", DM, True),
                                ("loop_d4", dict(data=4), False)):
        for r in ranks(world, name):
            assert r["losses"][-1] < 0.8 * r["losses"][0], r["losses"]
            np.testing.assert_allclose(r["losses"][0], ref_l[0], rtol=1e-5)
            np.testing.assert_allclose(r["losses"], ref_l, rtol=1e-4)
            np.testing.assert_allclose(r["grad_norms"], ref_g, rtol=1e-4)
        hist, _ = jax_trainer(name, lambda p: joptim.make_optimizer(
            p, **LOOP_OPT), mesh_kw, spec)
        np.testing.assert_allclose(ranks(world, name)[0]["losses"],
                                   [h["loss"] for h in hist], rtol=1e-4)
        np.testing.assert_allclose(ranks(world, name)[0]["grad_norms"],
                                   [h["grad_norm"] for h in hist], rtol=1e-4)


def test_remat_layers_keep_working_under_the_mesh(world):
    """Per-layer remat (torch.utils.checkpoint) around the tensor-parallel
    layers, whose collectives run again in the recompute: one SGD(1.0)
    step equals one device's without remat."""
    trainer, _ = one_device("sgd_dm")
    ref = {n: p.detach().numpy() for n, p in
           trainer.state.params.named_parameters()}
    for r in ranks(world, "remat"):
        assert_grads_equal(sgd_grads("remat", r["params"]),
                           sgd_grads("sgd_dm", ref), "remat")
        assert r["replicated_equal"] is True


@pytest.mark.parametrize("name", ["sgd_d2", "sgd_dm"])
def test_data2_gradients_equal_one_device(world, name):
    """One SGD(1.0) step at data = 2 (replicated weights, and split over
    model by the param_spec): the gradient equals one device's and the JAX
    Trainer's on a data = 2 x model = 2 mesh, on every rank. The trainees
    gather their outputs with gather_from, whose backward sums the ranks'
    cotangents; the trainer averages over data: the scale is once."""
    trainer, _ = one_device(name)
    ref = {n: p.detach().numpy() for n, p in
           trainer.state.params.named_parameters()}
    grads = sgd_grads(name, ref)
    for r in ranks(world, name):
        assert_grads_equal(sgd_grads(name, r["params"]), grads, name)
    _, jparams = jax_trainer(name, lambda p: optax.sgd(1.0), DM,
                             spec=name == "sgd_dm")
    jgot = port_names_of_jax(jparams, trainer.state.params)
    assert_grads_equal(sgd_grads(name, jgot), grads, "jax")


def test_mean_with_unequal_ignore_index_counts_across_ranks(world):
    """Rank 0's rows hold three IGNORE_INDEX labels, rank 1's none: the
    loss is the mean over the 5 valid labels of the global batch (not a
    mean of the ranks' means), as one device computes it."""
    trainer, out = one_device("ignore")
    ref = {n: p.detach().numpy() for n, p in
           trainer.state.params.named_parameters()}
    for r in ranks(world, "ignore"):
        np.testing.assert_allclose(r["losses"], [out["history"][0]["loss"]],
                                   rtol=1e-5)
        assert_grads_equal(sgd_grads("ignore", r["params"]),
                           sgd_grads("ignore", ref))


def test_a_leaf_not_divisible_by_data_is_replicated_and_counted_once(world):
    """3 questions on data = 2: the batch is replicated, each rank computes
    the whole loss, and the gradient is one device's (not twice it)."""
    trainer, out = one_device("replicated")
    ref = {n: p.detach().numpy() for n, p in
           trainer.state.params.named_parameters()}
    for r in ranks(world, "replicated"):
        np.testing.assert_allclose(r["losses"], [out["history"][0]["loss"]],
                                   rtol=1e-5)
        assert_grads_equal(sgd_grads("replicated", r["params"]),
                           sgd_grads("replicated", ref))


def test_replicated_rows_run_as_on_one_device(world):
    """3 questions and 6 passages on data = 4: no leaf divides, so every
    rank computes every row, under the view of the mesh that holds data
    whole: the dropout masks are one device's (no data coordinate folded
    in) and the MoE layers group the tokens as one device does (at a
    capacity of 1.25, where choices drop; were the rows taken for a block
    of the global batch, the groups would not be whole and the layer would
    raise). The SGD(1.0) step equals one device's."""
    trainer, out = one_device("replicated_dropout")
    ref = {n: p.detach().numpy() for n, p in
           trainer.state.params.named_parameters()}
    for r in ranks(world, "replicated_dropout"):
        np.testing.assert_allclose(r["losses"], [out["history"][0]["loss"]],
                                   rtol=1e-5)
        assert_grads_equal(sgd_grads("replicated_dropout", r["params"]),
                           sgd_grads("replicated_dropout", ref))


@pytest.mark.parametrize("name", ["loop_dm", "straight", "resumed",
                                  "dropout_a"])
def test_replicated_parameters_stay_bit_equal_across_model_ranks(world,
                                                                  name):
    """After every case's steps, each replicated parameter (embeddings,
    LayerNorms, biases of the row-parallel layers) is bit-equal on both
    model ranks, and every rank gathered the same full parameters."""
    rs = ranks(world, name)
    for r in rs:
        assert r["replicated_equal"] is True
        for n, p in r["params"].items():
            assert np.array_equal(p, rs[0]["params"][n]), n


def test_checkpoint_resume(world):
    """tests/test_train.py::test_checkpoint_resume on data = 2 x model = 2:
    2 steps, a checkpoint per rank (step_2/rank<r>.pt), a fresh trainer
    resumed to 4 steps equals the uninterrupted 4-step run bit for bit on
    every rank: parameters and the last two losses."""
    tmp = world[0]
    files = sorted(p.name for p in (tmp / "resume" / "step_2").iterdir())
    assert files == [f"rank{r}.pt" for r in range(4)]
    state = torch.load(tmp / "resume" / "step_2" / "rank3.pt",
                       weights_only=True)
    assert state["mesh"]["sizes"]["model"] == 2 and state["step"] == 2
    for straight, resumed in zip(ranks(world, "straight"),
                                 ranks(world, "resumed")):
        assert resumed["losses"] == straight["losses"][2:]
        for n, p in straight["params"].items():
            assert np.array_equal(resumed["params"][n], p), n


def test_export_from_a_mesh_is_one_devices_file(world):
    """export_params from a data = 2 x model = 2 mesh (the shards gathered
    to rank 0, which alone writes) holds the arrays one device's export of
    the same weights holds, bit for bit and under the same names."""
    tmp = world[0]
    tt = make("export")
    tt.export(tmp / "one")
    for tower in ("question_model", "context_model"):
        with np.load(tmp / "export" / tower / "params.npz") as got, \
                np.load(tmp / "one" / tower / "params.npz") as ref:
            assert got.files == ref.files
            for k in ref.files:
                assert got[k].dtype == ref[k].dtype
                assert np.array_equal(got[k], ref[k]), k


def test_collective_bytes_per_step_match_their_contract(world):
    """One AdamW step of the data = 2 x model = 2 biencoder:
    - one data all-reduce of the gradients, as many bytes as the shard
      module's gradients, and one of the loss (4 bytes);
    - per tower and layer, two model all-reduces forward (after ``o`` and
      ``mlp.out``) and two backward (``copy_to`` of the attention and MLP
      inputs), each of the (rows / data, L, D) f32 activation;
    - per tower one data all-gather of the (N_local, D) pooled outputs for
      the in-batch negatives (logged as the gathered bytes), reduce-
      scattered back in the backward; the labels are the global batch's
      on every rank, so nothing else is gathered;
    - one scalar all-reduce over model, the global norm's (the trainer's,
      which the clipping reuses)."""
    from viquae_torch.models import sharding

    tt = make("one_step")
    split = {n for n, e in sharding.flatten_spec(
        tth.trainee_spec(tt)).items() if e is not None}
    shard_bytes = sum(p.numel() * 4 // (2 if n in split else 1)
                      for n, p in tt.params.named_parameters())
    b = BATCHES[0]
    n, length = b["question_inputs"]["input_ids"].shape
    nm = b["context_inputs"]["input_ids"].shape[0]
    dim, layers = tth.TINY["hidden_size"], tth.TINY["num_hidden_layers"]
    act = {"question": n // 2 * length * dim * 4,
           "context": nm // 2 * length * dim * 4}
    for r in ranks(world, "one_step"):
        log = tth.log_by_kind(r["log"])
        steps = 1
        assert sorted(log["all_reduce/data"]) == sorted(
            [shard_bytes, 4] * steps)
        model = [x for x in log["all_reduce/model"] if x > 4]
        assert sorted(model) == sorted(
            [act["question"], act["context"]] * 4 * layers * steps)
        assert len([x for x in log["all_reduce/model"] if x == 4]) == steps
        assert sorted(log["all_gather/data"]) == sorted(
            [n * dim * 4, nm * dim * 4] * steps)
        assert sorted(log["reduce_scatter/data"]) == sorted(
            [n * dim * 4, nm * dim * 4] * steps)
        assert r["route"] == "gloo"


def test_grad_accum_packed_microbatched(world):
    """tests/test_train.py::test_grad_accum_packed_microbatched on data =
    2 x model = 2: packed canvases split over data (each rank reads its
    sequences' CLS through pointers rebased to its rows), two microbatch
    canvases of different heights against one canvas of all 16 sequences;
    both equal one device's and the JAX Trainer's (accum 1 and 2 on a JAX
    mesh of the same shape) after one SGD(1.0) step (3e-5, the JAX test's
    tolerance)."""
    assert PACKED[2][0]["canvas_input_ids"].ndim == 3
    trainer, _ = one_device("packed_1")
    ref = {n: p.detach().numpy() for n, p in
           trainer.state.params.named_parameters()}
    for accum in (1, 2):
        _, jparams = jax_trainer(f"packed_{accum}", lambda p: optax.sgd(1.0),
                                 DM, grad_accum=accum,
                                 microbatched=accum > 1)
        jgot = port_names_of_jax(jparams, trainer.state.params)
        for r in ranks(world, f"packed_{accum}"):
            for n, p in ref.items():
                np.testing.assert_allclose(r["params"][n], p, rtol=3e-5,
                                           atol=3e-5, err_msg=n)
                np.testing.assert_allclose(r["params"][n], jgot[n],
                                           rtol=3e-5, atol=3e-5, err_msg=n)


def test_mesh_dropout_runs_is_seeded_and_stochastic(world):
    """tests/test_pipeline.py::test_dropout_runs_and_is_stochastic on the
    mesh: with dropout on, two runs from the same seed agree bit for bit,
    the losses are finite and differ from the dropout-free run's."""
    a, b = ranks(world, "dropout_a"), ranks(world, "dropout_b")
    plain = ranks(world, "straight")[0]["losses"][:2]
    for ra, rb in zip(a, b):
        assert ra["losses"] == rb["losses"]
        assert all(np.isfinite(ra["losses"]))
        assert ra["losses"] != plain


def test_shard_batch_keeps_rectangular_lists():
    """tests/test_train.py::test_shard_batch_keeps_rectangular_lists on a
    data = 2 mesh: the loss gets the whole global batch on every rank,
    rectangular numeric lists kept as arrays, strings and ragged lists
    dropped; a batch_spec in the reference's form is taken (every rank
    holds the whole batch), and an entry naming no mesh axis raises."""
    ctx = mesh.MeshContext({**{a: 1 for a in mesh.AXES}, "data": 2},
                           {**{a: 0 for a in mesh.AXES}, "data": 1})
    seen = {}

    def loss_fn(p, b, r):
        seen.update({k: tuple(v.shape) for k, v in b.items()})
        return torch.mean(p.w ** 2), dict(b)

    params = torch.nn.Module()
    params.w = torch.nn.Parameter(torch.ones(2))
    batch = {"labels": [[1, 2], [3, 4]], "answers": ["a", "b"],
             "ragged": [[1], [2, 3]], "ids": np.ones((8, 4), np.int32),
             "odd": np.arange(3)}
    for spec in (None, {"ids": (None,)}, {"ids": ("data", None)}):
        seen.clear()
        t = Trainer(loss_fn, params, tth.SGD(0.1),
                    TrainerConfig(max_steps=1, log_every=0), mesh_ctx=ctx,
                    batch_spec=spec)
        _, _, aux = t._train_step(batch, t.seeds.split("step0"))
        assert seen == {"labels": (2, 2), "ids": (8, 4), "odd": (3,)}
        np.testing.assert_array_equal(aux["labels"].numpy(),
                                      [[1, 2], [3, 4]])
    with pytest.raises(ValueError, match="mesh axes"):
        Trainer(loss_fn, params, tth.SGD(0.1), TrainerConfig(),
                mesh_ctx=ctx, batch_spec={"ids": ("rows",)})


def test_grad_accum_rejects_inbatch_labels():
    """tests/test_train.py::test_grad_accum_rejects_inbatch_labels with a
    data = 2 mesh: reshape-splitting in-batch labels is refused before any
    split or collective."""
    ctx = mesh.MeshContext({**{a: 1 for a in mesh.AXES}, "data": 2},
                           {a: 0 for a in mesh.AXES})
    tt = tth.make_trainee("dpr")
    t = Trainer(tt.loss_fn, tt.params, tth.SGD(0.1),
                TrainerConfig(max_steps=1, grad_accum=2, log_every=0),
                mesh_ctx=ctx)
    with pytest.raises(ValueError, match="in-batch `labels`"):
        t.fit([biencoder_batch(0)])
