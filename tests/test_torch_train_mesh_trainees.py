"""The port's trainees on a mesh (viquae_torch/train/trainee.py over
train/data_parallel.py, ops/moe.py's expert parallelism, train/run.py and
the command line under torchrun): the trainee cases of
tests/test_trainee.py and tests/test_moe.py that need the 8-device mesh and
the ECA and reader steps of __graft_entry__.py:152-243, on gloo worlds of
4 CPU processes (data = 2 x model = 2, each BERT split by its
``param_spec``), against the port's one-device step and the JAX Trainer
with the JAX trainee on a JAX mesh of the same shape, on the same weights
(drawn by the port, converted to JAX trees) and batches.

Each trainee gathers its per-sequence outputs over ``data`` before its
objective; the packed ones read the CLS / ``gather_idx`` positions of the
global canvas through pointers rebased to their rows. Tolerances: one
SGD(1.0) step's gradient (parameters before minus after) within 1e-4
relative and 1e-5 absolute of one device's and of the JAX Trainer's (PR 9's
parameter tolerance), the losses within 1e-5 relative; expert parallelism
alone bit for bit in its outputs (top_k 2 on model = 2: a token's two
terms are added once, in either order) and within 1e-4 / 1e-6 in its
gradients (tests/test_moe.py's tolerance).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_helpers as tdh
import torch_train_helpers as tth
from test_torch_cli import (biencoder_config, losses,  # noqa: F401
                            train_ws, write, ws)
from viquae_torch.models.convert import tree_from_module
from viquae_torch.train import data as tdata
from viquae_tpu.core import mesh as jmesh
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import mm as jmm
from viquae_tpu.models import qa as jqa
from viquae_tpu.ops import moe as jmoe
from viquae_tpu.train import trainee as jtrainee
from viquae_tpu.train.trainer import Trainer as JTrainer
from viquae_tpu.train.trainer import TrainerConfig as JTrainerConfig

torch.set_num_threads(2)
DM = dict(data=2, model=2)
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + [f"ent{i}" for i in range(20)] + [f"fact{i}" for i in range(20)]
         + ["question", "about", "passage", "the", "answer", "is",
            "sentence", "of", "doc"]
         + list("abcdefghijklmnopqrstuvwxyz0123456789")
         + [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz0123456789"])


def kb_items(n=4):
    """tests/test_torch_trainee.py's questions over a 12-passage KB."""
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


def ict_batch(tokenizer, packed, n=4):
    """tests/test_torch_trainee.py's ICT batch (a sample without a face)."""
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
            if i != 2:
                item[f"{prefix}face_embedding"] = [
                    rng.standard_normal(6).tolist()]
                item[f"{prefix}face_box"] = [rng.uniform(size=7).tolist()]
        items.append(item)
    return tdata.ICTCollator(
        tokenizer, M=2, max_length=16, seed=0, image_features=feats,
        sentences_per_target=2, packed=packed, text_mask_rate=0.5,
        image_mask_rate=0.5).collate_fn(items)


def clip_batch(n=4, joint=False):
    """tests/test_torch_trainee.py's CLIP batches: pixels, EOS-ended
    titles; with ``joint`` a DPR biencoder batch with context titles and
    the question / context pixels (JointBiEncoderAndClipTrainee)."""
    rng = np.random.default_rng(0)
    if joint:
        batch = {
            "question_inputs": {
                "input_ids": rng.integers(5, 120, (n, 8)),
                "attention_mask": np.ones((n, 8), np.int64)},
            "context_inputs": {
                "input_ids": rng.integers(5, 120, (2 * n, 8)),
                "attention_mask": np.ones((2 * n, 8), np.int64)},
            "labels": np.arange(n) * 2,
            "question_pixel_values": rng.standard_normal(
                (n, 16, 16, 3)).astype(np.float32),
            "context_pixel_values": rng.standard_normal(
                (2 * n, 16, 16, 3)).astype(np.float32)}
        titles = rng.integers(1, 118, (2 * n, 6))
        titles[:, 5] = 119
        batch["context_inputs"]["titles"] = {
            "input_ids": titles, "attention_mask": np.ones((2 * n, 6),
                                                           np.int64)}
        return batch
    ids = rng.integers(1, 118, (n, 6))
    ids[:, 4] = 119
    return {"pixel_values": rng.standard_normal((n, 16, 16, 3)).astype(
                np.float32),
            "paired_pixel_values": rng.standard_normal(
                (n, 16, 16, 3)).astype(np.float32),
            "text_inputs": {"input_ids": ids,
                            "attention_mask": np.ones((n, 6), np.int64)},
            "labels": np.arange(n)}


def reader_batch(n=2, m=2, length=10, answers=2):
    """__graft_entry__.py's reader batch with IR scores and answers."""
    rng = np.random.default_rng(0)
    return {
        "input_ids": rng.integers(5, 60, (n * m, length)).astype(np.int64),
        "attention_mask": np.ones((n * m, length), np.int64),
        "start_positions": rng.integers(1, length - 1, (n, m, answers)),
        "end_positions": rng.integers(1, length - 1, (n, m, answers)),
        "answer_mask": np.ones((n, m, answers), np.int64),
        "passage_scores": rng.uniform(1, 2, n * m).astype(np.float32),
        "answer_strings": [["ent7"]] * (n * m)}


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """The tokenizer, the batches and the world's results."""
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                            do_lower_case=True)
    kb, items = kb_items()
    bi_packed = tdata.BiEncoderCollator(tok, kb=kb, M=2, max_length=16,
                                        seed=0, packed=True).collate_fn(items)
    reader_packed = tdata.ReaderCollator(
        tok, kb=kb, M=2, n_relevant_passages=1, max_n_answers=2,
        max_length=24, packed=True, seed=0).collate_fn(items)
    vocab = str(d / "vocab.txt")
    reranker = tdata.ReRankerCollator(tok, kb=kb, M=2, max_length=24, seed=0,
                                      train=True, packed=True
                                      ).collate_fn(items)
    batches = {
        "bi_packed": bi_packed,
        "eca_padded": ict_batch(tok, packed=False),
        "eca_packed": ict_batch(tok, packed=True),
        "ict_packed": ict_batch(tok, packed=True),
        "reader_padded": reader_batch(),
        "reader_packed": reader_packed,
        "moe_packed": bi_packed,
        "moe_drops": bi_packed,
        "reranker_packed": reranker,
        "crossmodal": clip_batch(),
        "jcm": clip_batch(),
        "joint": clip_batch(joint=True),
    }
    trainees = {
        "bi_packed": ("dpr", {}), "eca_padded": ("eca", {}),
        "eca_packed": ("eca", {}), "ict_packed": ("ict", {}),
        "reader_padded": ("reader", {"fuse": True, "vocab": vocab}),
        "reader_packed": ("reader", {"vocab": vocab}),
        "moe_packed": ("dpr", dict(tth.MOE, moe_aux_weight=0.05)),
        "moe_drops": ("dpr", dict(tth.MOE, moe_aux_weight=0.05,
                                  moe_capacity_factor=1.25,
                                  moe_group_size=16)),
        "reranker_packed": ("reranker", {}), "crossmodal": ("crossmodal", {}),
        "jcm": ("jcm", {}), "joint": ("joint", {}),
    }
    cases = [dict(name=name, trainee=trainees[name], mesh=DM, spec=True,
                  batches=[b], steps=1, sgd=1.0,
                  evaluate=name.startswith("reader"))
             for name, b in batches.items()]
    cases.append(dict(name="moe_adamw", trainee=trainees["moe_packed"],
                      mesh=DM, spec=True, batches=[bi_packed], steps=3))
    res = tdh.run_world("cases", 4, tmp_path_factory.mktemp("trainees"),
                        cases=cases, timeout=120)
    return {"tok": tok, "batches": batches, "trainees": trainees,
            "ranks": res}


def one_device(setting, name, steps=1, sgd=1.0):
    from viquae_torch.train import optim

    kind, kw = setting["trainees"].get(name, setting["trainees"].get(
        name.replace("adamw", "packed")))
    tt = tth.make_trainee(kind, **kw)
    batch = setting["batches"].get(name, setting["batches"]["moe_packed"])
    opt = tth.SGD(sgd) if sgd else optim.make_optimizer(tt.params,
                                                        **tth.OPT)
    trainer, out = tth.train(tt, [batch], steps, opt=opt)
    return tt, trainer, out


def jax_params_of(tt):
    """(the JAX trainee of a port trainee on the port's weights, its
    PartitionSpec tree)."""
    from jax.sharding import PartitionSpec as P

    if hasattr(tt, "question_model"):
        towers = []
        for name in ("question", "context"):
            module = tt.params[name]
            cfg = getattr(tt, f"{name}_model").cfg
            tree = jax.tree.map(jnp.asarray, tree_from_module(module))
            if hasattr(cfg, "n_faces"):
                jcfg = jmm.MMConfig(bert=jbert.BertConfig(**vars(cfg.bert)),
                                    **{k: getattr(cfg, k) for k in (
                                        "n_faces", "face_dim", "bbox_dim",
                                        "image_dims", "gating")})
                towers.append(jmm.ECAEncoder(cfg=jcfg, params=tree))
            else:
                jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(
                    **vars(cfg.bert)))
                towers.append(jdpr.DPREncoder(cfg=jcfg, params=tree))
        jt = jtrainee.BiEncoderTrainee(*towers,
                                       moe_aux_weight=tt.moe_aux_weight)
        spec = {}
        for name, tower in zip(("question", "context"), towers):
            if isinstance(tower, jdpr.DPREncoder):
                spec[name] = jdpr.param_spec(tower.cfg)
            else:   # the BERT split, the visual heads replicated
                spec[name] = {**jax.tree.map(
                    lambda _: P(), jt.params[name]),
                    "bert": jbert.param_spec(tower.cfg.bert)}
        return jt, spec
    jcfg = jqa.ReaderConfig(bert=jbert.BertConfig(**vars(tt.cfg.bert)),
                            fuse_ir_score=tt.cfg.fuse_ir_score)
    jt = jtrainee.ReaderTrainee(jcfg, jax.tree.map(
        jnp.asarray, tree_from_module(tt.params)), tt.tokenizer,
        m_passages=tt.M)
    return jt, jqa.param_spec(jcfg)


def jax_step(setting, name, tt):
    """One JAX Trainer SGD(1.0) step on a data = 2 x model = 2 JAX mesh:
    (loss, parameters in the port's names and layouts)."""
    from viquae_torch.core.device import _is_host_only
    from viquae_torch.models.convert import KERNEL_AXES, jax_paths

    jt, spec = jax_params_of(tt)
    batch = setting["batches"][name]

    def to_jax(b):
        return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(
            np.asarray(v)) for k, v in b.items() if not _is_host_only(v)}

    ctx = jmesh.make_mesh(devices=jax.devices()[:4], **DM)
    with jmesh.use(ctx):
        t = JTrainer(lambda p, b, r: jt.loss_fn(p, b, r, deterministic=True),
                     jt.params, optax.sgd(1.0),
                     JTrainerConfig(max_steps=1, log_every=1), mesh_ctx=ctx,
                     param_spec=spec)
        out = t.fit([to_jax(batch)])
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                t.state["params"])[0]}
    got = {}
    for n, path in jax_paths(tt.params).items():
        a = flat[path]
        if path.endswith("kernel"):
            a = a.transpose(np.argsort(KERNEL_AXES[a.ndim]))
        got[n] = a
    return out["history"][0]["loss"], got


def grads_of(start, params):
    return {n: start[n] - np.asarray(p) for n, p in params.items()}


def assert_grads_equal(got, ref, label):
    assert sorted(got) == sorted(ref)
    for n, g in ref.items():
        np.testing.assert_allclose(got[n], g, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{label}: {n}")


def check_case(setting, name, with_jax=True):
    """The world's SGD(1.0) step of ``name`` against one device's (and the
    JAX Trainer's): losses within 1e-5, gradients as
    :func:`assert_grads_equal`; replicated parameters bit-equal over
    model."""
    tt, trainer, out = one_device(setting, name)
    start = {n: p.detach().numpy() for n, p in tth.make_trainee(
        *setting["trainees"][name][:1],
        **setting["trainees"][name][1]).params.named_parameters()}
    ref = grads_of(start, {n: p.detach().numpy() for n, p in
                           trainer.state.params.named_parameters()})
    loss = out["history"][0]["loss"]
    for r in setting["ranks"]:
        got = r[name]
        assert got["replicated_equal"] is True
        np.testing.assert_allclose(got["losses"], [loss], rtol=1e-5)
        assert_grads_equal(grads_of(start, got["params"]), ref, name)
    if with_jax:
        jloss, jparams = jax_step(setting, name, tt)
        np.testing.assert_allclose(jloss, loss, rtol=1e-5)
        assert_grads_equal(grads_of(start, jparams), ref, f"jax {name}")
    return tt, trainer


def test_biencoder_packed_training(setting):
    """tests/test_trainee.py::test_biencoder_packed_training on the mesh:
    a packed DPR biencoder batch (canvas rows split over data, CLS read
    through rebased pointers, in-batch negatives gathered)."""
    check_case(setting, "bi_packed")


@pytest.mark.parametrize("name", ["eca_padded", "eca_packed"])
def test_eca_step_on_the_mesh(setting, name):
    """__graft_entry__.py:152-205's ECA biencoder step under the dp x tp
    mesh, padded and packed (visual tokens scattered into this rank's
    canvas rows through rebased pointers, the others dropped)."""
    check_case(setting, name)


def test_ict_eca_question_with_text_only_context_on_the_mesh(setting):
    """configs/experiments/ict/eca.yaml's pairing (ROADMAP C7): the DPR
    context tower reads its canvas with the visual slots masked, through
    rebased pointers; the JAX trainee fails on this batch, so the step is
    held to one device's."""
    check_case(setting, "ict_packed", with_jax=False)


@pytest.mark.parametrize("name", ["reader_padded", "reader_packed"])
def test_reader_step_on_the_mesh(setting, name):
    """__graft_entry__.py:207-243's reader step (the global softmax over
    each question's M passages) under the dp x tp mesh with the reader's
    param_spec: padded with the IR-score fusion, and packed (gather_idx
    rebased to this rank's canvas rows)."""
    check_case(setting, name)


@pytest.mark.parametrize("name", ["reader_padded", "reader_packed"])
def test_reader_trainee_eval_fn_with_trainer(setting, name):
    """tests/test_trainee.py::test_reader_trainee_eval_fn_with_trainer on
    the mesh: Trainer.evaluate's exact_match / f1 and loss equal one
    device's."""
    tt, trainer, _ = one_device(setting, name)
    trainer.eval_fn = tt.eval_fn
    ref = trainer.evaluate([setting["batches"][name]])
    assert set(ref) >= {"loss", "exact_match", "f1"}
    for r in setting["ranks"]:
        got = r[name]["eval"]
        assert got["exact_match"] == ref["exact_match"]
        assert got["f1"] == pytest.approx(ref["f1"])
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)


@pytest.mark.parametrize("name", ["reranker_packed", "crossmodal", "jcm",
                                  "joint"])
def test_the_other_trainees_on_the_mesh(setting, name):
    """The re-ranker (packed: its CLS logits read through rebased
    pointers), CLIP's symmetric loss, the joint mono / cross-modal CLIP
    and the joint DPR + CLIP trainee on the mesh (their BERTs split, the
    CLIP towers replicated): one SGD step equals one device's, whose
    parity with the JAX trainees tests/test_torch_trainee.py holds."""
    check_case(setting, name, with_jax=False)


def test_moe_biencoder_packed_training(setting):
    """tests/test_trainee.py::test_moe_biencoder_packed_training on the
    mesh with moe_spec: 4 experts split 2 a model rank, the aux term on
    (its statistics summed over data: the global batch's, as JAX's
    program computes it); one SGD step against one device and JAX, and
    three AdamW steps' losses within 1e-5 of one device's."""
    check_case(setting, "moe_packed")
    _, _, out = one_device(setting, "moe_adamw", steps=3, sgd=None)
    for r in setting["ranks"]:
        np.testing.assert_allclose(r["moe_adamw"]["losses"],
                                   [h["loss"] for h in out["history"]],
                                   rtol=1e-5)
        assert r["moe_adamw"]["replicated_equal"] is True


def test_moe_drops_are_one_devices_on_split_rows(setting):
    """The hazard of budgeting a MoE layer's groups from a rank's own
    tokens: at a capacity factor of 1.25 (the configured one) choices
    drop, and which ones depends on the groups. The groups are the global
    batch's (16 tokens, one canvas row each, so every rank's rows are whole
    groups): one SGD step on data = 2 x model = 2 equals one device's and
    the JAX Trainer's on a JAX mesh. The drops are real: the loss differs
    from the same weights' at capacity 8, where nothing drops."""
    check_case(setting, "moe_drops")
    _, _, drops = one_device(setting, "moe_drops")
    _, _, ample = one_device(setting, "moe_packed")
    assert drops["history"][0]["loss"] != ample["history"][0]["loss"]


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    dim, hidden, n_exp = 16, 32, 4
    tree = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(8), dim,
                                                  hidden, n_experts=n_exp))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 8, dim)).astype(np.float32)
    mask = np.ones((4, 8), bool)
    mask[3, 5:] = False
    configs = {"ep": dict(top_k=2), "grouped": dict(top_k=2, group_size=8),
               "drops": dict(top_k=2, capacity_factor=0.5, group_size=8)}
    res = tdh.run_world("moe", 4, tmp_path_factory.mktemp("moe"), tree=tree,
                        x=x, mask=mask, configs=configs, timeout=120)
    return tree, x, mask, configs, res


@pytest.mark.parametrize("name", ["ep", "grouped", "drops"])
def test_expert_parallel_sharding_parity(moe_world, name):
    """tests/test_moe.py::test_expert_parallel_sharding_parity and
    ::test_grouped_expert_sharding_parity on the port: experts split over
    model = 2, tokens replicated, with groups and with tight capacity
    (drops): the output and aux equal one device's bit for bit, the
    gradients of sum(w * y^2) + aux within 1e-4 / 1e-6."""
    from viquae_torch.models.convert import module_from_tree
    from viquae_torch.ops import moe

    tree, x, mask, configs, res = moe_world
    full = module_from_tree(moe.moe_init, 16, 32, 4, tree=tree,
                            device="cpu").requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(full, xt, token_mask=torch.from_numpy(mask),
                           **configs[name])
    ((y.square() * torch.linspace(-1, 1, y.shape[-1])).sum()
     + aux).backward()
    for r in res:
        got = r[name]
        assert np.array_equal(got["y"], y.detach().numpy())
        assert got["aux"] == float(aux.detach())
        np.testing.assert_allclose(got["x_grad"], xt.grad.numpy(),
                                   rtol=1e-4, atol=1e-6)
        for n, p in full.named_parameters():
            np.testing.assert_allclose(got["grads"][n], p.grad.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)
        kinds = tth.log_by_kind(got["log"])
        assert kinds["all_reduce/model"][0] == y.numel() * 4


def test_moe_bert_ep_train_step(setting):
    """tests/test_moe.py::test_moe_bert_ep_train_step: the MoE BERT towers
    train under moe_spec on the mesh: finite losses that fall over three
    AdamW steps on the repeated batch (the first update has lr 0: one
    warmup step)."""
    for r in setting["ranks"]:
        losses_ = r["moe_adamw"]["losses"]
        assert all(np.isfinite(losses_)) and losses_[2] < losses_[0]
        assert r["moe_adamw"]["sizes"]["model"] == 2


def test_cli_train_fit_under_torchrun_matches_one_process(ws, train_ws,
                                                         tmp_path):
    """``torchrun --nproc-per-node 2 -m viquae_torch --device cpu train
    fit`` (gloo, every rank on data): the loss history equals one
    process's (1e-5), rank 0 alone writes the log, the export and the
    printed result, each rank writes its checkpoint shard, and the exported
    weights agree with one process's within twice the summed learning
    rates (Adam's step on a rounding-noise gradient)."""
    from viquae_torch.cli import main as tmain

    one = write(tmp_path / "one.json",
                biencoder_config(ws, train_ws, tmp_path / "one"))
    two = write(tmp_path / "two.json",
                biencoder_config(ws, train_ws, tmp_path / "two"))
    tmain(["--device", "cpu", "train", "fit", str(one)])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "viquae_torch", "--device", "cpu",
         "train", "fit", str(two)],
        capture_output=True, text=True, timeout=120, cwd=tdh.ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(tdh.ROOT)})
    assert out.returncode == 0, out.stderr[-4000:]
    printed = [ln for ln in out.stdout.splitlines()
               if ln.startswith("{'final_step'")]
    assert len(printed) == 1
    logged = [json.loads(ln) for ln in out.stdout.splitlines()
              if ln.startswith('{"step"')]
    assert [e["step"] for e in logged] == [1, 2, 3, 4]
    got, ref = losses(tmp_path / "two" / "ckpt"), losses(
        tmp_path / "one" / "ckpt")
    assert len(got) == len(ref) == 4
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "two" / "ckpt" /
                                   "step_4").iterdir()) == ["rank0.pt",
                                                            "rank1.pt"]
    # Adam moves an entry whose gradient is rounding noise by ~lr either
    # way: the exports agree within twice the summed learning rates
    from viquae_torch.train.optim import linear_warmup_schedule

    opt = biencoder_config(ws, train_ws, tmp_path)["optimizer"]
    schedule = linear_warmup_schedule(opt["lr"], opt["warmup_steps"],
                                      opt["total_steps"])
    bound = 2 * sum(schedule(step) for step in range(4))
    for name in ("question_model", "context_model"):
        with np.load(tmp_path / "two" / "export" / name / "params.npz") as a, \
                np.load(tmp_path / "one" / "export" / name /
                        "params.npz") as b:
            assert a.files == b.files
            for k in b.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=bound,
                                           err_msg=k)
