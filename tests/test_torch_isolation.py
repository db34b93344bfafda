"""The PyTorch port stands alone: it never imports JAX, the JAX package,
ml_dtypes or JAX's training libraries (optax, orbax, flax); packages the GPU machine lacks (datasets, transformers, yaml,
PIL, safetensors, requests, sklearn, matplotlib, scipy) are imported only
inside the functions that need them;
and it owns a byte-identical copy of the native packer."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# never imported, anywhere in the port
FORBIDDEN = ("jax", "jaxlib", "viquae_tpu", "ml_dtypes", "optax", "orbax",
             "flax")
# imported only inside a function (the reference's runtime does the same):
# importing every port module must load none of them
LAZY_ONLY = ("datasets", "transformers", "yaml", "PIL", "safetensors",
             "requests", "sklearn", "matplotlib", "scipy")


def _port_sources():
    return sorted((ROOT / "viquae_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "kernel_probe.py",
        ROOT / "tests" / "torch_dist_helpers.py",
        ROOT / "tests" / "torch_train_helpers.py"]


def test_importing_every_port_module_loads_no_forbidden_package():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import viquae_torch
# built native libraries (_*.so) are not Python modules
names = [m.name for m in pkgutil.walk_packages(viquae_torch.__path__,
                                                "viquae_torch.")
         if not m.name.rsplit(".", 1)[-1].startswith("_")]
for name in names:
    importlib.import_module(name)
import chip_smoke, kernel_probe
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN + LAZY_ONLY!r})
print(json.dumps({{"modules": names, "forbidden": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    for module in ("ops.mips_fused", "ops.fusion", "ir.serving",
                   "rankeval.compare", "ir.search", "ir.qa_serving",
                   "models.qa", "ops.bm25", "data.loading", "core.config",
                   "ops.bm25_device", "ir.server", "ops.image",
                   "models.resnet", "models.clip", "models.arcface",
                   "models.mtcnn", "image.embedding", "image.face_detection",
                   "image.face_recognition", "image.face_box",
                   "image.resize", "models.mm", "models.dpr",
                   "train.checkpoint", "train.data", "interact.system",
                   "cli", "cli_aux", "core.prng", "models.rr",
                   "train.objectives", "train.optim", "train.prefetch",
                   "train.trainee", "train.trainer", "train.run",
                   "train.save_ptm", "train.callbacks", "models.vilt",
                   "models.bem", "models.ner", "data.evqa", "data.wiki",
                   "data.kilt2vqa", "ops.ivf", "ops.moe", "data.labelstudio",
                   "data.mscelebs", "data.wikidump", "data.wit", "viz",
                   "viz.html", "viz.projection", "viz.stats", "viz.umap",
                   "viz.wtl_filter", "core.mesh", "parallel",
                   "models.sharding", "train.data_parallel",
                   "ops.pipeline"):
        assert f"viquae_torch.{module}" in res["modules"]


def test_cli_help_runs_with_jax_blocked():
    """``python -m viquae_torch --help`` (``__main__``, the parser and the
    aux registration) runs where importing jax, the JAX package or
    ml_dtypes fails, and loads none of the lazy-only packages."""
    code = f"""
import importlib.abc, json, runpy, sys
sys.path.insert(0, {str(ROOT)!r})
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
sys.argv = ["viquae_torch", "--help"]
try:
    runpy.run_module("viquae_torch", run_name="__main__")
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN + LAZY_ONLY!r})
print(json.dumps({{"code": code, "forbidden": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "usage: viquae_torch" in out.stdout and "serve" in out.stdout
    res = json.loads(lines[-1])
    assert res == {"code": 0, "forbidden": []}


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, in_function):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            in_function = True
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {mod}")
            assert in_function or top not in LAZY_ONLY, (
                f"{path.name}:{node.lineno} imports {mod} at module level")
        for child in ast.iter_child_nodes(node):
            walk(child, in_function)

    walk(tree, False)


def test_lazy_rule_tells_a_module_level_import_from_one_in_a_function(
        tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("def f():\n    import yaml\n    return yaml\n")
    test_source_has_no_forbidden_import(ok)
    for text in ("import yaml\n", "class A:\n    from PIL import Image\n",
                 "def f():\n    import jax\n"):
        bad = tmp_path / "bad.py"
        bad.write_text(text)
        with pytest.raises(AssertionError):
            test_source_has_no_forbidden_import(bad)


def test_packer_source_is_byte_identical_copy():
    ours = (ROOT / "viquae_torch/native/packer.cpp").read_bytes()
    ref = (ROOT / "viquae_tpu/native/packer.cpp").read_bytes()
    assert ours == ref


def test_answer_span_matcher_source_is_byte_identical_copy():
    ours = (ROOT / "viquae_torch/native/answer_spans.cpp").read_bytes()
    ref = (ROOT / "viquae_tpu/native/answer_spans.cpp").read_bytes()
    assert ours == ref


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from viquae_torch.core import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_hybrid_parts_and_services_refuse_to_fall_back_to_cpu(monkeypatch):
    """DeviceBM25 resolves its device as every entry point does; the
    hybrid pipeline and the batched services own no device of their own:
    they run where their embedder and indexes were put, and those refuse
    the CPU unless it was named."""
    import numpy as np

    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.ir.serving import HybridRetrievalPipeline
    from viquae_torch.ops import bm25, mips
    from viquae_torch.ops.bm25_device import DeviceBM25

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = bm25.BM25Index.build(["a b c", "b c d"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBM25(host)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mips.DenseIndex(np.eye(4, dtype=np.float32), mode="global")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PackedTextEmbedder(None, None, None)
    sparse = DeviceBM25(host, q_block=4, device="cpu")
    index = mips.DenseIndex(np.eye(4, dtype=np.float32), mode="global",
                            device="cpu")
    pipe = HybridRetrievalPipeline(None, index, sparse, k=2)
    assert sparse.device == index.device == torch.device("cpu")
    assert pipe.k_bm25 == 2


def test_image_and_face_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """The towers' seeded inits, their JAX-tree loaders and the image and
    face stages resolve their device as every entry point does: the GPU,
    or the CPU when it is named."""
    from viquae_torch.image.embedding import ImageEmbedder
    from viquae_torch.image.face_detection import FaceDetector
    from viquae_torch.image.face_recognition import (FaceEmbedder,
                                                     FaceQueryEncoder)
    from viquae_torch.models import arcface, clip, mtcnn, resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = resnet.ResNetConfig(stage_sizes=(1,), width=8)
    for call in (lambda: resnet.init(small),
                 lambda: mtcnn.init(),
                 lambda: arcface.init(arcface.ArcFaceConfig(
                     stage_sizes=(1,), width=8, embedding_size=4)),
                 lambda: clip.CLIPTextTower(num_layers=1, vocab_size=10),
                 lambda: ImageEmbedder(None, None, "e"),
                 lambda: FaceDetector(None),
                 lambda: FaceEmbedder(None),
                 lambda: FaceQueryEncoder(None, None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = resnet.init(small, device="cpu")
    assert next(model.parameters()).device == torch.device("cpu")


def test_multimodal_and_cli_entry_points_refuse_to_fall_back_to_cpu(
        monkeypatch):
    """DPREncoder, the multimodal bundles, MMEmbedder, the reader and
    re-ranker inits and the training entry points (build_trainee,
    run_from_config) resolve their device as every entry point does, and
    so does the CLI's --device (``train``, ``save-ptm`` included)."""
    from viquae_torch.cli import parse_args
    from viquae_torch.ir.embedding import MMEmbedder
    from viquae_torch.models import dpr, mm, qa, rr
    from viquae_torch.train import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bert = {"vocab_size": 20, "hidden_size": 8, "num_hidden_layers": 1,
            "num_attention_heads": 2, "intermediate_size": 16,
            "max_position_embeddings": 16}
    for call in (lambda: dpr.DPREncoder(bert_config=bert),
                 lambda: mm.ECAEncoder(bert=bert, n_faces=0),
                 lambda: mm.IntermediateLinearFusion(bert=bert, n_faces=0),
                 lambda: MMEmbedder(None, None, None, None),
                 lambda: qa.init(qa.ReaderConfig()),
                 lambda: rr.bert_reranker_init(rr.BertReRankerConfig()),
                 lambda: run.build_trainee({"kind": "reader"}),
                 lambda: run.run_from_config("no-such-config.yaml")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for argv in (["hp", "config.json"], ["train", "fit", "c.yaml"],
                 ["save-ptm", "c.yaml", "out"]):
        with pytest.raises(SystemExit):
            parse_args(argv)
    assert parse_args(["--device", "cpu", "train", "fit", "c.yaml"]
                      ).device == torch.device("cpu")
    assert parse_args(["--device", "cpu", "hp", "c.json"]).device == \
        torch.device("cpu")
    bundle = mm.ECAEncoder(bert=bert, n_faces=0, device="cpu")
    assert next(bundle.params.parameters()).device == torch.device("cpu")


def test_auxiliary_models_and_commands_refuse_to_fall_back_to_cpu(
        monkeypatch, tmp_path):
    """The auxiliary models' seeded inits, BEMScorer and NeuralNER resolve
    their device as every entry point does, and so do the ``evqa`` and
    ``kilt2vqa ner`` commands through the CLI's --device: with no GPU and
    no device they raise and run nothing on the CPU."""
    from viquae_torch.cli import parse_args
    from viquae_torch.models import bem, bert, mm, ner, qa, rr, vilt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = bert.BertConfig(vocab_size=20, hidden_size=8,
                           num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=16, max_position_embeddings=16,
                           type_vocab_size=3)
    bem_cfg = bem.BEMConfig(bert=tiny, max_length=16)
    ner_cfg = ner.NERConfig(bert=tiny, num_labels=3,
                            id2label=("O", "B-PER", "I-PER"))
    mm_cfg = mm.MMConfig(bert=tiny, n_faces=0, image_dims=(("clip", 4),))
    vilt_cfg = vilt.ViltConfig(vocab_size=20, hidden_size=8, num_layers=1,
                               num_heads=2, intermediate_size=16,
                               image_size=32, patch_size=16)
    cpu_bem = bem.init(bem_cfg, device="cpu")
    cpu_ner = ner.init(ner_cfg, device="cpu")
    for call in (lambda: vilt.init(vilt_cfg),
                 lambda: vilt.reader_init(vilt_cfg),
                 lambda: bem.init(bem_cfg),
                 lambda: ner.init(ner_cfg),
                 lambda: rr.eca_reranker_init(mm_cfg),
                 lambda: qa.eca_reader_init(mm_cfg),
                 lambda: bem.BEMScorer(bem_cfg, cpu_bem, tokenizer=object()),
                 lambda: ner.NeuralNER(cpu_ner, ner_cfg, tokenizer=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    for argv in (["evqa", "p.json", "r.json", "--scorer", "bem",
                  "--config", "bem.json"],
                 ["kilt2vqa", "ner", "ds", "--config", "ner.json"]):
        with pytest.raises(SystemExit):
            parse_args(argv)
        assert parse_args(["--device", "cpu", *argv]).device == \
            torch.device("cpu")
    scorer = bem.BEMScorer(bem_cfg, cpu_bem, tokenizer=_Tok(), device="cpu")
    assert scorer.device == next(scorer.params.parameters()).device == \
        torch.device("cpu")


def test_ivf_index_and_moe_encoders_refuse_to_fall_back_to_cpu(
        monkeypatch, tmp_path):
    """IVFFlatIndex (built or loaded) and a Mixture-of-Experts encoder
    resolve their device as every entry point does: with no GPU and no
    device they raise; named, the CPU runs them."""
    import numpy as np

    from viquae_torch.models import bert, dpr
    from viquae_torch.ops.ivf import IVFFlatIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kb = np.random.default_rng(0).standard_normal((64, 8)).astype(
        np.float32)
    moe = dpr.DPRConfig(bert=bert.BertConfig(
        vocab_size=20, hidden_size=8, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=16,
        max_position_embeddings=16, moe_experts=2, moe_every=2))
    built = IVFFlatIndex(kb, nlist=4, device="cpu")
    built.save(tmp_path / "ivf")
    for call in (lambda: IVFFlatIndex(kb, nlist=4),
                 lambda: IVFFlatIndex.load(tmp_path / "ivf"),
                 lambda: dpr.DPREncoder(cfg=moe)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert IVFFlatIndex.load(tmp_path / "ivf", device="cpu").device == \
        torch.device("cpu")
    encoder = dpr.DPREncoder(cfg=moe, device="cpu")
    assert "moe_aux" in encoder(torch.ones((1, 4), dtype=torch.long))


class _Tok:
    """The one tokenizer method BEMScorer's constructor calls."""

    @staticmethod
    def convert_tokens_to_ids(tokens):
        return [2, 3]


# the pipeline's functions: what they run on a card stays on the card
PIPELINE_FUNCTIONS = {
    "viquae_torch/ops/pipeline.py": None,          # every function
    "viquae_torch/models/bert.py": ("pipeline_params", "pipeline_unstack",
                                    "pipeline_param_spec",
                                    "encode_pipelined"),
    "viquae_torch/core/mesh.py": ("_p2p", "send_to", "recv_from",
                                  "ring_shift", "broadcast"),
    "viquae_torch/models/sharding.py": ("_gather_stages",),
}


@pytest.mark.parametrize("path", sorted(PIPELINE_FUNCTIONS))
def test_pipelined_paths_move_nothing_to_the_cpu(path):
    """No pipelined path moves a stage, or the ring's tensors, to the CPU
    when the mesh names a card: no ``.cpu()`` / ``.numpy()`` / ``.item()``
    / ``.tolist()``, no "cpu" device. The one host copy is the explicit
    p2p staging under gloo (pinned buffers, ``core.mesh._p2p``), which
    ``collective_route(ctx, p2p=True)`` names."""
    names = PIPELINE_FUNCTIONS[path]
    tree = ast.parse((ROOT / path).read_text())
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and (names is None or n.name in names)]
    assert names is None or sorted({f.name for f in funcs}) == sorted(names)
    pinned = 0
    for func in funcs:
        for node in ast.walk(func):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("cpu", "numpy", "item", "tolist"), (
                    f"{path}:{node.lineno} {func.name} calls .{node.attr}")
            if isinstance(node, ast.Constant):
                assert node.value != "cpu", f"{path}:{node.lineno}"
            if isinstance(node, ast.keyword) and node.arg == "pin_memory":
                assert func.name == "_p2p", f"{path}:{node.lineno}"
                pinned += 1
    assert pinned == (2 if path.endswith("mesh.py") else 0)


def test_p2p_route_names_the_pinned_host_staging(tmp_path):
    """A gloo world whose device is a card: the collectives' route is
    gloo's own staging, the p2p calls' the pinned host copies of
    ``core.mesh``; under NCCL both are "nccl" (a world of one gloo rank
    here, the device named without touching a card)."""
    code = f"""
import dataclasses, json, sys, torch, torch.distributed as dist
sys.path.insert(0, {str(ROOT)!r})
from viquae_torch.core import mesh
dist.init_process_group("gloo", init_method="file://{tmp_path}/rdv",
                        rank=0, world_size=1)
ctx = mesh.make_mesh(device="cpu")
card = dataclasses.replace(ctx, device=torch.device("cuda", 0))
print(json.dumps([mesh.collective_route(ctx, p2p=True),
                  mesh.collective_route(card),
                  mesh.collective_route(card, p2p=True)]))
dist.destroy_process_group()
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "gloo", "gloo-cuda-staged", "gloo-cuda-pinned-host"]


def test_staged_modules_stay_on_their_device():
    """pipeline_params and the pipe shard copy modules where they lie (a
    card's stay on the card; meta tensors here): nothing is staged
    through the CPU."""
    from viquae_torch.core import mesh
    from viquae_torch.models import bert, sharding

    cfg = bert.BertConfig(vocab_size=20, hidden_size=8, num_hidden_layers=4,
                          num_attention_heads=2, intermediate_size=16,
                          max_position_embeddings=16)
    with torch.device("meta"):
        model = bert.Bert(cfg)
    staged = bert.pipeline_params(model, 2)
    ctx = mesh.MeshContext({**{a: 1 for a in mesh.AXES}, "pipe": 2},
                           {**{a: 0 for a in mesh.AXES}, "pipe": 1})
    shard = sharding.shard_module(staged, bert.pipeline_param_spec(cfg, 2),
                                  ctx)
    for module in (staged, shard):
        assert {p.device.type for p in module.parameters()} == {"meta"}
    assert shard.layers.held() == [1]
