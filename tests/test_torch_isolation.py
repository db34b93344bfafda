"""The PyTorch port stands alone: it never imports JAX, the JAX package or
ml_dtypes; packages the GPU machine lacks (datasets, transformers, yaml,
PIL, safetensors) are imported only inside the functions that need them;
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
FORBIDDEN = ("jax", "jaxlib", "viquae_tpu", "ml_dtypes")
# imported only inside a function (the reference's runtime does the same):
# importing every port module must load none of them
LAZY_ONLY = ("datasets", "transformers", "yaml", "PIL", "safetensors")


def _port_sources():
    return sorted((ROOT / "viquae_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "kernel_probe.py"]


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
                   "image.resize"):
        assert f"viquae_torch.{module}" in res["modules"]


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
