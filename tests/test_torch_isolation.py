"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (nor transformers, ml_dtypes or datasets, which the GPU machine
lacks), and owns a byte-identical copy of the native packer."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "viquae_tpu", "transformers", "ml_dtypes",
             "datasets")


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
             if m.split(".")[0] in {FORBIDDEN!r})
print(json.dumps({{"modules": names, "forbidden": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    for module in ("ops.mips_fused", "ops.fusion", "ir.serving",
                   "rankeval.compare"):
        assert f"viquae_torch.{module}" in res["modules"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {mod}")


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
