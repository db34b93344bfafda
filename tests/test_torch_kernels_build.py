"""The kernel build and binding layer (viquae_torch/kernels/build.py), on
any host: no nvcc and no GPU needed.

- ``_stale`` rebuilds a library when its ``.cu`` or any shared ``.cuh``
  header is newer than it (the two bf16 kernels share one mainloop
  header).
- Every ``extern "C"`` entry of ``csrc/*.cu`` has ctypes argtypes and a
  restype in ``_SIGNATURES`` of the same count and kinds: a mismatch would
  make ctypes cut a 64-bit pointer or integer without a word.
- The kernel wrappers' operand checks (``ops/mips_fused.py``
  ``_check_operands``: dtype pairs, d a multiple of one 16-byte vector,
  alignment, contiguity) and the arguments they hand to the C entry, with
  the launch stubbed and CPU tensors that claim to lie on the card.
"""
import ctypes
import os
import re

import pytest
import torch

from viquae_torch.kernels import build
from viquae_torch.ops import mips_fused


def _touch(path, mtime):
    path.write_text("// stub\n")
    os.utime(path, (mtime, mtime))


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A private csrc/ and build dir: a.cu, b.cu, shared.cuh, and liba.so
    built after all three."""
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    for name in ("a.cu", "b.cu", "shared.cuh"):
        _touch(csrc / name, 1_000_000)
    _touch(out / "liba.so", 1_000_100)
    return csrc, out


def test_stale_false_for_a_library_newer_than_its_sources(tree):
    assert not build._stale("a")


def test_stale_true_for_a_missing_library(tree):
    assert build._stale("b")


def test_stale_true_when_the_source_is_touched(tree):
    csrc, _ = tree
    _touch(csrc / "a.cu", 1_000_200)
    assert build._stale("a")


def test_stale_true_when_a_shared_header_is_touched(tree):
    csrc, _ = tree
    _touch(csrc / "shared.cuh", 1_000_200)
    assert build._stale("a")
    _touch(csrc / "new.cuh", 1_000_300)  # a header added later counts too
    _touch(csrc / "shared.cuh", 1_000_000)
    assert build._stale("a")


_C_ENTRY = re.compile(
    r"^(int|const char\s*\*)\s*(\w+)\s*\(([^)]*)\)\s*\{", re.MULTILINE)


def _kind(c_type: str) -> str:
    c_type = " ".join(c_type.split())
    if "*" in c_type:
        return "pointer"
    return {"int64_t": "int64", "int": "int"}[c_type.replace("const ", "")]


def _c_entries():
    """(library, entry, [argument kinds], return kind) of every function
    defined inside an ``extern "C"`` block of csrc/*.cu."""
    out = []
    for path in sorted(build.CSRC.glob("*.cu")):
        text = path.read_text()
        for block in text.split('extern "C" {')[1:]:
            for ret, name, args in _C_ENTRY.findall(block):
                # "const void* q": the type is all but the last word
                kinds = [_kind(re.sub(r"\w+$", "", a.strip()))
                         for a in args.split(",") if a.strip()]
                out.append((path.stem, name, kinds, _kind(ret)))
    return out


_CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_char_p: "pointer",
                ctypes.c_int64: "int64", ctypes.c_int: "int"}


def test_every_kernel_source_has_bound_entries():
    assert {lib for lib, *_ in _ENTRIES} == set(build._SIGNATURES)
    assert sorted(name for _, name, *_ in _ENTRIES) == sorted(
        fn for fns in build._SIGNATURES.values() for fn in fns)


_ENTRIES = _c_entries()


@pytest.mark.parametrize("lib,name,kinds,ret", _ENTRIES,
                         ids=[name for _, name, *_ in _ENTRIES])
def test_c_entry_matches_its_ctypes_signature(lib, name, kinds, ret):
    argtypes, restype = build._SIGNATURES[lib][name]
    assert [_CTYPES_KIND[t] for t in argtypes] == kinds
    assert _CTYPES_KIND[restype] == ret


# ---- the wrappers' operand checks, with the launch stubbed ----------------
class _OnCard:
    """A CPU tensor that says it lies on a CUDA device, so that a wrapper
    takes its kernel branch here; everything else is the tensor's own."""

    is_cuda = True

    def __init__(self, tensor):
        self._tensor = tensor

    def __getattr__(self, name):
        return getattr(self._tensor, name)


@pytest.fixture
def launched(monkeypatch):
    """Replaces the C call of the wrappers; returns the list of its calls."""
    calls = []
    monkeypatch.setattr(mips_fused, "_launch",
                        lambda *args: calls.append(args))
    return calls


def _operands(q_count, n, dim, dtype=torch.float32, kb_dtype=None):
    q = torch.zeros((q_count, dim), dtype=dtype)
    kb = torch.zeros((n, dim), dtype=kb_dtype or dtype)
    return _OnCard(q), _OnCard(kb)


@pytest.mark.parametrize("q_count,n,dim", [
    (1, 128, 4), (77, 256, 24), (130, 384, 40), (1257, 128, 768),
])
def test_b2_wrapper_passes_f32_operands_to_the_c_entry(launched, q_count, n,
                                                       dim):
    q, kb = _operands(q_count, n, dim)
    before = mips_fused.fused_score_segmax.launches
    scores_t, segmax_t = mips_fused.fused_score_segmax(q, kb)
    assert mips_fused.fused_score_segmax.launches == before + 1
    (lib, entry, *args), = launched
    assert (lib, entry) == ("score_segmax_kbmajor",
                            "score_segmax_kbmajor_launch")
    # (q, kb, scores_t, segmax_t, Q, N, d, is_f32): the stream is added by
    # _launch, and the kinds are those of _SIGNATURES
    assert args[0] is q and args[1] is kb
    assert args[2] is scores_t and args[3] is segmax_t
    assert args[4:] == [q_count, n, dim, 1]
    assert len(args) + 1 == len(build._SIGNATURES[lib][entry][0])
    assert scores_t.shape == (n, q_count) and scores_t.dtype == torch.float32
    assert segmax_t.shape == (n // 128, q_count)
    assert segmax_t.dtype == torch.float32


def test_b2_wrapper_marks_bf16_operands(launched):
    q, kb = _operands(8, 128, 16, torch.bfloat16)
    scores_t, _ = mips_fused.fused_score_segmax(q, kb)
    assert launched[0][-1] == 0 and scores_t.dtype == torch.bfloat16


def _shifted(rows, dim, dtype):
    """Contiguous, but one element past a 16-byte boundary."""
    return torch.zeros(rows * dim + 1, dtype=dtype)[1:].view(rows, dim)


@pytest.mark.parametrize("make,error,match", [
    (lambda: _operands(8, 128, 6), ValueError, "multiple of 4"),
    (lambda: _operands(8, 128, 12, torch.bfloat16), ValueError,
     "multiple of 8"),
    (lambda: _operands(8, 128, 8, torch.float32, torch.bfloat16), TypeError,
     "one dtype"),
    (lambda: _operands(8, 128, 8, torch.float16), TypeError, "one dtype"),
    (lambda: _operands(8, 128, 8, torch.float64), TypeError, "one dtype"),
    (lambda: _operands(8, 200, 8), ValueError, "multiple of 128"),
    (lambda: (_OnCard(torch.zeros((8, 8))), _OnCard(torch.zeros((128, 12)))),
     ValueError, "expected q"),
    (lambda: (_OnCard(torch.zeros((8, 8)).t().contiguous().t()),
              _OnCard(torch.zeros((128, 8)))), ValueError, "contiguous"),
    (lambda: (_OnCard(torch.zeros((8, 8))),
              _OnCard(_shifted(128, 8, torch.float32))), ValueError,
     "16-byte"),
    (lambda: (_OnCard(_shifted(8, 8, torch.float32)),
              _OnCard(torch.zeros((128, 8)))), ValueError, "16-byte"),
    (lambda: (torch.zeros((8, 8)), _OnCard(torch.zeros((128, 8)))),
     ValueError, "CUDA device"),
], ids=["f32-d6", "bf16-d12", "mixed", "f16", "f64", "ragged-n", "d-differs",
        "strided", "kb-off-16B", "q-off-16B", "q-on-cpu"])
def test_b2_wrapper_refuses_before_it_launches(launched, make, error, match):
    q, kb = make()
    before = mips_fused.fused_score_segmax.launches
    with pytest.raises(error, match=match):
        mips_fused.fused_score_segmax(q, kb)
    assert not launched
    assert mips_fused.fused_score_segmax.launches == before


def test_b1_wrapper_refuses_f32_operands(launched):
    q, kb = _operands(8, 128, 8)
    with pytest.raises(TypeError, match="one dtype"):
        mips_fused.fused_score_segmax_qmajor(q, kb, 128)
    assert not launched
