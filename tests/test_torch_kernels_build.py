"""The kernel build and binding layer (viquae_torch/kernels/build.py), on
any host: no nvcc and no GPU needed.

- ``_stale`` rebuilds a library when its ``.cu`` or any shared ``.cuh``
  header is newer than it (the two bf16 kernels share one mainloop
  header).
- Every ``extern "C"`` entry of ``csrc/*.cu`` has ctypes argtypes and a
  restype in ``_SIGNATURES`` of the same count and kinds: a mismatch would
  make ctypes cut a 64-bit pointer or integer without a word.
"""
import ctypes
import os
import re

import pytest

from viquae_torch.kernels import build


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
