"""kernel_probe.py's source patches against the kernels in the tree, on any
host (no nvcc, no GPU): the probe times patched copies of
viquae_torch/csrc, so an edit to a kernel that a patch no longer fits must
fail here, not on the card.

- every patch's anchor text occurs exactly once in the file it patches;
- every variant of the shared header and of B2's f32 kernel builds its
  text, "full" being the source itself;
- the traced variants gain exactly one ``read_trace`` C entry;
- the FFMA microbenchmark's C entry has the argument kinds the probe binds.
"""
import ctypes
import re

import pytest

import kernel_probe as kp
from viquae_torch.kernels import build

_HEADER = (build.CSRC / kp.HEADER).read_text()
_KBMAJOR = (build.CSRC / "score_segmax_kbmajor.cu").read_text()

_HEADER_PATCHES = {
    "no_epilogue": kp.NO_EPILOGUE, "no_a_loads": kp.NO_A_LOADS,
    "trace_end": kp.TRACE_END,
    **{f"trace_{i}": pair for i, pair in enumerate(kp.TRACE)},
}
_F32_PATCHES = {
    "no_epilogue": kp.F32_NO_EPILOGUE, "ffma_only": kp.F32_FFMA_ONLY,
    "lds_only": kp.F32_LDS_ONLY,
    **{f"trace_{i}": pair for i, pair in enumerate(kp.F32_TRACE)},
}


@pytest.mark.parametrize("name", sorted(_HEADER_PATCHES))
def test_header_patch_anchor_occurs_exactly_once(name):
    old, new = _HEADER_PATCHES[name]
    assert _HEADER.count(old) == 1
    assert new != old


@pytest.mark.parametrize("name", sorted(_F32_PATCHES))
def test_f32_patch_anchor_occurs_exactly_once(name):
    old, new = _F32_PATCHES[name]
    assert _KBMAJOR.count(old) == 1
    assert new != old


@pytest.mark.parametrize("kind", kp.HEADER_KINDS)
def test_header_variant_applies(kind):
    text = kp.variant_header(kind)
    assert (text == _HEADER) == (kind == "full")
    # a traced header declares the buffer that read_trace copies out
    assert ("g_trace" in text) == kind.startswith("trace")
    if "no_epilogue" in kind:
        assert "Epilogue::store(acc" not in text


@pytest.mark.parametrize("kind", kp.F32_KINDS)
def test_f32_variant_applies(kind):
    text = kp.variant_f32_source(kind)
    assert (text == _KBMAJOR) == (kind == "full")
    assert text.count('extern "C" int read_trace(') == (kind == "trace")
    assert ("f32::g_trace" in text) == (kind == "trace")
    # the patches touch the f32 kernel only: the bf16 epilogue and the C
    # entry the wrapper calls stay as they are
    for kept in ("struct KbMajorEpilogue {",
                 "int score_segmax_kbmajor_launch("):
        assert text.count(kept) == 1


def test_f32_variants_drop_what_they_say():
    assert "epilogue(acc, red" not in kp.variant_f32_source("no_epilogue")
    assert "fma_fragment(acc, a[" not in kp.variant_f32_source("lds_only")
    assert "if (c == 0) load_fragment(" in kp.variant_f32_source("ffma_only")
    # four time stamps a tile
    assert kp.variant_f32_source("trace").count("clock64()") == 4


@pytest.mark.parametrize("count", [0, 2])
def test_patch_refuses_an_anchor_that_is_not_unique(count):
    with pytest.raises(RuntimeError, match="does not apply"):
        kp.patch("x " * count, "x ", "y ")
    assert kp.patch("a x b", "x", "y") == "a y b"


def test_every_f32_kind_is_handled_by_variant_f32_source():
    # an unknown kind would silently time the unpatched kernel
    handled = {"full", "no_epilogue", "ffma_only", "lds_only", "trace"}
    assert set(kp.F32_KINDS) == handled
    assert set(kp.KERNELS.values()) <= set(build._SIGNATURES)


def test_ffma_microbenchmark_entry_matches_its_argtypes():
    found = re.search(r'extern "C" int ffma_peak_launch\(([^)]*)\)',
                      kp.FFMA_PEAK)
    kinds = ["pointer" if "*" in arg else "int"
             for arg in found.group(1).split(",")]
    bound = ["pointer" if t is ctypes.c_void_p else "int"
             for t in kp.FFMA_PEAK_ARGTYPES]
    assert kinds == bound
