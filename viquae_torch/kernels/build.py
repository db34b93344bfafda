"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``viquae_torch/csrc/<name>.cu`` has a plain C interface and compiles on
its own into ``viquae_torch/kernels/_build/lib<name>.so`` (git-ignored) at
first use, for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

The ``.cu`` files share headers (``csrc/*.cuh``): a library is rebuilt
when its source or any header is newer. :func:`build_all` starts one nvcc
per source, all at once, and waits for them together. Nothing here runs
at import time, and the CPU paths of the port never call into it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "kernels" / "_build"

# every kernel library is built with these: Hopper only, a plain C interface
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}

# argtypes/restype of each library's C entry points
_SIGNATURES = {
    "score_segmax": {
        "score_segmax_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int),
        "score_segmax_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "score_segmax_kbmajor": {
        "score_segmax_kbmajor_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
        "score_segmax_kbmajor_error_string": ([ctypes.c_int],
                                              ctypes.c_char_p),
    },
    "segment_attention": {
        "segment_attention_launch": (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 9
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
        "segment_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "encoder_glue": {
        "bias_residual_layernorm_launch": (
            [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
            ctypes.c_int),
        "bias_gelu_launch": (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
            + [ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
        "encoder_glue_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether lib<name>.so is missing or older than its .cu or any
    shared header."""
    lib = _library(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _start(name: str, verbose: bool):
    """Start one nvcc into a private file; returns (process, tmp path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".lib{name}-",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build_all(names: Optional[List[str]] = None, force: bool = False,
              verbose: bool = False) -> Dict[str, str]:
    """Compile the given kernels (default: every ``csrc/*.cu``) that are
    missing or stale, or all of them with ``force``: one nvcc each, all
    started together. ``verbose`` adds ptxas's register and shared-memory
    report. Returns each built name's compiler output; raises if any build
    failed."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n, verbose) for n in names if force or _stale(n)}
    logs, failed = {}, []
    for name, (proc, tmp) in started.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, _library(name))
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_library(name)))
        for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[name] = lib
    return lib


def launch(name: str, fn: str, *args) -> None:
    """Call the C entry ``fn`` of library ``name`` on the current stream of
    the first tensor's device; raise on a non-zero cudaGetLastError()."""
    import torch

    lib = load(name)
    dev = args[0].device
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{getattr(lib, name + '_error_string')(err).decode()} "
            f"(code {err})")
