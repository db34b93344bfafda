"""Build and load the port's host-side native code (ctypes over g++).

Counterpart of viquae_tpu/native/build.py for the sources the port owns
(``packer.cpp``, a byte-identical copy of the JAX package's). The shared
library is compiled at first use next to its source (mtime-checked; the
``_*.so`` files are git-ignored). Set ``VIQUAE_NO_NATIVE=1`` to force the
pure-Python paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).parent
_CACHE: dict = {}


def _compile(source: Path, out: Path):
    # compile to a private name, then rename: concurrent first uses (test
    # workers) must never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".{out.stem}-",
                               dir=out.parent)
    os.close(fd)
    try:
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            "-pthread", str(source), "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(name: str) -> Optional[ctypes.CDLL]:
    if os.environ.get("VIQUAE_NO_NATIVE"):
        return None
    if name in _CACHE:
        return _CACHE[name]
    source = _HERE / f"{name}.cpp"
    out = _HERE / f"_{name}.so"
    try:
        if not out.exists() or out.stat().st_mtime < source.stat().st_mtime:
            _compile(source, out)
        lib = ctypes.CDLL(str(out))
    except (subprocess.CalledProcessError, OSError):
        lib = None
    _CACHE[name] = lib
    return lib


def load_packer():
    """ctypes handle to pack_sequences, or None (fallback to numpy)."""
    lib = _load("packer")
    if lib is None:
        return None
    import numpy as np
    from numpy.ctypeslib import ndpointer

    fn = lib.pack_sequences
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ndpointer(np.int32, flags="C_CONTIGUOUS"),    # tokens (concat)
        ndpointer(np.int64, flags="C_CONTIGUOUS"),    # offsets (n+1)
        ctypes.c_int64,                               # n_seqs
        ctypes.c_int64,                               # row_len
        ctypes.c_int64,                               # max_rows
        ndpointer(np.int32, flags="C_CONTIGUOUS"),    # input_ids
        ndpointer(np.int32, flags="C_CONTIGUOUS"),    # segment_ids
        ndpointer(np.int32, flags="C_CONTIGUOUS"),    # position_ids
        ndpointer(np.int32, flags="C_CONTIGUOUS"),    # cls_rows
        ndpointer(np.int32, flags="C_CONTIGUOUS"),    # cls_cols
        ndpointer(np.int64, flags="C_CONTIGUOUS"),    # rows_used_out
    ]
    return fn
