"""Build and load the port's host-side native code (ctypes over g++).

Counterpart of viquae_tpu/native/build.py for the sources the port owns
(``packer.cpp`` and ``bm25_scorer.cpp``, byte-identical copies of the JAX
package's). The shared library is compiled at first use next to its source
(mtime-checked; the ``_*.so`` files are git-ignored). Set
``VIQUAE_NO_NATIVE=1`` to force the pure-Python paths.
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


def _bm25_entry(name: str, term_ub: bool = False, n_threads: bool = False):
    """ctypes handle to one batch scorer of bm25_scorer.cpp, or None. The
    three entries share their arguments; the MaxScore ones take the terms'
    score upper bounds too, the threaded one a thread count."""
    lib = _load("bm25_scorer")
    if lib is None or not hasattr(lib, name):
        return None
    import numpy as np
    from numpy.ctypeslib import ndpointer

    def array(dtype):
        return ndpointer(dtype, flags="C_CONTIGUOUS")

    fn = getattr(lib, name)
    fn.restype = None
    fn.argtypes = [
        array(np.int64),    # offsets
        array(np.int32),    # docs
        array(np.float32),  # tfs
        array(np.float32),  # idf
        array(np.float32),  # norm
        *([array(np.float32)] if term_ub else []),  # term_ub
        ctypes.c_int64,     # n_docs
        array(np.int32),    # query_terms
        array(np.float32),  # query_tfs
        array(np.int64),    # query_offsets
        ctypes.c_int64,     # n_queries
        ctypes.c_int32,     # k
        array(np.float32),  # out_scores
        array(np.int32),    # out_indices
        array(np.int32),    # out_counts
        *([ctypes.c_int32] if n_threads else []),   # n_threads
    ]
    return fn


def load_bm25_scorer():
    """ctypes handle to bm25_score_batch, or None (fallback to numpy)."""
    return _bm25_entry("bm25_score_batch")


def load_bm25_maxscore():
    """ctypes handle to bm25_maxscore_batch (term-upper-bound pruning,
    rank-safe exact top-k), or None (fallback to the TAAT scorer)."""
    return _bm25_entry("bm25_maxscore_batch", term_ub=True)


def load_bm25_maxscore_mt():
    """ctypes handle to bm25_maxscore_batch_mt (the MaxScore scorer over a
    std::thread pool, strided query assignment), or None."""
    return _bm25_entry("bm25_maxscore_batch_mt", term_ub=True,
                       n_threads=True)


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
