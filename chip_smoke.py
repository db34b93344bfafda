"""Drive the PyTorch port's retrieval and answer paths on one NVIDIA GPU and
hold every kernel on them against its plain PyTorch version.

    python3 chip_smoke.py

Needs one CUDA GPU, nvcc (the kernels are built from viquae_torch/csrc at
first use) and this checkout; no network, no JAX. Phases, each of which
raises on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source, one nvcc each, started together; fails if
   ptxas -v reports register spills or an ignored setmaxnreg;
3. kernel B1 vs plain: (a) integer-valued inputs at awkward shapes
   (INTEGER_SHAPES) must be bit-identical, (b) gaussian inputs at
   Q=1,280, d=768, N=262,144 must be >= 99.9 % bitwise equal and every
   score within the float32 reordering bound plus one bf16 ulp (see
   kernel_error);
4. kernel B2 (kb-major) vs plain, in bf16 and f32: (a) integer-valued
   inputs (INTEGER_SHAPES) bit-identical in scores_t and segmax_t,
   (b) gaussian inputs at Q=1,280, d=768, N=262,144: every score within
   the f32 reordering bound (plus one ulp and >= 99.9 % bitwise in bf16),
   every segment max within the bound (see kbmajor_error);
5. the main path at full width: DPR BERT-base (random weights from a seed,
   bf16), 1,257 lognormal-length questions packed into 64-token rows,
   FusedRetrievalPipeline over a DenseIndex(mode="fused") of 1.5M x 768
   bf16 rows, k=100; the native packer loaded, kernel launch counts, id
   range, >= 99.9 % id agreement with the same embeddings searched by the
   plain version, and the encoder's bf16 GEMMs within rtol = atol = 2e-2
   of the same forward on f32 products of the upcast operands;
6. B1 at the main path's shapes against its plain version and one library
   call;
7. topk_pallas (B2) on the main path's embeddings against the 1.5M fused
   index's matrix: one launch, and against the fused path's results
   scores within one bf16 ulp at every position and ids equal on
   >= 99.9 % of the positions above the k-th score's ties (see
   tie_aware_agreement); B2 at those shapes, and in f32 at 262,144 rows
   through topk_pallas against a full stable sort of the f32 scores;
8. serving in "global" mode as the JAX CLI builds it: FusedRetrievalPipeline
   .run over DenseIndex(mode="global") of 1.5M x 768 f32 rows; a Run of
   1,257 queries x 100 docs whose first 64 rows equal a full stable sort of
   the f32 scores on >= 99.9 % of positions;
9. StreamingDenseIndex over the fused KB in pinned bf16 chunks of 262,144
   rows: against the fused path's results as in phase 7, ms per batch and
   host->device GB/s;
10. late fusion at full width, dpr+arcface+clip+imagenet.json's four
   indexes (DPR fused 768, ImageNet-RN50 2048, CLIP-RN50 1024, ArcFace 512,
   1.5M rows each, bf16, L2norm for the image and face ones), weights
   [0.3, 0.2, 0.2, 0.2], gzmuv, 10 % faceless queries: one B1 launch per
   batch, and ids equal to fuse_topk over each index's search_device;
11. the kernel table: one JSON line with each kernel's launches on its
   path, error against the plain version, its time, the plain version's
   and one library call's, the least time the card could take, its
   design, its TFLOP/s and its fraction of the bound (bound_ms / ms);
   printed after phase 13;
12. the reader step at full width: Multi-passage BERT at BERT-base (random
   weights from a seed), 16 questions x 24 passages x 256 tokens, once
   padded and once packed at the pairs' real lengths; ms and samples/s of
   each, the packed canvas and its density; padded and packed spans agree
   in f32 and in bf16 (see span_agreement), and the bf16 logits are within
   rtol = atol = 2e-2 of the same forward on f32 products of the upcast
   operands;
13. the answer path: AnswerPipeline over phase 5's FusedRetrievalPipeline
   (1.5M x 768 bf16 KB, kernel B1, k=100) and a KB of pre-tokenized
   100-token passages, 256 questions, padded and packed (canvas pinned at
   the p99 row count): questions/s, the StageTimer report, one B1 launch
   per retrieval batch, passage ids equal to the retrieval's first 24,
   every answer the decoded span of one of its own rows, padded and packed
   answers agreeing by the span criterion; peak device memory.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from viquae_torch.core.profiling import StageTimer
from viquae_torch.ir.embedding import PackedTextEmbedder
from viquae_torch.ir.qa_serving import AnswerPipeline, span_probabilities
from viquae_torch.ir.serving import (FusedRetrievalPipeline,
                                     MultiIndexRetrievalPipeline)
from viquae_torch.kernels import build as kbuild
from viquae_torch.models import convert, dpr, layers, qa
from viquae_torch.native.build import load_packer
from viquae_torch.ops import mips, mips_fused, packing
from viquae_torch.ops.fusion import fuse_topk

# H100 SXM data-sheet peaks (dense bf16 tensor cores; non-tensor FP32;
# HBM3), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# the design of B1 and B2's bf16 path (viquae_torch/csrc/score_segmax_sm90.cuh)
DESIGN_SM90 = ("sm90 persistent, TMA ring 3 x (128+256) x 64, 1 producer + "
               "2 wgmma.m64n256k16 consumer warpgroups, 128 x 256 tiles")
# the design of B2's f32 path (viquae_torch/csrc/score_segmax_kbmajor.cu)
DESIGN_F32 = ("sm90 persistent FFMA (no TF32), TMA ring 4 x (128+128) x 32 "
              "K-major, 1 producer warpgroup + 8 consumer warps, 128 x 128 "
              "tiles, 8 x 8 a thread by LDS.128 along the depth")

# (Q, d, N) of the integer kernel-vs-plain checks
INTEGER_SHAPES = [(77, 64, 1024), (1257, 24, 1408)]
N_KB = 1_500_000
N_GAUSS = 262_144  # KB rows of the gaussian kernel-vs-plain check
DIM = 768
N_QUERIES = 1257
BATCH = 1280
ROW_LEN = 64
K = 100
STREAM_ROWS = 262_144
# dpr+arcface+clip+imagenet.json, in run-registration order: the text
# index, then the image and face indexes at their towers' widths
# (models/resnet.py, clip.py:199, arcface.py:27 of the JAX package)
FUSION_WIDTHS = {"imagenet-RN50": 2048, "clip-RN50": 1024, "arcface": 512}
FUSION_WEIGHTS = {"dpr": 0.3, "imagenet-RN50": 0.2, "clip-RN50": 0.2,
                  "arcface": 0.2}
# the reader's step: M passages a question, pair rows of READER_SEQ tokens,
# READER_QUESTIONS questions a step, passages of PASSAGE_TOKENS tokens
READER_M = 24
READER_SEQ = 256
READER_QUESTIONS = 16
PASSAGE_TOKENS = 100
N_ANSWER_QUERIES = 256
# two paths' spans agree when each one's span has, under the other's
# probabilities, a joint probability within this relative distance of the
# other's maximum (see span_agreement)
SPAN_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 ulps of two bf16 tensors."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def tie_aware_agreement(ids, scores, ref_ids, ref_scores) -> dict:
    """Two exact top-k results (host arrays, bf16-exact scores) against
    each other. At 1.5M bf16 scores a row's k-th value is often shared by
    several rows of the KB, and two exact selections may keep different
    duplicates of it (B1 ranks segments by their rounded maxima, B2 by the
    unrounded ones, a streamed merge by chunk): so positionwise scores must
    agree within one bf16 ulp everywhere, and ids wherever the reference
    score lies more than one ulp above the row's k-th score."""
    as_bf16 = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    ulps = ulp_distance(as_bf16(scores), as_bf16(ref_scores))
    kth = np.broadcast_to(ref_scores[:, -1:], ref_scores.shape)
    above = (ulp_distance(as_bf16(ref_scores), as_bf16(kth)) > 1).numpy()
    agree = ids == ref_ids
    return {"id_agreement": float(agree.mean()),
            "id_agreement_above_kth_tie": float(agree[above].mean()),
            "positions_above_kth_tie": float(above.mean()),
            "max_ulp_positionwise": int(ulps.max())}


def tie_aware_ok(agreement: dict) -> bool:
    return (agreement["id_agreement_above_kth_tie"] >= 0.999
            and agreement["max_ulp_positionwise"] <= 1)


def kernel_error(s, ps, q, kb, rows: int = 256) -> dict:
    """Kernel scores ``s`` against the plain version's ``ps`` (both bf16).

    The two f32 sums of the same d products, taken in different orders,
    differ by at most 2 g_d sum_i |q_i kb_i| (g_d = d u / (1 - d u),
    u = 2^-24, the classic bound for a float32 dot product); rounding each
    to bf16 adds at most one bf16 ulp of the larger value. Scores near zero
    come from cancellation and can be many ulps of their own tiny magnitude
    apart, so ulps alone are no criterion there. Row chunks bound memory."""
    d = q.shape[1]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    kb_abs = kb.float().abs()
    out = {"max_abs_err": 0.0, "max_ulp_err": 0, "bitwise_fraction": 0.0,
           "within_bound": True, "mask_equal": True}
    same = 0
    for i in range(0, q.shape[0], rows):
        a, b = s[i: i + rows], ps[i: i + rows]
        finite = torch.isfinite(b)
        out["mask_equal"] &= torch.equal(finite, torch.isfinite(a))
        af, bf = a.float(), b.float()
        diff = torch.where(finite, (af - bf).abs(), 0.0)
        mag = torch.where(finite, torch.maximum(af.abs(), bf.abs()), 0.0)
        ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
        bound = 2 * gamma * (q[i: i + rows].float().abs() @ kb_abs.T) + ulp
        out["within_bound"] &= bool((diff <= bound).all())
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        out["max_ulp_err"] = max(out["max_ulp_err"],
                                 int(ulp_distance(a, b).max()))
        same += int((a.view(torch.int16) == b.view(torch.int16)).sum())
    out["bitwise_fraction"] = same / s.numel()
    return out


def kbmajor_error(s, m, ps, pm, q, kb, rows: int = 16384) -> dict:
    """Kernel B2's scores_t (N, Q) and segmax_t (N/128, Q) against the
    plain version's, in chunks of KB rows.

    As in kernel_error, two f32 sums of the same d products differ by at
    most 2 g_d sum_i |q_i kb_i|; bf16 scores may add one bf16 ulp of the
    larger value by their rounding, f32 scores add nothing. The maxima are
    of the unrounded sums, so each lies within the largest bound of its
    segment."""
    d = q.shape[1]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    q_abs = q.float().abs()
    bf16 = s.dtype == torch.bfloat16
    bits = torch.int16 if bf16 else torch.int32
    out = {"max_abs_err": 0.0, "segmax_max_abs_err": 0.0,
           "bitwise_fraction": 0.0, "segmax_bitwise_fraction": 0.0,
           "within_bound": True, "segmax_within_bound": True}
    same = seg_same = 0
    for i in range(0, kb.shape[0], rows):
        a, b = s[i: i + rows].float(), ps[i: i + rows].float()
        bound = 2 * gamma * (kb[i: i + rows].float().abs() @ q_abs.T)
        diff = (a - b).abs()
        slack = 0.0
        if bf16:
            mag = torch.maximum(a.abs(), b.abs())
            slack = torch.ldexp(torch.ones_like(mag),
                                torch.frexp(mag).exponent - 8)
        out["within_bound"] &= bool((diff <= bound + slack).all())
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        seg = slice(i // 128, (i + a.shape[0]) // 128)
        seg_diff = (m[seg] - pm[seg]).abs()
        seg_bound = bound.view(-1, 128, bound.shape[1]).amax(dim=1)
        out["segmax_within_bound"] &= bool((seg_diff <= seg_bound).all())
        out["segmax_max_abs_err"] = max(out["segmax_max_abs_err"],
                                        float(seg_diff.max()))
        same += int((s[i: i + rows].view(bits)
                     == ps[i: i + rows].view(bits)).sum())
        seg_same += int((m[seg].view(torch.int32)
                         == pm[seg].view(torch.int32)).sum())
    out["bitwise_fraction"] = same / s.numel()
    out["segmax_bitwise_fraction"] = seg_same / m.numel()
    return out


def kbmajor_ok(err: dict, bf16: bool) -> bool:
    return (err["within_bound"] and err["segmax_within_bound"]
            and (err["bitwise_fraction"] >= 0.999 or not bf16))


def bound_ms(q_count, dim, n, itemsize, peak_flops, out_bytes) -> dict:
    """The least time the card could take: operations over the peak rate
    of their type, or each input read once and each output written once
    over the memory rate, whichever is larger."""
    flops = 2 * q_count * dim * n
    moved = (q_count + n) * dim * itemsize + out_bytes
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = moved / PEAK_HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": moved}


def achieved(bound: dict, kernel_ms: float) -> dict:
    """The kernel's rate and its share of the least time: bound_ms / ms."""
    return {"tflops": bound["flops"] / (kernel_ms / 1e3) / 1e12,
            "fraction_of_bound": bound["bound_ms"] / kernel_ms}


def gaussian(dev, rows, dim, dtype, seed, scale=1.0, block=1 << 18):
    """(rows, dim) gaussian values times ``scale`` in ``dtype``, drawn in
    f32 from ``seed`` in row blocks (no f32 copy of a wide bf16 KB)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((rows, dim), dtype=dtype, device=dev)
    for lo in range(0, rows, block):
        part = out[lo: lo + block]
        part.copy_(torch.randn(part.shape, generator=gen, device=dev) * scale)
    return out


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class WhitespaceTokenizer:
    """Minimal tokenizer with the HF call contract: words "w<j>" map to id
    j, wrapped in [CLS]=101 ... [SEP]=102 unless ``add_special_tokens`` is
    off, truncated to max_length; ``decode`` maps ids back to words."""

    cls_token_id, sep_token_id = 101, 102
    special_ids = frozenset((0, 101, 102))

    def __call__(self, texts, truncation=True, max_length=512,
                 add_special_tokens=True):
        room = max_length - 2 if add_special_tokens else max_length
        out = []
        for text in texts:
            ids = [int(w[1:]) for w in text.split()]
            if truncation:
                ids = ids[:room]
            if add_special_tokens:
                ids = [self.cls_token_id] + ids + [self.sep_token_id]
            out.append(ids)
        return {"input_ids": out}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(
            f"w{int(i)}" for i in ids
            if not (skip_special_tokens and int(i) in self.special_ids))


class SyntheticPassages:
    """A KB of ``n`` pre-tokenized passages that holds none of them: row
    ``i`` is ``{"passage_tokens": PASSAGE_TOKENS ids}`` drawn from
    ``(seed, i)`` when it is asked for."""

    def __init__(self, n: int, seed: int, length: int = PASSAGE_TOKENS,
                 vocab=(1000, 30_000)):
        self.n, self.seed, self.length, self.vocab = n, seed, length, vocab

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, int(i)))
        return {"passage_tokens": rng.integers(*self.vocab, self.length)}


def lognormal_questions(rng, n, lo=8, hi=ROW_LEN, special=2):
    """``n`` questions "w<j> ..." whose token counts, ``special`` tokens
    included, are lognormal(ln 18, 0.35) clipped to [lo, hi]."""
    lengths = np.clip(np.round(rng.lognormal(np.log(18.0), 0.35, n)),
                      lo, hi).astype(int)
    return [" ".join(f"w{j}" for j in rng.integers(1000, 10_000, m - special))
            for m in lengths]


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "assumed_peaks": {"bf16_flops": PEAK_BF16_FLOPS,
                            "hbm_bytes_per_s": PEAK_HBM_BYTES_PER_S,
                            "part": "H100 SXM data sheet, 700 W"}})
    return smi


def ptxas_faults(log: str) -> list:
    """What ptxas -v reports that the kernels must not have: register
    spills, and a setmaxnreg it ignored (the warp-role split of the Hopper
    mainloop would then run with the launch bound's registers)."""
    faults = [ln.strip() for ln in log.splitlines()
              if "setmaxnreg ignored" in ln]
    for stores, loads in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log):
        if int(stores) or int(loads):
            faults.append(f"{stores} bytes spill stores, {loads} bytes "
                          f"spill loads")
    return faults


def phase_build():
    start = time.perf_counter()
    logs = kbuild.build_all(force=True, verbose=True)
    seconds = time.perf_counter() - start
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "warning" in ln]
             for name, log in logs.items()}
    faults = {name: ptxas_faults(log) for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "kernels": sorted(logs), "ptxas": ptxas, "faults": faults})
    check(not any(faults.values()), f"ptxas reported {faults}")


def phase_kernel_vs_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    # (a) integer values in [-4, 4]: every f32 sum is exact; the second
    # shape has a ragged query edge against both tile widths, d below one
    # 64-deep stage and N = 5.5 tiles of 256 (the last one half empty)
    for q_count, dim, n in INTEGER_SHAPES:
        q = torch.randint(-4, 5, (q_count, dim), generator=gen,
                          device=dev).to(torch.bfloat16)
        kb = torch.randint(-4, 5, (n, dim), generator=gen, device=dev).to(
            torch.bfloat16)
        for valid in (n - 24, 0, n):
            s, m = mips_fused.fused_score_segmax_qmajor(q, kb, valid)
            ps, pm = mips_fused.fused_score_segmax_qmajor_plain(q, kb, valid)
            _, ids = mips_fused.topk_fused(q, kb, 50, valid_rows=valid)
            _, pids = mips_fused.segment_topk(ps, pm, 50)
            torch.cuda.synchronize()
            same = (torch.equal(s.view(torch.int16), ps.view(torch.int16)),
                    torch.equal(m.view(torch.int16), pm.view(torch.int16)),
                    torch.equal(ids, pids))
            emit({"phase": "kernel_vs_plain_integer",
                  "shape": [q_count, dim, n], "valid_rows": valid,
                  "scores_bitwise": same[0], "segmax_bitwise": same[1],
                  "topk_ids_equal": same[2]})
            check(all(same), f"integer inputs {[q_count, dim, n]}, "
                  f"valid_rows={valid}")
    # (b) gaussian at a wide shape
    q = torch.randn((BATCH, DIM), generator=gen, device=dev).to(
        torch.bfloat16)
    kb = (torch.randn((N_GAUSS, DIM), generator=gen, device=dev)
          / math.sqrt(DIM)).to(torch.bfloat16)
    s, m = mips_fused.fused_score_segmax_qmajor(q, kb, N_GAUSS - 77)
    ps, pm = mips_fused.fused_score_segmax_qmajor_plain(q, kb, N_GAUSS - 77)
    err = kernel_error(s, ps, q, kb)
    own_max = s.view(BATCH, -1, 128).amax(-1)
    segmax_own = torch.equal(m.view(torch.int16), own_max.view(torch.int16))
    emit({"phase": "kernel_vs_plain_gaussian",
          "shape": [BATCH, DIM, N_GAUSS], **err,
          "segmax_is_max_of_own_scores": segmax_own})
    check(err["mask_equal"] and err["within_bound"]
          and err["bitwise_fraction"] >= 0.999 and segmax_own,
          "gaussian inputs")


def phase_kbmajor_vs_plain(dev):
    """Kernel B2 against its plain version in both dtypes; returns the f32
    error at the gaussian shapes (the f32 row of the kernel table)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    ints = [(torch.randint(-4, 5, (q_count, dim), generator=gen, device=dev),
             torch.randint(-4, 5, (n, dim), generator=gen, device=dev))
            for q_count, dim, n in INTEGER_SHAPES]
    errors = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        # (a) integer values in [-4, 4]: every f32 sum is exact
        for q_int, kb_int in ints:
            q, kb = q_int.to(dtype), kb_int.to(dtype)
            s, m = mips_fused.fused_score_segmax(q, kb)
            ps, pm = mips_fused.fused_score_segmax_plain(q, kb)
            torch.cuda.synchronize()
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = (torch.equal(s.view(bits), ps.view(bits)),
                    torch.equal(m.view(torch.int32), pm.view(torch.int32)))
            shape = [q.shape[0], q.shape[1], kb.shape[0]]
            emit({"phase": "kbmajor_vs_plain_integer", "dtype": name,
                  "shape": shape, "scores_t_bitwise": same[0],
                  "segmax_t_bitwise": same[1]})
            check(all(same), f"B2 integer inputs {shape}, {name}")
        # (b) gaussian at a wide shape
        q = gaussian(dev, BATCH, DIM, dtype, seed=9)
        kb = gaussian(dev, N_GAUSS, DIM, dtype, seed=10,
                      scale=DIM ** -0.5)
        s, m = mips_fused.fused_score_segmax(q, kb)
        ps, pm = mips_fused.fused_score_segmax_plain(q, kb)
        err = kbmajor_error(s, m, ps, pm, q, kb)
        emit({"phase": "kbmajor_vs_plain_gaussian", "dtype": name,
              "shape": [BATCH, DIM, N_GAUSS], **err})
        check(kbmajor_ok(err, dtype == torch.bfloat16),
              f"B2 gaussian inputs, {name}")
        errors[name] = err
        del s, m, ps, pm, q, kb
        torch.cuda.empty_cache()
    return errors["float32"]


def phase_main_path(dev, cfg=dpr.DPRConfig()):
    """``cfg`` defaults to DPR BERT-base (no pooler)."""
    # the host pack time below is the native packer's, not the Python one's
    check(load_packer() is not None, "the native packer did not build")
    emit({"phase": "native_packer", "loaded": True})
    t0 = time.perf_counter()
    model = convert.params_from_jax(convert.init_tree(cfg, seed=0), cfg,
                                    device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    queries = lognormal_questions(rng, N_QUERIES)
    gen = torch.Generator(device=dev).manual_seed(1)
    kb = torch.randn((N_KB, DIM), generator=gen, device=dev,
                     dtype=torch.bfloat16) / math.sqrt(DIM)
    index = mips.DenseIndex(kb, mode="fused", device=dev)
    del kb
    embedder = PackedTextEmbedder(dpr.make_packed_apply(cfg), model,
                                  WhitespaceTokenizer(), row_len=ROW_LEN,
                                  batch_size=BATCH,
                                  compute_dtype=torch.bfloat16, device=dev)
    pipe = FusedRetrievalPipeline(embedder, index, batch_size=BATCH, k=K)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pipe.run_arrays(queries)  # warm-up: cuBLAS handles, allocator pools
    n_batches = -(-N_QUERIES // BATCH)

    mips_fused.fused_score_segmax_qmajor.launches = 0
    t0 = time.perf_counter()
    scores, ids = pipe.run_arrays(queries)
    first_s = time.perf_counter() - t0
    launches = mips_fused.fused_score_segmax_qmajor.launches
    check(launches == n_batches,
          f"score_segmax launched {launches} times for {n_batches} batches")
    walls = [first_s]
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.run_arrays(queries)
        walls.append(time.perf_counter() - t0)
    batch_ms = float(np.median(walls)) / n_batches * 1e3

    check(scores.shape == ids.shape == (N_QUERIES, K), "output shape")
    check(np.isfinite(scores).all(), "non-finite scores")
    check(ids.min() >= 0 and ids.max() < N_KB, "ids outside the KB")
    check((np.diff(scores, axis=1) <= 0).all(), "scores not descending")
    starts = range(0, N_QUERIES, BATCH)
    canvas_rows = [embedder.pack(queries[i: i + BATCH]).rows for i in starts]

    # the same embeddings through the plain version of the kernel
    q = torch.cat([embedder.embed_texts(queries[i: i + BATCH])[
        : min(BATCH, N_QUERIES - i)] for i in starts])
    check(bool(torch.isfinite(q).all()), "non-finite embeddings")
    qb = q.to(torch.bfloat16)
    _, k_i = mips_fused.topk_fused(qb, index.matrix, K, valid_rows=index.n)
    p_s, p_i = mips_fused.segment_topk(
        *mips_fused.fused_score_segmax_qmajor_plain(qb, index.matrix,
                                                    index.n), K)
    same_as_pipeline = bool(np.array_equal(k_i.cpu().numpy(), ids))
    agree = (p_i.cpu().numpy() == ids)
    differ = ~agree
    score_ulps = ulp_distance(p_s.to(torch.bfloat16),
                              torch.from_numpy(scores).to(dev).to(
                                  torch.bfloat16)).cpu().numpy()
    max_ulp_where_differ = int(score_ulps[differ].max()) if differ.any() else 0
    emit({"phase": "main_path", "model": {"hidden": cfg.bert.hidden_size,
                    "layers": cfg.bert.num_hidden_layers,
                    "vocab": cfg.bert.vocab_size, "weights": "bf16"},
          "queries": N_QUERIES, "batch": BATCH, "batches": n_batches,
          "canvas_rows": canvas_rows, "row_len": ROW_LEN,
          "kb_rows": index.n, "kb_rows_padded": index.matrix.shape[0],
          "k": K, "setup_s": round(setup_s, 3),
          "score_segmax_launches": launches,
          "batch_ms": batch_ms, "qps": N_QUERIES / (batch_ms / 1e3 * n_batches),
          "run_walls_s": walls, "kernel_search_equals_pipeline":
          same_as_pipeline,
          "plain_id_agreement": float(agree.mean()),
          "max_ulp_where_ids_differ": max_ulp_where_differ})
    check(agree.mean() >= 0.999, "id agreement with the plain version")
    check(max_ulp_where_differ <= 1, "scores where ids differ")
    check(same_as_pipeline, "pipeline ids differ from a direct search")

    # where one batch's time goes: host pack (host clock), then each device
    # stage alone (CUDA events); the kernel's own share is in phase 5
    first = queries[:BATCH]
    pack_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        packed = embedder.pack(first)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    canvas = embedder.upload(packed)
    q_full = embedder.forward(*canvas).to(torch.bfloat16)

    # the encoder's bf16 GEMMs (f32 results) against the same forward with
    # every dense product taken in f32 on the upcast operands (no TF32)
    got = embedder.forward(*canvas)[: len(first)]
    with mock.patch.object(layers, "_dot_f32", layers._dot_f32_upcast):
        ref = embedder.forward(*canvas)[: len(first)]
    diff = (got - ref).abs()
    close = bool(torch.isfinite(got).all()) and torch.allclose(
        got, ref, rtol=2e-2, atol=2e-2)
    emit({"phase": "encoder_bf16_gemm_vs_upcast", "queries": len(first),
          "max_abs_diff": float(diff.max()),
          "max_rel_diff": float((diff / ref.abs().clamp(min=1e-6)).max()),
          "mean_abs_diff": float(diff.mean()), "rtol_atol": 2e-2,
          "allclose": close})
    check(close, "encoder bf16 GEMMs against the f32 upcast")
    del got, ref, diff
    scored = mips_fused.fused_score_segmax_qmajor(q_full, index.matrix,
                                                  index.n)
    emit({"phase": "main_path_breakdown", "queries": len(first),
          "pack_host_ms": float(np.median(pack_ms)),
          "upload_ms": time_ms(lambda: embedder.upload(packed), reps=3),
          "encoder_ms": time_ms(lambda: embedder.forward(*canvas), reps=3),
          "search_ms": time_ms(lambda: mips_fused.topk_fused(
              q_full, index.matrix, K, valid_rows=index.n), reps=3),
          "select_ms": time_ms(lambda: mips_fused.segment_topk(*scored, K),
                               reps=3)})
    del scored

    # the encoder's device time by kernel, over one forward
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        embedder.forward(*canvas)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    emit({"phase": "encoder_profile",
          "device_ms": sum(e.device_time_total for e in events) / 1e3,
          "top": [{"kernel": e.key[:90], "calls": e.count,
                   "ms": e.device_time_total / 1e3} for e in events[:8]]})
    return {"index": index, "q": q_full, "launches": launches,
            "embedder": embedder, "queries": queries, "scores": scores,
            "ids": ids}


def phase_kernel_table(index, q, launches):
    """B1 at the main path's shapes: its kernel-table entry."""
    kb, nv = index.matrix, index.n
    q_count, n = q.shape[0], kb.shape[0]
    s, m = mips_fused.fused_score_segmax_qmajor(q, kb, nv)
    ps, pm = mips_fused.fused_score_segmax_qmajor_plain(q, kb, nv)
    err = kernel_error(s, ps, q, kb)
    emit({"phase": "kernel_vs_plain_main_shapes", **err})
    check(err["mask_equal"] and err["within_bound"]
          and err["bitwise_fraction"] >= 0.999,
          "kernel vs plain at the main-path shapes")
    del s, m, ps, pm
    torch.cuda.empty_cache()

    kernel_ms = time_ms(
        lambda: mips_fused.fused_score_segmax_qmajor(q, kb, nv),
        reps=10, warmup=2)
    plain_ms = time_ms(
        lambda: mips_fused.fused_score_segmax_qmajor_plain(q, kb, nv),
        reps=3)

    def library():
        scores = torch.matmul(q, kb.T)
        return scores.view(q_count, n // 128, 128).amax(-1)

    library_ms = time_ms(library, reps=5)
    bound = bound_ms(q_count, q.shape[1], n, 2, PEAK_BF16_FLOPS,
                     (q_count * n + q_count * (n // 128)) * 2)
    return {
        "name": "score_segmax",
        "route": "cuda",
        "source": "viquae_torch/csrc/score_segmax.cu",
        "replaces": "viquae_tpu/ops/mips_pallas.py:89",
        "design": DESIGN_SM90,
        "launches": launches,
        "max_abs_err": err["max_abs_err"],
        "max_ulp_err": err["max_ulp_err"],
        "bitwise_fraction": err["bitwise_fraction"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": library_ms,
        "shape": [q_count, q.shape[1], n],
        "flops": bound["flops"],
        "bytes": bound["bytes"],
        **achieved(bound, kernel_ms),
    }


def kbmajor_entry(q, kb, launches, err, path) -> dict:
    """Kernel B2's kernel-table entry at these shapes: its time, the plain
    version's, and one library call's (torch.matmul in the same dtype plus
    the 128-row amax)."""
    q_count, n = q.shape[0], kb.shape[0]
    kernel_ms = time_ms(lambda: mips_fused.fused_score_segmax(q, kb), reps=5)
    plain_ms = time_ms(lambda: mips_fused.fused_score_segmax_plain(q, kb),
                       reps=3)

    def library():
        scores_t = torch.matmul(kb, q.T)
        return scores_t, scores_t.view(n // 128, 128, q_count).amax(1)

    library_ms = time_ms(library, reps=5)
    bf16 = q.dtype == torch.bfloat16
    itemsize = q.element_size()
    bound = bound_ms(q_count, q.shape[1], n, itemsize,
                     PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS,
                     n * q_count * itemsize + (n // 128) * q_count * 4)
    return {
        "name": "score_segmax_kbmajor",
        "route": "cuda",
        "source": "viquae_torch/csrc/score_segmax_kbmajor.cu",
        "replaces": "viquae_tpu/ops/mips_pallas.py:258",
        "design": DESIGN_SM90 if bf16 else DESIGN_F32,
        "dtype": str(q.dtype).removeprefix("torch."),
        "path": path,
        "launches": launches,
        "max_abs_err": err["max_abs_err"],
        "segmax_max_abs_err": err["segmax_max_abs_err"],
        "bitwise_fraction": err["bitwise_fraction"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "library_ms": library_ms,
        "shape": [q_count, q.shape[1], n],
        "flops": bound["flops"],
        "bytes": bound["bytes"],
        **achieved(bound, kernel_ms),
    }


def phase_topk_pallas(dev, main, err_f32):
    """topk_pallas (B2) on the main path's embeddings, then B2's two
    kernel-table entries."""
    index, q = main["index"], main["q"]
    kb, nv, n_q = index.matrix, index.n, N_QUERIES
    mips_fused.fused_score_segmax.launches = 0
    s, i = mips_fused.topk_pallas(q, kb, K, valid_rows=nv)
    torch.cuda.synchronize()
    launches = mips_fused.fused_score_segmax.launches
    check(launches == 1, f"topk_pallas launched B2 {launches} times")
    agreement = tie_aware_agreement(i[:n_q].cpu().numpy(),
                                    s[:n_q].cpu().numpy(), main["ids"],
                                    main["scores"])
    del s, i
    torch.cuda.empty_cache()
    search_ms = time_ms(
        lambda: mips_fused.topk_pallas(q, kb, K, valid_rows=nv), reps=3)
    emit({"phase": "topk_pallas_main_path", "queries": n_q,
          "kb_rows": nv, "launches": launches, "search_ms": search_ms,
          "vs_fused_path": agreement})
    check(tie_aware_ok(agreement), "topk_pallas against the fused path")

    # B2 at the main path's shapes, against its plain version
    st, mt = mips_fused.fused_score_segmax(q, kb)
    pst, pmt = mips_fused.fused_score_segmax_plain(q, kb)
    err_bf16 = kbmajor_error(st, mt, pst, pmt, q, kb)
    emit({"phase": "kbmajor_vs_plain_main_shapes", **err_bf16})
    check(kbmajor_ok(err_bf16, True), "B2 vs plain at the main shapes")
    del st, mt, pst, pmt
    torch.cuda.empty_cache()
    entries = [kbmajor_entry(q, kb, launches, err_bf16,
                             "topk_pallas, main path (bf16)")]
    torch.cuda.empty_cache()

    # f32 through topk_pallas at the gaussian shapes of phase 4
    q32 = gaussian(dev, BATCH, DIM, torch.float32, seed=9)
    kb32 = gaussian(dev, N_GAUSS, DIM, torch.float32, seed=10,
                    scale=DIM ** -0.5)
    mips_fused.fused_score_segmax.launches = 0
    _, i32 = mips_fused.topk_pallas(q32, kb32, K)
    torch.cuda.synchronize()
    launches32 = mips_fused.fused_score_segmax.launches
    check(launches32 == 1, f"f32 topk_pallas launched B2 {launches32} times")
    ref32 = mips.top_k(torch.matmul(q32, kb32.T), K)[1]
    agree32 = float((i32.long() == ref32).float().mean())
    del i32, ref32
    torch.cuda.empty_cache()
    search32_ms = time_ms(lambda: mips_fused.topk_pallas(q32, kb32, K),
                          reps=3)
    emit({"phase": "topk_pallas_f32", "shape": [BATCH, DIM, N_GAUSS],
          "launches": launches32, "search_ms": search32_ms,
          "exact_sort_id_agreement": agree32})
    check(agree32 >= 0.999, "f32 topk_pallas ids against a full sort")
    entries.append(kbmajor_entry(q32, kb32, launches32, err_f32,
                                 "topk_pallas, f32 at 262,144 rows"))
    del q32, kb32
    torch.cuda.empty_cache()
    return entries


def batch_walls(fn, n_batches, reps=3):
    """Median wall ms per batch of ``fn()`` (after one warm-up run)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    batch_ms = float(np.median(walls)) / n_batches * 1e3
    return batch_ms, N_QUERIES / (batch_ms / 1e3 * n_batches), walls


def phase_global_serve(dev, main):
    """FusedRetrievalPipeline.run over an f32 'global' index, the mode the
    JAX serving CLI builds."""
    embedder, queries = main["embedder"], main["queries"]
    n_batches = -(-N_QUERIES // BATCH)
    index = mips.DenseIndex(gaussian(dev, N_KB, DIM, torch.float32, seed=2,
                                     scale=DIM ** -0.5),
                            mode="global", device=dev)
    pipe = FusedRetrievalPipeline(embedder, index, batch_size=BATCH, k=K)
    qids = [f"q{j}" for j in range(N_QUERIES)]
    batch_ms, qps, walls = batch_walls(lambda: pipe.run(qids, queries),
                                       n_batches)
    arrays_ms = batch_walls(lambda: pipe.run_arrays(queries), n_batches)[0]
    run = pipe.run(qids, queries)
    check(len(run) == N_QUERIES and all(len(run[q]) == K for q in qids),
          "the global-mode Run's shape")
    first = [int(d) for d in run["q0"]]
    _, ids = pipe.run_arrays(queries)
    check(first == ids[0].tolist(), "the Run's order")
    q = embedder.forward(*embedder.upload(embedder.pack(queries[:BATCH])))
    ref = mips.top_k(torch.matmul(q[:64], index.matrix[: index.n].T), K)[1]
    agree = float((ids[:64] == ref.cpu().numpy()).mean())
    del ref
    # where the search's time goes: the whole single pass, the f32 GEMM
    search_ms = time_ms(lambda: index.search_device(q, *index.snapshot(), K),
                        reps=3)
    gemm_ms = time_ms(lambda: torch.matmul(q, index.matrix.T), reps=3)
    emit({"phase": "global_f32_serve", "kb_rows": index.n,
          "kb_dtype": "float32", "queries": N_QUERIES,
          "run_queries": len(run), "docs_per_query": K,
          "batch_ms": batch_ms, "qps": qps, "run_walls_s": walls,
          "run_arrays_batch_ms": arrays_ms, "search_ms": search_ms,
          "f32_gemm_ms": gemm_ms,
          "first64_exact_sort_id_agreement": agree})
    check(agree >= 0.999, "global-mode ids against a full stable sort")
    del index, pipe, q
    torch.cuda.empty_cache()


def phase_streaming(dev, main):
    """StreamingDenseIndex over the fused KB, pinned bf16 chunks."""
    index, q = main["index"], main["q"]
    t0 = time.perf_counter()
    stream = mips.StreamingDenseIndex(index.matrix[: index.n],
                                      chunk_rows=STREAM_ROWS,
                                      dtype=torch.bfloat16, device=dev)
    build_s = time.perf_counter() - t0
    check(all(c.is_pinned() for c in stream._chunks), "unpinned chunks")
    s, i = stream.search_batch(q, k=K)
    agreement = tie_aware_agreement(i[:N_QUERIES], s[:N_QUERIES],
                                    main["ids"], main["scores"])
    search_ms = time_ms(lambda: stream.search_batch(q, k=K, sync=False),
                        reps=3)
    moved = sum(c.numel() * c.element_size() for c in stream._chunks)
    buf = torch.empty_like(stream._chunks[0], device=dev)

    def upload_all():
        for c in stream._chunks:
            buf.copy_(c, non_blocking=True)

    upload_ms = time_ms(upload_all, reps=3)
    emit({"phase": "streaming_index", "kb_rows": stream.n,
          "chunk_rows": STREAM_ROWS, "chunks": len(stream._chunks),
          "host_bytes": moved, "build_s": build_s, "batch_ms": search_ms,
          "search_h2d_gb_per_s": moved / (search_ms / 1e3) / 1e9,
          "upload_only_ms": upload_ms,
          "upload_only_gb_per_s": moved / (upload_ms / 1e3) / 1e9,
          "vs_fused_path": agreement})
    check(tie_aware_ok(agreement), "streaming against the fused path")
    del stream, buf
    torch.cuda.empty_cache()


def phase_late_fusion(dev, main):
    """MultiIndexRetrievalPipeline with the four indexes of
    dpr+arcface+clip+imagenet.json at full width."""
    embedder, queries = main["embedder"], main["queries"]
    n_batches = -(-N_QUERIES // BATCH)
    indexes = {"dpr": main["index"]}
    rng = np.random.default_rng(3)
    feats = {}
    for j, (name, width) in enumerate(FUSION_WIDTHS.items()):
        indexes[name] = mips.DenseIndex(
            gaussian(dev, N_KB, width, torch.bfloat16, seed=20 + j),
            do_l2norm=True, mode="global", dtype=torch.bfloat16, device=dev)
        feats[name] = rng.standard_normal((N_QUERIES, width)).astype(
            np.float32)
    faceless = rng.random(N_QUERIES) < 0.1
    feats["arcface"][faceless] = np.nan
    pipe = MultiIndexRetrievalPipeline(embedder, indexes, FUSION_WEIGHTS,
                                       text_index="dpr", batch_size=BATCH,
                                       k=K, norm="gzmuv")
    pipe.run_arrays(queries, feats)  # warm-up
    mips_fused.fused_score_segmax_qmajor.launches = 0
    scores, ids = pipe.run_arrays(queries, feats)
    launches = mips_fused.fused_score_segmax_qmajor.launches
    check(launches == n_batches, f"B1 launched {launches} times for "
          f"{n_batches} batches")
    batch_ms, qps, walls = batch_walls(
        lambda: pipe.run_arrays(queries, feats), n_batches)

    # the same batch through each index's search_device, then fuse_topk
    q_text = embedder.forward(*embedder.upload(embedder.pack(
        queries[:BATCH])))
    s_list, i_list, search_ms = [], [], {}
    for name, index in indexes.items():
        q, ok = q_text, None
        if name != "dpr":
            rows = np.zeros((BATCH, index.d), np.float32)
            rows[:N_QUERIES] = feats[name]
            q = torch.from_numpy(rows).to(dev).to(torch.bfloat16)
            ok = torch.isfinite(q).all(dim=1, keepdim=True)
            q = torch.where(ok, q, 0.0)
        s, i = index.search_device(q, *index.snapshot(), K)
        search_ms[name] = time_ms(
            lambda: index.search_device(q, *index.snapshot(), K), reps=3)
        if ok is not None:
            s = torch.where(ok, s, mips.NEG_INF)
            i = torch.where(ok, i, mips.INT32_MAX)
        s_list.append(s)
        i_list.append(i)
    weights = tuple(FUSION_WEIGHTS.values())
    ref_s, ref_i = fuse_topk(s_list, i_list, weights, K, norm="gzmuv",
                             valid_queries=N_QUERIES)
    search_ms["fuse_topk"] = time_ms(lambda: fuse_topk(
        s_list, i_list, weights, K, norm="gzmuv", valid_queries=N_QUERIES),
        reps=3)
    ids_equal = bool(np.array_equal(ref_i[:N_QUERIES].cpu().numpy(), ids))
    ulps = ulp_distance(ref_s[:N_QUERIES].to(torch.bfloat16),
                        torch.from_numpy(scores).to(dev).to(torch.bfloat16))
    emit({"phase": "late_fusion", "indexes": {
              n: [ix.n, ix.d, str(ix.dtype).removeprefix("torch."), ix.mode,
                  ix.do_l2norm] for n, ix in indexes.items()},
          "weights": FUSION_WEIGHTS, "norm": "gzmuv",
          "faceless_queries": int(faceless.sum()), "b1_launches": launches,
          "batch_ms": batch_ms, "qps": qps, "run_walls_s": walls,
          "stage_ms": search_ms, "ids_equal_fuse_topk": ids_equal,
          "max_ulp_vs_fuse_topk": int(ulps.max())})
    check(ids_equal, "late fusion ids against fuse_topk")
    check(int(ulps.max()) <= 1, "late fusion scores against fuse_topk")
    check(np.isfinite(scores).all() and ids.max() < N_KB,
          "late fusion outputs")
    del indexes, pipe, s_list, i_list
    torch.cuda.empty_cache()


def span_agreement(spans_a, probs_a, spans_b, probs_b, rtol) -> dict:
    """Two paths' best spans, each (passage, start, end-exclusive) of (n,)
    tensors, with the (n, M, L) start and end probabilities they were
    chosen under. The paths agree on a question when they pick the same
    span, or when each one's span has, under the other's probabilities, a
    joint probability within ``rtol`` relative of the other's maximum:
    with random weights near-ties are common, and the two paths round
    differently."""
    def joint(probs, spans):
        passage, start, end = spans
        rows = torch.arange(len(passage), device=passage.device)
        return (probs[0][rows, passage, start]
                * probs[1][rows, passage, end - 1])

    same = torch.stack([a == b for a, b in zip(spans_a, spans_b)]).all(0)
    shortfall = torch.maximum(
        1 - joint(probs_a, spans_b) / joint(probs_a, spans_a),
        1 - joint(probs_b, spans_a) / joint(probs_b, spans_b))
    agree = same | (shortfall <= rtol)
    return {"questions": len(same), "exact_share": float(same.float().mean()),
            "agree_share": float(agree.float().mean()),
            "max_relative_shortfall": float(shortfall.max()), "rtol": rtol}


def reader_probs_and_spans(pipe, ids, mask, tt, packed: bool):
    """One reader step of ``pipe`` on a padded pair batch (host arrays),
    through the padded or the packed forward: the (n, M, L) start and end
    probabilities and the best spans chosen under them."""
    with torch.no_grad():
        if packed:
            *canvas, mask_t = pipe.upload(*pipe.pack_pairs(ids, mask, tt),
                                          mask)
            out = qa.reader_apply_packed(
                pipe.reader_params, pipe.reader_cfg, *canvas,
                m_passages=pipe.M, compute_dtype=pipe.compute_dtype)
        else:
            ids_t, mask_t, tt_t = pipe.upload(ids, mask, tt)
            out = qa.reader_apply(
                pipe.reader_params, pipe.reader_cfg, ids_t,
                attention_mask=mask_t, token_type_ids=tt_t,
                m_passages=pipe.M, compute_dtype=pipe.compute_dtype)
        probs = span_probabilities(out.start_logits, out.end_logits, mask_t,
                                   pipe.M)
        return probs, qa.get_best_spans(*probs), out


def p99_packed_rows(rng, samples: int = 200) -> int:
    """The 99th percentile of the packed canvas height over ``samples``
    reader steps of READER_QUESTIONS lognormal questions, each paired with
    READER_M passages ([CLS] q [SEP] p [SEP])."""
    rows = []
    for _ in range(samples):
        q_len = np.clip(np.round(rng.lognormal(
            np.log(18.0), 0.35, READER_QUESTIONS)), 8, ROW_LEN).astype(int)
        seqs = [np.ones(n + PASSAGE_TOKENS + 3, np.int32)
                for n in np.repeat(q_len, READER_M)]
        rows.append(packing.pack_token_sequences(
            seqs, row_len=READER_SEQ, pad_rows_to=16).rows)
    return int(np.percentile(rows, 99, method="higher"))


def answer_pipeline(dev, main, reader, kb, **kwargs) -> AnswerPipeline:
    """AnswerPipeline over the main path's embedder and fused index."""
    retrieval = FusedRetrievalPipeline(main["embedder"], main["index"],
                                       batch_size=BATCH, k=K)
    dtype = next(reader.parameters()).dtype
    return AnswerPipeline(
        retrieval, kb, reader.cfg, reader, WhitespaceTokenizer(),
        m_passages=READER_M, reader_seq=READER_SEQ,
        passage_tokens_key="passage_tokens",
        questions_per_step=READER_QUESTIONS, compute_dtype=dtype,
        device=dev, **kwargs)


def phase_reader_step(dev, main, rcfg=qa.ReaderConfig()):
    """One reader step at full width, padded and packed. ``rcfg`` defaults
    to BERT-base without a pooler. Returns what phase 13 shares."""
    t0 = time.perf_counter()
    tree = convert.init_reader_tree(rcfg, seed=1)
    readers = {dtype: convert.reader_from_jax(tree, rcfg, device=dev,
                                              dtype=dtype)
               for dtype in (torch.bfloat16, torch.float32)}
    del tree
    kb = SyntheticPassages(main["index"].n, seed=4)
    rng = np.random.default_rng(5)
    # question tokens without specials: lognormal(ln 18, 0.35) in [8, 64]
    questions = lognormal_questions(rng, READER_QUESTIONS, special=0)
    indices = rng.integers(0, len(kb), (READER_QUESTIONS, READER_M))
    packed_rows = p99_packed_rows(np.random.default_rng(6))
    setup_s = time.perf_counter() - t0

    agreements = {}
    for dtype, reader in readers.items():
        name = str(dtype).removeprefix("torch.")
        pipe = answer_pipeline(dev, main, reader, kb)
        (_, n_real, ids, mask, tt), = pipe.reader_batches(questions, indices)
        check(n_real == READER_QUESTIONS and ids.shape == (
            READER_QUESTIONS * READER_M, READER_SEQ), "the reader batch")
        probs_pad, spans_pad, out_pad = reader_probs_and_spans(
            pipe, ids, mask, tt, packed=False)
        probs_pack, spans_pack, _ = reader_probs_and_spans(
            pipe, ids, mask, tt, packed=True)
        for probs in (*probs_pad, *probs_pack):
            check(bool(torch.isfinite(probs).all()), f"{name} probabilities")
        agreements[name] = span_agreement(spans_pad, probs_pad, spans_pack,
                                          probs_pack, SPAN_RTOL[dtype])
        check(agreements[name]["agree_share"] == 1.0,
              f"padded and packed spans, {name}: {agreements[name]}")
        # the spans the pipeline's own step returns are these spans
        step = pipe.read(*pipe.upload(ids, mask, tt), None)
        check(all(torch.equal(a, b) for a, b in zip(step, spans_pad)),
              f"read() against reader_apply + get_best_spans, {name}")
        if dtype == torch.bfloat16:
            bf16_pad = out_pad
        del probs_pad, probs_pack, out_pad
        torch.cuda.empty_cache()

    # the bf16 reader's GEMMs (f32 results) against the same forward with
    # every dense product taken in f32 on the upcast operands (no TF32)
    pipe = answer_pipeline(dev, main, readers[torch.bfloat16], kb)
    uploaded = pipe.upload(ids, mask, tt)
    with mock.patch.object(layers, "_dot_f32", layers._dot_f32_upcast), \
            torch.no_grad():
        ref = qa.reader_apply(pipe.reader_params, rcfg, uploaded[0],
                              attention_mask=uploaded[1],
                              token_type_ids=uploaded[2], m_passages=READER_M,
                              compute_dtype=torch.bfloat16)
    real = uploaded[1] > 0
    got = torch.stack([bf16_pad.start_logits[real], bf16_pad.end_logits[real]])
    want = torch.stack([ref.start_logits[real], ref.end_logits[real]])
    diff = (got - want).abs()
    close = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=2e-2, atol=2e-2)
    emit({"phase": "reader_bf16_gemm_vs_upcast", "real_tokens": int(real.sum()),
          "max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
          "logit_std": float(want.std()), "rtol_atol": 2e-2,
          "allclose": close})
    check(close, "reader bf16 GEMMs against the f32 upcast")
    del ref, got, want, diff, bf16_pad, readers[torch.float32]
    torch.cuda.empty_cache()

    # one step's time: the device work alone (CUDA events), then the host
    # assembly that feeds it (host clock)
    canvas = pipe.pack_pairs(ids, mask, tt)
    rows = canvas[0].shape[0]
    density = float(mask.sum()) / (rows * READER_SEQ)
    packed_uploaded = pipe.upload(*canvas, mask)
    padded_ms = time_ms(lambda: pipe.read(*uploaded, None), reps=5, warmup=2)
    packed_ms = time_ms(lambda: pipe.read_packed(*packed_uploaded, None),
                        reps=5, warmup=2)
    host = {}
    for name, fn in (
            ("assemble_ms", lambda: list(pipe.reader_batches(questions,
                                                             indices))),
            ("pack_pairs_ms", lambda: pipe.pack_pairs(ids, mask, tt)),
            ("upload_padded_ms", lambda: (pipe.upload(ids, mask, tt),
                                          torch.cuda.synchronize())),
            ("upload_packed_ms", lambda: (pipe.upload(*canvas, mask),
                                          torch.cuda.synchronize()))):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        host[name] = float(np.median(walls))
    pairs = READER_QUESTIONS * READER_M
    emit({"phase": "reader_step", "model": {
              "hidden": rcfg.bert.hidden_size,
              "layers": rcfg.bert.num_hidden_layers,
              "heads": rcfg.bert.num_attention_heads,
              "ffn": rcfg.bert.intermediate_size,
              "vocab": rcfg.bert.vocab_size, "weights": "bf16"},
          "questions": READER_QUESTIONS, "m_passages": READER_M,
          "reader_seq": READER_SEQ, "pairs": pairs,
          "real_tokens": int(mask.sum()),
          "mean_pair_tokens": float(mask.sum()) / pairs,
          "setup_s": round(setup_s, 3),
          "padded_ms": padded_ms, "padded_samples_per_s":
          READER_QUESTIONS / (padded_ms / 1e3),
          "packed_ms": packed_ms, "packed_samples_per_s":
          READER_QUESTIONS / (packed_ms / 1e3),
          "packed_canvas": [rows, READER_SEQ], "packed_density": density,
          "packed_rows_p99": packed_rows, "host": host,
          "padded_vs_packed_spans": agreements})
    return {"reader": readers[torch.bfloat16], "kb": kb,
            "packed_rows": packed_rows}


class TimelineTimer(StageTimer):
    """A StageTimer that also keeps every stage's (name, start, end) in
    seconds on the host clock, to lay one run's stages on a timeline."""

    def __init__(self, name):
        super().__init__(name)
        self.spans = []

    @contextlib.contextmanager
    def stage(self, stage_name, sync_output=None):
        start = time.perf_counter()
        with super().stage(stage_name, sync_output) as holder:
            yield holder
        self.spans.append((stage_name, start, time.perf_counter()))

    def timeline(self, run_start, run_end) -> dict:
        """Milliseconds from the run's start: where each stage's first call
        began and its last call ended, each call's length, and the run's
        end."""
        out = {"run_ms": (run_end - run_start) * 1e3}
        for name in dict.fromkeys(n for n, _, _ in self.spans):
            calls = [(a, b) for n, a, b in self.spans if n == name]
            out[name] = {
                "first_start_ms": (calls[0][0] - run_start) * 1e3,
                "last_end_ms": (calls[-1][1] - run_start) * 1e3,
                "calls_ms": [round((b - a) * 1e3, 2) for a, b in calls]}
        return out


def answers_of_own_rows(pipe, queries, indices, out) -> dict:
    """The pipeline's answers against the reader steps run again, batch by
    batch, on the ids it retrieved: the share of answers equal to the
    decoded ids[passage, start:end] of the recomputed span, and whether
    every answer is a run of tokens of one of its question's own rows.
    Returns these with the probabilities and spans of every step."""
    tok = pipe.tokenizer
    equal, contained, probs_all, spans_all = 0, 0, [], []
    for start, n_real, ids, mask, tt in pipe.reader_batches(queries, indices):
        probs, spans, _ = reader_probs_and_spans(pipe, ids, mask, tt,
                                                 packed=pipe.packed_reader)
        passage, s_idx, e_idx = (t.cpu().numpy() for t in spans)
        ids3 = ids.reshape(pipe.n_q, pipe.M, pipe.reader_seq)
        for i in range(n_real):
            answer = out[start + i]["answer"]
            span = ids3[i, passage[i], s_idx[i]: e_idx[i]]
            equal += answer == tok.decode(span, skip_special_tokens=True)
            # decode drops the special tokens inside a span, so look for
            # the answer in the rows with their specials dropped too
            contained += not answer or any(
                f" {answer} " in f" {tok.decode(row)} " for row in ids3[i])
        probs_all.append(tuple(p[:n_real] for p in probs))
        spans_all.append(tuple(t[:n_real] for t in spans))
    cat = lambda parts: tuple(torch.cat(x) for x in zip(*parts))  # noqa: E731
    return {"equal_share": equal / len(queries),
            "contained_share": contained / len(queries),
            "probs": cat(probs_all), "spans": cat(spans_all)}


def phase_answer_path(dev, main, shared):
    """AnswerPipeline at full width, padded and packed."""
    reader, kb = shared["reader"], shared["kb"]
    queries = lognormal_questions(np.random.default_rng(7), N_ANSWER_QUERIES)
    n_batches = -(-N_ANSWER_QUERIES // BATCH)
    n_steps = -(-N_ANSWER_QUERIES // READER_QUESTIONS)
    results, launches_by_path = {}, {}
    for label, kwargs in (("padded", {}), ("packed", dict(
            packed_reader=True, packed_rows=shared["packed_rows"]))):
        pipe = answer_pipeline(dev, main, reader, kb, **kwargs)
        pipe.run(queries)  # warm-up
        pipe.timer = TimelineTimer("qa-serving")
        mips_fused.fused_score_segmax_qmajor.launches = 0
        t0 = time.perf_counter()
        out = pipe.run(queries)
        t1 = time.perf_counter()
        walls = [t1 - t0]
        timeline = pipe.timer.timeline(t0, t1)
        launches = mips_fused.fused_score_segmax_qmajor.launches
        report = pipe.report()
        check(launches == n_batches, f"B1 launched {launches} times for "
              f"{n_batches} retrieval batches ({label})")
        t0 = time.perf_counter()
        pipe.run(queries)
        walls.append(time.perf_counter() - t0)
        wall_s = float(np.mean(walls))

        ref_scores, ref_ids = pipe.retrieval.run_arrays(queries)
        check(len(out) == N_ANSWER_QUERIES and all(
            isinstance(o["answer"], str) for o in out), "the answers")
        check(all(o["passage_ids"] == ref_ids[i, :READER_M].tolist()
                  for i, o in enumerate(out)),
              f"passage ids against run_arrays ({label})")
        check(np.isfinite(ref_scores).all() and all(
            o["scores"] == ref_scores[i, :READER_M].tolist()
            for i, o in enumerate(out)), f"passage scores ({label})")
        own = answers_of_own_rows(pipe, queries, ref_ids, out)
        results[label] = own
        launches_by_path[f"answer_path_{label}"] = launches
        emit({"phase": "answer_path", "reader": label,
              "queries": N_ANSWER_QUERIES, "retrieval_batches": n_batches,
              "reader_steps": n_steps, "kb_rows": main["index"].n, "k": K,
              "m_passages": READER_M, "reader_seq": READER_SEQ,
              "packed_rows": kwargs.get("packed_rows"),
              "b1_launches": launches, "wall_ms": wall_s * 1e3,
              "questions_per_s": N_ANSWER_QUERIES / wall_s,
              "run_walls_s": walls, "stages": report,
              "timeline": timeline,
              "empty_answers": sum(not o["answer"] for o in out),
              "answers_equal_recomputed_span": own["equal_share"],
              "answers_within_own_rows": own["contained_share"]})
        check(report.keys() == {"retrieve", "reader_dispatch", "decode"}
              and report["reader_dispatch"]["count"] == n_steps,
              f"the StageTimer report ({label})")
        check(own["equal_share"] >= 0.99, "answers against the decoded "
              f"ids[passage, start:end] of the recomputed spans ({label})")
        check(own["contained_share"] == 1.0,
              f"an answer that is no span of its own rows ({label})")
    agreement = span_agreement(
        results["padded"]["spans"], results["padded"]["probs"],
        results["packed"]["spans"], results["packed"]["probs"],
        SPAN_RTOL[torch.bfloat16])
    emit({"phase": "answer_path_padded_vs_packed", **agreement})
    check(agreement["agree_share"] == 1.0,
          f"padded and packed answers: {agreement}")
    return launches_by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    dev = torch.device("cuda")
    phase_kernel_vs_plain(dev)
    err_f32 = phase_kbmajor_vs_plain(dev)
    main_path = phase_main_path(dev)
    kernels = [phase_kernel_table(main_path["index"], main_path["q"],
                                  main_path["launches"])]
    kernels += phase_topk_pallas(dev, main_path, err_f32)
    phase_global_serve(dev, main_path)
    phase_streaming(dev, main_path)
    phase_late_fusion(dev, main_path)
    before_reader = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shared = phase_reader_step(dev, main_path)
    kernels[0]["launches_by_path"] = {
        "exact_retrieval": main_path["launches"],
        **phase_answer_path(dev, main_path, shared)}
    reader_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "device_memory",
          "max_memory_allocated_reader_phases": reader_peak,
          "max_memory_allocated": max(before_reader, reader_peak)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
