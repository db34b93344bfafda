"""Drive the PyTorch port's retrieval, answer and image paths on one NVIDIA
GPU and hold every kernel on them against its plain PyTorch version.

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
   answers agreeing by the span criterion; peak device memory;
14. BM25 alone at full size: a Zipf corpus of 1.5M documents over 400k
   terms (the host index's own synthesis, its unique and sorts done on the
   card), 1,257 queries of 8 Zipf terms, k=100: the host MaxScore scorer's
   queries/s, DeviceBM25's build seconds, queries/s at q_block 512 and
   128, overflow count and device bytes; one block by stage (head product,
   gather, scatter-add in three forms, selection) and the host planning
   time; device results against the exact f32 score vector on a sample,
   the lists against the device rows, an overflow row against the host
   scorer;
15. hybrid serving: HybridRetrievalPipeline over phase 5's encoder and
   fused index (kernel B1 once a batch) and that BM25 corpus, weights
   (0.7, 0.3), gzmuv, once with the host scorer and once with DeviceBM25,
   then a stream of 4 batches on the device branch; the fused scores
   against fuse_topk of the two legs run apart, device against host, and a
   raw + stats run against its closed form;
16. the server: make_http_server on 127.0.0.1 over a BatchedRetrievalService
   (the hybrid pipeline, device branch, 64 a dispatch) and a
   BatchedAnswerService (phase 13's AnswerPipeline): 64 concurrent POST
   /search, 16 POST /answer, GET /health; every response against the
   direct pipeline call on the same batch; request latency and requests/s;
   after phase 18 the same front over a BatchedVQAService (phase 13's
   reader over phase 18's indexes and online legs, 16 a dispatch): 16
   concurrent POST /answer with a PNG for every leg, for the face leg only,
   or none, each response against the direct call on its recorded batch;
17. the towers alone at their published widths (seeded weights):
   ImageNet ResNet-50, CLIP RN50 (ModifiedResNet), CLIP ViT-B/32 and
   ArcFace iresnet50, batch 128 in f32 and bf16 (ms, images/s), each in
   f32 within 1e-3 of the same module on the CPU; MTCNN at MTCNNConfig()
   (canvas 512, 10 scales) on 64 images by stage (pyramid + PNet, stage-1
   NMS, RNet, ONet, each NMS loop alone), at the default thresholds and at
   thresholds taken from the seeded run's per-stage probability quantiles
   so that half the images or more get a face; valid masks on the card
   equal the CPU's off images with a stage probability within 1e-4 of its
   threshold, boxes within 1e-2 px;
18. late fusion with online legs: phase 10's configuration whose image and
   face legs now take Pillow images (short sides 160-720 px, 10 % of the
   queries without one): ImageEmbedder over ResNet-50 (imagenet) and over
   CLIP RN50 (clip), FaceQueryEncoder (MTCNN at phase 17's thresholds +
   ArcFace, 64 a sub-batch), towers in f32; 1,257 questions, batch 1,280:
   batch wall (median of 3), host decode and face-loop ms, device ms by
   leg, a 4-batch stream with its device idle share (derived and traced),
   B1 once a batch; the fused top-100 against the same pipeline given the
   features that embed_images and the FaceQueryEncoder compute directly
   (tie_aware_agreement), queries without an image absent from every
   modal leg.

Phases 5 and 10 also time a stream of 4 batches (5,120 questions) with the
uploads staged through pinned memory and, for comparison, from pageable
memory, and print each call's place on the run's timeline.

Phases 17-18 and the VQA server run after phase 16. The last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

from viquae_torch.core.profiling import StageTimer
from viquae_torch.image.embedding import ImageEmbedder, decode_image_batch
from viquae_torch.image.face_recognition import FaceQueryEncoder
from viquae_torch.ir import embedding as ir_embedding
from viquae_torch.ir import qa_serving as ir_qa_serving
from viquae_torch.ir import serving as ir_serving
from viquae_torch.ir.embedding import PackedTextEmbedder
from viquae_torch.ir.qa_serving import AnswerPipeline, span_probabilities
from viquae_torch.ir.server import (BatchedAnswerService,
                                    BatchedRetrievalService,
                                    BatchedVQAService, make_http_server)
from viquae_torch.ir.serving import (FusedRetrievalPipeline,
                                     HybridRetrievalPipeline,
                                     MultiIndexRetrievalPipeline)
from viquae_torch.kernels import build as kbuild
from viquae_torch.models import (arcface, clip, convert, dpr, layers, mtcnn,
                                 qa, resnet)
from viquae_torch.native.build import load_packer
from viquae_torch.ops import bm25 as bm25_lib
from viquae_torch.ops import bm25_device, mips, mips_fused, packing
from viquae_torch.ops.bm25_device import DeviceBM25
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
# batches of the multi-batch streams (exact path, late fusion, hybrid)
STREAM_BATCHES = 4
# the BM25 corpus and queries (the shapes of the reference's hybrid bench)
N_BM25_DOCS = 1_500_000
BM25_VOCAB = 400_000
BM25_QUERY_TERMS = 8
BM25_K1, BM25_B = 0.5, 0.3
BM25_Q_BLOCKS = (512, 128)
BM25_SAMPLE = 64          # queries held against the exact score vector
HYBRID_WEIGHTS = (0.7, 0.3)
# the server: requests a dispatch, concurrent /answer requests, rounds of
# SERVER_BATCH concurrent /search requests that latency is taken over
SERVER_BATCH = 64
SERVER_ANSWERS = 16
SERVER_ROUNDS = 4
# the image and face chain (phases 17-18): images a tower call, images of
# the MTCNN stage timings and of its card-vs-CPU check, the face leg's
# sub-batch, the short sides of the query images (a Pillow image each)
TOWER_BATCH = 128
FACE_IMAGES = 64
MTCNN_CHECK = 8
# bf16 against f32 on phase 17's towers, relative to the largest output:
# about twice the readings of two sound runs on the H100 (5.4e-3, 7.8e-2,
# 2.6e-3, 1.7e-2; random weights compound the rounding through the depth)
BF16_REL_TOL = {"resnet50_imagenet": 0.015, "clip_rn50": 0.16,
                "clip_vit_b32": 0.01, "arcface_r50": 0.04}
FACE_BATCH = 64
QUERY_SIDES = (160, 720)


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


@contextlib.contextmanager
def pageable_uploads():
    """Uploads as a blocking copy from pageable host memory (before which
    CUDA waits for the stream) in place of the pinned staging path: the
    "before" of the multi-batch streams' before/after, nothing else."""
    def pageable(array, device):
        src = (array if isinstance(array, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(array)))
        return src.to(device)

    with contextlib.ExitStack() as stack:
        for module in (ir_embedding, ir_serving, ir_qa_serving, bm25_device):
            stack.enter_context(mock.patch.object(module, "upload", pageable))
        yield


def stream_timing(pipe, run, n_queries, n_batches, reps=2) -> dict:
    """``run()`` (a pipeline call over ``n_batches`` batches) once to warm
    up, then ``reps`` times on the host clock, the first of them with every
    stage call laid on the run's timeline."""
    run()
    keep, pipe.timer = pipe.timer, TimelineTimer(pipe.timer.name)
    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    timeline, report = pipe.timer.timeline(t0, t1), pipe.timer.report()
    pipe.timer = keep
    walls = [t1 - t0]
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall_s = float(np.median(walls))
    return {"queries": n_queries, "batches": n_batches,
            "wall_ms": wall_s * 1e3, "batch_ms": wall_s / n_batches * 1e3,
            "qps": n_queries / wall_s, "run_walls_s": walls,
            "stages": report, "timeline": timeline}


def traced_device_busy(run) -> dict:
    """One more ``run()`` under torch.profiler (device activities only):
    the device time of everything it put on the card over its wall time.
    The pipelines use one stream, so the sum is the time the card was
    busy; the rest of the wall it was idle."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    return {"traced_wall_ms": wall_ms, "traced_device_busy_ms": busy_ms,
            "traced_device_idle_share": 1.0 - busy_ms / wall_ms}


def stream_before_after(pipe, run, n_queries, n_batches, single_batch_ms,
                        device_stage_ms) -> dict:
    """A stream of ``n_batches`` batches with pageable uploads, then with
    the pinned ones, beside the single-batch wall. ``device_idle_share_
    derived`` is DERIVED, not traced: one less the sum of a batch's device
    stages (each timed alone with CUDA events) over the stream's wall a
    batch; the pinned stream is also run once under the profiler."""
    with pageable_uploads():
        before = stream_timing(pipe, run, n_queries, n_batches)
    after = stream_timing(pipe, run, n_queries, n_batches)
    after.update(traced_device_busy(run))
    device_ms = float(sum(device_stage_ms.values()))
    for result in (before, after):
        result["device_idle_share_derived"] = max(
            0.0, 1.0 - device_ms / result["batch_ms"])
    return {"single_batch_wall_ms": single_batch_ms,
            "device_stage_ms": device_stage_ms,
            "device_stages_sum_ms": device_ms,
            "idle_share_is": "derived from stage times, not traced",
            "pageable_uploads": before, "pinned_uploads": after}


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
    breakdown = {
        "pack_host_ms": float(np.median(pack_ms)),
        "upload_ms": time_ms(lambda: embedder.upload(packed), reps=3),
        "encoder_ms": time_ms(lambda: embedder.forward(*canvas), reps=3),
        "search_ms": time_ms(lambda: mips_fused.topk_fused(
            q_full, index.matrix, K, valid_rows=index.n), reps=3),
        "select_ms": time_ms(lambda: mips_fused.segment_topk(*scored, K),
                             reps=3)}
    emit({"phase": "main_path_breakdown", "queries": len(first), **breakdown})
    del scored

    # a stream of several full batches: does the prefetch thread hide the
    # host tokenize + pack behind the device?
    stream_queries = lognormal_questions(np.random.default_rng(11),
                                         STREAM_BATCHES * BATCH)
    mips_fused.fused_score_segmax_qmajor.launches = 0
    pipe.run_arrays(stream_queries)
    stream_launches = mips_fused.fused_score_segmax_qmajor.launches
    check(stream_launches == STREAM_BATCHES, f"B1 launched {stream_launches} "
          f"times for a stream of {STREAM_BATCHES} batches")
    emit({"phase": "main_path_stream", "b1_launches": stream_launches,
          **stream_before_after(
              pipe, lambda: pipe.run_arrays(stream_queries),
              len(stream_queries), STREAM_BATCHES, batch_ms,
              {k: breakdown[k] for k in ("upload_ms", "encoder_ms",
                                         "search_ms")})})

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
            "ids": ids, "encoder_ms": breakdown["encoder_ms"],
            "stream_queries": stream_queries,
            "stream_launches": stream_launches}


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

    # the same pipeline over a stream of several full batches
    stream_queries = main["stream_queries"]
    stream_feats = {
        name: rng.standard_normal((len(stream_queries), width)).astype(
            np.float32) for name, width in FUSION_WIDTHS.items()}
    stream_feats["arcface"][rng.random(len(stream_queries)) < 0.1] = np.nan
    emit({"phase": "late_fusion_stream", **stream_before_after(
        pipe, lambda: pipe.run_arrays(stream_queries, stream_feats),
        len(stream_queries), STREAM_BATCHES, batch_ms,
        {"encoder_ms": main["encoder_ms"], **search_ms})})
    del indexes, pipe, s_list, i_list, stream_feats
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
    shared["answer_pipe"] = pipe  # the packed one, for the server phase
    return launches_by_path


def synth_zipf_index_on_device(n_docs: int, vocab_size: int = 400_000,
                               mean_len: int = 100, zipf_a: float = 1.2,
                               k1: float = 0.5, b: float = 0.3,
                               seed: int = 0, device="cuda"):
    """``ops.bm25.synth_zipf_index`` with the same numpy generator and the
    same draws, its ``unique`` and its stable sort done with torch on
    ``device``: the same BM25Index, array for array (a CPU test holds it),
    in seconds instead of minutes at 1.5M documents."""
    rng = np.random.default_rng(seed)
    doc_len = rng.poisson(mean_len, n_docs).clip(20, 220).astype(np.int64)
    total = int(doc_len.sum())
    tokens = (rng.zipf(zipf_a, total).astype(np.int64) - 1) % vocab_size
    lens = torch.from_numpy(doc_len).to(device)
    key = torch.repeat_interleave(
        torch.arange(n_docs, device=device), lens) * vocab_size
    key += torch.from_numpy(tokens).to(device)
    del tokens
    uniq, tf = torch.unique(key, return_counts=True)  # sorted
    del key
    t = uniq % vocab_size
    d = (uniq // vocab_size).to(torch.int32)
    del uniq
    order = torch.argsort(t, stable=True)
    counts = torch.bincount(t, minlength=vocab_size)
    offsets = np.zeros(vocab_size + 1, np.int64)
    offsets[1:] = torch.cumsum(counts, 0).cpu().numpy()
    return bm25_lib.BM25Index(
        {f"t{i}": i for i in range(vocab_size)}, offsets,
        d[order].cpu().numpy(), tf[order].float().cpu().numpy(),
        doc_len.astype(np.float32), n_docs, k1=k1, b=b)


def zipf_queries(rng, n, vocab_size, n_terms=BM25_QUERY_TERMS):
    """``n`` queries of ``n_terms`` Zipf(1.2) terms "t<i>"."""
    return [" ".join(f"t{t}" for t in
                     (rng.zipf(1.2, n_terms).astype(np.int64) - 1)
                     % vocab_size) for _ in range(n)]


class FoldingTokenizer(WhitespaceTokenizer):
    """BM25 terms "t<i>" (i up to the corpus vocabulary) folded into the
    encoder's id range [1000, 30000), so one query text feeds both legs."""

    def __call__(self, texts, truncation=True, max_length=512,
                 add_special_tokens=True):
        folded = [" ".join(f"w{1000 + int(w[1:]) % 29_000}"
                           for w in text.split()) for text in texts]
        return super().__call__(folded, truncation=truncation,
                                max_length=max_length,
                                add_special_tokens=add_special_tokens)


def exact_bm25_scores(index, query) -> np.ndarray:
    """The exact f32 score vector of one query over the host index."""
    scores = np.zeros(index.n_docs, np.float32)
    counts = {}
    for tok in bm25_lib.analyze(query):
        tid = index.vocab.get(tok)
        if tid is not None:
            counts[tid] = counts.get(tid, 0) + 1
    for tid, qtf in counts.items():
        lo, hi = index.offsets[tid], index.offsets[tid + 1]
        docs, tf = index.docs[lo:hi], index.tfs[lo:hi]
        scores[docs] += index.idf[tid] * qtf * tf / (tf + index.norm[docs])
    return scores


def device_vs_exact(index, queries, d_scores, d_ids, k) -> dict:
    """DeviceBM25 lists against the exact score vectors: every retrieved
    doc scores within one bf16 relative step (1.6e-2) of the true k-th
    score, and its device score is the bf16-quantised exact one."""
    worst_rank, worst_score, counts_ok = 0.0, 0.0, True
    for query, ds, di in zip(queries, d_scores, d_ids):
        exact = exact_bm25_scores(index, query)
        n_pos = int((exact > 0).sum())
        counts_ok &= len(di) == min(k, n_pos)
        if not di:
            continue
        kth = -np.partition(-exact, len(di) - 1)[len(di) - 1]
        tol = 1.6e-2 * max(abs(kth), 1e-6) + 1e-6
        got = exact[np.asarray(di)]
        worst_rank = max(worst_rank, float(((kth - got) / tol).max()))
        worst_score = max(worst_score, float(
            (np.abs(np.asarray(ds) - got) / (tol + 1.6e-2 * got)).max()))
    return {"sample": len(queries), "result_counts_ok": bool(counts_ok),
            "worst_rank_shortfall_over_tol": worst_rank,
            "worst_score_error_over_tol": worst_score}


def rows_agree(ids_a, scores_a, ids_b, scores_b, rtol) -> dict:
    """Two top-k results of one scorer whose f32 sums may differ in their
    last bits (atomic adds land in any order): the scores agree
    positionwise within ``rtol``, and where the ids differ, the doc is
    either in the other row with a score within ``rtol``, or tied with the
    other row's last score within ``rtol`` (it fell off the end)."""
    rows = swapped = 0
    ok = True
    for ia, sa, ib, sb in zip(ids_a, scores_a, ids_b, scores_b):
        rows += 1
        if len(ia) != len(ib):
            ok = False
            continue
        if not len(ia):
            continue
        sa, sb = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
        ok &= bool(np.all(np.abs(sa - sb) <= rtol * np.abs(sb)))
        if list(ia) == list(ib):
            continue
        swapped += 1
        other = dict(zip(ib, sb))
        for doc, score in zip(ia, sa):
            want = other.get(doc, sb[-1])
            ok &= abs(score - want) <= rtol * abs(want)
    return {"rows": rows, "rows_with_another_order": swapped,
            "agree": bool(ok), "rtol": rtol}


def bm25_block_stages(dev_bm25, queries, k) -> dict:
    """One block of ``q_block`` queries by stage (CUDA events), and the
    host planning of that block (host clock). The scatter-add is timed in
    three forms on the same lanes: atomic adds with the masked lanes
    spread over the pad columns (what DeviceBM25 runs), atomic adds with
    every masked lane on column n_docs (the reference's layout), and
    ``index_put_(accumulate=True)``, which sorts the lanes and is
    deterministic."""
    qb = dev_bm25.q_block
    block = list(queries[:qb])
    plan_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan, overflow = dev_bm25._plan(block)
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    head_w, *pools = plan
    dev = dev_bm25.device
    head_w16 = bm25_device._to_bf16(head_w).to(dev)
    ms, ml, mr, mq, ss, sl, sr, sq = (
        torch.from_numpy(a[0]).to(dev) for a in pools)
    n_docs, d_pad = dev_bm25.n_docs, dev_bm25.d_pad
    tiers = ((ms, ml, mr, mq, dev_bm25.l_mid),
             (ss, sl, sr, sq, dev_bm25.l_small))

    def lanes(d_pad_for_trash=d_pad):
        out = []
        for starts, lens, rows, qtf, cap in tiers:
            flat, vals = bm25_device._pool_lanes(
                dev_bm25.tail_docs, dev_bm25.tail_w, starts, lens, rows, qtf,
                cap, n_docs, d_pad_for_trash)
            out.append((flat, vals))
        return out

    spread = lanes()
    # one trash column: as if the block were n_docs + 1 wide, then the
    # flat targets re-based on the real row stride
    single = []
    for flat, vals in lanes(n_docs + 1):
        rows, docs = flat // (n_docs + 1), flat % (n_docs + 1)
        single.append((rows * d_pad + docs, vals))
    masked = sum(int((v == 0).sum()) for _, v in spread)
    total = sum(f.numel() for f, _ in spread)
    scores = bm25_device._head_scores(head_w16, dev_bm25.head_dense)

    def scatter(pairs):
        for flat, vals in pairs:
            bm25_device._scatter_add(scores, flat, vals)

    def scatter_sorted(pairs):
        for flat, vals in pairs:
            scores.view(-1).index_put_((flat.reshape(-1),), vals.reshape(-1),
                                       accumulate=True)

    out = {
        "q_block": qb, "queries_overflowing": len(overflow),
        "plan_host_ms": float(np.median(plan_ms)),
        "lanes": total, "masked_lanes": masked,
        "pad_columns": d_pad - n_docs,
        "head_product_ms": time_ms(lambda: bm25_device._head_scores(
            head_w16, dev_bm25.head_dense), reps=5),
        "gather_ms": time_ms(lanes, reps=5),
        "scatter_add_ms": time_ms(lambda: scatter(spread), reps=5),
        "scatter_add_one_trash_column_ms": time_ms(
            lambda: scatter(single), reps=5),
        "scatter_index_put_sorted_ms": time_ms(
            lambda: scatter_sorted(spread), reps=3),
        "select_ms": time_ms(lambda: mips._select_topk(scores, k, "fast"),
                             reps=5),
        "block_ms": time_ms(lambda: bm25_device._bm25_block(
            dev_bm25.head_dense, dev_bm25.tail_docs, dev_bm25.tail_w,
            head_w16, ms, ml, mr, mq, ss, sl, sr, sq, k=k,
            l_mid=dev_bm25.l_mid, l_small=dev_bm25.l_small, n_docs=n_docs),
            reps=5),
    }
    # the bytes and operations the card must at least move for this block
    # (each input once, the block written once) and the head product's
    # operations, with the times they imply
    moved = (dev_bm25.head_dense.numel() * 2 + head_w16.numel() * 2
             + (total - masked) * 6 + qb * d_pad * 4 * 2)
    flops = 2 * qb * dev_bm25.head_dense.shape[0] * d_pad
    out["block_bound_ms"] = max(moved / PEAK_HBM_BYTES_PER_S,
                                flops / PEAK_BF16_FLOPS) * 1e3
    return out


def with_q_block(dev_bm25, q_block):
    """The same built arrays scored in blocks of ``q_block`` queries, with
    the default pools of that block size."""
    other = copy.copy(dev_bm25)
    other.q_block = q_block
    other.pool_mid = bm25_device._round_up(3 * q_block + 320, 64)
    other.pool_small = bm25_device._round_up(3 * q_block // 2 + 160, 64)
    return other


def phase_bm25(dev):
    """BM25 alone: the host scorer and DeviceBM25 at full size."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = synth_zipf_index_on_device(
        N_BM25_DOCS, vocab_size=BM25_VOCAB, k1=BM25_K1, b=BM25_B, device=dev)
    torch.cuda.empty_cache()
    corpus_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    queries = zipf_queries(rng, N_QUERIES, BM25_VOCAB)
    stream_queries = queries + zipf_queries(
        rng, STREAM_BATCHES * BATCH - N_QUERIES, BM25_VOCAB)

    # the host scorer: bounds built and the library loaded before timing
    index.term_ub
    index.search_batch(queries[:8], k=K)
    check(index._maxscore_scorer_mt() is not None,
          "the native multi-thread MaxScore scorer did not build")
    host_walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        h_scores, h_ids = index.search_batch(queries, k=K)
        host_walls.append(time.perf_counter() - t0)
    host_s = float(np.median(host_walls))

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scorers = {BM25_Q_BLOCKS[0]: DeviceBM25(index, q_block=BM25_Q_BLOCKS[0],
                                            device=dev)}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    first = scorers[BM25_Q_BLOCKS[0]]
    device_bytes = torch.cuda.memory_allocated() - held
    for q_block in BM25_Q_BLOCKS[1:]:
        scorers[q_block] = with_q_block(first, q_block)

    by_block = {}
    for q_block, scorer in scorers.items():
        scorer.search_batch(queries, k=K)  # warm-up
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            d_scores, d_ids = scorer.search_batch(queries, k=K)
            walls.append(time.perf_counter() - t0)
        wall_s = float(np.median(walls))
        # the device form, nothing read back: enqueue, then wait
        t0 = time.perf_counter()
        rows_s, rows_i = scorer.search_batch_device(queries, k=K)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        device_form_s = time.perf_counter() - t0
        rows_s, rows_i = rows_s.cpu().numpy(), rows_i.cpu().numpy()
        keep = rows_i[:N_QUERIES] != mips.INT32_MAX
        lists_vs_rows = rows_agree(
            d_ids, d_scores,
            [rows_i[q][keep[q]].tolist() for q in range(N_QUERIES)],
            [rows_s[q][keep[q]].tolist() for q in range(N_QUERIES)],
            rtol=1e-5)
        pads_ok = bool(np.isneginf(rows_s[:N_QUERIES][~keep]).all()
                       and np.isfinite(rows_s[:N_QUERIES][keep]).all())
        exact = device_vs_exact(index, queries[:BM25_SAMPLE],
                                d_scores[:BM25_SAMPLE], d_ids[:BM25_SAMPLE],
                                K)
        by_block[q_block] = {
            "qps": N_QUERIES / wall_s, "wall_ms": wall_s * 1e3,
            "run_walls_s": walls, "last_overflow": scorer.last_overflow,
            "pool_mid": scorer.pool_mid, "pool_small": scorer.pool_small,
            "search_batch_device_enqueue_ms": enqueue_s * 1e3,
            "search_batch_device_ms": device_form_s * 1e3,
            "vs_exact_scores": exact, "lists_vs_device_rows": lists_vs_rows,
            "pad_convention_ok": pads_ok,
            "stages": bm25_block_stages(scorer, queries, K)}
        check(exact["result_counts_ok"]
              and exact["worst_rank_shortfall_over_tol"] <= 1.0
              and exact["worst_score_error_over_tol"] <= 1.0,
              f"DeviceBM25 (q_block {q_block}) against the exact scores: "
              f"{exact}")
        check(lists_vs_rows["agree"] and pads_ok,
              f"search_batch lists against search_batch_device rows "
              f"(q_block {q_block}): {lists_vs_rows}")

    # a query with more tail terms than a block's whole pool goes to the
    # host scorer: its row is the host's, float for float
    tail_terms = np.flatnonzero(first.tail_df > 0)
    giant = " ".join(f"t{t}" for t in tail_terms[
        -(first.pool_mid + first.pool_small + 8):])
    mixed = queries[:7] + [giant]
    m_scores, m_ids = first.search_batch(mixed, k=K)
    overflowed = first.last_overflow
    g_scores, g_ids = index.search_batch([giant], k=K)
    rows_s, rows_i = first.search_batch_device(mixed, k=K)
    row_i = rows_i[7].cpu().numpy()
    row_s = rows_s[7].cpu().numpy()
    overflow_ok = (overflowed == 1 and m_ids[7] == g_ids[0]
                   and m_scores[7] == g_scores[0]
                   and row_i[: len(g_ids[0])].tolist() == g_ids[0]
                   and row_s[: len(g_ids[0])].tolist() == g_scores[0])
    emit({"phase": "bm25", "docs": index.n_docs, "vocab": BM25_VOCAB,
          "postings": int(len(index.docs)), "k1": BM25_K1, "b": BM25_B,
          "queries": N_QUERIES, "query_terms": BM25_QUERY_TERMS, "k": K,
          "corpus_synthesis_s": corpus_s,
          "host_scorer": {"qps": N_QUERIES / host_s, "wall_ms": host_s * 1e3,
                          "run_walls_s": host_walls, "threads": "one a core",
                          "scorer": "load_bm25_maxscore_mt"},
          "device_build_s": build_s, "device_bytes_held": device_bytes,
          "n_head": first.head_dense.shape[0], "d_pad": first.d_pad,
          "l_mid": first.l_mid, "l_small": first.l_small,
          "tail_postings": int(first.tail_offsets[-1]),
          "by_q_block": by_block,
          "overflow_query_terms": len(giant.split()),
          "overflow_row_equals_host": bool(overflow_ok),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(overflow_ok, "an overflow query's row against the host scorer")
    return {"index": index, "scorers": scorers, "queries": queries,
            "stream_queries": stream_queries}


def by_doc_agreement(ids_a, scores_a, ids_b, scores_b) -> dict:
    """Two (n, k) fused results by doc id: the share of a's docs that b
    holds too (per row, pads left out), and over the shared docs the
    largest score difference relative to max(1, |score|)."""
    shared_share, worst = [], 0.0
    for ia, sa, ib, sb in zip(ids_a, scores_a, ids_b, scores_b):
        a = {int(d): float(s) for d, s in zip(ia, sa) if d != mips.INT32_MAX}
        b = {int(d): float(s) for d, s in zip(ib, sb) if d != mips.INT32_MAX}
        if not a and not b:
            continue
        shared = set(a) & set(b)
        shared_share.append(len(shared) / max(len(b), 1))
        for d in shared:
            worst = max(worst, abs(a[d] - b[d]) / max(1.0, abs(b[d])))
    return {"rows": len(shared_share),
            "min_shared_share": float(min(shared_share)),
            "mean_shared_share": float(np.mean(shared_share)),
            "max_relative_score_diff": worst}


def hybrid_legs_apart(pipe, queries):
    """``fuse_topk`` of the two legs of one batch run apart: the dense leg
    through the index's search_device, the sparse leg through the
    pipeline's own backend."""
    emb, index = pipe.embed_fn, pipe.index
    q = emb.forward(*emb.upload(emb.pack(list(queries))))
    d_s, d_i = index.search_device(q, *index.snapshot(), pipe.k)
    if hasattr(pipe.bm25, "search_batch_device"):
        b_s, b_i = pipe.bm25.search_batch_device(list(queries),
                                                 k=pipe.k_bm25)
        b_s, b_i = b_s[: pipe.batch_size], b_i[: pipe.batch_size]
        if b_s.shape[0] < pipe.batch_size:
            pad = pipe.batch_size - b_s.shape[0]
            b_s = torch.cat([b_s, b_s.new_full((pad, b_s.shape[1]),
                                               mips.NEG_INF)])
            b_i = torch.cat([b_i, b_i.new_full((pad, b_i.shape[1]),
                                               mips.INT32_MAX)])
    else:
        b_s, b_i = (torch.from_numpy(a).to(index.device)
                    for a in pipe._bm25_arrays(queries))
    fused, fused_i = fuse_topk((d_s, b_s), (d_i, b_i), pipe.weights, pipe.k,
                               norm=pipe.norm, valid_queries=len(queries))
    n = len(queries)
    return (fused[:n].to(torch.bfloat16).float().cpu().numpy(),
            fused_i[:n].cpu().numpy())


def phase_hybrid(dev, main, sparse):
    """HybridRetrievalPipeline over the main path's encoder and fused
    index and the BM25 corpus, with both sparse backends."""
    queries = sparse["queries"]
    n_batches = -(-N_QUERIES // BATCH)
    embedder = PackedTextEmbedder(
        main["embedder"].packed_apply_fn, main["embedder"].params,
        FoldingTokenizer(), row_len=ROW_LEN, batch_size=BATCH,
        compute_dtype=torch.bfloat16, device=dev)
    backends = {"host": sparse["index"],
                "device": sparse["scorers"][BM25_Q_BLOCKS[0]]}
    results, launches_by_path, pipes = {}, {}, {}
    for label, backend in backends.items():
        pipe = HybridRetrievalPipeline(
            embedder, main["index"], backend, weights=HYBRID_WEIGHTS,
            batch_size=BATCH, k=K, norm="gzmuv")
        pipes[label] = pipe
        pipe.run_arrays(queries)  # warm-up
        mips_fused.fused_score_segmax_qmajor.launches = 0
        scores, ids = pipe.run_arrays(queries)
        launches = mips_fused.fused_score_segmax_qmajor.launches
        check(launches == n_batches, f"B1 launched {launches} times for "
              f"{n_batches} hybrid batches ({label})")
        launches_by_path[f"hybrid_{label}"] = launches
        timing = stream_timing(pipe, lambda: pipe.run_arrays(queries),
                               N_QUERIES, n_batches, reps=3)
        apart = by_doc_agreement(ids, scores,
                                 *reversed(hybrid_legs_apart(pipe, queries)))
        results[label] = (scores, ids)
        check(scores.shape == ids.shape == (N_QUERIES, K)
              and np.isfinite(scores).all() and ids.max() < N_KB
              and ids.min() >= 0, f"hybrid outputs ({label})")
        stage = "bm25_device" if label == "device" else "bm25_host"
        check(set(timing["stages"]) == {"tokenize+pack+dense_dispatch",
                                        stage, "fuse_dispatch",
                                        "drain_to_host"},
              f"the StageTimer's stages ({label}): {set(timing['stages'])}")
        # the host leg is deterministic: the same fuse gives the same rows;
        # the device leg's atomic sums may move a near-tie
        floor = 1.0 if label == "host" else 0.9
        check(apart["min_shared_share"] >= floor
              and apart["mean_shared_share"] >= 0.999
              and apart["max_relative_score_diff"] <= 2e-2,
              f"hybrid ({label}) against fuse_topk of its legs: {apart}")
        emit({"phase": "hybrid", "sparse_backend": label,
              "weights": HYBRID_WEIGHTS, "norm": "gzmuv", "k": K,
              "k_bm25": pipe.k_bm25, "kb_rows": main["index"].n,
              "bm25_docs": backend.n_docs, "b1_launches": launches,
              "vs_fuse_topk_of_the_legs_apart": apart, **timing})

    # device against host: the criterion of the reference's own test
    d_vs_h = by_doc_agreement(*reversed(results["device"]),
                              *reversed(results["host"]))
    check(d_vs_h["min_shared_share"] >= 0.7
          and d_vs_h["max_relative_score_diff"] <= 5e-2,
          f"hybrid device branch against the host branch: {d_vs_h}")

    # raw + stats against its closed form (host scorer: deterministic)
    stats = ((0.5, 2.0), (20.1111, 5.85003))
    raw = HybridRetrievalPipeline(
        embedder, main["index"], backends["host"], weights=HYBRID_WEIGHTS,
        batch_size=BATCH, k=K, norm="raw", stats=stats)
    r_scores, r_ids = raw.run_arrays(queries)
    d_scores, d_ids = FusedRetrievalPipeline(
        embedder, main["index"], batch_size=BATCH, k=K).run_arrays(queries)
    b_scores, b_ids = backends["host"].search_batch(queries, k=K)
    worst, in_topk = 0.0, True
    for i in range(N_QUERIES):
        expect = {}
        for sc, d in zip(d_scores[i], d_ids[i]):
            expect[int(d)] = (expect.get(int(d), 0.0) + HYBRID_WEIGHTS[0]
                              * (float(sc) - stats[0][0]) / stats[0][1])
        for sc, d in zip(b_scores[i], b_ids[i]):
            expect[int(d)] = (expect.get(int(d), 0.0) + HYBRID_WEIGHTS[1]
                              * (sc - stats[1][0]) / stats[1][1])
        got = {int(d): float(sc) for d, sc in zip(r_ids[i], r_scores[i])
               if d != mips.INT32_MAX}
        worst = max([worst] + [
            float(abs(sc - expect[d]) / max(1.0, abs(expect[d])))
            for d, sc in got.items()])
        kth = sorted(expect.values(), reverse=True)[
            min(len(got), len(expect)) - 1]
        in_topk &= all(expect[d] >= kth - 0.05 for d in got)
    emit({"phase": "hybrid_checks", "device_vs_host": d_vs_h,
          "raw_stats": stats, "raw_max_relative_diff_vs_closed_form": worst,
          "raw_rows_within_closed_form_topk": bool(in_topk)})
    check(worst <= 2e-2 and in_topk, "raw + stats against the closed form")

    # a stream of several batches on the device branch
    pipe = pipes["device"]
    stream_queries = sparse["stream_queries"]
    mips_fused.fused_score_segmax_qmajor.launches = 0
    pipe.run_arrays(stream_queries)
    launches = mips_fused.fused_score_segmax_qmajor.launches
    check(launches == STREAM_BATCHES, f"B1 launched {launches} times for a "
          f"hybrid stream of {STREAM_BATCHES} batches")
    launches_by_path["hybrid_device_stream"] = launches
    emit({"phase": "hybrid_stream", "sparse_backend": "device",
          "b1_launches": launches,
          "last_overflow": pipe.bm25.last_overflow,
          **stream_timing(pipe, lambda: pipe.run_arrays(stream_queries),
                          len(stream_queries), STREAM_BATCHES),
          **traced_device_busy(lambda: pipe.run_arrays(stream_queries)),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches_by_path


def http_json(url, payload=None, timeout=120):
    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    with urllib.request.urlopen(request, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def concurrent_posts(url, payloads):
    """One thread a payload, started together: [(status, body, seconds)]."""
    out = [None] * len(payloads)

    def client(i):
        t0 = time.perf_counter()
        status, body = http_json(url, payloads[i])
        out[i] = (status, body, time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


class RecordedBatches:
    """A pipeline that keeps every batch it is given, as given (pads
    included), so that a service's responses can be held against the
    direct call on the same padded batch."""

    def __init__(self, pipe):
        self.pipe, self.batches = pipe, []

    def run_arrays(self, queries):
        self.batches.append(list(queries))
        return self.pipe.run_arrays(queries)

    def run(self, questions, **kwargs):
        self.batches.append((list(questions), kwargs) if kwargs
                            else list(questions))
        return self.pipe.run(questions, **kwargs)


def phase_server(dev, main, sparse, shared):
    """The online entry point: the HTTP front over the batched services."""
    embedder = PackedTextEmbedder(
        main["embedder"].packed_apply_fn, main["embedder"].params,
        FoldingTokenizer(), row_len=ROW_LEN, batch_size=SERVER_BATCH,
        fixed_rows=PackedTextEmbedder.ROWS_GRANULARITY,
        compute_dtype=torch.bfloat16, device=dev)
    pipe = HybridRetrievalPipeline(
        embedder, main["index"], sparse["scorers"][BM25_Q_BLOCKS[-1]],
        weights=HYBRID_WEIGHTS, batch_size=SERVER_BATCH, k=K, norm="gzmuv")
    answer_pipe = shared["answer_pipe"]
    seen_search, seen_answer = RecordedBatches(pipe), RecordedBatches(
        answer_pipe)
    retrieval = BatchedRetrievalService(seen_search, max_batch=SERVER_BATCH,
                                        max_wait_ms=50.0)
    answerer = BatchedAnswerService(seen_answer, max_batch=SERVER_ANSWERS,
                                    max_wait_ms=100.0)
    server = make_http_server("127.0.0.1", 0, retrieval=retrieval,
                              answerer=answerer)
    # the stdlib server listens with a backlog of 5: a burst of 64
    # connections overflows it and the kernel makes some of them wait a
    # second for their SYN to be sent again; widen it for the burst
    server.socket.listen(2 * SERVER_BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        queries = sparse["queries"][:SERVER_BATCH]
        questions = lognormal_questions(np.random.default_rng(13),
                                        SERVER_ANSWERS)
        # warm-up at the service's shapes, then what one dispatch costs
        # when it is called directly (host clock, results on the host)
        direct_ms = {}
        for name, call in (
                ("search_batch", lambda: pipe.run_arrays(list(queries))),
                ("answer_batch", lambda: answer_pipe.run(list(questions)))):
            call()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                call()
                walls.append((time.perf_counter() - t0) * 1e3)
            direct_ms[name] = float(np.median(walls))

        mips_fused.fused_score_segmax_qmajor.launches = 0
        got, _ = concurrent_posts(f"{base}/search",
                                  [{"query": q} for q in queries])
        search_launches = mips_fused.fused_score_segmax_qmajor.launches
        search_dispatches = len(seen_search.batches)
        check(all(status == 200 for status, _, _ in got), "/search statuses")
        check(search_launches == search_dispatches
              == retrieval.batcher.n_dispatches,
              f"{search_launches} B1 launches for "
              f"{search_dispatches} search dispatches")
        # every response against the direct call on the batch it was in
        expected = {}
        for batch in seen_search.batches:
            check(len(batch) == SERVER_BATCH, "a dispatch not padded to "
                  f"{SERVER_BATCH} queries")
            scores, ids = pipe.run_arrays(batch)
            expected.update({q: (ids[j], scores[j])
                             for j, q in enumerate(batch) if q})
        search_vs_direct = by_doc_agreement(
            [body["indices"] for _, body, _ in got],
            [body["scores"] for _, body, _ in got],
            [expected[q][0] for q in queries],
            [expected[q][1] for q in queries])
        check(search_vs_direct["min_shared_share"] >= 0.9
              and search_vs_direct["mean_shared_share"] >= 0.999
              and search_vs_direct["max_relative_score_diff"] <= 2e-2,
              f"/search against the direct call: {search_vs_direct}")

        mips_fused.fused_score_segmax_qmajor.launches = 0
        answers, _ = concurrent_posts(f"{base}/answer",
                                      [{"question": q} for q in questions])
        answer_launches = mips_fused.fused_score_segmax_qmajor.launches
        check(all(status == 200 for status, _, _ in answers),
              "/answer statuses")
        check(answer_launches == len(seen_answer.batches)
              == answerer.batcher.n_dispatches,
              f"{answer_launches} B1 launches for "
              f"{len(seen_answer.batches)} answer dispatches")
        expected = {}
        for batch in seen_answer.batches:
            check(len(batch) == SERVER_ANSWERS, "a dispatch not padded to "
                  f"{SERVER_ANSWERS} questions")
            expected.update({q: out for q, out in zip(
                batch, answer_pipe.run(batch)) if q})
        answers_equal = sum(body == expected[questions[i]]
                            for i, (_, body, _) in enumerate(answers))
        check(answers_equal == SERVER_ANSWERS,
              f"/answer: {answers_equal} of {SERVER_ANSWERS} responses equal "
              "the direct call on their batch")

        # latency and throughput: rounds of SERVER_BATCH concurrent requests
        dispatches_before = retrieval.batcher.n_dispatches
        latencies, round_s = [], []
        rng = np.random.default_rng(17)
        for _ in range(SERVER_ROUNDS):
            batch = [sparse["queries"][j] for j in rng.integers(
                0, N_QUERIES, SERVER_BATCH)]
            got, seconds = concurrent_posts(
                f"{base}/search", [{"query": q} for q in batch])
            check(all(status == 200 for status, _, _ in got),
                  "/search statuses under load")
            latencies += [sec for _, _, sec in got]
            round_s.append(seconds)
        answer_latencies = [sec for _, _, sec in answers]
        status, health = http_json(f"{base}/health")
        check(status == 200 and health["ok"]
              and health["search"]["items"]
              == SERVER_BATCH * (1 + SERVER_ROUNDS)
              and health["answer"]["items"] == SERVER_ANSWERS
              and health["search"]["transient_retries"] == 0,
              f"/health: {health}")
        emit({"phase": "server", "search_service": {
                  "pipeline": "hybrid, device BM25 (q_block "
                              f"{BM25_Q_BLOCKS[-1]})",
                  "max_batch": SERVER_BATCH, "max_wait_ms": 50.0,
                  "fixed_rows": embedder.fixed_rows},
              "answer_service": {"max_batch": SERVER_ANSWERS,
                                 "max_wait_ms": 100.0, "reader": "packed"},
              "direct_call_ms": direct_ms,
              "search_vs_direct_call": search_vs_direct,
              "answers_equal_direct_call": answers_equal,
              "b1_launches": {"search": search_launches,
                              "answer": answer_launches},
              "dispatches": {"search_check": search_dispatches,
                             "answer_check": len(seen_answer.batches),
                             "search_load_rounds":
                             retrieval.batcher.n_dispatches
                             - dispatches_before},
              "search_requests": len(latencies),
              "search_latency_ms": {
                  "p50": float(np.percentile(latencies, 50) * 1e3),
                  "p99": float(np.percentile(latencies, 99) * 1e3),
                  "max": float(np.max(latencies) * 1e3)},
              "search_requests_per_s": len(latencies) / float(sum(round_s)),
              "round_walls_s": round_s,
              "answer_latency_ms": {
                  "p50": float(np.percentile(answer_latencies, 50) * 1e3),
                  "p99": float(np.percentile(answer_latencies, 99) * 1e3)},
              "health": health,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        return {"server_search": search_launches,
                "server_answer": answer_launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        retrieval.close()
        answerer.close()


# ---------------------------------------------------------------------------
# phases 17-18: the image and face chain
# ---------------------------------------------------------------------------
def tower_specs(dev, res=resnet.ResNetConfig(),
                mrn=clip.ModifiedResNetConfig(), vit=clip.CLIPVisionConfig(),
                arc=arcface.ArcFaceConfig()) -> list:
    """The four towers, seeded, at their published configurations by
    default: (name, module, apply(module, images, compute_dtype), input
    side, output width, config)."""
    return [
        ("resnet50_imagenet", resnet.init(res, seed=30, device=dev),
         lambda m, x, cd: resnet.apply(m, res, x, cd), mrn.image_size,
         res.width * 2 ** (len(res.stage_sizes) + 1), res),
        ("clip_rn50", clip.modified_resnet_init(mrn, seed=31, device=dev),
         lambda m, x, cd: clip.modified_resnet_apply(m, mrn, x, cd),
         mrn.image_size, mrn.output_dim, mrn),
        ("clip_vit_b32", clip.vit_init(vit, seed=32, device=dev),
         lambda m, x, cd: clip.vit_apply(m, vit, x, cd or torch.float32)[
             "image_embeds"], vit.image_size, vit.projection_dim, vit),
        ("arcface_r50", arcface.init(arc, seed=33, device=dev),
         lambda m, x, cd: arcface.apply(m, arc, x, cd), arc.image_size,
         arc.embedding_size, arc),
    ]


def rel_error(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the largest |b|."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def query_image_arrays(rng, n: int, sides=None) -> list:
    """``n`` uint8 RGB arrays whose short side is drawn from ``sides``
    (default QUERY_SIDES) and whose long side is 1-1.5 times that, in
    either orientation."""
    lo, hi = sides or QUERY_SIDES
    out = []
    for _ in range(n):
        short = int(rng.integers(lo, hi + 1))
        long = int(short * rng.uniform(1.0, 1.5))
        h, w = (short, long) if rng.random() < 0.5 else (long, short)
        out.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return out


def detection_canvases(arrays, cfg):
    """FaceQueryEncoder's host preparation of arrays already at most the
    canvas size: (canvases uint8 (n, side, side, 3), true hws (n, 2))."""
    side = cfg.canvas
    canvas = np.zeros((len(arrays), side, side, 3), np.uint8)
    hws = np.zeros((len(arrays), 2), np.float32)
    for i, a in enumerate(arrays):
        canvas[i, : a.shape[0], : a.shape[1]] = a
        hws[i] = a.shape[:2]
    return canvas, hws


def online_image_features(enc, pics) -> np.ndarray:
    """An image leg's features as MultiIndexRetrievalPipeline's online leg
    computes them: the serving decode of each BATCH of ``pics``, then
    ``enc``'s preprocess + tower; NaN rows where there is no image."""
    out = []
    for start in range(0, len(pics), BATCH):
        chunk = pics[start: start + BATCH]
        canvas, ok = decode_image_batch(chunk, enc.raw_size, BATCH)
        rows = enc._forward(enc.params, torch.from_numpy(canvas).to(
            enc.device))[: len(chunk)].float().cpu().numpy()
        rows[~ok[: len(chunk)]] = np.nan
        out.append(rows)
    return np.concatenate(out)


def mtcnn_stages(params, images, hws, cfg) -> dict:
    """The cascade stage by stage (the stages detect_faces_batch chains),
    each stage's probabilities kept."""
    boxes, scores, regs, valid = mtcnn.pnet_stage(params, images, hws, cfg)
    b1, v1 = mtcnn.stage1_nms(boxes, scores, regs, valid, cfg)
    p2, b2, v2 = mtcnn.rnet_stage(params, images, b1, v1, cfg)
    p3, out = mtcnn.onet_stage(params, images, b2, v2, cfg)
    return {"pnet": (boxes, scores, regs, valid), "stage1": (b1, v1),
            "rnet": (p2, b2, v2), "onet": (p3, out)}


def gap_threshold(values: torch.Tensor, near: float,
                  window: float = 0.02) -> float:
    """The middle of the widest gap between the sorted ``values`` that lie
    within ``window`` of ``near``: a threshold next to ``near`` that no
    value lies close to."""
    v = torch.sort(values.flatten().float().cpu()).values
    v = v[(v > near - window) & (v < near + window)]
    if len(v) < 2:
        return near
    i = int(torch.argmax(v[1:] - v[:-1]))
    return float((v[i] + v[i + 1]) / 2)


def borderline_images(st, cfg, margin=1e-4) -> dict:
    """Per stage, the images with a candidate whose probability lies within
    ``margin`` of the stage's threshold (PNet: the candidates)."""
    t0, t1, t2 = cfg.thresholds
    return {"pnet_candidates": int(((st["pnet"][1] - t0).abs() < margin)
                                   .sum()),
            "rnet": int((((st["rnet"][0] - t1).abs() < margin)
                         & st["stage1"][1]).any(1).sum()),
            "onet": int((((st["onet"][0] - t2).abs() < margin)
                         & st["rnet"][2]).any(1).sum())}


def mtcnn_card_vs_cpu(params, images, hws, cfg, margin=1e-4) -> dict:
    """Each cascade stage on the card against the same stage on the CPU fed
    the card's inputs to it (so a stage's difference is its own, not the
    earlier stages' amplified by random pixels): probabilities, boxes in
    px, and the stage's valid mask off the borderline. PNet's candidates
    are thresholded one by one, so there a candidate whose probability
    lies within ``margin`` of the threshold is left out; RNet's and ONet's
    NMS couple an image's candidates, so there such an image is left
    out."""
    cpu = copy.deepcopy(params).to("cpu")
    host = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    imgs, sizes = images.cpu(), hws.cpu()
    card = mtcnn_stages(params, images, hws, cfg)
    t0, t1, t2 = cfg.thresholds
    boxes, scores, regs, valid = host(card["pnet"])
    b1, v1 = host(card["stage1"])
    p2, b2, v2 = host(card["rnet"])
    p3 = card["onet"][0].cpu()
    out = {k: v.cpu() for k, v in card["onet"][1].items()}
    ref = {"pnet": host(mtcnn.pnet_stage(cpu, imgs, sizes, cfg)),
           "stage1": host(mtcnn.stage1_nms(boxes, scores, regs, valid,
                                           cfg)),
           "rnet": host(mtcnn.rnet_stage(cpu, imgs, b1, v1, cfg)),
           "onet": mtcnn.onet_stage(cpu, imgs, b2, v2, cfg)}
    near = {"pnet": (scores - t0).abs() < margin,
            "stage1": torch.zeros(len(imgs), dtype=torch.bool),
            "rnet": (((p2 - t1).abs() < margin) & v1).any(1),
            "onet": (((p3 - t2).abs() < margin) & v2).any(1)}
    pairs = {"pnet": (valid, ref["pnet"][3], boxes, ref["pnet"][0]),
             "stage1": (v1, ref["stage1"][1], b1, ref["stage1"][0]),
             "rnet": (v2, ref["rnet"][2], b2, ref["rnet"][1]),
             "onet": (out["valid"], ref["onet"][1]["valid"], out["boxes"],
                      ref["onet"][1]["boxes"])}
    result = {"prob_max_diff": max(
        float((scores - ref["pnet"][1]).abs().max()),
        float((p2 - ref["rnet"][0]).abs().max()),
        float((p3 - ref["onet"][0]).abs().max()))}
    for stage, (got, want, gb, wb) in pairs.items():
        same = got == want if stage == "pnet" else (got == want).all(1)
        both = got & want
        result[stage] = {
            "borderline": int(near[stage].sum()),
            "masks_equal_off_borderline": bool(same[~near[stage]].all()),
            "max_box_err_px": float((gb - wb)[both].abs().max())
            if both.any() else 0.0}
    result["faces"] = int(out["valid"].sum())
    return result


def calibrated_thresholds(params, images, hws, cfg, quantile):
    """Thresholds at the ``quantile`` of each stage's probabilities on
    these images, stage after stage (each stage's candidates are those the
    previous calibrated threshold keeps)."""
    boxes, scores, regs, _ = mtcnn.pnet_stage(params, images, hws, cfg)
    t0 = float(torch.quantile(scores.flatten(), quantile))
    cfg = dataclasses.replace(cfg, thresholds=(t0,) + cfg.thresholds[1:])
    b1, v1 = mtcnn.stage1_nms(*mtcnn.pnet_stage(params, images, hws, cfg),
                              cfg)
    p2 = mtcnn.rnet_stage(params, images, b1, v1, cfg)[0]
    t1 = float(torch.quantile(p2[v1], quantile))
    cfg = dataclasses.replace(cfg, thresholds=(t0, t1, cfg.thresholds[2]))
    _, b2, v2 = mtcnn.rnet_stage(params, images, b1, v1, cfg)
    p3 = mtcnn.onet_stage(params, images, b2, v2, cfg)[0]
    t2 = float(torch.quantile(p3[v2], quantile))
    return dataclasses.replace(cfg, thresholds=(round(t0, 4), round(t1, 4),
                                                round(t2, 4)))


def phase_towers(dev, specs=None, cfg=mtcnn.MTCNNConfig()) -> dict:
    """Phase 17: each tower alone at its published width (seeded weights),
    batch TOWER_BATCH in f32 and bf16, against the same module on the CPU;
    MTCNN at MTCNNConfig() on FACE_IMAGES images by stage, at the default
    thresholds and at thresholds calibrated so that at least half the
    images get a face, against the CPU. Returns the towers and the
    calibrated detector configuration for phase 18."""
    towers, results = {}, {}
    for name, model, apply, side, width, tcfg in specs or tower_specs(dev):
        x = gaussian(dev, TOWER_BATCH * side * side, 3, torch.float32,
                     seed=40).reshape(TOWER_BATCH, side, side, 3)
        row = {"batch": TOWER_BATCH, "input": [side, side, 3],
               "width": width}
        for label, cd in (("f32", None), ("bf16", torch.bfloat16)):
            ms = time_ms(lambda: apply(model, x, cd), reps=3)
            row[f"{label}_ms"] = ms
            row[f"{label}_images_per_s"] = TOWER_BATCH / ms * 1e3
        got = apply(model, x[:4], None)
        check(tuple(got.shape) == (4, width), f"{name} output shape")
        cpu = copy.deepcopy(model).to("cpu")
        row["f32_rel_err_vs_cpu"] = rel_error(got, apply(cpu, x[:4].cpu(),
                                                         None))
        row["bf16_rel_err_vs_f32"] = rel_error(
            apply(model, x[:4], torch.bfloat16), got)
        # the check's control: the f32 tower with one mid-network weight
        # zeroed (a residual branch cut, as a dropped key in a weight
        # conversion would leave it) must fail the bf16 limit
        cut = copy.deepcopy(model)
        mats = [p for p in cut.parameters() if p.dim() >= 2]
        mats[len(mats) // 2].zero_()
        row["control_rel_err_vs_f32"] = rel_error(apply(cut, x[:4], None),
                                                  got)
        del cpu, cut, x
        results[name] = row
        towers[name] = (model, apply, side, tcfg)
        check(row["f32_rel_err_vs_cpu"] <= 1e-3,
              f"{name} f32 on the card against the CPU: {row}")
        check(row["bf16_rel_err_vs_f32"] <= BF16_REL_TOL[name]
              < row["control_rel_err_vs_f32"],
              f"{name} bf16 against f32 (limit {BF16_REL_TOL[name]}; the "
              f"control must exceed it): {row}")
    emit({"phase": "towers", "towers": results, "rel_err_tol": {
        "f32_vs_cpu": 1e-3, "bf16_vs_f32": BF16_REL_TOL}})

    # ---- MTCNN at its published configuration -------------------------
    params = mtcnn.init(seed=34, device=dev)
    arrays = query_image_arrays(
        np.random.default_rng(41), FACE_IMAGES,
        (min(QUERY_SIDES[0], cfg.canvas // 2), cfg.canvas))
    arrays = [a[: cfg.canvas, : cfg.canvas] for a in arrays]
    canvas, hws_np = detection_canvases(arrays, cfg)
    images = torch.from_numpy(canvas).to(dev).float()
    hws = torch.from_numpy(hws_np).to(dev)

    def by_stage(cfg):
        st = mtcnn_stages(params, images, hws, cfg)
        boxes, scores, regs, valid = st["pnet"]
        b1, v1 = st["stage1"]
        p2, b2, v2 = st["rnet"]
        p3, out = st["onet"]
        ms = {
            "pyramid_pnet": time_ms(lambda: mtcnn.pnet_stage(
                params, images, hws, cfg), reps=3),
            "stage1_nms_select": time_ms(lambda: mtcnn.stage1_nms(
                boxes, scores, regs, valid, cfg), reps=3),
            "rnet_stage": time_ms(lambda: mtcnn.rnet_stage(
                params, images, b1, v1, cfg), reps=3),
            "onet_stage": time_ms(lambda: mtcnn.onet_stage(
                params, images, b2, v2, cfg), reps=3),
            "detect_faces_batch": time_ms(lambda: mtcnn.detect_faces_batch(
                params, images, hws, cfg), reps=3)}
        # the NMS loops alone, at their stages' shapes and inputs
        k1, k2 = v1 & (p2 >= cfg.thresholds[1]), v2 & (p3 >= cfg.thresholds[2])
        flat = (boxes.reshape(len(arrays), -1, 4),
                scores.reshape(len(arrays), -1))
        nms = {
            "per_scale": time_ms(lambda: mtcnn.nms_fixed(
                boxes, scores, valid, 0.5), reps=3),
            "cross_scale": time_ms(lambda: mtcnn.nms_fixed(
                *flat, valid.reshape(len(arrays), -1), 0.7,
                max_keep=cfg.k_stage1), reps=3),
            "rnet": time_ms(lambda: mtcnn.nms_fixed(
                b1, p2, k1, 0.7, max_keep=cfg.k_stage2), reps=3),
            "onet": time_ms(lambda: mtcnn.nms_fixed(
                b2, p3, k2, 0.7, mode="min", max_keep=cfg.max_faces),
                reps=3)}
        found = out["valid"].any(1)
        return st, {"thresholds": list(cfg.thresholds), "stage_ms": ms,
                    "nms_ms": nms, "nms_ms_sum": sum(nms.values()),
                    "nms_iterations": [cfg.k_per_scale, cfg.k_stage1,
                                       cfg.k_stage2, cfg.max_faces],
                    "stage1_candidates": int(v1.sum()),
                    "stage2_candidates": int(v2.sum()),
                    "faces": int(out["valid"].sum()),
                    "share_with_a_face": float(found.float().mean())}

    _, default = by_stage(cfg)
    for quantile in (0.5, 0.3, 0.1):
        tuned = calibrated_thresholds(params, images, hws, cfg, quantile)
        st, calibrated = by_stage(tuned)
        if calibrated["share_with_a_face"] >= 0.5:
            break
    calibrated["quantile"] = quantile
    check(calibrated["share_with_a_face"] >= 0.5,
          f"calibrated thresholds find a face in half the images: "
          f"{calibrated}")
    # the card against the CPU on the first MTCNN_CHECK images. Random
    # RNet / ONet probabilities crowd near their medians, so at the
    # calibrated thresholds most images hold a candidate within 1e-4 of
    # one (printed): RNet's and ONet's thresholds move into the widest
    # nearby gap of these images' probabilities (ONet's after RNet's
    # move). PNet's candidates are compared one by one and need no move.
    n = MTCNN_CHECK
    imgs, sizes = images[:n], hws[:n]
    st = mtcnn_stages(params, imgs, sizes, tuned)
    at_calibrated = borderline_images(st, tuned)
    t0, t1, t2 = tuned.thresholds
    t1 = gap_threshold(st["rnet"][0][st["stage1"][1]], t1)
    check_cfg = dataclasses.replace(tuned, thresholds=(t0, t1, t2))
    st = mtcnn_stages(params, imgs, sizes, check_cfg)
    t2 = gap_threshold(st["onet"][0][st["rnet"][2]], t2)
    check_cfg = dataclasses.replace(check_cfg, thresholds=(t0, t1, t2))
    agreement = {"images": n, "thresholds": [t0, t1, t2],
                 "borderline_at_calibrated": at_calibrated,
                 **mtcnn_card_vs_cpu(params, imgs, sizes, check_cfg)}
    emit({"phase": "mtcnn", "config": dataclasses.asdict(cfg),
          "scales": len(cfg.scales), "images": len(arrays),
          "image_sides": [int(hws_np.min()), int(hws_np.max())],
          "default_thresholds": default, "calibrated": calibrated,
          "card_vs_cpu_by_stage": agreement})
    stages = ("pnet", "stage1", "rnet", "onet")
    check(agreement["prob_max_diff"] <= 1e-4
          and all(agreement[k]["masks_equal_off_borderline"]
                  and agreement[k]["max_box_err_px"] <= 1e-2
                  for k in stages) and agreement["faces"] > 0
          and max(agreement[k]["borderline"] for k in ("rnet", "onet"))
          <= n // 2,
          f"MTCNN on the card against the CPU: {agreement}")
    return {"towers": towers, "mtcnn": params, "mtcnn_cfg": tuned}


def phase_image_fusion(dev, main, chain) -> dict:
    """Phase 18: late fusion with online legs. Phase 10's configuration,
    whose three non-text legs now take their features online: ImageEmbedder
    over ResNet-50 (imagenet) and over CLIP RN50 (clip), FaceQueryEncoder
    (MTCNN at the calibrated thresholds + ArcFace, FACE_BATCH a
    sub-batch), all in f32."""
    embedder, queries = main["embedder"], main["queries"]
    n_batches = -(-N_QUERIES // BATCH)
    towers = chain["towers"]
    indexes = {"dpr": main["index"]}
    for j, (name, width) in enumerate(FUSION_WIDTHS.items()):
        indexes[name] = mips.DenseIndex(
            gaussian(dev, N_KB, width, torch.bfloat16, seed=20 + j),
            do_l2norm=True, mode="global", dtype=torch.bfloat16, device=dev)
    legs = {"imagenet-RN50": ("resnet50_imagenet", "imagenet"),
            "clip-RN50": ("clip_rn50", "clip")}
    # embed_images (the precomputed check below) at the pipeline's batch:
    # cuDNN chooses its algorithm by shape, and f32 sums of another
    # algorithm differ in their last bits
    encoders = {
        name: ImageEmbedder(
            lambda p, x, apply=towers[tower][1]: apply(p, x, None),
            towers[tower][0], name, image_size=towers[tower][2],
            preprocessing=kind, batch_size=BATCH, device=dev)
        for name, (tower, kind) in legs.items()}
    face_enc = FaceQueryEncoder(
        chain["mtcnn"], towers["arcface_r50"][0],
        mtcnn_cfg=chain["mtcnn_cfg"], arcface_cfg=towers["arcface_r50"][3],
        batch_size=FACE_BATCH, device=dev)
    faces = {"arcface": face_enc}
    from PIL import Image

    # the face leg's rows go up as features: in f32 (no compact
    # transfer), as the image legs' embeddings stay f32 until the search
    pipe = MultiIndexRetrievalPipeline(
        embedder, indexes, FUSION_WEIGHTS, text_index="dpr",
        batch_size=BATCH, k=K, norm="gzmuv", compact_transfer=False,
        image_encoders=encoders, face_encoders=faces)
    rng = np.random.default_rng(42)
    pics = [Image.fromarray(a) for a in query_image_arrays(rng, N_QUERIES)]
    no_image = rng.random(N_QUERIES) < 0.1
    pics = [None if none else p for p, none in zip(pics, no_image)]
    query_images = dict.fromkeys(FUSION_WIDTHS, pics)

    def run():
        return pipe.run_arrays(queries, query_images=query_images)

    # one run, traced: the run whose outputs are checked and whose B1
    # launches are counted (a batch takes ~30 s of host work, so the batch
    # wall is read from the stream below, not from repeats of this run)
    checked = {}

    def run_checked():
        checked["out"] = run()

    mips_fused.fused_score_segmax_qmajor.launches = 0
    traced = traced_device_busy(run_checked)
    launches = mips_fused.fused_score_segmax_qmajor.launches
    scores, ids = checked["out"]
    check(launches == n_batches, f"B1 launched {launches} times for "
          f"{n_batches} batches")

    # ---- online against the same features passed precomputed ---------
    # the clip leg's embed_images resizes as the serving decode does; the
    # imagenet kind's embed_images takes another PIL filter than the
    # serving decode (ROADMAP.md C5), so that leg's features are the
    # serving decode's, through the same preprocess + tower
    host = {}
    feats = {"imagenet-RN50": online_image_features(
                 encoders["imagenet-RN50"], pics),
             "clip-RN50": encoders["clip-RN50"].embed_images(pics)}
    t0 = time.perf_counter()
    feats["arcface"] = face_enc(pics)
    host["face_leg_wall_ms"] = (time.perf_counter() - t0) * 1e3
    staged = MultiIndexRetrievalPipeline(
        embedder, indexes, FUSION_WEIGHTS, text_index="dpr",
        batch_size=BATCH, k=K, norm="gzmuv", compact_transfer=False)
    ref_scores, ref_ids = staged.run_arrays(queries, feats)
    agreement = tie_aware_agreement(ids, scores, ref_ids, ref_scores)
    nan_rows = {n: int(np.isnan(f).any(1).sum()) for n, f in feats.items()}
    absent = {"no_image": int(no_image.sum()), "nan_rows": nan_rows,
              "faces_found": int(np.isfinite(feats["arcface"]).all(1).sum())}

    # ---- by leg: device ms over the first batch ------------------------
    first = pics[:BATCH]
    present_faces = [p for p in first if p is not None]
    n_sub = -(-len(present_faces) // FACE_BATCH)
    sub = [np.asarray(p.resize((max(1, int(p.size[0] * s)),
                                max(1, int(p.size[1] * s)))))
           for p in present_faces[:FACE_BATCH]
           for s in [min(1.0, face_enc.mtcnn_cfg.canvas / max(p.size))]]
    sub_canvas, sub_hws = detection_canvases(sub, face_enc.mtcnn_cfg)
    sub_imgs = torch.from_numpy(sub_canvas).to(dev).float()
    sub_hws = torch.from_numpy(sub_hws).to(dev)
    lms, _ = face_enc._detect(face_enc.mtcnn_params, sub_imgs, sub_hws)
    device_ms = {"text_encoder": main["encoder_ms"]}
    q = {"dpr": embedder.forward(*embedder.upload(embedder.pack(
        queries[:BATCH])))}
    for name, enc in encoders.items():
        t0 = time.perf_counter()
        canvas = decode_image_batch(first, enc.raw_size, BATCH)[0]
        host[f"decode_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        canvas = torch.from_numpy(canvas).to(dev)
        device_ms[f"{name}_preprocess_tower"] = time_ms(
            lambda: enc._forward(enc.params, canvas), reps=3)
        q[name] = enc._forward(enc.params, canvas)
    per_sub = {
        "mtcnn": time_ms(lambda: face_enc._detect(
            face_enc.mtcnn_params, sub_imgs, sub_hws), reps=3),
        "align_arcface": time_ms(lambda: face_enc._align_embed(
            face_enc.embedder.params, sub_imgs, lms), reps=3)}
    device_ms["mtcnn"] = per_sub["mtcnn"] * n_sub
    device_ms["align_arcface"] = per_sub["align_arcface"] * n_sub
    host["face_leg_host_ms"] = host["face_leg_wall_ms"] - (
        device_ms["mtcnn"] + device_ms["align_arcface"])
    present = torch.from_numpy(~no_image[:BATCH])
    agreement["feature_max_rel_diff"] = {
        name: rel_error(q[name][: len(first)][present],
                        torch.from_numpy(feats[name][:BATCH][present.numpy()]))
        for name in encoders}
    rows = np.zeros((BATCH, feats["arcface"].shape[1]), np.float32)
    rows[: len(first)] = np.nan_to_num(feats["arcface"][:BATCH])
    q["arcface"] = torch.from_numpy(rows).to(dev)
    s_list, i_list = [], []
    for name, index in indexes.items():
        label = "b1_dpr" if name == "dpr" else f"search_{name}"
        device_ms[label] = time_ms(lambda: index.search_device(
            q[name], *index.snapshot(), K), reps=3)
        s, i = index.search_device(q[name], *index.snapshot(), K)
        s_list.append(s)
        i_list.append(i)
    weights = tuple(FUSION_WEIGHTS.values())
    device_ms["fuse_topk"] = time_ms(lambda: fuse_topk(
        s_list, i_list, weights, K, norm="gzmuv", valid_queries=N_QUERIES),
        reps=3)
    del q, s_list, i_list

    # ---- a stream of several full batches ------------------------------
    stream_queries = main["stream_queries"]
    stream_images = dict.fromkeys(FUSION_WIDTHS, [
        pics[j % N_QUERIES] for j in range(len(stream_queries))])

    def run_stream():
        return pipe.run_arrays(stream_queries, query_images=stream_images)

    keep, pipe.timer = pipe.timer, TimelineTimer(pipe.timer.name)
    t0 = time.perf_counter()
    run_stream()
    t1 = time.perf_counter()
    stream = {"queries": len(stream_queries), "batches": STREAM_BATCHES,
              "wall_ms": (t1 - t0) * 1e3,
              "batch_ms": (t1 - t0) * 1e3 / STREAM_BATCHES,
              "stages": pipe.timer.report(),
              "timeline": pipe.timer.timeline(t0, t1)}
    pipe.timer = keep
    # traced over one batch (the checked run): the face leg's NMS loops put
    # ~4k kernels a sub-batch on the card, and the profiler keeps every one
    stream.update(traced)
    batch_ms = stream["batch_ms"]
    qps = N_QUERIES / (batch_ms / 1e3 * n_batches)
    device_sum = float(sum(device_ms.values()))
    stream["device_idle_share_derived"] = max(
        0.0, 1.0 - device_sum / stream["batch_ms"])
    emit({"phase": "image_fusion", "indexes": {
              n: [ix.n, ix.d, str(ix.dtype).removeprefix("torch."), ix.mode,
                  ix.do_l2norm] for n, ix in indexes.items()},
          "online_legs": {"imagenet-RN50": "ImageEmbedder(ResNet-50, "
                          "imagenet)", "clip-RN50": "ImageEmbedder(CLIP "
                          "RN50, clip)", "arcface": "FaceQueryEncoder("
                          "MTCNN + ArcFace r50)"},
          "face_thresholds": list(face_enc.mtcnn_cfg.thresholds),
          "face_batch": FACE_BATCH, "towers_dtype": "float32",
          "weights": FUSION_WEIGHTS, "norm": "gzmuv",
          "query_image_sides": list(QUERY_SIDES), **absent,
          "b1_launches": launches, "batch_ms": batch_ms, "qps": qps,
          "batch_ms_is": "the 4-batch stream's wall over its batches",
          "host_ms": host, "device_ms": device_ms,
          "device_ms_sum": device_sum, "face_sub_batches": n_sub,
          "face_per_sub_batch_ms": per_sub,
          "online_vs_precomputed": agreement, "stream": stream})
    check(tie_aware_ok(agreement),
          f"online legs against the same features precomputed: {agreement}")
    check(nan_rows["imagenet-RN50"] == nan_rows["clip-RN50"]
          == absent["no_image"] and nan_rows["arcface"] >= absent["no_image"],
          f"queries without an image are absent from the image legs: "
          f"{absent}")
    check(np.isfinite(scores).all() and ids.max() < N_KB,
          "late fusion outputs")
    return {"pipe": pipe, "indexes": indexes, "encoders": encoders,
            "faces": faces, "pics": pics, "launches": launches,
            "stream_launches": STREAM_BATCHES}


def png_b64(image) -> str:
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def phase_vqa_server(dev, main, shared, fusion) -> dict:
    """Phase 16's server with images: make_http_server over a
    BatchedVQAService whose AnswerPipeline reads with phase 13's reader over
    phase 18's indexes and online legs (SERVER_ANSWERS a dispatch):
    SERVER_ANSWERS concurrent POST /answer, with an image for every leg,
    with a face image only, or with none; each response against the direct
    call on its recorded batch."""
    embedder = PackedTextEmbedder(
        main["embedder"].packed_apply_fn, main["embedder"].params,
        WhitespaceTokenizer(), row_len=ROW_LEN, batch_size=SERVER_ANSWERS,
        fixed_rows=PackedTextEmbedder.ROWS_GRANULARITY,
        compute_dtype=torch.bfloat16, device=dev)
    retrieval = MultiIndexRetrievalPipeline(
        embedder, fusion["indexes"], FUSION_WEIGHTS, text_index="dpr",
        batch_size=SERVER_ANSWERS, k=K, norm="gzmuv",
        image_encoders=fusion["encoders"], face_encoders=fusion["faces"])
    reader = shared["reader"]
    answers = AnswerPipeline(
        retrieval, shared["kb"], reader.cfg, reader, WhitespaceTokenizer(),
        m_passages=READER_M, reader_seq=READER_SEQ,
        passage_tokens_key="passage_tokens",
        questions_per_step=READER_QUESTIONS,
        compute_dtype=next(reader.parameters()).dtype, device=dev)
    seen = RecordedBatches(answers)
    names = list(FUSION_WIDTHS)
    service = BatchedVQAService(seen, names, max_batch=SERVER_ANSWERS,
                                max_wait_ms=100.0)
    server = make_http_server("127.0.0.1", 0, vqa=service)
    server.socket.listen(4 * SERVER_ANSWERS)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        questions = lognormal_questions(np.random.default_rng(19),
                                        SERVER_ANSWERS)
        pics = [p for p in fusion["pics"] if p is not None]
        payloads = []
        for j, question in enumerate(questions):
            payload = {"question": question}
            if j % 4 in (0, 1):
                payload["image_b64"] = png_b64(pics[j])
            elif j % 4 == 2:
                payload["images_b64"] = {"arcface": png_b64(pics[j])}
            payloads.append(payload)
        warm = {n: [pics[0]] + [None] * (SERVER_ANSWERS - 1) for n in names}
        answers.run([questions[0]] + [""] * (SERVER_ANSWERS - 1),
                    query_images=warm)
        seen.batches.clear()
        mips_fused.fused_score_segmax_qmajor.launches = 0
        got, seconds = concurrent_posts(f"{base}/answer", payloads)
        launches = mips_fused.fused_score_segmax_qmajor.launches
        check(all(status == 200 for status, _, _ in got), "/answer statuses")
        check(launches == len(seen.batches) == service.batcher.n_dispatches,
              f"{launches} B1 launches for {len(seen.batches)} VQA "
              "dispatches")
        expected = {}
        for questions_b, kwargs in seen.batches:
            check(len(questions_b) == SERVER_ANSWERS, "a VQA dispatch not "
                  f"padded to {SERVER_ANSWERS} questions")
            expected.update({q: out for q, out in zip(
                questions_b, answers.run(questions_b, **kwargs)) if q})
        equal = sum(json.loads(json.dumps(expected[p["question"]])) == body
                    for p, (_, body, _) in zip(payloads, got))
        latencies = [sec for _, _, sec in got]
        emit({"phase": "server_vqa", "service": {
                  "max_batch": SERVER_ANSWERS, "max_wait_ms": 100.0,
                  "legs": names, "reader": "padded"},
              "requests": len(payloads),
              "with_every_image": sum("image_b64" in p for p in payloads),
              "with_face_image_only": sum("images_b64" in p
                                          for p in payloads),
              "dispatches": len(seen.batches), "b1_launches": launches,
              "answers_equal_direct_call": equal, "wall_s": seconds,
              "latency_ms": {"p50": float(np.percentile(latencies, 50) * 1e3),
                             "max": float(np.max(latencies) * 1e3)}})
        check(equal == SERVER_ANSWERS, f"/answer with images: {equal} of "
              f"{SERVER_ANSWERS} responses equal the direct call")
        return {"server_vqa": launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        service.close()


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
    launches_by_path = {
        "exact_retrieval": main_path["launches"],
        "exact_retrieval_stream": main_path["stream_launches"],
        **phase_answer_path(dev, main_path, shared)}
    reader_peak = torch.cuda.max_memory_allocated()
    sparse = phase_bm25(dev)
    launches_by_path.update(phase_hybrid(dev, main_path, sparse))
    launches_by_path.update(phase_server(dev, main_path, sparse, shared))
    sparse_peak = torch.cuda.max_memory_allocated()
    del sparse
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    chain = phase_towers(dev)
    fusion = phase_image_fusion(dev, main_path, chain)
    launches_by_path["image_fusion"] = fusion["launches"]
    launches_by_path.update(phase_vqa_server(dev, main_path, shared, fusion))
    kernels[0]["launches_by_path"] = launches_by_path
    image_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "device_memory",
          "max_memory_allocated_reader_phases": reader_peak,
          "max_memory_allocated_bm25_hybrid_server_phases": sparse_peak,
          "max_memory_allocated_image_phases": image_peak,
          "max_memory_allocated": max(before_reader, reader_peak,
                                      sparse_peak, image_peak)})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
