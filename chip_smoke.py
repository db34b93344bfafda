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
   leg, a 2-batch stream with its device idle share (derived and traced),
   B1 once a batch; the fused top-100 against the same pipeline given the
   features that embed_images and the FaceQueryEncoder compute directly
   (tie_aware_agreement), queries without an image absent from every
   modal leg.
19. early fusion at published widths: the ECA and ILF encoders of
   configs/experiments/ir/{eca,ilf}_embedding{,_kb}.json (BERT-base, no
   face, CLIP-RN50 1,024, max_length 256, packed; seeded weights stand in
   for their checkpoints) through MMEmbedder, f32: phase 5's 1,257
   questions (batch 128) and 2,048 passages of about 100 tokens (one call
   at batch 2,048), each with a random unit CLIP feature or, for 10 %,
   none; questions/s and passages/s, one batch by stage (host prepare on
   the host clock, the encoder with CUDA events); packed against padded on
   the card and, for the questions, the card against the CPU (64), within
   1e-4 of the output scale; then the exact top-100 of the ECA question vectors over
   phase 5's fused index through B1 (once a batch), against the plain
   version by tie_aware_agreement;
20. the command line on the card, as subprocesses (``python -m
   viquae_torch``, through a wrapper that reports B1's launches at exit):
   an export directory of phase 5's DPR weights, a BERT tokenizer
   directory and phase 5's KB saved as .npz; ``serve`` over the 1,257
   questions with a fused index (B1), its run against the in-process
   pipeline on the same weights, tokenizer and queries; ``server`` with the
   same config (started with ``serve``), 64 concurrent POST /search one a
   dispatch, each response against the direct call on its own batch of
   one; wall, start-up (and its first steps) and batch seconds.

21. training at full width, f32, seeded weights, synthetic data through
   the port's collators and Trainer.fit (AdamW with each config's
   schedule and clipping, dropout on): the DPR biencoder of
   configs/dpr_train.yaml (two BERT-base towers, 256 questions x 2
   passages, packed, max_length 256; run as shipped and, if that runs out
   of device memory, with the trainee's remat_layers, both printed), the
   multimodal ICT of configs/experiments/ict/eca.yaml (ECA question tower
   with a CLIP-RN50 token, DPR context tower, 512 items, remat, BERT
   layers 6-11 frozen: every frozen leaf bitwise unchanged) and the reader
   of configs/experiments/rc/viquae.yaml (4 questions x 24 passages x 256,
   packed): step ms over 5 steps after a warm-up step, items/s, peak
   memory, the deterministic loss on the repeated batch falling; each
   trainee's step at 2 layers on the card against the CPU's (card_vs_cpu);
   then ``python -m viquae_torch train fit`` (checkpoints, resume, export)
   and ``save-ptm`` as subprocesses on a synthetic dataset saved with
   ``datasets``. No kernel is on the training path: B1's and B2's counts
   over the phase are printed (0).
22. the auxiliary models at full width, seeded weights (phase_auxiliary):
   ViLT-B/32 (ViltConfig(): 12 x 768, 40 text + 145 visual tokens) for
   retrieval on 256 (question, image) pairs in f32 and bf16 and as the
   multi-passage reader on 4 x 24 pairs; BEM (BERT-base, 3 token types)
   scoring 1,024 examples at max_length 128 in one batch, then ``evqa
   --scorer bem`` in process on 256 predictions (one forward a miss, as
   the reference) against the same protocol run directly; neural NER
   (BERT-base, 9 CoNLL labels, max_length 64, batch 32, bf16) over 2,048
   sentences, then ``kilt2vqa ner`` with a ``neural`` block in process on
   a ``datasets`` dataset of 512 questions; the ECA reader and the ECA
   and Flamant re-rankers at configs/experiments/mm/eca.yaml's widths
   (gates open) on 4 x 24 x 256; every model at 2 layers on the card
   against the CPU (f32 within 1e-4 of the output scale, bf16 within
   2e-2, NER labels under the margin rule). No kernel is on these paths:
   B1's and B2's counts over the phase are printed (0).
23. the IVF-Flat index (phase_ivf, after phase 7, on phase 5's KB on the
   card): built at the reference's defaults (nlist 1,024, 64 training
   points a list, 10 Lloyd iterations, max_list_factor 4) in f32 and in
   bf16 storage, the build's seconds by stage, nlist after the skew
   split, list_cap, list sizes, bytes held; phase 5's 1,257 questions at
   nprobe 8 and 32 (CUDA events, median of 4) with recall@100 against
   phase 5's exact top-100 (and the share of 256 KB rows that their own
   search finds), beside B1's exact search ms; gates: 64 questions against a brute force over
   their probed lists, on a 65,536-row slice full probe against the exact
   plain search, the card against the CPU on one saved state, save/load
   bit-equal, a traced search (core.profiling.trace) holding CUDA kernel
   events;
24. the Mixture-of-Experts BERT (phase_moe): DPR BERT-base with 8 experts,
   top-2, every other layer, groups of 1,024 tokens, capacity factor 1.25
   (GShard), seeded weights: the packed question encoder on phase 5's
   1,257 questions in bf16 beside the dense encoder (CUDA events), the
   share of choices dropped by capacity, the aux; the card against the
   CPU at 2 layers (f32 within 1e-4 of the scale; bf16 within 2e-2 where
   the routing agrees, the routing equal where the router's margin clears
   two roundings); a biencoder with MoE towers (dropout off) at
   configs/dpr_train.yaml's shapes with remat_layers: step ms over 5
   steps, peak memory and the aux in the loss at capacity factor 1.25,
   then the same towers at capacity factor 4 (nothing dropped), where the
   loss must fall. Phases 23-24
   run after phase 7 and reach no kernel: B1's and B2's counts over each
   are printed (0).
25. serving on the mesh (phase_sharded_serving, last, with the earlier
   phases' tensors freed; the card has one GPU, so nothing here is a
   multi-GPU speed): (a) a NCCL world of one in this process:
   topk_sharded(mode="fused") over phase 5's KB and embeddings through its
   shard step (B1), the NCCL all-gather and the merge, bit-equal to phase
   5, its batch ms beside topk_fused's; (b) four gloo ranks sharing the
   card (processes of their own that load the B1 library phase 2 built):
   B1 on each rank's quarter (375,040 rows) with valid_rows 1.5M - 37,
   the merged top-100 bit-equal to one topk_fused over the whole KB; at
   data = 2 x kb = 2 the serving pipeline with the packed encoder split
   over data (embeddings within 2e-2 of phase 5's, results by
   tie_aware_agreement) and the QA program of __graft_entry__.py:496-596
   on 64 questions (the DPR KB and a 1.5M x 512 bf16 index, fuse_topk in
   gzmuv, the reader step at BERT-base with its canvas rows split over
   data: fused ids equal to the same program on one device, spans by
   span_agreement); (c) ShardedDeviceBM25 over the four ranks on phase
   14's corpus against phase 14's DeviceBM25 by doc id (by_doc_agreement),
   with its overflow count. Each rank's B1 launches, seconds and peak
   memory are printed.
26. training on the mesh (phase_mesh_training, after phase 25, every
   earlier tensor freed; nothing here is a multi-GPU speed: four gloo
   ranks on one card time the host-staged route, not NVLink): (a) a NCCL
   world of one, make_mesh(data=1, model=1) with the towers' param_spec,
   drives phase 21's DPR biencoder (BERT-base x 2, f32, remat, phase 21's
   256-question batch) for 3 steps, bit-equal to the plain Trainer on the
   same batches, step ms beside phase 21's; (b) four gloo ranks sharing
   the card at data = 2 x model = 2 train the same biencoder (dropout off)
   for 2 steps on one 32-question batch (AdamW at the config's lr, no
   warmup): each
   loss within 1e-5 and the first grad norm within 1e-4 of the
   one-device trainer's on the card, the parameters by card_vs_cpu's
   update bound, replicated parameters bit-equal over model; every rank
   writes its checkpoint shard at step 1 and a fresh world restores it
   and takes step 2, bit-equal (parameters, AdamW moments, schedule step)
   to the uninterrupted run; (c) one step of phase 24's MoE towers at 2
   layers and capacity factor 4 under moe_spec, held as (b); (d)
   ``torchrun --nproc-per-node 1 -m viquae_torch train fit`` on phase
   21's CLI config against phase 21's one-process fit, started after (a)
   so that its start-up overlaps (b) and (c). Printed: step ms,
   peak memory and collective bytes by kind for each rank, the routes,
   and B1's and B2's launches (0).
27. pipeline parallelism (phase_pipeline, after phase 26; nothing here is
   a multi-GPU speed: ranks that share one card time the host-staged
   route and the bubble (S - 1) / (M + S - 1)): (a) a NCCL world of one,
   make_mesh(data=1, pipe=1), on phase 26 (a)'s biencoder in the padded
   form of __graft_entry__.py's pp_loss: encode_pipelined bit-equal to
   encode at one microbatch and within the f32 reordering bound at 4, the
   pipelined Trainer (pipeline_param_spec) 3 steps bit-equal to the plain
   Trainer, both timed; (b) four gloo ranks at data = 2 x pipe = 2, 2
   microbatches, full width (6 layers a stage): 2 AdamW steps held as
   phase 26 (b), replicated parameters bit-equal over pipe and data,
   stage checkpoints resumed bit-equal in a fresh world, full_params' HF
   state dicts against one device's; ms a step split into compute and
   waiting, collective bytes by kind and peak memory per rank; (c) the
   same ranks at pipe = 4, 8 microbatches: the question tower's output,
   input and parameter gradients against one device; beside (a), a probe
   of gloo send / recv on raw CUDA tensors (the port stages them through
   pinned host memory either way). B1's and B2's launches: 0.
28. the fused attention of a packed canvas (ops/segment_attention.py,
   phase_segment_attention, after phase 13's reader; alone with
   ``--segment-attention-only``): at the reader's canvas (16 x 24 pairs
   of a lognormal question + 3 + normal(125, 8) passage tokens on rows of
   256) and the retriever's (1,280 lognormal questions on rows of 64), 12
   heads, f32 q, k, v: the kernel against the plain version and the
   plain path (``layers.plain_attention``) within the order of the f32
   sums but for one entry in 10^3 (one bf16 rounding step at most), its
   f32 probabilities past that bound (the rounding point is kept),
   padding queries the mean of v; its time against its bound (q, k, v
   and the context once over the memory rate, FFMA over each segment's
   own keys over the f32 rate), the plain path's time (bias add, softmax, casts,
   transposes; the bias built once an encoder call, timed apart) and
   F.scaled_dot_product_attention in f32 with the bias (the library
   yardstick, never on the port's path); ptxas's registers, shared memory
   and spills; a 2-layer packed encoder with gradients launches it 0
   times and without them once a layer. Its launches over phase 13's
   answer-path runs (read before phase 28 launches it) and over phase
   21's training steps (0) are printed with it, and beside them those of
   the encoder block's glue kernels (ops/encoder_glue.py: two of
   ``bias_residual_layernorm`` and one of ``bias_gelu`` a layer of a bf16
   encoder at inference; 0 over the training steps).

``python3 chip_smoke.py --encoder-glue-only`` (not a phase of the whole
run): the glue kernels built with ptxas -v, each against its plain twin at
the reader's and the retriever's canvases (BERT-base widths, bf16
parameters), and timed beside their bound (the bytes read and written
once over the memory rate), the twin (the plain path's operations) and
the library's ``F.layer_norm`` / ``F.gelu`` over the same rows (the
yardstick alone: the LayerNorm or the GELU without the adds and casts).

Phases 5 and 10 also time a stream of 4 batches (5,120 questions) with the
uploads staged through pinned memory and, for comparison, from pageable
memory, and print each call's place on the run's timeline.

Phases 17-18 and the VQA server run after phase 16, phases 19-20 after
them; phase 17 also times each tower in bf16 with its convolutions' f32
sums taken by models/resnet._conv_upcast instead of im2col + GEMM. The last line is
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
import os
import re
import signal
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
from viquae_torch.models import (arcface, bem, bert, clip, convert, dpr,
                                 layers, mm, mtcnn, ner, qa, resnet, rr,
                                 vilt)
from viquae_torch.native.build import load_packer
from viquae_torch.ops import bm25 as bm25_lib
from viquae_torch.ops import bm25_device, ivf, mips, mips_fused, packing
from viquae_torch.ops import encoder_glue as glue
from viquae_torch.ops import segment_attention as segattn
from viquae_torch.ops import moe as moe_lib
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
# phase 18's stream: a batch of its online legs takes ~22 s of host work,
# and every phase shares the script's time limit
FUSION_STREAM_BATCHES = 2
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
# about twice the readings of sound runs on the H100 with f32 convolution
# sums (4.7e-3, 1.16e-1, 2.8e-3, 1.4e-2; random weights compound the
# operands' rounding through the depth); never raised, each control above
BF16_REL_TOL = {"resnet50_imagenet": 0.01, "clip_rn50": 0.16,
                "clip_vit_b32": 0.01, "arcface_r50": 0.03}
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
    def stage(self, stage_name):
        start = time.perf_counter()
        with super().stage(stage_name):
            yield
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


def kernel_profile(run, top: int = 8) -> dict:
    """One ``run()`` under torch.profiler (device activities only): its
    wall, the device time of everything it put on the card, the share of
    the wall the card idled, and the ``top`` kernels by device time."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    device_ms = sum(e.device_time_total for e in events) / 1e3
    return {"traced_wall_ms": wall_ms, "device_ms": device_ms,
            "traced_device_idle_share": 1.0 - device_ms / wall_ms,
            "top": [{"kernel": e.key[:90], "calls": e.count,
                     "ms": e.device_time_total / 1e3} for e in events[:top]]}


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
    return logs


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
    kb = main_kb(dev)
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
    emit({"phase": "encoder_profile",
          **kernel_profile(lambda: embedder.forward(*canvas))})
    return {"index": index, "q": q_full, "launches": launches,
            "embedder": embedder, "queries": queries, "scores": scores,
            "ids": ids, "encoder_ms": breakdown["encoder_ms"],
            "stream_queries": stream_queries,
            "stream_launches": stream_launches,
            "search_ms": breakdown["search_ms"], "q_all": q}


def segment_bound(seg: torch.Tensor, width: int) -> dict:
    """The fused attention's least time: q, k, v read and the context
    written once (f32) over the memory rate, or the FFMA of both products
    over each segment's own keys (2 n^2 x 64 each, for every head) over
    the f32 rate, whichever is larger."""
    rows, length = seg.shape
    seg = seg.long().cpu()
    sizes = torch.stack([torch.bincount(r[r > 0], minlength=length + 1)
                         for r in seg])
    n_heads = width // segattn.HEAD_DIM
    flops = 2 * 2 * segattn.HEAD_DIM * n_heads * float((sizes.double() ** 2)
                                                     .sum())
    moved = 4 * rows * length * width * 4
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = moved / PEAK_HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": moved}


def split_heads(t: torch.Tensor) -> torch.Tensor:
    """(R, L, heads x 64) -> (R, heads, L, 64), a view."""
    return t.reshape(*t.shape[:2], -1, segattn.HEAD_DIM).transpose(1, 2)


def library_segment_attention(q, k, v, bias):
    """The same attention by one library call, f32
    F.scaled_dot_product_attention with the bias as its mask (f32
    probabilities: it has no rounding point): the yardstick alone."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        split_heads(q), split_heads(k), split_heads(v),
        attn_mask=bias).transpose(1, 2).reshape(q.shape)


def segment_canvases(rng) -> dict:
    """Segment ids of the reader's canvas (a step's 16 x 24 pairs: a
    lognormal question, 3 special tokens, a normal(125, 8) passage; rows
    of 256) and of the retriever's (a batch of 1,280 lognormal questions
    on rows of 64), packed by ops/packing."""
    def packed(lengths, row_len):
        seqs = [np.ones(int(n), np.int32) for n in lengths]
        return torch.from_numpy(packing.pack_token_sequences(
            seqs, row_len, pad_rows_to=8).segment_ids)

    n_pairs = READER_QUESTIONS * READER_M
    questions = np.clip(np.round(rng.lognormal(np.log(18), 0.35, n_pairs)),
                        8, 64)
    passages = np.round(rng.normal(125, 8, n_pairs))
    pairs = np.minimum(questions + 3 + passages, READER_SEQ)
    asked = np.clip(np.round(rng.lognormal(np.log(18), 0.35, BATCH)), 8,
                    ROW_LEN)
    return {"reader": packed(pairs, READER_SEQ),
            "retriever": packed(asked, ROW_LEN)}


def segment_attention_case(dev, seg, width, reps=20) -> dict:
    """The kernel at one canvas: against the plain version and the plain
    path, and timed beside them and the library call."""
    rows, length = seg.shape
    gen = torch.Generator(device=dev).manual_seed(rows)
    q, k, v = (torch.randn((rows, length, width), generator=gen,
                           device=dev) * s for s in (2.0, 2.0, 1.0))
    seg = seg.to(dev)
    before = segattn.segment_attention.launches
    got = segattn.segment_attention(q, k, v, seg)
    torch.cuda.synchronize()
    check(segattn.segment_attention.launches == before + 1,
          "the fused attention did not launch")
    bias = layers.attention_bias_from_segments(seg)
    plain = layers.plain_attention(q, k, v, bias, segattn.HEAD_DIM,
                                   torch.bfloat16)
    twin = segattn.segment_attention_plain(q, k, v, seg)
    # what the order of the f32 sums can move an entry by where both sides
    # round each probability alike: L ulps of P . |v| a side; a
    # probability whose two f32 values straddle a bf16 midpoint rounds
    # either way, one rounding step (2^-7 of it) at most, in at most one
    # entry in 10^3 (tests/test_torch_segment_attention.py _bounds)
    spread = layers.plain_attention(q, k, v.abs(), bias, segattn.HEAD_DIM,
                                    torch.bfloat16)
    reorder = 2 * length * 2.0 ** -24 * spread
    step = reorder + 2.0 ** -7 * spread
    real = (seg > 0)[..., None].expand_as(got)
    f32_probs = segattn.segment_attention(q, k, v, seg, torch.float32)
    err = {"max_abs_vs_plain": float((got - plain).abs().max()),
           "max_abs_vs_twin": float((got - twin).abs().max()),
           "share_past_reordering_vs_plain": float(
               ((got - plain).abs() > reorder).float().mean()),
           "share_past_reordering_vs_twin": float(
               ((got - twin).abs() > reorder).float().mean()),
           "within_rounding_step": bool(
               ((got - plain).abs() <= step).all()
               and ((got - twin).abs() <= step).all()),
           "bitwise_share_vs_twin": float((got == twin).float().mean()),
           # the planted check: f32 probabilities leave the bound
           "f32_probs_share_past_reordering": float(
               ((got - f32_probs).abs() > reorder)[real].float().mean())}
    pad = seg <= 0
    if pad.any():
        mean = torch.tensor(1.0 / length).to(torch.bfloat16).float().to(
            dev) * v.sum(dim=1)                       # (R, width)
        err["padding_max_abs"] = float((got - mean[:, None, :]).abs()[
            pad].max())
    check(err["share_past_reordering_vs_plain"] <= 1e-3
          and err["share_past_reordering_vs_twin"] <= 1e-3
          and err["within_rounding_step"]
          and err["f32_probs_share_past_reordering"] > 0.5
          and err.get("padding_max_abs", 0.0) <= 1e-5 * (
              1.0 + float(v.abs().sum(dim=1).max()) / length),
          f"the fused attention is off its plain versions: {err}")
    del plain, twin, spread, reorder, step, real, f32_probs, got
    torch.cuda.empty_cache()
    out = {"rows": rows, "length": length, "width": width,
           "real_token_share": float((seg > 0).float().mean()), **err}
    bound = segment_bound(seg, width)
    kernel_ms = time_ms(lambda: segattn.segment_attention(q, k, v, seg),
                        reps, warmup=3)
    out.update(
        kernel_ms=kernel_ms, bound=bound, **achieved(bound, kernel_ms),
        plain_ms=time_ms(lambda: layers.plain_attention(
            q, k, v, bias, segattn.HEAD_DIM, torch.bfloat16), reps,
            warmup=2),
        bias_build_ms=time_ms(
            lambda: layers.attention_bias_from_segments(seg), reps),
        library_ms=time_ms(lambda: library_segment_attention(q, k, v, bias),
                           reps, warmup=2))
    return out


def segment_attention_selection(dev) -> dict:
    """A 2-layer packed encoder at heads of 64 on the card, f32 as
    training runs it: with gradients it launches the fused attention 0
    times, without them once a layer."""
    cfg = bert.BertConfig(vocab_size=3000, hidden_size=DIM,
                          num_hidden_layers=2, num_attention_heads=12,
                          intermediate_size=4 * DIM,
                          max_position_embeddings=ROW_LEN, add_pooler=False)
    model = layers.seeded(bert.Bert, cfg, seed=0, device=dev)
    seg = segment_canvases(np.random.default_rng(1))["retriever"][:64].to(dev)
    ids = torch.randint(5, 3000, seg.shape, device=dev)
    launches = {}
    for name, grad in (("with_gradients", True), ("inference", False)):
        model.requires_grad_(grad)
        before = segattn.segment_attention.launches
        with torch.set_grad_enabled(grad):
            out = bert.apply(model, cfg, ids, segment_ids=seg,
                             compute_dtype=torch.float32)
            if grad:
                out["last_hidden_state"].sum().backward()
        torch.cuda.synchronize()
        launches[name] = segattn.segment_attention.launches - before
    check(launches == {"with_gradients": 0, "inference": 2},
          f"the fused attention's selection on the card: {launches}")
    return launches


def glue_launch_count() -> int:
    """The encoder block's glue kernels' launches so far, both kernels."""
    return glue.bias_residual_layernorm.launches + glue.bias_gelu.launches


def values_of(tree, key: str) -> list:
    """Every value stored under ``key`` in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [v for k, sub in tree.items()
                for v in ([sub] if k == key else values_of(sub, key))]
    if isinstance(tree, list):
        return [v for sub in tree for v in values_of(sub, key)]
    return []


def segment_attention_ptxas(log: str) -> dict:
    return {"lines": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "smem" in ln],
            "faults": ptxas_faults(log)}


def phase_segment_attention(dev, ptxas=None) -> dict:
    """Phase 28: the fused attention at the main path's shapes; returns
    its kernel-table entry."""
    t0 = time.perf_counter()
    canvases = segment_canvases(np.random.default_rng(18))
    entry = {"kernel": "segment_attention",
             "file": "viquae_torch/csrc/segment_attention.cu",
             "design": ("a block a (row, head, 64 queries), 256 threads, "
                        "the tile's key range from its segments, logits "
                        "and probabilities in shared memory, FFMA 4 x 4 a "
                        "thread, exact softmax, bf16-rounded "
                        "probabilities"),
             "ptxas": ptxas}
    for name, seg in canvases.items():
        entry[name] = segment_attention_case(dev, seg, DIM)
        emit({"phase": f"segment_attention_{name}", **entry[name]})
    entry["selection"] = segment_attention_selection(dev)
    emit({"phase": "segment_attention", "seconds":
          time.perf_counter() - t0, "selection": entry["selection"],
          "ptxas": ptxas})
    return entry


def glue_case(dev, tokens: int, reps: int = 20) -> dict:
    """The encoder block's glue kernels at a canvas of ``tokens`` slots,
    BERT-base widths and bf16 parameters: against their twins (kernel A
    within the order of the LayerNorm's sums, its bf16 copy its f32 output
    rounded; kernel B one bf16 step at most, in at most one value in 10^3:
    tests/test_torch_encoder_glue.py says why), and timed."""
    import torch.nn.functional as F

    width, inner, eps = DIM, 4 * DIM, 1e-12
    gen = torch.Generator(device=dev).manual_seed(tokens)

    def draw(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(shape, generator=gen, device=dev)

    y, x, g = draw(tokens, width), draw(tokens, width), draw(tokens, inner,
                                                             scale=1.5)
    bias, weight, shift, bias_in = (t.to(torch.bfloat16) for t in (
        draw(width, scale=0.02), draw(width, scale=0.1, base=1.0),
        draw(width, scale=0.02), draw(inner, scale=0.02)))
    launches = (glue.bias_residual_layernorm.launches,
                glue.bias_gelu.launches)
    out, low = glue.bias_residual_layernorm(y, bias, x, weight, shift, eps)
    h = glue.bias_gelu(g, bias_in)
    torch.cuda.synchronize()
    check((glue.bias_residual_layernorm.launches, glue.bias_gelu.launches)
          == (launches[0] + 1, launches[1] + 1),
          "the glue kernels did not launch")
    twin, _ = glue.bias_residual_layernorm_plain(y, bias, x, weight, shift,
                                                 eps)
    steps = (h.view(torch.int16).int()
             - glue.bias_gelu_plain(g, bias_in).view(torch.int16).int()).abs()
    err = {"a_max_abs_vs_twin": float((out - twin).abs().max()),
           "a_bf16_is_its_f32_rounded": bool(torch.equal(
               low, out.to(torch.bfloat16))),
           "b_share_off_twin": float((steps > 0).float().mean()),
           "b_max_bf16_steps": int(steps.max())}
    check(err["a_max_abs_vs_twin"] <= 1e-4 and err["a_bf16_is_its_f32_rounded"]
          and err["b_max_bf16_steps"] <= 1 and err["b_share_off_twin"] <= 1e-3,
          f"the glue kernels are off their twins: {err}")
    del out, low, h, twin, steps
    t = x + (y + bias)
    w32, s32 = weight.float(), shift.float()
    gb = g + bias_in

    def timed(name, moved, kernel, twin_fn, library):
        bytes_ms = moved / PEAK_HBM_BYTES_PER_S * 1e3
        kernel_ms = time_ms(kernel, reps, warmup=3)
        return {"kernel": name, "bytes": moved, "bound_ms": bytes_ms,
                "bound_by": "bytes", "kernel_ms": kernel_ms,
                "fraction_of_bound": bytes_ms / kernel_ms,
                "twin_ms": time_ms(twin_fn, reps, warmup=2),
                "library_ms": time_ms(library, reps, warmup=2)}

    return {"tokens": tokens, **err, "a": timed(
        "bias_residual_layernorm", tokens * width * 14,
        lambda: glue.bias_residual_layernorm(y, bias, x, weight, shift, eps),
        lambda: glue.bias_residual_layernorm_plain(y, bias, x, weight, shift,
                                                   eps),
        lambda: F.layer_norm(t, (width,), w32, s32, eps)), "b": timed(
        "bias_gelu", tokens * inner * 6, lambda: glue.bias_gelu(g, bias_in),
        lambda: glue.bias_gelu_plain(g, bias_in), lambda: F.gelu(gb))}


def encoder_glue_only() -> int:
    """``python3 chip_smoke.py --encoder-glue-only``: the glue kernels
    built (ptxas -v, no spill allowed), checked and timed at the reader's
    and the retriever's canvases."""
    phase_device()
    logs = kbuild.build_all(["encoder_glue"], force=True, verbose=True)
    ptxas = segment_attention_ptxas(logs["encoder_glue"])
    emit({"phase": "build", "ptxas": ptxas})
    check(not ptxas["faults"], f"ptxas reported {ptxas['faults']}")
    dev = torch.device("cuda")
    for name, seg in segment_canvases(np.random.default_rng(18)).items():
        emit({"phase": f"encoder_glue_{name}", "rows": seg.shape[0],
              "length": seg.shape[1], **glue_case(dev, seg.numel())})
        torch.cuda.empty_cache()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def segment_attention_only() -> int:
    """``python3 chip_smoke.py --segment-attention-only``: phase 28 alone,
    after building its library (ptxas -v, no spill allowed)."""
    phase_device()
    logs = kbuild.build_all(["segment_attention"], force=True, verbose=True)
    ptxas = segment_attention_ptxas(logs["segment_attention"])
    emit({"phase": "build", "ptxas": ptxas})
    check(not ptxas["faults"], f"ptxas reported {ptxas['faults']}")
    entry = phase_segment_attention(torch.device("cuda"), ptxas)
    emit({"kernels": [entry]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


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
        # bf16 with each convolution's f32 sum taken by the f32
        # convolution of the upcast operands instead of im2col + one bf16
        # GEMM (bf16_ms), ROADMAP C6
        with mock.patch.object(resnet, "_conv_gemm", resnet._conv_upcast):
            row["bf16_upcast_conv_ms"] = time_ms(
                lambda: apply(model, x, torch.bfloat16), reps=3)
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
    stream_queries = main["stream_queries"][: FUSION_STREAM_BATCHES * BATCH]
    stream_images = dict.fromkeys(FUSION_WIDTHS, [
        pics[j % N_QUERIES] for j in range(len(stream_queries))])

    def run_stream():
        return pipe.run_arrays(stream_queries, query_images=stream_images)

    keep, pipe.timer = pipe.timer, TimelineTimer(pipe.timer.name)
    t0 = time.perf_counter()
    run_stream()
    t1 = time.perf_counter()
    stream = {"queries": len(stream_queries),
              "batches": FUSION_STREAM_BATCHES,
              "wall_ms": (t1 - t0) * 1e3,
              "batch_ms": (t1 - t0) * 1e3 / FUSION_STREAM_BATCHES,
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
          "batch_ms_is": "the 2-batch stream's wall over its batches",
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
            "stream_launches": FUSION_STREAM_BATCHES}


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


# ---------------------------------------------------------------------------
# phases 19-20: early fusion and the CLI
# ---------------------------------------------------------------------------
# the published early-fusion embedding configs (seeded weights stand in for
# their checkpoints); passages of about PASSAGE_TOKENS tokens; questions
# checked on the CPU; rows of the packed-vs-padded check on the passages
MM_CONFIGS = {"eca_questions": "configs/experiments/ir/eca_embedding.json",
              "eca_passages": "configs/experiments/ir/eca_embedding_kb.json",
              "ilf_questions": "configs/experiments/ir/ilf_embedding.json"}
N_MM_PASSAGES = 2048
MM_CPU_CHECK = 64
MM_PADDED_CHECK = 256
MM_REL_TOL = 1e-4
# phase 20: concurrent requests, seconds a subprocess may take
CLI_REQUESTS = 64
CLI_TIMEOUT_S = 600


def bert_vocab_tokenizer(path, vocab_size: int):
    """A BertTokenizerFast whose vocabulary maps "w<j>" to id j (and the
    specials to BERT's ids 0, 100-103), saved under ``path``: it tokenizes
    the synthetic questions exactly as WhitespaceTokenizer does."""
    from transformers import BertTokenizerFast

    specials = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
                103: "[MASK]"}
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(
        specials.get(i, f"w{i}") for i in range(vocab_size)))
    tok = BertTokenizerFast(vocab_file=str(path / "vocab.txt"),
                            do_lower_case=True)
    tok.save_pretrained(str(path))
    return tok


def mm_items(rng, texts, key, dim, missing=0.1) -> list:
    """One item a text, with a random unit CLIP-RN50 feature, or none for
    a ``missing`` share."""
    feats = rng.standard_normal((len(texts), dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    absent = rng.random(len(texts)) < missing
    return [{key: t, "clip-RN50": None if absent[i] else feats[i].tolist()}
            for i, t in enumerate(texts)]


def mm_embedder(dev, name, tokenizer, packed=None, bundle=None):
    """The MMEmbedder that ``MM_CONFIGS[name]`` describes, over seeded
    weights (its checkpoint path is dropped): the CLI's ``embed`` branch."""
    from viquae_torch.core.config import get_pretrained, load_config
    from viquae_torch.train.data import PreComputedImageFeatures

    config = load_config(MM_CONFIGS[name])
    model_kwargs = dict(config.pop("model"))
    model_kwargs.pop("pretrained_model_name_or_path")
    if bundle is None:
        bundle = get_pretrained(**model_kwargs, seed=50, device=dev)
    config.pop("tokenizer")
    features = PreComputedImageFeatures(**config.pop("image_features"))
    packed_cfg = config.pop("packed", False)
    packed = packed_cfg if packed is None else packed
    return bundle, ir_embedding.MMEmbedder(
        bundle.apply_fn, bundle.params, tokenizer, features,
        packed_bundle=bundle if packed else None, device=dev, **config)


def mm_stage_ms(embedder, items, reps: int = 3) -> dict:
    """One batch by stage: host (tokenize, features, pack) on the host
    clock, the encoder with CUDA events; medians of ``reps``."""
    chunk = items[: embedder.batch_size]
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prepared = embedder.prepare(chunk)
        host.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": float(np.median(host)),
            "encoder_ms": time_ms(lambda: embedder.forward(prepared),
                                  reps=reps)}


def phase_early_fusion(dev, main, tokenizer) -> dict:
    """Phase 19: the ECA / ILF encoders at BERT-base width from the
    published configs (seeded weights), ECA questions and passages and ILF
    questions, then the exact top-K of the ECA question vectors over
    phase 5's fused index through B1."""
    rng = np.random.default_rng(19)
    questions = main["queries"]
    passages = [" ".join(f"w{j}" for j in rng.integers(
        1000, 30_000, int(n))) for n in rng.integers(
        PASSAGE_TOKENS - 10, PASSAGE_TOKENS + 10, N_MM_PASSAGES)]
    results, vectors = {}, {}
    for name in MM_CONFIGS:
        t_phase = time.perf_counter()
        key = "passage" if name == "eca_passages" else "input"
        items = mm_items(rng, passages if key == "passage" else questions,
                         key, 1024)
        bundle, emb = mm_embedder(dev, name, tokenizer)
        emb.embed_items(items[: emb.batch_size])    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = emb.embed_items(items)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(out.shape == (len(items), bundle.cfg.bert.hidden_size)
              and np.isfinite(out).all(), f"{name} embeddings")
        # packed against padded, on the card, in f32
        _, padded = mm_embedder(dev, name, tokenizer, packed=False,
                                bundle=bundle)
        padded.batch_size = min(padded.batch_size, 128)
        sub = items[:MM_PADDED_CHECK]
        ref = padded.embed_items(sub)
        packed_err = float(np.abs(out[: len(sub)] - ref).max()
                           / np.abs(ref).max())
        # the card against the CPU (f32, TF32 off), on the questions
        cpu_err = None
        if key == "input":
            cpu_bundle = copy.copy(bundle)
            cpu_bundle.params = copy.deepcopy(bundle.params).to("cpu")
            _, on_cpu = mm_embedder("cpu", name, tokenizer,
                                    bundle=cpu_bundle)
            on_cpu.batch_size = MM_CPU_CHECK
            ref = on_cpu.embed_items(items[:MM_CPU_CHECK])
            cpu_err = float(np.abs(out[:MM_CPU_CHECK] - ref).max()
                            / np.abs(ref).max())
            del cpu_bundle, on_cpu
        results[name] = {
            "config": MM_CONFIGS[name], "items": len(items),
            "batch": emb.batch_size, "packed": emb.packed_bundle is not None,
            "max_length": emb.max_length,
            "without_image": sum(it["clip-RN50"] is None for it in items),
            "wall_s": wall, "items_per_s": len(items) / wall,
            **mm_stage_ms(emb, items, reps=3 if key == "input" else 1),
            "packed_vs_padded_rel_err": packed_err,
            "card_vs_cpu_rel_err": cpu_err,
            "phase_s": time.perf_counter() - t_phase}
        check(packed_err <= MM_REL_TOL and (cpu_err or 0.0) <= MM_REL_TOL,
              f"{name}: packed against padded and the card against the CPU "
              f"(limit {MM_REL_TOL}): {results[name]}")
        vectors[name] = out
        del bundle, emb, padded
        torch.cuda.empty_cache()

    # the exact search of the ECA question vectors through B1
    index = main["index"]
    q = torch.from_numpy(vectors["eca_questions"]).to(dev).to(torch.bfloat16)
    mips_fused.fused_score_segmax_qmajor.launches = 0
    starts = range(0, len(q), BATCH)
    got = [index.search_device(q[i: i + BATCH], index.n, index.matrix, K)
           for i in starts]
    torch.cuda.synchronize()
    launches = mips_fused.fused_score_segmax_qmajor.launches
    check(launches == len(starts),
          f"B1 launched {launches} times for {len(starts)} ECA batches")
    scores = torch.cat([s for s, _ in got]).float().cpu().numpy()
    ids = torch.cat([i for _, i in got]).cpu().numpy()
    p_s, p_i = mips_fused.segment_topk(
        *mips_fused.fused_score_segmax_qmajor_plain(q, index.matrix,
                                                    index.n), K)
    agreement = tie_aware_agreement(ids, scores, p_i.cpu().numpy(),
                                    p_s.float().cpu().numpy())
    search_ms = time_ms(lambda: index.search_device(
        q[:BATCH], index.n, index.matrix, K), reps=3)
    emit({"phase": "early_fusion", "encoders": results,
          "search": {"queries": len(q), "kb_rows": index.n, "k": K,
                     "b1_launches": launches, "batch_ms": search_ms,
                     "plain_agreement": agreement},
          "rel_tol": MM_REL_TOL})
    check(tie_aware_ok(agreement),
          f"ECA search against the plain version: {agreement}")
    return {"launches": launches}


# Runs ``python -m viquae_torch`` (runpy, as -m does) and, at exit, prints
# to stderr the B1 launch count of the process, its seconds, those of the
# pipelines' run() calls and of the start-up's first steps (importing torch
# and initialising CUDA, importing transformers)
CLI_WRAPPER = """
import atexit, json, runpy, sys, time
t0 = time.perf_counter()
import torch
if torch.cuda.is_available():
    torch.cuda.init()
t_cuda = time.perf_counter()
import transformers
t_transformers = time.perf_counter()
from viquae_torch.ir import serving
from viquae_torch.ops import mips_fused
runs = []
run = serving.RetrievalPipeline.run
def timed(self, *args, **kwargs):
    t = time.perf_counter()
    out = run(self, *args, **kwargs)
    runs.append(time.perf_counter() - t)
    return out
serving.RetrievalPipeline.run = timed
atexit.register(lambda: print(json.dumps({
    "b1_launches": mips_fused.fused_score_segmax_qmajor.launches,
    "process_s": time.perf_counter() - t0, "run_s": runs,
    "torch_and_cuda_init_s": t_cuda - t0,
    "import_transformers_s": t_transformers - t_cuda}),
    file=sys.stderr, flush=True))
sys.argv = ["viquae_torch"] + sys.argv[1:]
runpy.run_module("viquae_torch", run_name="__main__")
"""


def cli_process(dev, *args):
    return subprocess.Popen(
        [sys.executable, "-c", CLI_WRAPPER, "--device", str(dev),
         *map(str, args)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)))


def cli_exit_report(stderr: str) -> dict:
    return json.loads(stderr.strip().splitlines()[-1])


def run_arrays_of(run, n) -> tuple:
    """A saved Run (rank order kept) -> (scores, ids) arrays."""
    rows = [run[str(i)] for i in range(n)]
    ids = np.array([[int(d) for d in r] for r in rows])
    scores = np.array([[r[d] for d in r] for r in rows], np.float32)
    return scores, ids


def phase_cli(dev, main, tokenizer, workdir, cfg=dpr.DPRConfig()) -> dict:
    """Phase 20: the command line on the card, as subprocesses started
    together (their start-ups overlap): ``serve`` over phase 5's questions
    and KB (fused index, B1), and ``server`` with the same config answering
    CLI_REQUESTS concurrent /search once ``serve`` is done; each against
    the in-process pipeline on the same weights, tokenizer and queries."""
    from viquae_torch.train.checkpoint import export_params

    t0 = time.perf_counter()
    tree = convert.init_tree(cfg, seed=0)        # phase 5's weights
    export_params(workdir / "dpr", tree)
    index = main["index"]
    index.save(workdir / "kb")
    write_s = time.perf_counter() - t0
    (workdir / "queries.txt").write_text("\n".join(main["queries"]))
    config = {"model": {"class_name": "DPREncoder",
                        "pretrained_model_name_or_path": str(workdir / "dpr"),
                        "bert_config": dataclasses.asdict(cfg.bert)},
              "tokenizer": str(workdir / "tok"), "row_len": ROW_LEN,
              "index": {"load": str(workdir / "kb.npz"), "mode": "fused"}}
    (workdir / "serve.json").write_text(json.dumps(config))
    torch.cuda.empty_cache()

    # the in-process pipeline: the CLI's embedder on the same weights
    model = convert.params_from_jax(tree, cfg, device=dev)
    del tree

    def pipeline(batch):
        emb = PackedTextEmbedder(dpr.make_packed_apply(cfg), model,
                                 tokenizer, row_len=ROW_LEN,
                                 batch_size=batch, device=dev)
        return FusedRetrievalPipeline(emb, index, batch_size=batch, k=K)

    queries = main["queries"]
    ref_scores, ref_ids = pipeline(BATCH).run_arrays(queries)

    # server (one query a dispatch, so that each response is the direct
    # call on its own batch of one) and serve, started together
    t_server = time.perf_counter()
    server_proc = cli_process(dev, "server", workdir / "serve.json",
                              "--port", 0, "--k", K, "--max-batch", 1,
                              "--max-wait-ms", 5)
    try:
        t0 = time.perf_counter()
        proc = cli_process(dev, "serve", workdir / "queries.txt",
                           workdir / "serve.json", workdir / "run.json",
                           "--k", K, "--batch", BATCH)
        try:
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
        finally:
            proc.kill()
        serve_wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"viquae_torch serve failed: {err[-4000:]}")
        report = cli_exit_report(err)
        printed = json.loads(out.strip().splitlines()[-1])
        run = json.loads((workdir / "run.json").read_text())
        scores, ids = run_arrays_of(run, len(queries))
        serve_agreement = tie_aware_agreement(ids, scores, ref_ids,
                                              ref_scores)
        serve = {"queries": printed["queries"], "wall_s": serve_wall,
                 **{k: report[k] for k in ("process_s", "run_s",
                                           "torch_and_cuda_init_s",
                                           "import_transformers_s")},
                 "start_up_s": report["process_s"] - sum(report["run_s"]),
                 "batch_ms": sum(report["run_s"]) * 1e3
                 / -(-len(queries) // BATCH),
                 "b1_launches": report["b1_launches"],
                 "stages": printed["stages"],
                 "bitwise_equal": bool(np.array_equal(ids, ref_ids)
                                       and np.array_equal(scores,
                                                          ref_scores)),
                 "in_process_agreement": serve_agreement}
        check(report["b1_launches"] == -(-len(queries) // BATCH)
              and tie_aware_ok(serve_agreement),
              f"viquae_torch serve against the in-process pipeline: {serve}")

        info = json.loads(server_proc.stdout.readline())
        start_up = time.perf_counter() - t_server
        base = info["listening"]
        picks = queries[:CLI_REQUESTS]
        responses, burst_s = concurrent_posts(
            f"{base}/search", [{"query": q} for q in picks])
        status, health = http_json(f"{base}/health")
    finally:
        server_proc.send_signal(signal.SIGINT)  # cmd_server shuts down
        try:
            _, err = server_proc.communicate(timeout=60)
        finally:
            server_proc.kill()
    report = cli_exit_report(err)
    direct = pipeline(1)
    same, agreements = 0, []
    for q, (code, body, _) in zip(picks, responses):
        check(code == 200, f"/search answered {code}")
        r_scores, r_ids = direct.run_arrays([q])
        got_ids = np.array([body["indices"]])
        got_scores = np.array([body["scores"]], np.float32)
        same += bool(np.array_equal(got_ids, r_ids)
                     and np.array_equal(got_scores, r_scores))
        agreements.append(tie_aware_agreement(got_ids, got_scores, r_ids,
                                              r_scores))
    latencies = sorted(t for _, _, t in responses)
    server = {"requests": len(picks), "start_up_s": start_up,
              **{k: report[k] for k in ("torch_and_cuda_init_s",
                                        "import_transformers_s")},
              "burst_s": burst_s,
              "p50_ms": latencies[len(latencies) // 2] * 1e3,
              "max_ms": latencies[-1] * 1e3,
              "b1_launches": report["b1_launches"],
              "health": health, "bitwise_equal_responses": same,
              "min_id_agreement_above_kth_tie": min(
                  a["id_agreement_above_kth_tie"] for a in agreements),
              "max_ulp_positionwise": max(a["max_ulp_positionwise"]
                                          for a in agreements)}
    emit({"phase": "cli", "index_rows": index.n,
          "write_export_and_index_s": write_s, "serve": serve,
          "server": server})
    check(status == 200 and report["b1_launches"] >= len(picks)
          and all(tie_aware_ok(a) for a in agreements),
          f"viquae_torch server against the direct calls: {server}")
    return {"cli_serve": serve["b1_launches"],
            "cli_server": report["b1_launches"]}


# --------------------------------------------------------------------------
# phase 21: training
# --------------------------------------------------------------------------
TRAIN_STEPS = 5          # timed steps, after one warm-up step
DPR_TRAIN_QUESTIONS = 256
ICT_TRAIN_ITEMS = 512
READER_TRAIN_QUESTIONS = 4
SMALL_DEPTH = 2          # layers of the card-against-CPU step
SMALL_BATCH = 16         # questions of that step (DPR)
SMALL_ICT_ITEMS = 8      # ICT items of that step: its CPU half is the
                         # slowest (47 s at 16 items on the card's host)
GRAD_RTOL = 1e-3         # of the largest gradient entry (see card_vs_cpu)
# configs/dpr_train.yaml, configs/experiments/ict/eca.yaml and
# configs/experiments/rc/viquae.yaml, as the JAX package ships them
DPR_TRAIN_OPT = dict(lr=2e-5, warmup_steps=100, total_steps=40000,
                     grad_clip=1.0)
ICT_TRAIN_OPT = dict(lr=2e-5, warmup_steps=100, total_steps=10000,
                     grad_clip=2.0,
                     freeze_regex=".*/layers/(6|7|8|9|10|11)/.*")
READER_TRAIN_OPT = dict(lr=1e-5, warmup_steps=1000, total_steps=30000,
                        grad_clip=1.0)


def words(ids) -> str:
    return " ".join(f"w{int(j)}" for j in ids)


def passage_lengths(rng, n):
    """Passage token counts: normal(125, 8) clipped to [100, 160]."""
    return np.clip(np.round(rng.normal(125, 8, n)), 100, 160).astype(int)


def dpr_train_items(rng, n_questions):
    """BM25-mined DPR training items over a KB of 2 passages a question:
    lognormal-length questions, normal(125, 8)-length passages, ids in
    [1000, 10000)."""
    kb = [{"passage": words(rng.integers(1000, 10_000, m))}
          for m in passage_lengths(rng, 2 * n_questions)]
    items = [{"id": f"q{i}", "input": q,
              "BM25_provenance_indices": [i],
              "BM25_irrelevant_indices": [n_questions + i]}
             for i, q in enumerate(lognormal_questions(
                 rng, n_questions, special=0))]
    return kb, items


def ict_train_items(rng, n_items, dim=1024):
    """WIT-like ICT items: 5 sentences of normal(125, 8) / 4 tokens (a
    pseudo-question of one sentence, a target of about four), a unit
    CLIP-RN50 feature for the question and one for the context."""
    feats = rng.standard_normal((2, n_items, dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=2, keepdims=True)
    return [{"title": f"w{1000 + i}",
             "sentences": [{"text": words(rng.integers(1000, 10_000, m))}
                           for m in passage_lengths(rng, 5) // 4],
             "clip-RN50": feats[0, i].tolist(),
             "context_clip-RN50": feats[1, i].tolist()}
            for i in range(n_items)]


def reader_train_items(rng, n_questions, m=24, n_relevant=8):
    """Reader items: a lognormal question, 8 relevant passages holding the
    2-token answer at a random place, 16 irrelevant ones."""
    kb, items = [], []
    for i in range(n_questions):
        answer = rng.integers(1000, 10_000, 2)
        rel = []
        for _ in range(m):
            ids = rng.integers(1000, 10_000, passage_lengths(rng, 1)[0])
            if len(rel) < n_relevant:
                at = int(rng.integers(0, len(ids) - 2))
                ids[at: at + 2] = answer
                rel.append(len(kb))
            kb.append({"passage": words(ids)})
        items.append({"id": f"q{i}",
                      "input": lognormal_questions(rng, 1, special=0)[0],
                      "output": {"original_answer": words(answer),
                                 "answer": [words(answer)]},
                      "search_provenance_indices": rel,
                      "search_irrelevant_indices": list(
                          range(rel[-1] + 1, len(kb)))})
    return kb, items


def dpr_trainee(dev, layers_=12, seed=0, remat=False):
    from viquae_torch.train.trainee import BiEncoderTrainee

    cfg = dpr.DPRConfig(bert=dataclasses.replace(
        dpr.DPRConfig().bert, num_hidden_layers=layers_))
    return BiEncoderTrainee(dpr.DPREncoder(cfg=cfg, seed=seed, device=dev),
                            dpr.DPREncoder(cfg=cfg, seed=seed + 1,
                                           device=dev),
                            remat_layers=remat)


def ict_trainee(dev, layers_=12, seed=0):
    from viquae_torch.models import mm
    from viquae_torch.train.trainee import BiEncoderTrainee

    bcfg = dataclasses.replace(dpr.DPRConfig().bert,
                               num_hidden_layers=layers_)
    question = mm.ECAEncoder(cfg=mm.MMConfig(
        bert=bcfg, n_faces=0, image_dims=(("clip-RN50", 1024),)),
        seed=seed, device=dev)
    context = dpr.DPREncoder(cfg=dpr.DPRConfig(bert=bcfg), seed=seed + 1,
                             device=dev)
    return BiEncoderTrainee(question, context, remat_layers=True)


def reader_trainee(dev, tokenizer, layers_=12, seed=0):
    from viquae_torch.train.trainee import ReaderTrainee

    cfg = qa.ReaderConfig(bert=dataclasses.replace(
        qa.ReaderConfig().bert, num_hidden_layers=layers_))
    return ReaderTrainee(cfg, qa.init(cfg, seed, device=dev), tokenizer,
                         m_passages=READER_M)


def timed_training(trainee, batch, opt_kw, questions, label,
                   require_fall: bool = True) -> dict:
    """One warm-up step, then TRAIN_STEPS steps timed with CUDA events
    (log_every = TRAIN_STEPS: one host read in the timed run), through
    Trainer.fit on a step-indexed source that gives the same batch every
    step; the deterministic loss on that batch before and after (which
    must fall, with ``require_fall``); peak device memory over the
    steps."""
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(trainee.loss_fn, trainee.params,
                      optim.make_optimizer(trainee.params, **opt_kw),
                      TrainerConfig(max_steps=1, log_every=0))
    loss_before = trainer.evaluate([batch])["loss"]
    launches = segattn.segment_attention.launches
    glue_launches = glue_launch_count()
    t0 = time.perf_counter()
    trainer.fit(lambda step: batch)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    trainer.cfg.max_steps = trainer.cfg.log_every = TRAIN_STEPS
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    out = trainer.fit(lambda step: batch)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    # the steps take gradients: the fused attention is never theirs (the
    # no-grad evaluations around them may take it)
    step_launches = segattn.segment_attention.launches - launches
    check(step_launches == 0, f"{label}: the training steps launched the "
          f"fused attention {step_launches} times")
    glue_step_launches = glue_launch_count() - glue_launches
    check(glue_step_launches == 0, f"{label}: the training steps launched "
          f"the glue kernels {glue_step_launches} times")
    loss_after = trainer.evaluate([batch])["loss"]
    result = {"step_ms": step_ms, "first_step_s": first_step_s,
              "segment_attention_step_launches": step_launches,
              "glue_step_launches": glue_step_launches,
              "host_wall_per_step_ms": wall_s * 1e3 / TRAIN_STEPS,
              "items_per_s": questions / (step_ms / 1e3),
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "train_loss_last_step": out["history"][-1]["loss"],
              "eval_loss_before": loss_before, "eval_loss_after": loss_after}
    check(all(math.isfinite(v) for v in (loss_before, loss_after,
                                         result["train_loss_last_step"])),
          f"{label}: a loss is not finite: {result}")
    check(loss_after < loss_before or not require_fall,
          f"{label}: the loss did not fall on the repeated batch: {result}")
    result["trainer"] = trainer
    return result


def canvas_tokens(side) -> int:
    text = side.get("text_inputs", side)
    return int((text["canvas_segment_ids"] > 0).sum())


def card_vs_cpu(dev, make, batch, label) -> dict:
    """One AdamW step (no warmup, clip 1.0, dropout off) of the same
    trainee at SMALL_DEPTH layers on the card and on the CPU, from the
    same weights and batch. Held: the loss within 1e-5 relative; every
    gradient entry within GRAD_RTOL of the largest (the f32 sums of the
    card's and the CPU's GEMMs come in other orders, which moves the last
    bits of every product; at BERT's 0.02 init the in-batch softmax is
    nearly flat and its gradient is a difference of near-equal terms, which
    the CPU parity tests measured at ~5e-4 of the largest entry between the
    two packages); the updated parameters within 1e-6 + 2 lr min(1, tol /
    |g|) each (Adam moves an entry by ~lr whatever its gradient's size, so
    one whose gradient is rounding noise moves either way)."""
    from viquae_torch.core.device import upload_batch
    from viquae_torch.train import optim

    lr = 1e-3
    runs = {}
    trainee = make(dev)          # seeded on the card, then moved: one init
    params = trainee.params.requires_grad_(True)
    start = {k: v.clone() for k, v in params.state_dict().items()}
    for label_, where in (("card", dev), ("cpu", torch.device("cpu"))):
        # the trainee's bundles hold these very modules: they move too
        params.to(where).load_state_dict(start)
        for p in params.parameters():
            p.grad = None
        opt = optim.make_optimizer(params, lr=lr, grad_clip=1.0).build(params)
        loss, _ = trainee.loss_fn(params, upload_batch(batch, where), None,
                                  deterministic=True)
        loss.backward()
        # copies: the CPU run's .cpu() would alias the gradients that the
        # optimizer step clips in place
        grads = {n: p.grad.detach().to("cpu", copy=True) for n, p in
                 params.named_parameters() if p.grad is not None}
        opt.step()
        runs[label_] = (float(loss.detach()), grads,
                            {n: p.detach().to("cpu", copy=True)
                             for n, p in params.named_parameters()})
    del trainee, params, opt, start
    (l_cpu, g_cpu, p_cpu), (l_dev, g_dev, p_dev) = runs["cpu"], runs["card"]
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    g_err = max(float((g_dev[n] - g).abs().max()) for n, g in g_cpu.items())
    tol = GRAD_RTOL * g_max
    p_excess = 0.0
    for n, p in p_cpu.items():
        g = g_cpu.get(n)
        scale = (torch.ones_like(p) if g is None
                 else torch.clamp(tol / g.abs().clamp_min(1e-30), max=1.0))
        bound = 1e-6 + 2 * lr * scale
        p_excess = max(p_excess, float(((p_dev[n] - p).abs() - bound).max()))
    out = {"loss_cpu": l_cpu, "loss_card": l_dev,
           "loss_rel_diff": abs(l_dev - l_cpu) / abs(l_cpu),
           "grad_max": g_max, "grad_max_abs_diff": g_err,
           "grad_rel_to_max": g_err / g_max,
           "params_excess_over_bound": p_excess}
    check(out["loss_rel_diff"] <= 1e-5 and g_err <= tol and p_excess <= 0,
          f"{label}: the card's step against the CPU's: {out}")
    return out


def phase_training(dev, tokenizer, workdir) -> dict:
    """Phase 21: training at full width. Three trainees through their
    collators and Trainer.fit (AdamW, the configs' schedules, f32, no
    TF32), each card step held against the CPU's at SMALL_DEPTH layers,
    then the command line (train fit, resume, export, save-ptm)."""
    import gc

    from viquae_torch.train import data as tdata

    rng = np.random.default_rng(21)
    out = {}
    t_block = time.perf_counter()
    # ---- DPR biencoder, configs/dpr_train.yaml --------------------------
    kb, items = dpr_train_items(rng, DPR_TRAIN_QUESTIONS)
    coll = tdata.BiEncoderCollator(tokenizer, kb=kb, M=2,
                                   n_relevant_passages=1, search_key="BM25",
                                   max_length=256, packed=True, seed=0)
    t0 = time.perf_counter()
    batch = coll.collate_fn(items)
    collate_ms = (time.perf_counter() - t0) * 1e3
    tokens = {"question": canvas_tokens(batch["question_inputs"]),
              "context": canvas_tokens(batch["context_inputs"])}
    dpr_run = {"collate_ms": collate_ms, "real_tokens": tokens,
               "questions": DPR_TRAIN_QUESTIONS, "passages": 2 *
               DPR_TRAIN_QUESTIONS, "max_length": 256, "packed": True}
    for remat in (False, True):
        res, t0 = None, time.perf_counter()
        try:
            res = timed_training(dpr_trainee(dev, remat=remat), batch,
                                 DPR_TRAIN_OPT, DPR_TRAIN_QUESTIONS,
                                 f"dpr remat={remat}")
            res.pop("trainer")
        except torch.cuda.OutOfMemoryError as e:
            if remat:
                raise
            # the config as shipped does not fit: measured and reported,
            # then the trainee's own remat_layers option is run
            res = {"out_of_memory": str(e).splitlines()[0][:300],
                   "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        res["seconds"] = time.perf_counter() - t0
        dpr_run["with_remat" if remat else "without_remat"] = res
        gc.collect()
        torch.cuda.empty_cache()
        if "out_of_memory" not in res:
            break
    emit({"phase": "training_dpr", "config": "configs/dpr_train.yaml",
          "optimizer": DPR_TRAIN_OPT, **dpr_run})
    t_check = time.perf_counter()
    dpr_run["card_vs_cpu"] = card_vs_cpu(
        dev, lambda where: dpr_trainee(where, SMALL_DEPTH),
        coll.collate_fn(items[:SMALL_BATCH]), "dpr")
    emit({"phase": "training_dpr_card_vs_cpu", **dpr_run["card_vs_cpu"],
          "check_s": time.perf_counter() - t_check,
          "block_s": time.perf_counter() - t_block})
    t_block = time.perf_counter()
    out["dpr"] = dpr_run
    del batch, coll, kb, items
    gc.collect()
    torch.cuda.empty_cache()

    # ---- multimodal ICT, configs/experiments/ict/eca.yaml ---------------
    items = ict_train_items(rng, ICT_TRAIN_ITEMS)
    feats = tdata.PreComputedImageFeatures(n_faces=0,
                                           image_dims={"clip-RN50": 1024})
    # M=1: the config sets no M, and the collator's default (24) would tile
    # each target text 24 times with rolled images that the text-only DPR
    # context tower cannot see
    coll = tdata.ICTCollator(tokenizer, M=1, max_length=256,
                             image_features=feats, text_mask_rate=0.5,
                             image_mask_rate=0.0, packed=True, seed=0)
    t0 = time.perf_counter()
    batch = coll.collate_fn(items)
    collate_ms = (time.perf_counter() - t0) * 1e3
    trainee = ict_trainee(dev)
    res = timed_training(trainee, batch, ICT_TRAIN_OPT, ICT_TRAIN_ITEMS,
                         "ict")
    trainer = res.pop("trainer")
    from viquae_torch.train.optim import freeze_mask

    frozen = [n for n, ok in freeze_mask(
        trainer.state.params, ICT_TRAIN_OPT["freeze_regex"]).items() if not ok]
    start = dict(trainee.params.named_parameters())
    now = dict(trainer.state.params.named_parameters())
    unchanged = all(torch.equal(start[n], now[n]) for n in frozen)
    moved = sum(not torch.equal(start[n], now[n]) for n in now
                if n not in frozen)
    check(frozen and unchanged and moved > 0,
          f"ict: {len(frozen)} frozen leaves unchanged={unchanged}, "
          f"{moved} trainable leaves moved")
    ict_run = {"collate_ms": collate_ms, "items": ICT_TRAIN_ITEMS,
               "real_tokens": {"question": canvas_tokens(
                   batch["question_inputs"]), "context": canvas_tokens(
                   batch["context_inputs"])},
               "remat_layers": True, "frozen_leaves": len(frozen),
               "frozen_bitwise_unchanged": unchanged,
               "trainable_leaves_moved": moved, **res}
    del trainer, trainee, start, now
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "training_ict_eca",
          "config": "configs/experiments/ict/eca.yaml", "M": 1,
          "optimizer": ICT_TRAIN_OPT, **ict_run})
    t_check = time.perf_counter()
    ict_run["card_vs_cpu"] = card_vs_cpu(
        dev, lambda where: ict_trainee(where, SMALL_DEPTH),
        coll.collate_fn(items[:SMALL_ICT_ITEMS]), "ict")
    emit({"phase": "training_ict_eca_card_vs_cpu", **ict_run["card_vs_cpu"],
          "check_s": time.perf_counter() - t_check,
          "block_s": time.perf_counter() - t_block})
    t_block = time.perf_counter()
    out["ict"] = ict_run
    del batch, coll, items
    gc.collect()
    torch.cuda.empty_cache()

    # ---- reader, configs/experiments/rc/viquae.yaml ---------------------
    kb, items = reader_train_items(rng, READER_TRAIN_QUESTIONS)
    coll = tdata.ReaderCollator(tokenizer, kb=kb, M=READER_M,
                                n_relevant_passages=8, max_n_answers=10,
                                max_length=256, packed=True, seed=0)
    t0 = time.perf_counter()
    batch = coll.collate_fn(items)
    collate_ms = (time.perf_counter() - t0) * 1e3
    check(int(batch["answer_mask"].sum()) >= READER_TRAIN_QUESTIONS * 8,
          "reader: every relevant passage holds its answer")
    res = timed_training(reader_trainee(dev, tokenizer), batch,
                         READER_TRAIN_OPT, READER_TRAIN_QUESTIONS, "reader")
    res.pop("trainer")
    reader_run = {"collate_ms": collate_ms,
                  "questions": READER_TRAIN_QUESTIONS, "m_passages": READER_M,
                  "max_length": 256, "packed": True,
                  "real_tokens": int((batch["canvas_segment_ids"] > 0).sum()),
                  "canvas": list(batch["canvas_input_ids"].shape), **res}
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "training_reader",
          "config": "configs/experiments/rc/viquae.yaml",
          "optimizer": READER_TRAIN_OPT, **reader_run})
    t_check = time.perf_counter()
    reader_run["card_vs_cpu"] = card_vs_cpu(
        dev, lambda where: reader_trainee(where, tokenizer, SMALL_DEPTH),
        coll.collate_fn(items[:1]), "reader")
    emit({"phase": "training_reader_card_vs_cpu",
          **reader_run["card_vs_cpu"],
          "check_s": time.perf_counter() - t_check,
          "block_s": time.perf_counter() - t_block})
    out["reader"] = reader_run
    del batch, coll, kb, items
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = phase_train_cli(dev, workdir)
    return out


TRAIN_CLI_QUESTIONS = 64
TRAIN_CLI_BATCH = 16


def train_cli(dev, *args) -> subprocess.Popen:
    """``python -m viquae_torch --device <dev> <args>``, started."""
    return subprocess.Popen(
        [sys.executable, "-m", "viquae_torch", "--device", str(dev),
         *map(str, args)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)))


def finished(proc, t0, label) -> tuple:
    """(wall seconds since t0, stdout) of a started CLI process."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"viquae_torch {label} failed: {err[-4000:]}")
    return time.perf_counter() - t0, out


def phase_train_cli(dev, workdir) -> dict:
    """``train fit`` of a DPR biencoder (seeded towers at full width,
    SMALL_DEPTH layers) on a synthetic dataset written with
    ``datasets.save_to_disk``: 4 steps, one checkpoint and an export; then,
    started together, ``fit --ckpt-path`` resuming to 6 steps and
    ``save-ptm --step 4``, whose towers must equal the first export.
    Wall, start-up (wall less the in-fit time) and step ms of each run."""
    from datasets import Dataset

    rng = np.random.default_rng(211)
    kb, items = dpr_train_items(rng, TRAIN_CLI_QUESTIONS)
    Dataset.from_list(items).save_to_disk(str(workdir / "train_questions"))
    Dataset.from_list(kb).save_to_disk(str(workdir / "train_kb"))
    ckpt = workdir / "train_ckpt"
    tower = {"class_name": "DPREncoder",
             "bert_config": {"num_hidden_layers": SMALL_DEPTH}}
    config = {
        "seed": 42,
        "trainee": {"kind": "biencoder",
                    "question_model": {**tower, "seed": 0},
                    "context_model": {**tower, "seed": 1}},
        "data": {"tokenizer": str(workdir / "tok"),
                 "dataset": str(workdir / "train_questions"),
                 "kb": str(workdir / "train_kb"), "M": 2,
                 "n_relevant_passages": 1, "search_key": "BM25",
                 "batch_size": TRAIN_CLI_BATCH, "max_length": 256,
                 "packed": True},
        "optimizer": DPR_TRAIN_OPT,
        "trainer": {"max_steps": 4, "log_every": 1, "keep_ckpts": 2,
                    "ckpt_dir": str(ckpt)},
        "export": str(workdir / "train_export_4"),
    }
    (workdir / "train_fit.json").write_text(json.dumps(config))
    config["trainer"]["max_steps"] = 6
    del config["trainer"]["ckpt_dir"]
    config["export"] = str(workdir / "train_export_6")
    (workdir / "train_resume.json").write_text(json.dumps(config))
    t0 = time.perf_counter()
    fit_wall, _ = finished(train_cli(dev, "train", "fit",
                                     workdir / "train_fit.json"), t0, "fit")
    t0 = time.perf_counter()
    resume = train_cli(dev, "train", "fit", workdir / "train_resume.json",
                       "--ckpt-path", ckpt)
    ptm = train_cli(dev, "save-ptm", workdir / "train_fit.json",
                    workdir / "train_ptm", "--step", 4)
    ptm_wall, printed = finished(ptm, t0, "save-ptm")
    resume_wall, _ = finished(resume, t0, "fit --ckpt-path")
    log = [json.loads(line) for line in
           (ckpt / "log.jsonl").read_text().splitlines()]
    steps = [e for e in log if "loss" in e]
    check([e["step"] for e in steps] == [1, 2, 3, 4, 5, 6] and all(
        math.isfinite(e["loss"]) for e in steps), f"train fit log: {log}")
    check(sorted(p.name for p in ckpt.glob("step_*")) ==
          ["step_4", "step_6"], "the fit's and the resume's checkpoints")
    saved = json.loads(printed.strip().splitlines()[-1])
    check(saved["step"] == 4 and len(saved["exported"]) == 2,
          f"save-ptm: {saved}")
    for name in ("question_model", "context_model"):
        with np.load(workdir / "train_ptm" / name / "params.npz") as a, \
                np.load(workdir / "train_export_4" / name / "params.npz") as b:
            check(sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files),
                f"save-ptm {name} equals the fit's export")
        check((workdir / "train_export_6" / name / "params.npz").exists(),
              f"the resumed fit exported {name}")

    def step_ms(run):
        elapsed = [e["elapsed_s"] for e in run]
        return [1e3 * (b - a) for a, b in zip(elapsed, elapsed[1:])]

    out = {"questions": TRAIN_CLI_QUESTIONS, "batch_size": TRAIN_CLI_BATCH,
           "layers": SMALL_DEPTH, "fit_wall_s": fit_wall,
           "resume_wall_s": resume_wall, "save_ptm_wall_s": ptm_wall,
           "fit_start_up_s": fit_wall - steps[3]["elapsed_s"],
           "resume_start_up_s": resume_wall - steps[5]["elapsed_s"],
           "fit_step_ms_after_first": step_ms(steps[:4]),
           "resume_step_ms_after_first": step_ms(steps[4:]),
           "losses": [e["loss"] for e in steps]}
    emit({"phase": "training_cli", "datasets_on_card": True, **out})
    return out


# ---- phase 22: the auxiliary models ---------------------------------------
VILT_PAIRS = 256           # (question, image) pairs of the retrieval batch
VILT_TEXT_TOKENS = 40      # ViltConfig.max_positions
AUX_QUESTIONS = 4          # questions of the ViLT and ECA reader batches
AUX_PASSAGES = 24          # passages a question
AUX_ANSWERS = 4            # answer spans a passage
BEM_EXAMPLES = 1024        # one score() batch
BEM_EVQA_QUESTIONS = 256   # predictions of the in-process evqa command
BEM_EM_HITS = 64           # of them exact matches (no BEM forward)
BEM_MAX_LENGTH = 128
NER_SENTENCES = 2048
NER_CLI_QUESTIONS = 512
NER_BATCH = 32
NER_MAX_LENGTH = 64
ECA_SEQ = 256              # configs/experiments/mm/eca.yaml max_length
AUX_CHECK_ROWS = 8         # rows of each card-against-CPU check
AUX_F32_TOL = 1e-4         # of the output scale, card vs CPU in f32
AUX_BF16_TOL = 2e-2        # of the output scale, card vs CPU in bf16


def rel_to_scale(got, ref) -> float:
    """max |got - ref| over max |ref|, both moved to the CPU in f32."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    check(bool(torch.isfinite(got).all()), "non-finite output on the card")
    return float((got - ref).abs().max()) / float(ref.abs().max())


def depth(cfg, layers: int):
    """``cfg`` (a BertConfig, or a config holding one as ``bert``) cut to
    ``layers`` layers."""
    if hasattr(cfg, "bert"):
        return dataclasses.replace(cfg, bert=depth(cfg.bert, layers))
    return dataclasses.replace(cfg, num_hidden_layers=layers)


def open_gates(model):
    """Every tanh gate of a multimodal module to a non-zero value (a gate
    at its initial 0 hides the visual path)."""
    with torch.no_grad():
        for i, mod in enumerate(model.modules()):
            if isinstance(mod, mm.TanhGate):
                mod.gate.fill_(0.5 + 0.01 * i)
    return model


def text_batch(rng, n, length, lo, dev):
    """(n, length) ids "w<j>" in [1000, 30000) after [CLS], a real length
    drawn in [lo, length] a row, padding masked."""
    ids = rng.integers(1000, 30_000, (n, length))
    ids[:, 0] = 101
    lengths = rng.integers(lo, length + 1, n)
    mask = (np.arange(length)[None] < lengths[:, None]).astype(np.int64)
    return (torch.from_numpy(ids * mask).to(dev),
            torch.from_numpy(mask).to(dev))


def phase_vilt(dev, rng) -> dict:
    """ViLT-B/32 (ViltConfig(): 12 x 768, 384 px / 32 = 144 patches + CLS,
    40 text tokens): vilt_for_ir_apply on VILT_PAIRS pairs in f32 and bf16,
    multi_passage_vilt_apply on AUX_QUESTIONS x AUX_PASSAGES pairs with its
    loss, then the card against the CPU at 2 layers."""
    cfg = vilt.ViltConfig()
    model = vilt.reader_init(cfg, seed=22, device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    ids, mask = text_batch(rng, VILT_PAIRS, VILT_TEXT_TOKENS, 8, dev)
    pix = torch.randn((VILT_PAIRS, cfg.image_size, cfg.image_size, 3),
                      generator=gen, device=dev)
    out = {"config": dataclasses.asdict(cfg), "pairs": VILT_PAIRS,
           "tokens_a_pair": VILT_TEXT_TOKENS + cfg.n_patches + 1}
    pooled = {}
    with torch.no_grad():
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            def run():
                return vilt.vilt_for_ir_apply(
                    model.vilt, cfg, ids, pix, attention_mask=mask,
                    compute_dtype=dtype).pooler_output
            pooled[name] = run()
            check(pooled[name].shape == (VILT_PAIRS, cfg.hidden_size)
                  and bool(torch.isfinite(pooled[name]).all()),
                  f"vilt_for_ir {name}")
            ms = time_ms(run, reps=3)
            out[f"ir_{name}_ms"] = ms
            out[f"ir_{name}_pairs_per_s"] = VILT_PAIRS / ms * 1e3
            out[f"ir_{name}_profile"] = kernel_profile(run)
        out["ir_bf16_vs_f32"] = rel_to_scale(pooled["bf16"], pooled["f32"])
        n = AUX_QUESTIONS * AUX_PASSAGES
        start = torch.from_numpy(rng.integers(
            1, 8, (AUX_QUESTIONS, AUX_PASSAGES, AUX_ANSWERS))).to(dev)
        answers = dict(start_positions=start, end_positions=start + 2,
                       answer_mask=torch.ones_like(start))

        def reader():
            return vilt.multi_passage_vilt_apply(
                model, cfg, ids[:n], pix[:n], attention_mask=mask[:n],
                m_passages=AUX_PASSAGES, **answers)
        res = reader()
        check(res.start_logits.shape == (n, VILT_TEXT_TOKENS)
              and math.isfinite(float(res.loss)), "multi_passage_vilt")
        out["reader_ms"] = time_ms(reader, reps=3)
        out["reader_pairs"] = n
        out["reader_loss"] = float(res.loss)
        # the card against the CPU at 2 layers, same weights and inputs
        small = dataclasses.replace(cfg, num_layers=SMALL_DEPTH)
        cpu = vilt.init(small, seed=23, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        rows = slice(0, AUX_CHECK_ROWS)
        for name, dtype, tol in (("f32", torch.float32, AUX_F32_TOL),
                                 ("bf16", torch.bfloat16, AUX_BF16_TOL)):
            got = vilt.apply(card, small, ids[rows], pix[rows],
                             attention_mask=mask[rows], compute_dtype=dtype)
            ref = vilt.apply(cpu, small, ids[rows].cpu(), pix[rows].cpu(),
                             attention_mask=mask[rows].cpu(),
                             compute_dtype=dtype)
            err = rel_to_scale(got["last_hidden_state"],
                               ref["last_hidden_state"])
            out[f"card_vs_cpu_{name}"] = err
            check(err <= tol, f"vilt card vs cpu {name}: {err} > {tol}")
    del model, pix
    return out


def bem_examples(rng, n) -> list:
    def phrase(lo, hi):
        return words(rng.integers(1000, 30_000, rng.integers(lo, hi + 1)))

    return [{"question": phrase(6, 20), "reference": phrase(1, 5),
             "candidate": phrase(1, 5)} for _ in range(n)]


def phase_bem(dev, rng, tokenizer, workdir) -> dict:
    """BEM at BEMConfig() (BERT-base, 3 token types, pooler), the scorer at
    max_length 128: score() on BEM_EXAMPLES examples in one batch (wall on
    the host clock, the forward alone with CUDA events); ``evqa --scorer
    bem`` in process on BEM_EVQA_QUESTIONS predictions over an export of
    the same weights (Exact Match first, one BEM forward a miss, as the
    reference), its accuracy against the same protocol run here; the
    card's probabilities against the CPU's at 2 layers."""
    from viquae_torch import cli as port_cli
    from viquae_torch.data import evqa
    from viquae_torch.train.checkpoint import export_params

    cfg = bem.BEMConfig()
    model = bem.init(cfg, seed=24, device=dev)
    scorer = bem.BEMScorer(cfg, model, tokenizer, max_length=BEM_MAX_LENGTH,
                           device=dev)
    examples = bem_examples(rng, BEM_EXAMPLES)
    out = {"examples": BEM_EXAMPLES, "max_length": BEM_MAX_LENGTH}
    scorer.score(examples[:8])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = scorer.score(examples)
    out["score_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["score_examples_per_s"] = BEM_EXAMPLES / out["score_wall_ms"] * 1e3
    check(probs.shape == (BEM_EXAMPLES,) and np.isfinite(probs).all()
          and ((probs >= 0) & (probs <= 1)).all(), "BEM probabilities")
    rows = [bem.combine_segments(
        scorer._encode(e["candidate"]), scorer._encode(e["reference"]),
        scorer._encode(e["question"]), scorer.cls_id, scorer.sep_id,
        BEM_MAX_LENGTH) for e in examples]
    batch = [torch.from_numpy(np.stack([r[k] for r in rows])).to(dev)
             for k in ("input_ids", "segment_ids", "attention_mask")]
    with torch.no_grad():
        out["forward_ms"] = time_ms(lambda: bem.apply(model, cfg, *batch),
                                    reps=3)
    out["real_tokens"] = int(batch[2].sum())

    # evqa --scorer bem in process, one forward a miss
    export_params(workdir / "bem", convert.tree_from_module(model))
    (workdir / "bem.json").write_text(json.dumps({
        "tokenizer": str(workdir / "tok"), "params": str(workdir / "bem"),
        "scorer": {"max_length": BEM_MAX_LENGTH}}))
    evqa_examples = bem_examples(rng, BEM_EVQA_QUESTIONS)
    predictions, references = {}, {}
    for i, ex in enumerate(evqa_examples):
        qid = f"q{i}"
        predictions[qid] = (ex["reference"] if i < BEM_EM_HITS
                            else ex["candidate"])
        references[qid] = {"reference": ex["reference"],
                           "question": ex["question"]}
    (workdir / "pred.json").write_text(json.dumps(predictions))
    (workdir / "ref.json").write_text(json.dumps(references))
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        port_cli.main(["--device", str(dev), "evqa",
                       str(workdir / "pred.json"), str(workdir / "ref.json"),
                       "--scorer", "bem", "--config",
                       str(workdir / "bem.json")])
    out["evqa_command_s"] = time.perf_counter() - t0
    cli_result = json.loads(printed.getvalue().strip().splitlines()[-1])
    calls = []

    def counted(example, threshold_score=True):
        calls.append(1)
        return scorer(example, threshold_score=threshold_score)

    bem_fn = evqa.initialize_bem_scoring_function(scorer=counted)
    t0 = time.perf_counter()
    direct = evqa.evaluate(predictions, references, scoring_function=(
        lambda ex: evqa.encyclopedic_vqa_evaluation_function(ex, bem_fn)))
    protocol_s = time.perf_counter() - t0
    check(cli_result == direct, f"evqa command {cli_result} vs {direct}")
    check(len(calls) == BEM_EVQA_QUESTIONS - BEM_EM_HITS,
          f"BEM forwards {len(calls)}: one a miss")
    out["evqa_example_profile"] = kernel_profile(
        lambda: scorer(evqa_examples[-1]))
    out.update({"evqa": cli_result, "evqa_bem_forwards": len(calls),
                "evqa_protocol_s": protocol_s,
                "evqa_ms_per_bem_example": protocol_s / len(calls) * 1e3})
    # the card against the CPU at 2 layers
    small = depth(cfg, SMALL_DEPTH)
    cpu = bem.init(small, seed=25, device="cpu")
    on_card = bem.BEMScorer(small, copy.deepcopy(cpu), tokenizer,
                            max_length=BEM_MAX_LENGTH, device=dev)
    on_cpu = bem.BEMScorer(small, cpu, tokenizer, max_length=BEM_MAX_LENGTH,
                           device="cpu")
    got = on_card.score(examples[:AUX_CHECK_ROWS])
    ref = on_cpu.score(examples[:AUX_CHECK_ROWS])
    out["card_vs_cpu_prob_max_abs"] = float(np.abs(got - ref).max())
    check(out["card_vs_cpu_prob_max_abs"] <= 1e-5, "BEM card vs cpu")
    del model, scorer
    return out


def ner_sentences(rng, n) -> list:
    return [words(rng.integers(1000, 30_000, rng.integers(8, 41)))
            for _ in range(n)]


def phase_ner(dev, rng, tokenizer, workdir) -> dict:
    """Neural NER at NERConfig() (BERT-base, 9 CoNLL labels): NeuralNER at
    max_length 64, batch 32, bf16 over NER_SENTENCES sentences
    (sentences/s, host tokenization and BIO decoding included; one batch's
    forward with CUDA events); ``kilt2vqa ner`` with a ``neural`` block in
    process on a ``datasets`` dataset of NER_CLI_QUESTIONS questions, the
    model directory written from the seeded weights
    (``ner.save_pretrained_hf``), its first placeholders against the same
    NeuralNER here; the card against the CPU at 2 layers (f32 labels equal,
    bf16 under the margin rule)."""
    from datasets import Dataset, load_from_disk

    from viquae_torch import cli as port_cli
    from viquae_torch.data import kilt2vqa

    cfg = ner.NERConfig()
    model = ner.init(cfg, seed=26, device=dev)
    tagger = ner.NeuralNER(model, cfg, tokenizer, max_length=NER_MAX_LENGTH,
                           batch_size=NER_BATCH, device=dev)
    sentences = ner_sentences(rng, NER_SENTENCES)
    tagger.predict_batch(sentences[:NER_BATCH])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spans = tagger.predict_batch(sentences)
    wall = time.perf_counter() - t0
    check(len(spans) == NER_SENTENCES, "NeuralNER spans")
    enc = tokenizer(sentences[:NER_BATCH], padding="max_length",
                    truncation=True, max_length=NER_MAX_LENGTH,
                    return_tensors="pt")
    ids, mask = enc["input_ids"].to(dev), enc["attention_mask"].to(dev)
    with torch.no_grad():
        forward_ms = time_ms(lambda: ner.apply(
            model, cfg, ids, mask, compute_dtype=torch.bfloat16), reps=5)
    out = {"sentences": NER_SENTENCES, "batch": NER_BATCH,
           "max_length": NER_MAX_LENGTH, "compute_dtype": "bf16",
           "wall_s": wall, "sentences_per_s": NER_SENTENCES / wall,
           "batch_forward_ms": forward_ms,
           "batch_profile": kernel_profile(
               lambda: tagger.predict_batch(sentences[:NER_BATCH])),
           "spans": sum(len(s) for s in spans)}
    # kilt2vqa ner with a neural block, in process
    ner.save_pretrained_hf(model, cfg, workdir / "ner")
    questions = ner_sentences(rng, NER_CLI_QUESTIONS)
    Dataset.from_list([{"id": f"q{i}", "input": q}
                       for i, q in enumerate(questions)]).save_to_disk(
        str(workdir / "ner_questions"))
    (workdir / "ner.json").write_text(json.dumps({"neural": {
        "path": str(workdir / "ner"), "tokenizer": str(workdir / "tok"),
        "max_length": NER_MAX_LENGTH, "batch_size": NER_BATCH}}))
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        port_cli.main(["--device", str(dev), "kilt2vqa", "ner",
                       str(workdir / "ner_questions"), "--output",
                       str(workdir / "ner_out"), "--config",
                       str(workdir / "ner.json")])
    out["kilt2vqa_ner_s"] = time.perf_counter() - t0
    out["kilt2vqa_ner_questions_per_s"] = (NER_CLI_QUESTIONS
                                           / out["kilt2vqa_ner_s"])
    printed = json.loads(printed.getvalue().strip().splitlines()[-1])
    check(printed["items"] == NER_CLI_QUESTIONS, f"kilt2vqa ner {printed}")
    done = load_from_disk(str(workdir / "ner_out"))
    here = [kilt2vqa.item2placeholder({"input": q}, ner_fn=tagger)[
        "placeholder"] for q in questions[:AUX_CHECK_ROWS * 8]]
    check(done[: len(here)]["placeholder"] == here,
          "kilt2vqa ner placeholders against the in-process NeuralNER")
    out["kilt2vqa_placeholders"] = sum(len(p) for p in done["placeholder"])
    # the card against the CPU at 2 layers
    small = depth(cfg, SMALL_DEPTH)
    cpu = ner.init(small, seed=27, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    texts = sentences[:AUX_CHECK_ROWS * 8]
    check(ner.NeuralNER(card, small, tokenizer, NER_MAX_LENGTH, NER_BATCH,
                        torch.float32, dev).predict_batch(texts)
          == ner.NeuralNER(cpu, small, tokenizer, NER_MAX_LENGTH, NER_BATCH,
                           torch.float32, "cpu").predict_batch(texts),
          "NER f32 spans card vs cpu")
    enc = tokenizer(texts, padding="max_length", truncation=True,
                    max_length=NER_MAX_LENGTH, return_tensors="pt")
    got = ner.apply(card, small, enc["input_ids"].to(dev),
                    enc["attention_mask"].to(dev),
                    compute_dtype=torch.bfloat16).cpu()
    ref = ner.apply(cpu, small, enc["input_ids"], enc["attention_mask"],
                    compute_dtype=torch.bfloat16)
    out["card_vs_cpu_bf16_logits"] = rel_to_scale(got, ref)
    check(out["card_vs_cpu_bf16_logits"] <= AUX_BF16_TOL, "NER bf16 logits")
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * AUX_BF16_TOL * float(
        ref.abs().max())
    out["bf16_margin_clear_share"] = float(clear.float().mean())
    check(torch.equal(got.argmax(-1)[clear], ref.argmax(-1)[clear]),
          "NER bf16 labels under the margin rule")
    del model, tagger
    return out


def eca_batch(rng, n, dev) -> tuple:
    """configs/experiments/mm/eca.yaml's inputs: (n, ECA_SEQ) question +
    passage rows of 100-256 real tokens, no face, one unit CLIP-RN50
    feature a row (none for 10 %)."""
    ids, mask = text_batch(rng, n, ECA_SEQ, 100, dev)
    feats = rng.standard_normal((n, 1, 1024)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    face = {"face": torch.zeros((n, 1, 0, 512), device=dev),
            "bbox": torch.zeros((n, 1, 0, 7), device=dev),
            "attention_mask": torch.zeros((n, 1, 0), dtype=torch.long,
                                          device=dev)}
    image = {"clip-RN50": {
        "input": torch.from_numpy(feats).to(dev),
        "attention_mask": torch.from_numpy(
            (rng.random((n, 1)) >= 0.1).astype(np.int64)).to(dev)}}
    return {"input_ids": ids, "attention_mask": mask}, face, image


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def phase_mm_heads(dev, rng) -> dict:
    """The ECA reader and the ECA and Flamant re-rankers at the widths of
    configs/experiments/mm/eca.yaml (BERT-base, no face, one CLIP-RN50
    1,024 feature), gating on with every gate non-zero: the reader's
    forward and loss on AUX_QUESTIONS x AUX_PASSAGES x ECA_SEQ, the
    re-rankers on the same pairs; each at 2 layers on the card against the
    CPU."""
    cfg = mm.MMConfig(n_faces=0, image_dims=(("clip-RN50", 1024),),
                      gating=True)
    fcfg = mm.FlamantConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})
    n = AUX_QUESTIONS * AUX_PASSAGES
    text, face, image = eca_batch(rng, n, dev)
    start = torch.from_numpy(rng.integers(
        1, 100, (AUX_QUESTIONS, AUX_PASSAGES, AUX_ANSWERS))).to(dev)
    answers = dict(start_positions=start, end_positions=start + 3,
                   answer_mask=torch.ones_like(start))
    out = {"pairs": n, "seq": ECA_SEQ,
           "real_tokens": int(text["attention_mask"].sum())}
    heads = (("eca_reader", qa.eca_reader_init, cfg, qa.eca_reader_apply,
              "start_logits", (n, ECA_SEQ)),
             ("eca_reranker", rr.eca_reranker_init, cfg,
              rr.eca_reranker_apply, "logits", (n,)),
             ("flamant_reranker", rr.flamant_reranker_init, fcfg,
              rr.flamant_reranker_apply, "logits", (n,)))
    rows = slice(0, AUX_CHECK_ROWS)
    part = ({k: v[rows] for k, v in text.items()},
            {k: v[rows] for k, v in face.items()},
            {k: {kk: vv[rows] for kk, vv in v.items()}
             for k, v in image.items()})
    with torch.no_grad():
        for name, init, c, apply, field, shape in heads:
            extra = (dict(m_passages=AUX_PASSAGES, **answers)
                     if name == "eca_reader" else {})
            model = open_gates(init(c, seed=28, device=dev))
            res = apply(model, c, text, face, image, **extra)
            check(getattr(res, field).shape == shape and bool(
                torch.isfinite(getattr(res, field)).all()), name)
            if extra:
                check(math.isfinite(float(res.loss)), "eca reader loss")
                out["eca_reader_loss"] = float(res.loss)
            out[f"{name}_ms"] = time_ms(
                lambda: apply(model, c, text, face, image, **extra), reps=3)
            del model, res
            # the card against the CPU at 2 layers, same weights and rows
            small = depth(c, SMALL_DEPTH)
            cpu = open_gates(init(small, seed=29, device="cpu"))
            card = copy.deepcopy(cpu).to(dev)
            err = rel_to_scale(getattr(apply(card, small, *part), field),
                               getattr(apply(cpu, small, *map(to_cpu, part)),
                                       field))
            out[f"{name}_card_vs_cpu"] = err
            check(err <= AUX_F32_TOL, f"{name} card vs cpu: {err}")
    return out


def phase_auxiliary(dev, tokenizer, workdir) -> dict:
    """Phase 22: ViLT, BEM (with ``evqa``), neural NER (with ``kilt2vqa
    ner``), the ECA reader and the ECA and Flamant re-rankers at full
    width on the card, seeded weights; plain torch ops (no kernel of the
    port is on these paths)."""
    rng = np.random.default_rng(22)
    out = {}
    for name, run in (("vilt", lambda: phase_vilt(dev, rng)),
                      ("bem", lambda: phase_bem(dev, rng, tokenizer,
                                                workdir)),
                      ("ner", lambda: phase_ner(dev, rng, tokenizer,
                                                workdir)),
                      ("mm_heads", lambda: phase_mm_heads(dev, rng))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out[name] = run()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        emit({"phase": f"auxiliary_{name}", **out[name]})
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 23: the IVF-Flat index over phase 5's KB
# --------------------------------------------------------------------------
IVF_NPROBES = (8, 32)
IVF_CHECK_QUERIES = 64
IVF_SLICE_ROWS = 65_536
IVF_SLICE_QUERIES = 256
IVF_OWN_ROWS = 256


def timed_ivf_build(kb, **kwargs):
    """``IVFFlatIndex(kb, **kwargs)`` on ``kb``'s device and its build's
    seconds by stage: k-means++, the Lloyd iterations and the assignment
    pass are each timed with the device synchronized around them; the rest
    of the build (the host's draw of the training sample, the sort, the
    skew split and the cluster-sorted copy) is ``sort_and_layout_s``."""
    stages = {"kmeanspp_s": 0.0, "lloyd_s": 0.0, "assign_s": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            stages[name] += time.perf_counter() - t0
            return res
        return wrapper

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(ivf, "_kmeanspp_init",
                           timed("kmeanspp_s", ivf._kmeanspp_init)), \
            mock.patch.object(ivf, "_kmeans_fit",
                              timed("lloyd_s", ivf._kmeans_fit)), \
            mock.patch.object(ivf, "_assign_chunk",
                              timed("assign_s", ivf._assign_chunk)):
        index = ivf.IVFFlatIndex(kb, device=kb.device, **kwargs)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    sizes = index._st.sizes.float()
    stages.update(sort_and_layout_s=total - sum(stages.values()),
                  total_s=total, nlist=index.nlist, list_cap=index.list_cap,
                  mean_list_size=float(sizes.mean()),
                  max_list_size=int(sizes.max()),
                  empty_lists=int((sizes == 0).sum()),
                  index_bytes=index.nbytes())
    return index, stages


def recall_at(ids, ref_ids) -> float:
    """Mean share of each reference row's ids found in the same row."""
    return float(np.mean([len(np.intersect1d(a, b)) / len(b)
                          for a, b in zip(ids, ref_ids)]))


def probed_brute_force(index, q, nprobe, k):
    """Per query: ``torch.matmul`` over exactly the rows of its probed
    lists, then the finalize_topk tail (host loop, for the gate)."""
    st = index._st
    probed = ivf._probe(q, st.centroids, nprobe).cpu()
    starts, sizes = st.starts.cpu(), st.sizes.cpu()
    out_s, out_i = [], []
    for r in range(q.shape[0]):
        rows = torch.cat([torch.arange(int(starts[c]),
                                       int(starts[c] + sizes[c]))
                          for c in probed[r]]).to(q.device)
        cand = torch.matmul(st.matrix[rows].float(), q[r])[None]
        s, i = mips.finalize_topk(cand, st.ids[rows][None], k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s).cpu().numpy(), torch.cat(out_i).cpu().numpy()


def f32_agreement(ids, scores, ref_ids, ref_scores, q, kb_absmax) -> dict:
    """Two f32 top-k results of the same search summed in other orders
    (host arrays), the f32 counterpart of tie_aware_agreement: scores
    positionwise within the reordering bound of their dot products (2 g_d
    |q|_1 max|kb|), so that ids may differ only between near-equal
    scores; and no id kept by one side and not the other whose score
    clears the row's k-th score by more than that bound."""
    d = q.shape[1]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    bound = 2 * gamma * np.abs(q).sum(1, keepdims=True) * kb_absmax
    finite = np.isfinite(ref_scores)
    diff = np.abs(np.where(finite, scores, 0.0)
                  - np.where(finite, ref_scores, 0.0))
    kth = np.where(np.isfinite(ref_scores[:, -1:]), ref_scores[:, -1:],
                   -np.inf)
    clear = 0
    for r in range(len(ids)):
        for side_ids, side_scores, other in ((ids[r], scores[r], ref_ids[r]),
                                             (ref_ids[r], ref_scores[r],
                                              ids[r])):
            lone = ~np.isin(side_ids, other)
            clear += int((side_scores[lone] - kth[r, 0] > bound[r, 0]).sum())
    return {"id_agreement": float((ids == ref_ids).mean()),
            "max_score_diff_over_bound": float((diff / bound).max()),
            "ids_apart_clear_of_kth": clear,
            "same_infinities": bool((np.isfinite(scores) == finite).all())}


def f32_agreement_ok(agreement: dict, id_share: float = 0.999) -> bool:
    return (agreement["id_agreement"] >= id_share
            and agreement["max_score_diff_over_bound"] <= 1.0
            and agreement["ids_apart_clear_of_kth"] == 0
            and agreement["same_infinities"])


def phase_ivf(dev, main) -> dict:
    """Phase 23: IVFFlatIndex built on phase 5's KB (1.5M x 768 bf16 rows,
    on the card) at the reference's defaults (nlist 1,024, 64 training
    points a list, 10 Lloyd iterations, max_list_factor 4), f32 storage
    and once bf16; search of phase 5's 1,257 question vectors at nprobe 8
    and 32 (CUDA events, median of 4) with recall@100 against phase 5's
    exact top-100, beside B1's exact search ms of the same run; the gates
    of ROADMAP's A17a (brute force over the probed lists, full probe =
    exact, card = CPU on one saved state, save/load bit-equal, a traced
    search holding CUDA kernel events)."""
    index, n_q = main["index"], N_QUERIES
    kb = index.matrix[: index.n]
    q = main["q"][:n_q].float()
    out = {"kb_rows": index.n, "queries": n_q,
           "b1_exact_search_ms": main["search_ms"]}
    # KB rows as their own queries: is a row found in its own search?
    gen = torch.Generator(device=dev).manual_seed(23)
    own = torch.randint(0, index.n, (IVF_OWN_ROWS,), generator=gen,
                        device=dev)
    wall = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        wall[name] = now - mark
        mark = now

    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        built, stages = timed_ivf_build(kb, dtype=dtype)
        res = {"build": stages}
        for nprobe in IVF_NPROBES:
            s, i = built.search_batch(q, K, nprobe=nprobe, sync=False)
            res[f"nprobe_{nprobe}"] = {
                "search_ms": time_ms(lambda: built.search_batch(
                    q, K, nprobe=nprobe, sync=False), reps=4),
                "recall_at_100": recall_at(i.cpu().numpy(), main["ids"]),
                "own_row_found": recall_at(
                    built.search_batch(kb[own].float(), K,
                                       nprobe=nprobe)[1],
                    own.cpu().numpy()[:, None])}
            check(bool(torch.isfinite(s[:, 0]).all()), f"ivf {label} scores")
        out[label] = res
        lap(f"{label}_build_and_search_s")
        emit({"phase": f"ivf_{label}", **res,
              "b1_exact_search_ms": main["search_ms"]})
        if label == "f32":
            nprobe = IVF_NPROBES[0]
            qc = q[:IVF_CHECK_QUERIES]
            s, i = built.search_batch(qc, K, nprobe=nprobe)
            bs, bi = probed_brute_force(built, qc, nprobe, K)
            agree = f32_agreement(i, s, bi, bs, qc.cpu().numpy(),
                                  float(kb.abs().max()))
            out["brute_force_over_probed_lists"] = agree
            check(f32_agreement_ok(agree), f"ivf vs brute force: {agree}")
            lap("brute_force_s")
        del built
        torch.cuda.empty_cache()

    # ---- a 65,536-row slice: full probe, card vs CPU, save/load, trace ---
    part = kb[:IVF_SLICE_ROWS]
    q = q[:IVF_SLICE_QUERIES]
    small = ivf.IVFFlatIndex(part, device=dev)
    s, i = small.search_batch(q, K, nprobe=small.nlist)
    es, ei = mips.topk_single(q, part.float(), K, mode="exact")
    lap("slice_full_probe_s")
    part_max = float(part.abs().max())
    full = f32_agreement(i, s, ei.cpu().numpy(), es.cpu().numpy(),
                         q.cpu().numpy(), part_max)
    out["slice"] = {"rows": IVF_SLICE_ROWS, "queries": IVF_SLICE_QUERIES,
                    "nlist": small.nlist,
                    "list_cap": small.list_cap, "full_probe_vs_exact": full}
    check(f32_agreement_ok(full), f"ivf full probe vs exact: {full}")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        small.save(f"{tmp}/ivf")
        lap("slice_save_s")
        again = ivf.IVFFlatIndex.load(f"{tmp}/ivf", device=dev)
        on_cpu = ivf.IVFFlatIndex.load(f"{tmp}/ivf", device="cpu")
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        dataclasses.astuple(small._st), dataclasses.astuple(again._st)))
    s2, i2 = again.search_batch(q, K, nprobe=IVF_NPROBES[0])
    s1, i1 = small.search_batch(q, K, nprobe=IVF_NPROBES[0])
    same = same and np.array_equal(i1, i2) and np.array_equal(s1, s2)
    out["slice"]["save_load_bit_equal"] = same
    check(same, "ivf save/load round trip")
    lap("slice_load_s")
    cs, ci = on_cpu.search_batch(q.cpu(), K, nprobe=IVF_NPROBES[0])
    lap("slice_cpu_search_s")
    card_cpu = f32_agreement(i1, s1, ci, cs, q.cpu().numpy(), part_max)
    out["slice"]["card_vs_cpu"] = card_cpu
    check(f32_agreement_ok(card_cpu), f"ivf card vs cpu: {card_cpu}")
    from viquae_torch.core.profiling import annotate, trace

    import glob

    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            with annotate("ivf_search"):
                small.search_batch(q, K, nprobe=IVF_NPROBES[0])
        files = glob.glob(f"{tmp}/*.pt.trace.json")
        events = json.load(open(files[0]))["traceEvents"] if files else []
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    out["slice"]["trace"] = {"files": len(files), "cuda_kernel_events":
                             kernels, "annotated": any(
                                 e.get("name") == "ivf_search"
                                 for e in events)}
    check(kernels > 0, f"the traced ivf search holds no kernel event: "
          f"{out['slice']['trace']}")
    lap("trace_s")
    out["wall_s"] = wall
    emit({"phase": "ivf_slice", **out["slice"], "wall_s": wall})
    del small, again, on_cpu
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 24: the Mixture-of-Experts BERT
# --------------------------------------------------------------------------
# GShard (arXiv:2006.16668): top-2 experts in every other FFN, tokens in
# groups; capacity factor and group size are the reference's defaults
MOE_BERT = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                moe_every=2, moe_group_size=1024)
MOE_CHECK_QUESTIONS = 64
# 4 x 2 choices x 1,024 tokens / 8 experts = 1,024 slots an expert a
# group: a token takes each expert at most once, so nothing is dropped
MOE_AMPLE_CAPACITY = 4.0


def moe_dpr_config(layers_: int = 12) -> dpr.DPRConfig:
    return dpr.DPRConfig(bert=dataclasses.replace(
        dpr.DPRConfig().bert, num_hidden_layers=layers_, **MOE_BERT))


class RouteLog:
    """Patches ``moe._route`` to record every MoE layer's routing: the
    valid choices, the ones dropped by capacity, and (with ``keep``) each
    call's expert ids, kept flags and router logits."""

    def __init__(self, keep: bool = False):
        self.keep, self.calls = keep, []
        self.choices = self.dropped = 0

    def __enter__(self):
        orig = moe_lib._route

        def wrapper(params, tokens, valid, top_k, capacity, n_groups, tg,
                    *rest):
            res = orig(params, tokens, valid, top_k, capacity, n_groups, tg,
                       *rest)
            slots = res[3]
            n_slots = params["in"].weight.shape[0] * n_groups * capacity
            v = valid[:, None].expand_as(slots)
            self.choices += int(v.sum())
            self.dropped += int(((slots == n_slots) & v).sum())
            if self.keep:
                logits = torch.matmul(tokens.float(),
                                      params["router"].weight.float().T)
                self.calls.append({"experts": res[2].cpu(),
                                   "kept": (slots < n_slots).cpu(),
                                   "logits": logits.cpu(),
                                   "valid": valid.cpu()})
            return res

        self._patch = mock.patch.object(moe_lib, "_route", wrapper)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def moe_card_vs_cpu(dev, queries) -> dict:
    """The MoE BERT at SMALL_DEPTH layers (layer 2 is the MoE one), same
    weights on the card and the CPU, packed questions: in f32 the last
    hidden states within AUX_F32_TOL of the scale; in bf16 the routing
    equal wherever the router's top-k margin (the k-th logit over the
    next) clears two roundings (2 AUX_BF16_TOL of the largest logit), and
    the hidden states within AUX_BF16_TOL of the scale at the tokens whose
    routing and kept slots agree."""
    cfg = moe_dpr_config(SMALL_DEPTH)
    tree = convert.init_tree(cfg, seed=25)
    canvas = PackedTextEmbedder(
        dpr.make_packed_apply(cfg), None, WhitespaceTokenizer(),
        row_len=ROW_LEN, batch_size=MOE_CHECK_QUESTIONS,
        device="cpu").pack(queries[:MOE_CHECK_QUESTIONS])
    arrays = [torch.from_numpy(np.asarray(a).astype(np.int64)) for a in
              (canvas.input_ids, canvas.segment_ids, canvas.position_ids)]
    real = arrays[1] > 0
    out = {"tokens": int(real.sum())}
    runs = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for where in (dev, torch.device("cpu")):
            model = convert.params_from_jax(tree, cfg, device=where)
            ids, seg, pos = (a.to(where) for a in arrays)
            with RouteLog(keep=True) as log, torch.no_grad():
                res = bert.apply(model, cfg.bert, ids, position_ids=pos,
                                 segment_ids=seg, compute_dtype=dtype)
            runs[where.type] = (res["last_hidden_state"].float().cpu(),
                                log.calls[0])
        (h_card, r_card), (h_cpu, r_cpu) = runs[dev.type], runs["cpu"]
        scale = float(h_cpu[real].abs().max())
        if label == "f32":
            err = float((h_card[real] - h_cpu[real]).abs().max()) / scale
            out["f32_rel_to_scale"] = err
            check(err <= AUX_F32_TOL, f"moe f32 card vs cpu: {err}")
            continue
        k = cfg.bert.moe_top_k
        top = r_cpu["logits"].sort(dim=-1, descending=True).values
        clear = (top[:, k - 1] - top[:, k]) > 2 * AUX_BF16_TOL * float(
            r_cpu["logits"].abs().max())
        valid = r_cpu["valid"]
        same_experts = (r_card["experts"] == r_cpu["experts"]).all(1)
        held = same_experts & (r_card["kept"] == r_cpu["kept"]).all(1)
        flat_real = real.reshape(-1)
        n = flat_real.shape[0]
        held_tokens = (held[:n] & flat_real).reshape(real.shape)
        err = float((h_card[held_tokens] - h_cpu[held_tokens]).abs().max()
                    ) / scale
        out.update(bf16_rel_to_scale=err,
                   bf16_margin_clear_share=float(clear[valid].float().mean()),
                   bf16_routing_equal_share=float(
                       same_experts[valid].float().mean()),
                   bf16_held_token_share=float(held_tokens.sum()) / float(
                       real.sum()))
        check(bool(same_experts[clear & valid].all()),
              "moe bf16 routing where the margin clears two roundings")
        check(err <= AUX_BF16_TOL, f"moe bf16 card vs cpu: {err}")
    return out


def phase_moe(dev, main) -> dict:
    """Phase 24: DPR BERT-base with MoE FFNs (MOE_BERT: 8 experts, top-2,
    every other layer, groups of 1,024 tokens, capacity factor 1.25),
    seeded weights: the packed question encoder on phase 5's 1,257
    questions in bf16 against phase 5's dense encoder on the same canvas
    (CUDA events), the share of choices dropped by capacity and the aux;
    the card against the CPU at 2 layers; then a biencoder with MoE towers
    (dropout off) at configs/dpr_train.yaml's shapes with remat_layers:
    step ms over TRAIN_STEPS, peak memory and the aux in the loss at the
    config's capacity, the loss falling at MOE_AMPLE_CAPACITY."""
    from viquae_torch.core.device import upload_batch
    from viquae_torch.train import data as tdata
    from viquae_torch.train.trainee import BiEncoderTrainee

    cfg = moe_dpr_config()
    queries = main["queries"]
    model = convert.params_from_jax(convert.init_tree(cfg, seed=24), cfg,
                                    device=dev, dtype=torch.bfloat16)
    embedder = PackedTextEmbedder(dpr.make_packed_apply(cfg), model,
                                  WhitespaceTokenizer(), row_len=ROW_LEN,
                                  batch_size=BATCH,
                                  compute_dtype=torch.bfloat16, device=dev)
    canvas = embedder.upload(embedder.pack(queries[:BATCH]))
    dense = main["embedder"]
    dense_canvas = dense.upload(dense.pack(queries[:BATCH]))
    with RouteLog() as log, torch.no_grad():
        cls, aux = dpr.apply_packed(model, cfg, *canvas,
                                    compute_dtype=torch.bfloat16,
                                    return_aux=True)
    check(bool(torch.isfinite(cls[:N_QUERIES]).all())
          and math.isfinite(float(aux)), "moe encoder output")
    out = {"config": MOE_BERT, "layers": cfg.bert.num_hidden_layers,
           "questions": N_QUERIES,
           "real_tokens": int((canvas[1] > 0).sum()),
           "moe_forward_ms": time_ms(lambda: embedder.forward(*canvas),
                                     reps=4),
           "dense_forward_ms": time_ms(lambda: dense.forward(*dense_canvas),
                                       reps=4),
           "dropped_share": log.dropped / max(log.choices, 1),
           "choices": log.choices, "aux": float(aux)}
    emit({"phase": "moe_forward", **out})
    del model, embedder, canvas
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = moe_card_vs_cpu(dev, queries)
    emit({"phase": "moe_card_vs_cpu", **out["card_vs_cpu"]})

    # ---- training: a biencoder with MoE towers, dpr_train.yaml shapes ----
    import tempfile
    from pathlib import Path

    rng = np.random.default_rng(24)
    kb, items = dpr_train_items(rng, DPR_TRAIN_QUESTIONS)
    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = bert_vocab_tokenizer(Path(tmp) / "tok",
                                         cfg.bert.vocab_size)
    batch = tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, n_relevant_passages=1, search_key="BM25",
        max_length=256, packed=True, seed=0).collate_fn(items)
    # dropout off: the step's objective is then the loss the check reads.
    # At capacity factor 1.25 a seeded router drops about a quarter of the
    # choices, and a step that moves a token across an expert's capacity
    # changes its output by a whole expert's: the loss is not smooth
    # there, so it is reported, and the fall is checked on the same towers
    # with ample capacity (MOE_AMPLE_CAPACITY: no choice dropped).
    def moe_trainee(capacity_factor):
        bcfg = dataclasses.replace(
            cfg.bert, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
            moe_capacity_factor=capacity_factor)
        towers = [dpr.DPREncoder(cfg=dpr.DPRConfig(bert=bcfg), seed=s,
                                 device=dev) for s in (0, 1)]
        return towers, BiEncoderTrainee(*towers, remat_layers=True)

    towers, trainee = moe_trainee(cfg.bert.moe_capacity_factor)
    with torch.no_grad():
        on_card = upload_batch(batch, dev)
        loss, outputs = trainee.loss_fn(trainee.params, on_card,
                                        deterministic=True)
        loss0, _ = BiEncoderTrainee(*towers, moe_aux_weight=0.0).loss_fn(
            trainee.params, on_card, deterministic=True)
    aux_term = float(outputs["moe_aux"])
    in_loss = abs(float(loss) - float(loss0) - aux_term) <= 1e-5 * abs(
        float(loss))
    check(aux_term > 0 and in_loss, f"the moe aux is not in the loss: "
          f"{float(loss)} {float(loss0)} {aux_term}")
    del on_card
    res = timed_training(trainee, batch, DPR_TRAIN_OPT, DPR_TRAIN_QUESTIONS,
                         "moe dpr remat", require_fall=False)
    res.pop("trainer")
    del trainee, towers
    torch.cuda.empty_cache()
    towers, trainee = moe_trainee(MOE_AMPLE_CAPACITY)
    ample = timed_training(trainee, batch, DPR_TRAIN_OPT,
                           DPR_TRAIN_QUESTIONS, "moe dpr remat, ample "
                           "capacity")
    ample.pop("trainer")
    out["training"] = {"aux_term": aux_term, "aux_in_loss": in_loss,
                       "real_tokens": {
                           "question": canvas_tokens(batch[
                               "question_inputs"]),
                           "context": canvas_tokens(batch[
                               "context_inputs"])}, **res,
                       "ample_capacity": {"capacity_factor":
                                          MOE_AMPLE_CAPACITY, **ample}}
    emit({"phase": "moe_training", "config": "configs/dpr_train.yaml + "
          "MOE_BERT, remat_layers, dropout 0", **out["training"]})
    del trainee, towers, batch
    torch.cuda.empty_cache()
    return out


# ---- phase 25: serving on the mesh ------------------------------------------
SHARD_RANKS = 4            # gloo ranks sharing the one card
SHARD_VALID_ROWS = N_KB - 37   # the last shard part padding
SHARD_QA_QUESTIONS = 64
SHARD_QA_DIM = 512         # the QA program's second index (ArcFace's width)
SHARD_QA_WEIGHTS = (0.6, 0.4)
SHARD_BM25_Q_BLOCK = 128
SHARD_REPS = 3
SHARD_TIMEOUT_S = 150      # the ranks' own limit, joins and collectives
SHARD_RANK_CODE = ("import sys, chip_smoke; "
                   "chip_smoke.shard_rank(sys.argv[1], int(sys.argv[2]))")
# the sizes a rank reads: handed over in the spec, so that a rehearsal at
# small sizes reaches the ranks too
SHARD_SIZES = ("N_KB", "DIM", "K", "BATCH", "ROW_LEN", "READER_M",
               "READER_SEQ", "PASSAGE_TOKENS", "SHARD_RANKS",
               "SHARD_VALID_ROWS", "SHARD_QA_QUESTIONS", "SHARD_QA_DIM",
               "SHARD_BM25_Q_BLOCK", "SHARD_REPS", "SHARD_TIMEOUT_S")


def main_kb(dev, seed: int = 1, dim=None):
    """Phase 5's KB (seed 1, N_KB x DIM), or another of its kind: N(0, 1/d)
    bf16 rows drawn on the card from a seeded generator, the same on
    every call."""
    rows, dim = N_KB, dim or DIM
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, dim), generator=gen, device=dev,
                       dtype=torch.bfloat16) / math.sqrt(dim)


def save_bm25_arrays(index, path):
    """A host BM25 index as raw .npy arrays (the ranks load it in
    seconds; savez_compressed takes minutes at 1.5M documents)."""
    path.mkdir(parents=True)
    for name in ("offsets", "docs", "tfs", "doc_len"):
        np.save(path / f"{name}.npy", getattr(index, name))
    (path / "meta.json").write_text(json.dumps(
        {"vocab": index.vocab, "n_docs": index.n_docs, "k1": index.k1,
         "b": index.b}))


def load_bm25_arrays(path):
    meta = json.loads((path / "meta.json").read_text())
    return bm25_lib.BM25Index(
        meta["vocab"], *(np.load(path / f"{name}.npy") for name in (
            "offsets", "docs", "tfs", "doc_len")), meta["n_docs"],
        k1=meta["k1"], b=meta["b"])


def qa_pairs(questions, fused_ids, passages):
    """The QA program's host boundary: [CLS] question [SEP] passage [SEP]
    for each question and each of its fused passages (a pad id gets an
    empty passage), with their token types."""
    heads = WhitespaceTokenizer()(questions)["input_ids"]
    seqs, types = [], []
    for head, row in zip(heads, fused_ids):
        for d in row:
            body = (passages[int(d)]["passage_tokens"]
                    if 0 <= int(d) < len(passages) else np.zeros(0))
            seqs.append(np.r_[head, body, 102].astype(np.int32))
            types.append(np.r_[np.zeros(len(head)),
                               np.ones(len(body) + 1)].astype(np.int32))
    return seqs, types


def qa_read(reader, pairs, dev, ctx=None):
    """The packed reader step over the pairs' canvas (rows padded to a
    multiple of the mesh's data size, and split over it with ``ctx``):
    the start / end probabilities and the best spans."""
    seqs, types = pairs
    rp = packing.pack_token_sequences(
        seqs, row_len=READER_SEQ,
        pad_rows_to=ctx.data_size if ctx is not None else 1)
    tt = packing.pack_parallel(rp, types)
    g_idx, g_mask = packing.gather_indices(rp, READER_SEQ)
    canvas = [torch.from_numpy(np.asarray(a)).to(dev) for a in (
        rp.input_ids, rp.segment_ids, rp.position_ids, tt, g_idx, g_mask)]
    with torch.no_grad():
        out = qa.reader_apply_packed(
            reader, reader.cfg, *canvas, m_passages=READER_M,
            compute_dtype=torch.bfloat16, mesh_ctx=ctx)
        probs = span_probabilities(out.start_logits, out.end_logits,
                                   canvas[-1], READER_M)
        return probs, qa.get_best_spans(*probs), rp.rows


def qa_reader(dev, rcfg):
    """The QA program's reader (Multi-passage BERT), seeded, bf16."""
    return convert.reader_from_jax(convert.init_reader_tree(rcfg, seed=3),
                                   rcfg, device=dev, dtype=torch.bfloat16)


def last_shard(matrix, valid_rows: int, kb_size: int):
    """The last of ``kb_size`` shards of a KB whose first rows are
    ``matrix``'s, laid out as a sharded DenseIndex lays it out (128-row
    aligned shards, zero rows past the KB), and its local valid rows."""
    rows = -(-matrix.shape[0] // (kb_size * 128)) * 128
    base = (kb_size - 1) * rows
    shard = matrix.new_zeros((rows, matrix.shape[1]))
    part = matrix[base: base + rows]
    shard[: len(part)] = part
    return shard, min(max(valid_rows - base, 0), rows)


def b1_against_plain(q, kb, valid_rows: int, label: str, got=None) -> dict:
    """B1's top-K through topk_fused (or ``got``, a result already taken
    from it) against the plain version's selection on the same inputs,
    held as the main path is: ids tie-aware, scores within one bf16 ulp
    positionwise; the bitwise share of the scores is reported."""
    k_s, k_i = got if got is not None else mips_fused.topk_fused(
        q, kb, K, valid_rows=valid_rows)
    p_s, p_i = mips_fused.segment_topk(
        *mips_fused.fused_score_segmax_qmajor_plain(q, kb, valid_rows), K)
    agreement = tie_aware_agreement(
        k_i.cpu().numpy(), k_s.float().cpu().numpy(), p_i.cpu().numpy(),
        p_s.float().cpu().numpy())
    out = {"check": label, "shape": [q.shape[0], q.shape[1], kb.shape[0]],
           "valid_rows": valid_rows, **agreement,
           "scores_bitwise_share": float((k_s == p_s).float().mean())}
    check(tie_aware_ok(agreement), f"B1 against plain, {label}: {out}")
    return out


def b1_launches() -> int:
    return mips_fused.fused_score_segmax_qmajor.launches


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_memory(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def shard_rank(spec_path: str, rank: int) -> None:
    """One of phase 25's gloo ranks (a process of its own, all on the one
    card): joins the world, runs :func:`shard_rank_work` and writes what
    it measured next to the spec."""
    import datetime
    import pickle
    from pathlib import Path

    import torch.distributed as dist

    spec = pickle.loads(Path(spec_path).read_bytes())
    globals().update(spec["sizes"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        # the parent built the kernels in phase 2: four ranks must not
        # rebuild them at once
        check(not kbuild._stale("score_segmax"),
              "the B1 library is missing or stale: phase 2 builds it")
    dist.init_process_group(
        "gloo", init_method=spec["init"], rank=rank, world_size=SHARD_RANKS,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        out = shard_rank_work(dev, spec)
    finally:
        dist.destroy_process_group()
    Path(spec["dir"], f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def shard_rank_work(dev, spec) -> dict:
    """(b) B1 on this rank's quarter of the 1.5M KB at kb = 4, uneven
    valid rows; the retrieval pipeline at data = 2 x kb = 2 (the packed
    encoder split over data); the QA program at data = 2 x kb = 2;
    (c) ShardedDeviceBM25 over kb = 4. Every number is this rank's, on a
    card the four ranks share."""
    from viquae_torch.core import mesh

    t_start = time.perf_counter()
    out = {}
    q = torch.from_numpy(spec["q"]).to(dev).to(torch.bfloat16)
    kb = main_kb(dev)
    ctx4 = mesh.make_kb_mesh(device=dev)
    out["route"] = mesh.collective_route(ctx4)
    index = mips.DenseIndex(kb, mode="fused", mesh_ctx=ctx4)
    out["kb4_shard_rows"] = index.matrix.shape[0]

    def kb4():
        return mips.topk_sharded(q, index.matrix, K, mesh_ctx=ctx4,
                                 valid_rows=SHARD_VALID_ROWS, mode="fused")

    mips_fused.fused_score_segmax_qmajor.launches = 0
    ctx4.collective_log.clear()
    s, i = kb4()
    out["kb4"] = (s.cpu().numpy(), i.cpu().numpy())
    out["kb4_launches"] = b1_launches()
    out["kb4_log"] = list(ctx4.collective_log)
    walls = []
    for _ in range(SHARD_REPS):
        sync(dev)
        t0 = time.perf_counter()
        kb4()
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["kb4_ms"] = float(np.median(walls))
    del index

    # data = 2 x kb = 2: the serving pipeline end to end
    ctx = mesh.make_mesh(data=2, kb=2, device=dev)
    index = mips.DenseIndex(kb, mode="fused", mesh_ctx=ctx)
    del kb
    second = mips.DenseIndex(main_kb(dev, seed=2, dim=SHARD_QA_DIM),
                             mode="fused", mesh_ctx=ctx)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg = spec["dpr_cfg"]
    model = convert.params_from_jax(convert.init_tree(cfg, seed=0), cfg,
                                    device=dev, dtype=torch.bfloat16)
    emb = PackedTextEmbedder(dpr.make_packed_apply(cfg), model,
                             WhitespaceTokenizer(), row_len=ROW_LEN,
                             batch_size=BATCH, compute_dtype=torch.bfloat16,
                             device=dev, mesh_ctx=ctx)
    queries = spec["queries"]
    out["embeddings"] = torch.cat([
        emb.embed_texts(queries[i: i + BATCH])[: len(queries[i: i + BATCH])]
        for i in range(0, len(queries), BATCH)]).float().cpu().numpy()
    pipe = FusedRetrievalPipeline(emb, index, batch_size=BATCH, k=K)
    pipe.run_arrays(queries)  # warm-up
    mips_fused.fused_score_segmax_qmajor.launches = 0
    t0 = time.perf_counter()
    out["pipeline"] = pipe.run_arrays(queries)
    out["pipeline_s"] = time.perf_counter() - t0
    out["pipeline_launches"] = b1_launches()

    # the QA program: two kb-sharded legs, fuse_topk, the reader step
    questions = queries[:SHARD_QA_QUESTIONS]
    q_face = torch.from_numpy(spec["q_face"]).to(dev)
    reader = qa_reader(dev, spec["reader_cfg"])
    mips_fused.fused_score_segmax_qmajor.launches = 0
    t0 = time.perf_counter()
    q_qa = emb.embed_texts(questions)[: len(questions)]
    legs = [ix.search_device(qq, *ix.snapshot(), K)
            for ix, qq in ((index, q_qa), (second, q_face))]
    _, fused_i = fuse_topk([s for s, _ in legs], [i for _, i in legs],
                           SHARD_QA_WEIGHTS, READER_M, norm="gzmuv",
                           valid_queries=len(questions))
    fused_i = fused_i[: len(questions)].cpu().numpy()
    pairs = qa_pairs(questions, fused_i,
                     SyntheticPassages(N_KB, seed=spec["passage_seed"]))
    probs, spans, rows = qa_read(reader, pairs, dev, ctx)
    sync(dev)
    out["qa_s"] = time.perf_counter() - t0
    out["qa_launches"] = b1_launches()
    out["qa"] = {"q": q_qa.float().cpu().numpy(), "fused_ids": fused_i,
                 "canvas_rows": rows,
                 "probs": [p.float().cpu().numpy() for p in probs],
                 "spans": [t.cpu().numpy() for t in spans]}
    del index, second, pipe, emb, model, reader
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) BM25 over the same four ranks
    host = load_bm25_arrays(spec["bm25_dir"])
    t0 = time.perf_counter()
    sparse = bm25_device.ShardedDeviceBM25(
        host, mesh_ctx=ctx4, q_block=SHARD_BM25_Q_BLOCK, device=dev)
    sync(dev)
    out["bm25_build_s"] = time.perf_counter() - t0
    sparse.search_batch(spec["bm25_queries"][:SHARD_BM25_Q_BLOCK], k=K)
    t0 = time.perf_counter()
    out["bm25"] = sparse.search_batch(spec["bm25_queries"], k=K)
    out["bm25_s"] = time.perf_counter() - t0
    out["bm25_overflow"] = sparse.last_overflow
    out["bm25_shard"] = {"d_shard": sparse.d_shard,
                         "d_shard_pad": sparse.d_shard_pad,
                         "l_mid": sparse.l_mid, "l_small": sparse.l_small}
    out["peak_memory_bytes"] = peak_memory(dev)
    out["seconds"] = time.perf_counter() - t_start
    return out


def run_shard_ranks(spec, workdir) -> list:
    """Start phase 25's ranks, wait for them within SHARD_TIMEOUT_S (kill
    them all past it) and read what each measured."""
    import pickle

    spec_path = workdir / "spec.pkl"
    spec_path.write_bytes(pickle.dumps(spec))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="2")
    logs = [open(workdir / f"rank{r}.log", "wb") for r in range(SHARD_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RANK_CODE, str(spec_path), str(r)],
        cwd=here, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(SHARD_RANKS)]
    deadline = time.monotonic() + SHARD_TIMEOUT_S + 30
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for r, p in enumerate(procs):
        out = workdir / f"rank{r}.pkl"
        if p.returncode != 0 or not out.exists():
            tail = (workdir / f"rank{r}.log").read_text(
                errors="replace")[-3000:]
            check(False, f"phase 25 rank {r} exited {p.returncode}:\n{tail}")
        results.append(pickle.loads(out.read_bytes()))
    return results


def phase_sharded_serving(dev, main, bm25_ref, workdir,
                          cfg=dpr.DPRConfig(), rcfg=qa.ReaderConfig()
                          ) -> dict:
    """Phase 25: kb-sharded serving on the one card. (a) A NCCL world of
    one: topk_sharded(mode="fused") through its shard step (B1), the NCCL
    all-gather and the merge, bit-equal to phase 5. (b) Four gloo ranks
    sharing the card (each its own process and CUDA context): B1 on each
    rank's quarter at kb = 4 with valid_rows 1.5M - 37, bit-equal to one
    topk_fused over the whole KB; at data = 2 x kb = 2 the serving
    pipeline with the packed encoder split over data (embeddings within
    the bf16 bound of phase 5's, results tie-aware against phase 5's) and
    the QA program (two kb-sharded legs, fuse_topk in gzmuv, the reader
    step with its canvas rows split over data) against the same program on
    one device. (c) ShardedDeviceBM25 over the four ranks against phase
    14's DeviceBM25 by doc id. No number here is a multi-GPU speed."""
    import datetime

    import torch.distributed as dist

    from viquae_torch.core import mesh

    t_phase = time.perf_counter()
    if dev.type == "cuda" and dev.index is None:  # NCCL and the ranks
        dev = torch.device("cuda", torch.cuda.current_device())
    workdir.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    q_all = main["q_all"]
    qb = q_all.to(torch.bfloat16)
    single = mips.DenseIndex(main_kb(dev), mode="fused", device=dev)

    # (a) a NCCL world of one (gloo when a rehearsal runs on the CPU)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{workdir / 'nccl_rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S),
        **({"device_id": dev} if dev.type == "cuda" else {}))
    try:
        ctx = mesh.make_kb_mesh(device=dev)

        def sharded():
            return mips.topk_sharded(qb, single.matrix, K, mesh_ctx=ctx,
                                     valid_rows=single.n, mode="fused")

        mips_fused.fused_score_segmax_qmajor.launches = 0
        s, i = sharded()
        launches_a = b1_launches()
        log_a = list(ctx.collective_log)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        world_ms = time_ms(sharded, reps=SHARD_REPS)
        single_ms = time_ms(lambda: mips_fused.topk_fused(
            qb, single.matrix, K, valid_rows=single.n), reps=SHARD_REPS)
        route = mesh.collective_route(ctx)
    finally:
        dist.destroy_process_group()
    same_a = bool(np.array_equal(i, main["ids"])
                  and np.array_equal(s, main["scores"]))
    emit({"phase": "sharded_world_of_one", "route": route, "kb": 1,
          "queries": len(qb), "k": K, "b1_launches": launches_a,
          "collectives": log_a, "bit_equal_to_phase_5": same_a,
          "batch_ms_topk_sharded": world_ms,
          "batch_ms_topk_fused_same_call": single_ms,
          "phase_5_search_ms_1280_queries": main["search_ms"]})
    check(same_a, "topk_sharded on a NCCL world of one against phase 5")
    check(launches_a == 1 and log_a == [("all_gather", "kb",
                                         3 * len(qb) * K * 4)],
          f"world of one: {launches_a} B1 launches, collectives {log_a}")

    # the single-device references of (b), before the ranks share the card
    ref_s, ref_i = (t.cpu().numpy() for t in mips_fused.topk_fused(
        qb, single.matrix, K, valid_rows=SHARD_VALID_ROWS))
    rng = np.random.default_rng(25)
    q_face = rng.standard_normal((SHARD_QA_QUESTIONS, SHARD_QA_DIM)).astype(
        np.float32) / math.sqrt(SHARD_QA_DIM)
    del single
    torch.cuda.empty_cache()
    spec = {"init": f"file://{workdir / 'gloo_rendezvous'}",
            "dir": str(workdir), "device": str(dev),
            "sizes": {name: globals()[name] for name in SHARD_SIZES},
            "dpr_cfg": cfg, "reader_cfg": rcfg,
            "q": qb.float().cpu().numpy(),
            "queries": main["queries"], "q_face": q_face, "passage_seed": 4,
            "bm25_dir": bm25_ref["dir"], "bm25_queries": bm25_ref["queries"]}
    t0 = time.perf_counter()
    ranks = run_shard_ranks(spec, workdir)
    ranks_s = time.perf_counter() - t0

    # (b) kb = 4: B1 a quarter each, bit-equal to one topk_fused
    for r, res in enumerate(ranks):
        check(res["route"] == ("gloo-cuda-staged" if dev.type == "cuda"
                               else "gloo"), f"rank {r}: {res['route']}")
        check(np.array_equal(res["kb4"][1], ref_i)
              and np.array_equal(res["kb4"][0], ref_s),
              f"rank {r}: kb = 4 top-{K} against one topk_fused")
        check(res["kb4_launches"] == 1 and res["kb4_log"] == [
            ("all_gather", "kb", 3 * SHARD_RANKS * len(qb) * K * 4)],
            f"rank {r}: kb = 4 launches {res['kb4_launches']}, collectives "
            f"{res['kb4_log']}")

    # data = 2 x kb = 2: embeddings split over data, the pipeline end to end
    q_ref = q_all.float().cpu()
    n_batches = -(-len(main["queries"]) // BATCH)
    e2e = []
    for r, res in enumerate(ranks):
        got = torch.from_numpy(res["embeddings"])
        close = torch.allclose(got, q_ref, rtol=2e-2, atol=2e-2)
        scores, ids = res["pipeline"]
        agreement = tie_aware_agreement(ids, scores, main["ids"],
                                        main["scores"])
        e2e.append({"embedding_max_abs_diff": float(
            (got - q_ref).abs().max()), "embedding_allclose_2e-2": close,
            "vs_phase_5": agreement})
        check(close, f"rank {r}: embeddings split over data")
        check(tie_aware_ok(agreement),
              f"rank {r}: data = 2 x kb = 2 pipeline: {agreement}")
        check(res["pipeline_launches"] == n_batches,
              f"rank {r}: {res['pipeline_launches']} B1 launches for "
              f"{n_batches} batches")

    # the QA program on one device, from rank 0's question vectors
    qa0 = ranks[0]["qa"]
    for r, res in enumerate(ranks[1:], 1):
        check(np.array_equal(res["qa"]["fused_ids"], qa0["fused_ids"]),
              f"rank {r}: QA fused ids differ from rank 0's")
    single = mips.DenseIndex(main_kb(dev), mode="fused", device=dev)
    second = mips.DenseIndex(main_kb(dev, seed=2, dim=SHARD_QA_DIM),
                             mode="fused", device=dev)
    q_qa = torch.from_numpy(qa0["q"]).to(dev)
    legs = [ix.search_device(qq, *ix.snapshot(), K) for ix, qq in (
        (single, q_qa), (second, torch.from_numpy(q_face).to(dev)))]
    _, one_i = fuse_topk([s for s, _ in legs], [i for _, i in legs],
                         SHARD_QA_WEIGHTS, READER_M, norm="gzmuv",
                         valid_queries=SHARD_QA_QUESTIONS)
    one_i = one_i[:SHARD_QA_QUESTIONS].cpu().numpy()
    # B1 against its plain version at the depths and shard heights the
    # ranks gave it: the 512-wide leg whole (the one-device reference
    # above), its last shard at data = 2 x kb = 2, and the last, part
    # padding, shard of the 768-wide KB at kb = 4
    q_face_b = torch.from_numpy(q_face).to(dev).to(torch.bfloat16)
    kb2_last, kb2_valid = last_shard(second.matrix, second.n, 2)
    kb4_last, kb4_valid = last_shard(single.matrix, SHARD_VALID_ROWS,
                                     SHARD_RANKS)
    rank_shapes = [
        b1_against_plain(q_face_b, second.matrix, second.n,
                         "QA second leg, one device", legs[1]),
        b1_against_plain(q_face_b, kb2_last, kb2_valid,
                         "QA second leg, last shard at kb = 2"),
        b1_against_plain(qb, kb4_last, kb4_valid, "last shard at kb = 4")]
    del single, second, legs, kb2_last, kb4_last
    torch.cuda.empty_cache()
    fused_equal = bool(np.array_equal(one_i, qa0["fused_ids"]))
    check(fused_equal, "the QA program's fused ids against one device")
    reader = qa_reader(dev, rcfg)
    probs, spans, one_rows = qa_read(
        reader, qa_pairs(main["queries"][:SHARD_QA_QUESTIONS], one_i,
                         SyntheticPassages(N_KB, seed=4)), dev)
    del reader
    spans_agree = []
    for res in ranks:
        r_probs = [torch.from_numpy(p).to(dev) for p in res["qa"]["probs"]]
        r_spans = [torch.from_numpy(t).to(dev) for t in res["qa"]["spans"]]
        spans_agree.append(span_agreement(r_spans, r_probs, spans, probs,
                                          SPAN_RTOL[torch.bfloat16]))
        check(spans_agree[-1]["agree_share"] == 1.0,
              f"QA spans against one device: {spans_agree[-1]}")
        check(res["qa_launches"] == 2, f"QA legs launched B1 "
              f"{res['qa_launches']} times (one a leg)")

    # (c) ShardedDeviceBM25 against phase 14's DeviceBM25, by doc id
    bm25_agree = []
    for r, res in enumerate(ranks):
        s_lists, i_lists = res["bm25"]
        agree = by_doc_agreement(i_lists, s_lists, bm25_ref["ids"],
                                 bm25_ref["scores"])
        bm25_agree.append(agree)
        check(agree["mean_shared_share"] >= 0.999
              and agree["min_shared_share"] >= 0.9
              and agree["max_relative_score_diff"] <= 2e-2,
              f"rank {r}: ShardedDeviceBM25 against DeviceBM25: {agree}")
    launches = {"world_of_one_nccl": launches_a,
                "kb4_per_rank": [r["kb4_launches"] for r in ranks],
                "data2_kb2_pipeline_per_rank":
                    [r["pipeline_launches"] for r in ranks],
                "qa_legs_per_rank": [r["qa_launches"] for r in ranks]}
    emit({"phase": "sharded_serving",
          "label": "4 ranks sharing one H100 over gloo; not a multi-GPU "
                   "speed",
          "route": ranks[0]["route"], "kb_rows": N_KB,
          "valid_rows": SHARD_VALID_ROWS,
          "kb4_shard_rows": ranks[0]["kb4_shard_rows"],
          "kb4_bit_equal_to_topk_fused": True,
          "kb4_batch_ms_per_rank": [r["kb4_ms"] for r in ranks],
          "data2_kb2": e2e,
          "pipeline_s_per_rank": [r["pipeline_s"] for r in ranks],
          "b1_vs_plain_at_rank_shapes": rank_shapes,
          "qa": {"questions": SHARD_QA_QUESTIONS, "m": READER_M,
                 "second_index_dim": SHARD_QA_DIM,
                 "fused_ids_equal_one_device": fused_equal,
                 "canvas_rows": ranks[0]["qa"]["canvas_rows"],
                 "one_device_canvas_rows": one_rows,
                 "span_agreement_per_rank": spans_agree,
                 "seconds_per_rank": [r["qa_s"] for r in ranks]},
          "bm25": {"q_block": SHARD_BM25_Q_BLOCK,
                   "shard": ranks[0]["bm25_shard"],
                   "build_s_per_rank": [r["bm25_build_s"] for r in ranks],
                   "search_s_per_rank": [r["bm25_s"] for r in ranks],
                   "queries": len(bm25_ref["queries"]),
                   "overflow_per_rank": [r["bm25_overflow"] for r in ranks],
                   "single_device_overflow": bm25_ref["overflow"],
                   "vs_device_bm25_by_doc": bm25_agree},
          "b1_launches": launches,
          "rank_seconds": [r["seconds"] for r in ranks],
          "ranks_wall_s": ranks_s,
          "peak_memory_bytes_per_rank":
              [r["peak_memory_bytes"] for r in ranks],
          "parent_peak_memory_bytes": peak_memory(dev),
          "seconds": time.perf_counter() - t_phase})
    return launches


def bm25_reference(sparse, workdir) -> dict:
    """What phase 25 holds ShardedDeviceBM25 to: phase 14's queries and
    DeviceBM25 lists at SHARD_BM25_Q_BLOCK, and the host index as raw
    arrays for the ranks."""
    scorer = sparse["scorers"][SHARD_BM25_Q_BLOCK]
    scores, ids = scorer.search_batch(sparse["queries"], k=K)
    save_bm25_arrays(sparse["index"], workdir / "bm25")
    return {"dir": workdir / "bm25", "queries": sparse["queries"],
            "scores": scores, "ids": ids, "overflow": scorer.last_overflow}


# ---- phase 26: training on the mesh ----------------------------------------
MESH_TRAIN_STEPS = 3       # (a): the steps of each trainer
MESH_QUESTIONS = 32        # (b), (c): the global batch of the four ranks
MESH_RANKS = 4             # gloo ranks sharing the one card
MESH_MOE_LAYERS = 2        # (c): phase 24's configuration cut to 2 layers
MESH_TIMEOUT_S = 240       # the ranks' own limit, joins and collectives
MESH_BERT: dict = {}       # BertConfig overrides (a CPU rehearsal's widths)
# configs/dpr_train.yaml's AdamW without its warmup, so that both steps
# move every parameter by ~lr (with the warmup the first two lrs are 0 and
# 2e-7, and a misplaced shard would hide under them)
MESH_OPT = dict(DPR_TRAIN_OPT, warmup_steps=0)
MESH_LOSS_RTOL = 1e-5      # as card_vs_cpu: f32 sums in another order
MESH_NORM_RTOL = 1e-4      # the norm sums every gradient's square
MESH_RANK_CODE = ("import sys, chip_smoke; "
                  "chip_smoke.mesh_rank(sys.argv[1], int(sys.argv[2]))")
MESH_SIZES = ("MESH_RANKS", "MESH_TIMEOUT_S", "MESH_MOE_LAYERS",
              "MESH_BERT", "MESH_OPT")


def mesh_bert(layers_: int, moe: bool = False, dropout: bool = True):
    cfg = dataclasses.replace(dpr.DPRConfig().bert, num_hidden_layers=layers_,
                              **MESH_BERT)
    if not dropout:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    if moe:
        cfg = dataclasses.replace(cfg, **dict(
            MOE_BERT, moe_capacity_factor=MOE_AMPLE_CAPACITY))
    return cfg


def mesh_trainee(dev, moe: bool = False, dropout: bool = True):
    """Phase 21's DPR biencoder (full width, 12 layers, remat, seeds 0 and
    1), or with ``moe`` phase 24's MoE towers at MESH_MOE_LAYERS layers and
    capacity MOE_AMPLE_CAPACITY (nothing drops); dropout off without
    ``dropout`` (the mesh draws other masks than one device: the data
    coordinate is folded into each seed)."""
    from viquae_torch.train.trainee import BiEncoderTrainee

    cfg = dpr.DPRConfig(bert=mesh_bert(MESH_MOE_LAYERS if moe else 12, moe,
                                       dropout))
    return BiEncoderTrainee(dpr.DPREncoder(cfg=cfg, seed=0, device=dev),
                            dpr.DPREncoder(cfg=cfg, seed=1, device=dev),
                            remat_layers=True)


def mesh_spec(trainee) -> dict:
    return {name: dpr.param_spec(trainee.question_model.cfg)
            for name in ("question", "context")}


def state_digest(trainer) -> str:
    """sha256 of a trainer's parameters, AdamW moments and schedule step,
    in name order: equal digests are bit-equal states."""
    import hashlib

    h = hashlib.sha256()
    state = trainer.state.state_dict()
    for name, t in state["params"].items():
        h.update(name.encode())
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    for group in state["opt_state"]["adamw"]["state"].values():
        for key in sorted(group):
            t = torch.as_tensor(group[key])
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    h.update(str(state["opt_state"]["scheduler"]["last_epoch"]).encode())
    h.update(str(state["step"]).encode())
    return h.hexdigest()


def mesh_steps(trainer, batch, steps, dev) -> dict:
    """``steps`` optimizer steps on ``batch`` after the trainer's current
    step (Trainer.fit's generator per step), each read back: losses, grad
    norms, step ms by CUDA events (per-step sync)."""
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    for _ in range(steps):
        step = trainer.state.step
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        loss, norm, _ = trainer._train_step(batch,
                                            trainer.seeds.split(f"step{step}"))
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            out["step_ms"].append(start.elapsed_time(end))
        else:
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(norm))
    return out


def collective_kinds(log) -> dict:
    """{op/axis: [count, bytes]} of a collective log."""
    out = {}
    for op, axis, nbytes in log:
        entry = out.setdefault(f"{op}/{axis}", [0, 0])
        entry[0] += 1
        entry[1] += nbytes
    return out


def mesh_rank(spec_path: str, rank: int) -> None:
    """One of phase 26's gloo ranks (a process of its own on the one
    card): joins the world, runs :func:`mesh_rank_work` and writes what it
    measured next to the spec."""
    import datetime
    import pickle
    from pathlib import Path

    import torch.distributed as dist

    spec = pickle.loads(Path(spec_path).read_bytes())
    globals().update(spec["sizes"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=spec["init"], rank=rank, world_size=MESH_RANKS,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        out = mesh_rank_work(dev, spec)
    finally:
        dist.destroy_process_group()
    Path(spec["dir"], f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def mesh_rank_work(dev, spec) -> dict:
    """(b) the full-width biencoder on data = 2 x model = 2: step 1, this
    rank's checkpoint shard (``train.checkpoint.save_state``), step 2; or,
    in the resume world, the shard of step 1 restored
    (``restore_state``) and step 2. (c) one MoE step under moe_spec. Every
    number is this rank's, on a card the four ranks share."""
    from viquae_torch.core import mesh
    from viquae_torch.train import checkpoint as ckpt_lib
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    ctx = mesh.make_mesh(data=2, model=2, device=dev)
    out = {"coords": dict(ctx.coords), "route": mesh.collective_route(ctx),
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    if dev.type == "cuda" and not spec["resume"]:
        out["gloo_cuda"] = gloo_cuda_collectives(ctx, dev)
    mips_fused.fused_score_segmax_qmajor.launches = 0
    mips_fused.fused_score_segmax.launches = 0
    runs = [("b", False, spec["batch"])] + (
        [] if spec["resume"] else [("c", True, spec["batch"])])
    for label, moe, batch in runs:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        tt = mesh_trainee(dev, moe, dropout=False)
        ckpt = spec["ckpt"] if label == "b" else None
        trainer = Trainer(tt.loss_fn, tt.params,
                          optim.make_optimizer(tt.params, **MESH_OPT),
                          TrainerConfig(max_steps=2, log_every=0),
                          mesh_ctx=ctx, param_spec=mesh_spec(tt))
        del tt
        res = {}
        if label == "b" and spec["resume"]:
            t0 = time.perf_counter()
            ckpt_lib.restore_state(ckpt, trainer.state, map_location=dev,
                                   rank=ctx.rank)
            res["restore_s"] = time.perf_counter() - t0
            res.update(mesh_steps(trainer, batch, 1, dev))
        elif label == "c":
            ctx.collective_log.clear()
            res.update(mesh_steps(trainer, batch, 1, dev))
            res["step_collectives"] = collective_kinds(ctx.collective_log)
        else:
            first = mesh_steps(trainer, batch, 1, dev)
            t0 = time.perf_counter()
            ckpt_lib.save_state(ckpt, trainer.state, 1, rank=ctx.rank)
            res["save_s"] = time.perf_counter() - t0
            ctx.collective_log.clear()
            later = mesh_steps(trainer, batch, 1, dev)
            res["step_collectives"] = collective_kinds(ctx.collective_log)
            res.update({k: first[k] + later[k] for k in first})
        res["replicated_equal"] = replicated_equal_over(
            trainer, (mesh.MODEL_AXIS,))
        if label == "b":        # the resume is held by digests
            res["digest"] = state_digest(trainer)
        if not spec["resume"]:  # the parameters against one device's
            full = trainer.full_params()
            if ctx.rank == 0:
                torch.save({n: p.detach().cpu() for n, p in
                            full.named_parameters()},
                           os.path.join(spec["dir"], f"params_{label}.pt"))
            del full
        res["peak_memory_bytes"] = peak_memory(dev)
        out[label] = res
        del trainer
    out["b1_launches"] = mips_fused.fused_score_segmax_qmajor.launches
    out["b2_launches"] = mips_fused.fused_score_segmax.launches
    return out


def gloo_cuda_collectives(ctx, dev) -> dict:
    """Which gloo collectives take a CUDA tensor as it is: each tried
    once on the ``data`` group ("native", or the error it raised).
    ``core.mesh`` hands gloo its CUDA tensors as they are."""
    import torch.distributed as dist

    from viquae_torch.core import mesh

    group, size = ctx.group(mesh.DATA_AXIS), ctx.size(mesh.DATA_AXIS)
    x = torch.ones(8 * size, device=dev)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(
            x.clone(), src=dist.get_global_rank(group, 0), group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(size)], x, group=group),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(
            x.new_empty(8), x, group=group)}
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "native"
        except Exception as e:     # noqa: BLE001 - the answer is the error
            out[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    torch.cuda.synchronize(dev)
    return out


def run_mesh_ranks(spec, workdir) -> list:
    """Start phase 26's ranks, wait for them within MESH_TIMEOUT_S (kill
    them all past it: the phase fails) and read what each measured."""
    return finish_world(start_world(MESH_RANK_CODE, spec, workdir,
                                    MESH_RANKS, MESH_SIZES),
                        MESH_TIMEOUT_S, "phase 26")


def start_world(code, spec, workdir, n, sizes):
    """Write ``spec`` with the world's directory, rendezvous and the
    module constants named in ``sizes`` (a rehearsal's shrunk ones), and
    start its ``n`` ranks (``python -c code spec rank``): (processes,
    logs, workdir)."""
    import pickle

    workdir.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, dir=str(workdir),
                init=f"file://{workdir / 'rendezvous'}",
                sizes={k: globals()[k] for k in sizes})
    spec_path = workdir / "spec.pkl"
    spec_path.write_bytes(pickle.dumps(spec))
    procs, logs = start_ranks(code, spec_path, n, workdir, spec["device"])
    return procs, logs, workdir


def finish_world(started, timeout_s, label) -> list:
    """Wait for a world's ranks within ``timeout_s`` (kill them all past
    it: the phase fails) and read what each measured."""
    import pickle

    procs, logs, workdir = started
    wait_ranks(procs, logs, timeout_s + 30)
    results = []
    for r, p in enumerate(procs):
        out = workdir / f"rank{r}.pkl"
        if p.returncode != 0 or not out.exists():
            tail = (workdir / f"rank{r}.log").read_text(
                errors="replace")[-3000:]
            check(False, f"{label} rank {r} exited {p.returncode}:\n{tail}")
        results.append(pickle.loads(out.read_bytes()))
    return results


def start_ranks(code, arg, n, workdir, device):
    """``n`` rank processes ``python -c code arg r``, their output to
    ``workdir/rank<r>.log``: (processes, logs)."""
    here = os.path.dirname(os.path.abspath(__file__))
    # one thread on the CPU (a rehearsal): the CPU's threaded embedding
    # backward adds in another order run to run
    env = dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="1" if
               device == "cpu" else "2")
    logs = [open(workdir / f"rank{r}.log", "wb") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(arg), str(r)],
                              cwd=here, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(n)]
    return procs, logs


def wait_ranks(procs, logs, timeout_s) -> None:
    """Wait for every rank within ``timeout_s``; kill the rest."""
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def one_device_reference(dev, batch, moe: bool, steps: int) -> dict:
    """The one-device trainer of (b) or (c) on the card: see
    :func:`reference_steps`."""
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    tt = mesh_trainee(dev, moe, dropout=False)
    trainer = Trainer(tt.loss_fn, tt.params,
                      optim.make_optimizer(tt.params, **MESH_OPT),
                      TrainerConfig(max_steps=steps, log_every=0))
    del tt
    return reference_steps(trainer, batch, steps)


def reference_steps(trainer, batch, steps) -> dict:
    """A one-device trainer's ``steps`` steps: losses, grad norms, the
    parameters after the steps and, per parameter, the smallest
    |gradient| over the steps (for the update bound), the largest
    gradient entry and the steps' summed learning rate."""
    from viquae_torch.train import optim

    smallest, g_max = {}, 0.0
    res = {"losses": [], "grad_norms": []}
    for step in range(steps):
        loss, norm, _ = trainer._train_step(batch,
                                            trainer.seeds.split(f"step{step}"))
        res["losses"].append(float(loss))
        res["grad_norms"].append(float(norm))
        # the clipped gradients the AdamW step took (clipping is in place)
        for n, p in trainer.state.params.named_parameters():
            g = p.grad.detach().abs()
            smallest[n] = g if n not in smallest else torch.minimum(
                smallest[n], g)
            g_max = max(g_max, float(g.max()))
    res["params"] = {n: p.detach() for n, p in
                     trainer.state.params.named_parameters()}
    res["smallest_grad"], res["grad_max"] = smallest, g_max
    res["lr_sum"] = sum(optim.linear_warmup_schedule(
        MESH_OPT["lr"], MESH_OPT["warmup_steps"],
        MESH_OPT["total_steps"])(s) for s in range(steps))
    return res


def params_within_update_bound(got: dict, ref: dict) -> dict:
    """Parameters after AdamW steps against the one-device run's, by
    card_vs_cpu's rule: each entry within 1e-6 + 2 lr_sum min(1, tol /
    |g|), tol = GRAD_RTOL x the largest gradient entry and |g| the entry's
    smallest one-device gradient over the steps (Adam moves an entry by
    ~lr whatever its gradient's size, so one whose gradient is rounding
    noise may move either way; one with a clear gradient moves alike).
    Also the largest difference and the share of entries beyond 1e-6."""
    tol = GRAD_RTOL * ref["grad_max"]
    excess, worst, beyond, total = -math.inf, 0.0, 0, 0
    for n, p in ref["params"].items():
        q = got[n].to(p.device)
        bound = 1e-6 + 2 * ref["lr_sum"] * torch.clamp(
            tol / ref["smallest_grad"][n].clamp_min(1e-30), max=1.0)
        diff = (q - p).abs()
        excess = max(excess, float((diff - bound).max()))
        worst = max(worst, float(diff.max()))
        beyond += int((diff > 1e-6).sum())
        total += diff.numel()
    return {"excess_over_bound": excess, "max_abs_diff": worst,
            "share_beyond_1e-6": beyond / total, "lr_sum": ref["lr_sum"]}


def phase_mesh_training(dev, tokenizer, workdir, phase21_step_ms=None
                        ) -> dict:
    """Phase 26: training on the mesh, on the one card. (a) A NCCL world
    of one: make_mesh(data=1, model=1) with the towers' param_spec drives
    phase 21's DPR biencoder (full width, f32, remat, phase 21's batch) for
    MESH_TRAIN_STEPS steps, bit-equal to the plain Trainer on the same
    batches. (b) Four gloo ranks sharing the card at data = 2 x model = 2:
    the full-width biencoder for 2 steps on one global batch against the
    one-device trainer (losses, the first grad norm, the parameters by the
    update bound, replicated parameters bit-equal over model); the ranks
    write their checkpoint shards at step 1 and a fresh world resumes to
    step 2, bit-equal to the uninterrupted run. (c) One MoE step at data =
    2 x model = 2 under moe_spec, held as (b). (d) ``torchrun
    --nproc-per-node 1 -m viquae_torch train fit`` on phase 21's CLI
    config, against phase 21's one-process fit; it starts after (a) and
    runs beside (b) and (c). No number here is a
    multi-GPU speed: four gloo ranks on one card time the host-staged
    route, not NVLink."""
    import datetime
    import gc

    import torch.distributed as dist

    from viquae_torch.core import mesh
    from viquae_torch.train import data as tdata
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    workdir.mkdir(parents=True, exist_ok=True)
    out = {}

    # ---- (a) a NCCL world of one against the plain Trainer -------------
    kb, items = dpr_train_items(np.random.default_rng(21),
                                DPR_TRAIN_QUESTIONS)
    coll = tdata.BiEncoderCollator(tokenizer, kb=kb, M=2,
                                   n_relevant_passages=1, search_key="BM25",
                                   max_length=256, packed=True, seed=0)
    batch = coll.collate_fn(items)
    runs = {}
    for label in ("plain", "world_of_one"):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kw = {}
        if label == "world_of_one":
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"file://{workdir / 'nccl_rendezvous'}", rank=0,
                world_size=1,
                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S),
                **({"device_id": dev} if dev.type == "cuda" else {}))
            ctx = mesh.make_mesh(data=1, model=1, device=dev)
            kw = dict(mesh_ctx=ctx, param_spec=None)
        try:
            tt = mesh_trainee(dev)
            if kw:
                kw["param_spec"] = mesh_spec(tt)
            trainer = Trainer(tt.loss_fn, tt.params,
                              optim.make_optimizer(tt.params, **DPR_TRAIN_OPT),
                              TrainerConfig(max_steps=MESH_TRAIN_STEPS,
                                            log_every=0), **kw)
            del tt
            res = mesh_steps(trainer, batch, MESH_TRAIN_STEPS, dev)
            if kw:
                res["collectives"] = collective_kinds(ctx.collective_log)
                res["route"] = mesh.collective_route(ctx)
            res["params"] = [p.detach().clone() for p in
                             trainer.state.params.parameters()]
            res["peak_memory_bytes"] = peak_memory(dev)
        finally:
            if kw:
                dist.destroy_process_group()
        del trainer
        runs[label] = res
    plain, one = runs["plain"], runs["world_of_one"]
    bit_equal = (one["losses"] == plain["losses"]
                 and one["grad_norms"] == plain["grad_norms"]
                 and all(torch.equal(a, b) for a, b in zip(
                     one["params"], plain["params"])))
    out["a"] = {k: {n: v for n, v in r.items() if n != "params"}
                for k, r in runs.items()}
    out["a"]["bit_equal"] = bit_equal
    del runs, plain, one, batch
    emit({"phase": "mesh_training_world_of_one", "steps": MESH_TRAIN_STEPS,
          "questions": DPR_TRAIN_QUESTIONS, "remat_layers": True,
          "phase_21_step_ms": phase21_step_ms, **out["a"]})
    check(bit_equal, f"a NCCL world of one against the plain Trainer: "
          f"{out['a']}")

    # (d) starts now: its start-up (imports, CUDA, the dataset) overlaps
    # the references and the ranks' worlds
    config = json.loads((workdir.parent / "train_fit.json").read_text())
    config["trainer"].update(ckpt_dir=str(workdir / "torchrun_ckpt"))
    config["export"] = str(workdir / "torchrun_export")
    (workdir / "torchrun_fit.json").write_text(json.dumps(config))
    t_torchrun = time.perf_counter()
    logs = [open(workdir / f"torchrun.{k}", "w+") for k in ("out", "err")]
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "viquae_torch", "--device", str(dev),
         "train", "fit", str(workdir / "torchrun_fit.json")],
        stdout=logs[0], stderr=logs[1],
        cwd=os.path.dirname(os.path.abspath(__file__)))

    # ---- (b), (c): the one-device references, then the ranks -----------
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kb, items = dpr_train_items(np.random.default_rng(26), MESH_QUESTIONS)
    mbatch = tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, n_relevant_passages=1, search_key="BM25",
        max_length=256, packed=True, seed=0).collate_fn(items)
    refs = {"b": one_device_reference(dev, mbatch, False, 2),
            "c": one_device_reference(dev, mbatch, True, 1)}
    # the references wait on the host while the ranks use the card
    for ref in refs.values():
        for key in ("params", "smallest_grad"):
            ref[key] = {n: t.cpu() for n, t in ref[key].items()}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    spec = {"device": str(dev), "batch": mbatch,
            "ckpt": str(workdir / "ckpt")}
    t0 = time.perf_counter()
    ranks = run_mesh_ranks(dict(spec, resume=False), workdir / "run")
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = run_mesh_ranks(dict(spec, resume=True), workdir / "resume")
    resume_s = time.perf_counter() - t0
    checks = {}
    for label in ("b", "c"):
        ref = refs[label]
        got = torch.load(workdir / "run" / f"params_{label}.pt",
                         weights_only=True)
        first = ranks[0][label]
        checks[label] = {
            "losses": first["losses"], "ref_losses": ref["losses"],
            "loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(
                first["losses"], ref["losses"])),
            "grad_norm_rel_diff": abs(first["grad_norms"][0]
                                      - ref["grad_norms"][0])
            / ref["grad_norms"][0],
            "replicated_equal": all(r[label]["replicated_equal"]
                                    for r in ranks),
            "same_on_every_rank": all(r[label]["losses"] == first["losses"]
                                      for r in ranks),
            **params_within_update_bound(got, ref)}
    checks["resume_bit_equal"] = all(
        r["b"]["digest"] == s["b"]["digest"]
        and r["b"]["losses"][1] == s["b"]["losses"][0]
        for r, s in zip(ranks, resumed))
    per_rank = [{"coords": r["coords"], "route": r["route"],
                 "gloo_cuda_collectives": r.get("gloo_cuda"),
                 "tf32": r["tf32"],
                 "b1_launches": r["b1_launches"] + s["b1_launches"],
                 "b2_launches": r["b2_launches"] + s["b2_launches"],
                 "b_step_ms": r["b"]["step_ms"],
                 "b_resumed_step_ms": s["b"]["step_ms"],
                 "c_step_ms": r["c"]["step_ms"],
                 "b_peak_memory_bytes": r["b"]["peak_memory_bytes"],
                 "c_peak_memory_bytes": r["c"]["peak_memory_bytes"],
                 "b_resume_peak_memory_bytes": s["b"]["peak_memory_bytes"],
                 "b_checkpoint_save_s": r["b"]["save_s"],
                 "b_checkpoint_restore_s": s["b"]["restore_s"],
                 "b_step2_collectives": r["b"]["step_collectives"],
                 "c_step_collectives": r["c"]["step_collectives"]}
                for r, s in zip(ranks, resumed)]
    out["b_c"] = {"checks": checks, "ranks": per_rank,
                  "world_s": run_s, "resume_world_s": resume_s}
    emit({"phase": "mesh_training_gloo_ranks", "ranks": MESH_RANKS,
          "mesh": {"data": 2, "model": 2}, "questions": MESH_QUESTIONS,
          "optimizer": MESH_OPT, "moe_layers": MESH_MOE_LAYERS,
          "moe_capacity_factor": MOE_AMPLE_CAPACITY,
          "loss_rtol": MESH_LOSS_RTOL, "grad_norm_rtol": MESH_NORM_RTOL,
          "note": "four gloo ranks share one card and stage every "
                  "collective through host memory: no multi-GPU speed",
          **out["b_c"]})
    for label in ("b", "c"):
        c = checks[label]
        check(c["loss_rel_diff"] <= MESH_LOSS_RTOL
              and c["grad_norm_rel_diff"] <= MESH_NORM_RTOL
              and c["excess_over_bound"] <= 0 and c["replicated_equal"]
              and c["same_on_every_rank"],
              f"phase 26 ({label}) against one device: {c}")
    check(checks["resume_bit_equal"], "phase 26: the resumed world against "
          "the uninterrupted run")
    check(all(r["b1_launches"] == r["b2_launches"] == 0 and not r["tf32"]
              for r in per_rank), f"phase 26 ranks: {per_rank}")

    # ---- (d) torchrun train fit on the card, started before (b) -------
    try:
        torchrun.wait(timeout=CLI_TIMEOUT_S)
    finally:
        torchrun.kill()
        for f in logs:
            f.seek(0)
        err = logs[1].read()
        for f in logs:
            f.close()
    torchrun_s = time.perf_counter() - t_torchrun
    check(torchrun.returncode == 0, f"torchrun train fit: {err[-4000:]}")
    got = [json.loads(ln)["loss"] for ln in (
        workdir / "torchrun_ckpt" / "log.jsonl").read_text().splitlines()]
    ref = [json.loads(ln)["loss"] for ln in (
        workdir.parent / "train_ckpt" / "log.jsonl").read_text(
        ).splitlines()][: len(got)]
    out["d"] = {"wall_s_beside_the_ranks": torchrun_s, "losses": got,
                "phase_21_losses": ref, "bit_equal": got == ref,
                "rank_files": sorted(p.name for p in (
                    workdir / "torchrun_ckpt" / "step_4").iterdir())}
    emit({"phase": "mesh_training_torchrun", **out["d"]})
    check(len(got) == 4 and np.allclose(got, ref, rtol=1e-5, atol=0)
          and out["d"]["rank_files"] == ["rank0.pt"],
          f"torchrun train fit against phase 21's fit: {out['d']}")
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "mesh_training_seconds", "seconds": out["seconds"]})
    return out



# ---- phase 27: pipeline parallelism -------------------------------------------
PIPE_MICRO = 4             # (a): the microbatches of the agreement check
PIPE_RANKS = 4             # gloo ranks sharing the one card
PIPE_TIMEOUT_S = 240       # the ranks' own limit, joins and collectives
PIPE_STEPS = 2             # (b): AdamW steps of the ranks
PIPE_B = dict(data=2, pipe=2, n_micro=2)
PIPE_C = dict(data=1, pipe=4, n_micro=8)
PIPE_RANK_CODE = ("import sys, chip_smoke; "
                  "chip_smoke.pipe_rank(sys.argv[1], int(sys.argv[2]))")
PIPE_PROBE_CODE = ("import sys, chip_smoke; "
                   "chip_smoke.p2p_probe_rank(sys.argv[1], int(sys.argv[2]))")
PIPE_SIZES = ("PIPE_RANKS", "PIPE_TIMEOUT_S", "PIPE_STEPS", "PIPE_B",
              "PIPE_C", "MESH_BERT", "MESH_OPT")


def pp_batch(collated: dict) -> dict:
    """A padded BiEncoderCollator batch in the form __graft_entry__.py's
    pp_loss takes (q_ids, q_mask, c_ids, c_mask, labels), each side cut
    after its longest sequence (the padding columns are masked out of
    every real token's attention: the cut changes no value)."""
    out = {"labels": np.asarray(collated["labels"], np.int64)}
    for side, key in (("q", "question_inputs"), ("c", "context_inputs")):
        ids = np.asarray(collated[key]["input_ids"])
        mask = np.asarray(collated[key]["attention_mask"])
        width = int(np.nonzero(mask.any(0))[0].max()) + 1
        out[f"{side}_ids"] = ids[:, :width].astype(np.int64)
        out[f"{side}_mask"] = mask[:, :width].astype(np.int64)
    return out


def pp_towers(dev, stages=None, layers_: int = 12):
    """Phase 26's DPR towers (BERT-base, seeds 0 and 1, dropout off) as
    one ModuleDict of BERTs, staged into ``stages`` when given."""
    from torch import nn

    cfg = dpr.DPRConfig(bert=mesh_bert(layers_, dropout=False))
    out = {}
    for name, seed in (("question", 0), ("context", 1)):
        m = dpr.DPREncoder(cfg=cfg, seed=seed, device=dev).params
        out[name] = bert.pipeline_params(m, stages) if stages else m
    return nn.ModuleDict(out), cfg.bert


def pp_loss_fn(cfg, n_micro=None, ctx=None):
    """__graft_entry__.py's pp_loss over remat layers: each tower's
    embeddings, the encoder (pipelined over ``ctx`` with ``n_micro``
    microbatches, or sequential without), the CLS states and the in-batch
    biencoder loss."""
    from viquae_torch.train import objectives

    def tower(p, ids, mask):
        x = bert.embed(p, cfg, ids)
        if n_micro is None:
            return bert.encode(p, cfg, x, mask, remat_layers=True)[:, 0]
        return bert.encode_pipelined(p, cfg, x, mask, n_micro=n_micro,
                                     mesh_ctx=ctx, remat_layers=True)[:, 0]

    def loss_fn(params, batch, generator=None, deterministic=False):
        q = tower(params["question"], batch["q_ids"], batch["q_mask"])
        c = tower(params["context"], batch["c_ids"], batch["c_mask"])
        loss, _ = objectives.biencoder_loss(q, c, batch["labels"])
        return loss, {}

    return loss_fn


def pp_spec(cfg, stages: int) -> dict:
    return {n: bert.pipeline_param_spec(cfg, stages)
            for n in ("question", "context")}


def encoder_bound(ref: torch.Tensor, layers_: int, depth: int) -> float:
    """The f32 reordering bound of an encoder's output: 2 gamma_d (gamma_d
    = d u / (1 - d u), u = 2^-24, d the deepest dot product) of the
    output's scale once a layer."""
    gamma = depth * 2.0 ** -24 / (1 - depth * 2.0 ** -24)
    return 2 * gamma * layers_ * float(ref.abs().max())


class CommTimer:
    """Wall time spent inside core.mesh's collectives and p2p calls (the
    device synchronised on entry and exit, so device work is counted as
    compute), by patching the module's functions; ``seconds`` grows."""

    NAMES = ("send_to", "recv_from", "broadcast", "all_reduce",
             "all_gather", "reduce_scatter")

    def __init__(self, dev):
        from viquae_torch.core import mesh

        self.seconds, self.dev = 0.0, dev
        for name in self.NAMES:
            setattr(mesh, name, self._timed(getattr(mesh, name)))

    def _timed(self, fn):
        def call(*args, **kwargs):
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
                self.seconds += time.perf_counter() - t0
        return call


def pp_steps(trainer, batch, steps, dev, comm) -> dict:
    """``steps`` optimizer steps (Trainer.fit's generator per step), each
    read back: losses, grad norms, wall ms a step (synchronised) and the
    ms of it spent in collectives (``comm``, a CommTimer)."""
    out = {"losses": [], "grad_norms": [], "step_ms": [], "wait_ms": []}
    for _ in range(steps):
        step = trainer.state.step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0, w0 = time.perf_counter(), comm.seconds
        loss, norm, _ = trainer._train_step(batch,
                                            trainer.seeds.split(f"step{step}"))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["wait_ms"].append(1e3 * (comm.seconds - w0))
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(norm))
    out["compute_ms"] = [a - b for a, b in zip(out["step_ms"],
                                               out["wait_ms"])]
    return out


def replicated_equal_over(trainer, axes) -> bool:
    """Every parameter bit-equal over each of ``axes`` it is not split
    over (one all-gather each)."""
    from viquae_torch.core import mesh
    from viquae_torch.models.sharding import parameter_axes

    same = True
    axes_of = parameter_axes(trainer.state.params)
    for name, p in trainer.state.params.named_parameters():
        for axis in axes:
            if axes_of[name] != axis:
                parts = mesh.all_gather(trainer.mesh_ctx, p.detach(), axis)
                same &= all(torch.equal(parts[0], q) for q in parts[1:])
    return bool(same)


def p2p_probe_rank(workdir: str, rank: int) -> None:
    """Whether gloo's send / recv take a CUDA tensor as it is (core.mesh
    stages them through pinned host memory either way): rank 0 sends
    arange(4096) from the card, rank 1 receives it into the card. Writes
    the outcome; a crash shows as the process's exit code."""
    import datetime
    import resource
    from pathlib import Path

    import torch.distributed as dist

    # the probe may abort: no core file
    resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(workdir) / 'rendezvous'}",
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
    x = torch.arange(4096, dtype=torch.float32, device=dev)
    try:
        if rank == 0:
            dist.send(x, 1)
            outcome = "sent"
        else:
            buf = torch.zeros_like(x)
            dist.recv(buf, 0)
            torch.cuda.synchronize(dev)
            outcome = "delivered" if torch.equal(buf, x) else "wrong bytes"
    except Exception as e:     # noqa: BLE001 - the answer is the error
        outcome = f"refused: {type(e).__name__}: {str(e)[:160]}"
    finally:
        dist.destroy_process_group()
    Path(workdir, f"probe{rank}.json").write_text(json.dumps(outcome))


def pipe_rank(spec_path: str, rank: int) -> None:
    """One of phase 27's gloo ranks (a process of its own on the one
    card): joins the world, runs :func:`pipe_rank_work` and writes what it
    measured next to the spec."""
    import datetime
    import pickle
    from pathlib import Path

    import torch.distributed as dist

    spec = pickle.loads(Path(spec_path).read_bytes())
    globals().update(spec["sizes"])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)          # the CUDA context, before the go
    # a world started early (its start-up beside the previous world's
    # work) waits for the parent's go before it joins
    deadline = time.monotonic() + PIPE_TIMEOUT_S
    while spec.get("go") and not Path(spec["go"]).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no go at {spec['go']}")
        time.sleep(0.1)
    dist.init_process_group(
        "gloo", init_method=spec["init"], rank=rank, world_size=PIPE_RANKS,
        timeout=datetime.timedelta(seconds=PIPE_TIMEOUT_S))
    try:
        out = pipe_rank_work(dev, spec)
    finally:
        dist.destroy_process_group()
    Path(spec["dir"], f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def pipe_rank_work(dev, spec) -> dict:
    """(b) the full-width biencoder on data = 2 x pipe = 2: step 1, this
    rank's stage checkpoint, step 2, full_params (rank 0 writes the
    per-layer parameters and HF state dicts); or, in the resume world,
    step 1's checkpoint restored and step 2. (c) the question tower at
    pipe = 4: the forward, the input gradient and this stage's parameter
    gradients of sum(out * w). Every number is this rank's, on a card the
    four ranks share."""
    import gc

    from viquae_torch.core import mesh
    from viquae_torch.models import sharding
    from viquae_torch.train import checkpoint as ckpt_lib
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    comm = CommTimer(dev)
    b = PIPE_B
    ctx = mesh.make_mesh(data=b["data"], pipe=b["pipe"], device=dev)
    out = {"coords": dict(ctx.coords), "route": mesh.collective_route(ctx),
           "p2p_route": mesh.collective_route(ctx, p2p=True),
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    mips_fused.fused_score_segmax_qmajor.launches = 0
    mips_fused.fused_score_segmax.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    towers, cfg = pp_towers(dev, stages=b["pipe"])
    trainer = Trainer(pp_loss_fn(cfg, b["n_micro"], ctx), towers,
                      optim.make_optimizer(towers, **MESH_OPT),
                      TrainerConfig(max_steps=PIPE_STEPS, log_every=0),
                      mesh_ctx=ctx, param_spec=pp_spec(cfg, b["pipe"]))
    del towers
    batch = spec["batch"]
    res = {"held": trainer.state.params["question"].layers.held()}
    if spec["resume"]:
        t0 = time.perf_counter()
        ckpt_lib.restore_state(spec["ckpt"], trainer.state,
                               map_location=dev, rank=ctx.rank)
        res["restore_s"] = time.perf_counter() - t0
        res.update(pp_steps(trainer, batch, 1, dev, comm))
    else:
        first = pp_steps(trainer, batch, 1, dev, comm)
        t0 = time.perf_counter()
        ckpt_lib.save_state(spec["ckpt"], trainer.state, 1, rank=ctx.rank)
        res["save_s"] = time.perf_counter() - t0
        ctx.collective_log.clear()
        later = pp_steps(trainer, batch, PIPE_STEPS - 1, dev, comm)
        res["step_collectives"] = collective_kinds(ctx.collective_log)
        res.update({k: first[k] + later[k] for k in first})
    res["replicated_equal"] = replicated_equal_over(
        trainer, (mesh.DATA_AXIS, mesh.PIPE_AXIS))
    res["digest"] = state_digest(trainer)
    res["peak_memory_bytes"] = peak_memory(dev)
    if not spec["resume"]:
        full = trainer.full_params()
        if ctx.rank == 0:
            torch.save({"params": {n: p.detach().cpu() for n, p in
                                   full.named_parameters()},
                        "hf": {n: bert.params_to_hf_state_dict(full[n], cfg)
                               for n in ("question", "context")}},
                       os.path.join(spec["dir"], "params_b.pt"))
        del full
    out["b"] = res
    del trainer
    gc.collect()
    if spec["resume"]:
        return finish_pipe_rank(out)

    # ---- (c) the question tower at pipe = 4 --------------------------
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    c = PIPE_C
    ctx4 = mesh.make_mesh(data=c["data"], pipe=c["pipe"], device=dev)
    towers, cfg = pp_towers(dev, stages=c["pipe"])
    shard = sharding.shard_module(
        towers["question"], bert.pipeline_param_spec(cfg, c["pipe"]), ctx4
    ).requires_grad_(True)
    del towers
    x, w = pipe_c_inputs(shard, cfg, batch, dev)
    x.requires_grad_(True)
    ctx4.collective_log.clear()
    t0 = time.perf_counter()
    y = bert.encode_pipelined(shard, cfg, x, batch_mask(batch, dev),
                              n_micro=c["n_micro"], mesh_ctx=ctx4)
    (y * w).sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = {"ms": 1e3 * (time.perf_counter() - t0),
           "collectives": collective_kinds(ctx4.collective_log),
           "held": shard.layers.held(),
           "peak_memory_bytes": peak_memory(dev)}
    torch.save({"out": y.detach().cpu(), "x_grad": x.grad.cpu(),
                "grads": {n: p.grad.detach().cpu() for n, p in
                          shard.layers.named_parameters()}},
               os.path.join(spec["dir"], f"c_rank{ctx4.rank}.pt"))
    out["c"] = res
    return finish_pipe_rank(out)


def finish_pipe_rank(out: dict) -> dict:
    out["b1_launches"] = mips_fused.fused_score_segmax_qmajor.launches
    out["b2_launches"] = mips_fused.fused_score_segmax.launches
    return out


def batch_mask(batch, dev) -> torch.Tensor:
    return torch.from_numpy(batch["q_mask"]).to(dev)


def pipe_c_inputs(tower, cfg, batch, dev):
    """(c)'s encoder input, the question tower's embeddings of the batch's
    questions, and the output weights w (seeded on the device): the same
    on every rank and in the one-device reference."""
    with torch.no_grad():
        x = bert.embed(tower, cfg, torch.from_numpy(batch["q_ids"]).to(dev))
    gen = torch.Generator(device=dev).manual_seed(27)
    w = torch.randn(x.shape, generator=gen, device=dev)
    return x, w


def pp_reference(dev, batch, steps) -> dict:
    """(b)'s one-device sequential Trainer on the card
    (:func:`reference_steps`, moved to the CPU) and the towers' HF state
    dicts."""
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    towers, cfg = pp_towers(dev)
    trainer = Trainer(pp_loss_fn(cfg), towers,
                      optim.make_optimizer(towers, **MESH_OPT),
                      TrainerConfig(max_steps=steps, log_every=0))
    del towers
    res = reference_steps(trainer, batch, steps)
    for key in ("params", "smallest_grad"):
        res[key] = {n: t.cpu() for n, t in res[key].items()}
    res["hf"] = {n: bert.params_to_hf_state_dict(trainer.state.params[n],
                                                 cfg)
                 for n in ("question", "context")}
    return res


def pipe_c_reference(dev, batch) -> dict:
    """(c)'s one-device sequential encoder: output, input gradient and
    every layer's parameter gradients of sum(out * w), on the CPU."""
    towers, cfg = pp_towers(dev)
    tower = towers["question"].requires_grad_(True)
    x, w = pipe_c_inputs(tower, cfg, batch, dev)
    x.requires_grad_(True)
    y = bert.encode(tower, cfg, x, batch_mask(batch, dev))
    (y * w).sum().backward()
    return {"out": y.detach().cpu(), "x_grad": x.grad.cpu(),
            "grads": {n: p.grad.detach().cpu() for n, p in
                      tower.layers.named_parameters()}}


def phase_pipeline(dev, tokenizer, workdir) -> dict:
    """Phase 27: pipeline parallelism on the card. (a) A NCCL world of
    one, make_mesh(data=1, pipe=1), drives phase 26 (a)'s DPR biencoder
    (BERT-base x 2, f32, remat, phase 21's batch, padded as
    __graft_entry__.py's pp_loss takes it): encode_pipelined at one
    microbatch bit-equal to encode, at PIPE_MICRO within the f32
    reordering bound; the pipelined Trainer (pipeline_param_spec) for 3
    steps bit-equal to the plain Trainer, both timed. (b) Four gloo ranks
    sharing the card at data = 2 x pipe = 2, 2 microbatches (the dry
    run's shape at full width: 12 layers, 6 a stage) on phase 26 (b)'s
    batch: 2 AdamW steps against one device's sequential Trainer (losses,
    the first grad norm, the parameters by the update bound, replicated
    parameters bit-equal over pipe and data); each rank's stage
    checkpoint of step 1 resumed bit-equal in a fresh world;
    full_params' HF state dicts against one device's. (c) The same world
    at pipe = 4, 8 microbatches (3 layers a stage): the question tower's
    output, input and parameter gradients against one device. Beside
    them, a probe of gloo's send / recv with raw CUDA tensors (the port
    stages them through pinned host memory either way). No number here is
    a multi-GPU speed: ranks that share one card time the host-staged
    route and the pipeline bubble (S - 1) / (M + S - 1), not NVLink; NCCL
    refuses two ranks on one GPU, so NCCL p2p is not exercised."""
    import datetime
    import gc

    import torch.distributed as dist

    from viquae_torch.core import mesh
    from viquae_torch.train import data as tdata
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    workdir.mkdir(parents=True, exist_ok=True)
    out = {}
    probe = None
    if dev.type == "cuda":      # runs beside (a)
        (workdir / "probe").mkdir()
        probe = start_ranks(PIPE_PROBE_CODE, workdir / "probe", 2,
                            workdir / "probe", str(dev))

    # ---- (a) a NCCL world of one ---------------------------------------
    kb, items = dpr_train_items(np.random.default_rng(21),
                                DPR_TRAIN_QUESTIONS)
    batch = pp_batch(tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, n_relevant_passages=1, search_key="BM25",
        max_length=256, packed=False, seed=0).collate_fn(items))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{workdir / 'nccl_rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PIPE_TIMEOUT_S),
        **({"device_id": dev} if dev.type == "cuda" else {}))
    try:
        ctx = mesh.make_mesh(data=1, pipe=1, device=dev)
        plain, cfg = pp_towers(dev)
        staged, _ = pp_towers(dev, stages=1)
        ids = torch.from_numpy(batch["q_ids"]).to(dev)
        mask = torch.from_numpy(batch["q_mask"]).to(dev)
        with torch.no_grad():
            x = bert.embed(plain["question"], cfg, ids)
            ref = bert.encode(plain["question"], cfg, x, mask)
            one = bert.encode_pipelined(staged["question"], cfg, x, mask,
                                        n_micro=1, mesh_ctx=ctx)
            four = bert.encode_pipelined(staged["question"], cfg, x, mask,
                                         n_micro=PIPE_MICRO, mesh_ctx=ctx)
        bound = encoder_bound(ref, cfg.num_hidden_layers,
                              cfg.intermediate_size)
        encode = {"one_microbatch_bit_equal": bool(torch.equal(one, ref)),
                  "micro": PIPE_MICRO,
                  "max_abs_diff": float((four - ref).abs().max()),
                  "bound": bound}
        del plain, staged, x, ref, one, four
        runs = {}
        for label in ("plain", "pipelined"):
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            towers, _ = pp_towers(dev, stages=1 if label == "pipelined"
                                  else None)
            kw = ({} if label == "plain" else
                  dict(mesh_ctx=ctx, param_spec=pp_spec(cfg, 1)))
            loss_fn = pp_loss_fn(cfg, *((1, ctx) if label == "pipelined"
                                        else ()))
            trainer = Trainer(loss_fn, towers,
                              optim.make_optimizer(towers, **DPR_TRAIN_OPT),
                              TrainerConfig(max_steps=MESH_TRAIN_STEPS,
                                            log_every=0), **kw)
            del towers
            ctx.collective_log.clear()
            res = mesh_steps(trainer, batch, MESH_TRAIN_STEPS, dev)
            res["collectives"] = collective_kinds(ctx.collective_log)
            res["params"] = [p.detach().clone() for p in
                             trainer.state.params.parameters()]
            res["peak_memory_bytes"] = peak_memory(dev)
            del trainer
            runs[label] = res
        route = mesh.collective_route(ctx, p2p=True)
    finally:
        dist.destroy_process_group()
    bit_equal = (runs["plain"]["losses"] == runs["pipelined"]["losses"]
                 and runs["plain"]["grad_norms"]
                 == runs["pipelined"]["grad_norms"]
                 and all(torch.equal(a, b) for a, b in zip(
                     runs["plain"]["params"], runs["pipelined"]["params"])))
    out["a"] = {"encode": encode, "trainer_bit_equal": bit_equal,
                "route": route, **{k: {n: v for n, v in r.items()
                                       if n != "params"}
                                   for k, r in runs.items()}}
    del runs, batch
    emit({"phase": "pipeline_world_of_one", "steps": MESH_TRAIN_STEPS,
          "questions": DPR_TRAIN_QUESTIONS, "remat_layers": True,
          **out["a"]})
    check(encode["one_microbatch_bit_equal"]
          and encode["max_abs_diff"] <= encode["bound"],
          f"phase 27 (a) encode_pipelined against encode: {encode}")
    check(bit_equal, f"phase 27 (a) the pipelined Trainer against the "
          f"plain Trainer: {out['a']}")

    # ---- (b), (c): the one-device references, then the ranks -----------
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kb, items = dpr_train_items(np.random.default_rng(26), MESH_QUESTIONS)
    pbatch = pp_batch(tdata.BiEncoderCollator(
        tokenizer, kb=kb, M=2, n_relevant_passages=1, search_key="BM25",
        max_length=256, packed=False, seed=0).collate_fn(items))
    ref_b = pp_reference(dev, pbatch, PIPE_STEPS)
    ref_c = pipe_c_reference(dev, pbatch)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    spec = {"device": str(dev), "batch": pbatch,
            "ckpt": str(workdir / "ckpt")}
    # the resume world starts beside the first and joins on its go
    go = workdir / "resume_go"
    t0 = time.perf_counter()
    run = start_world(PIPE_RANK_CODE, dict(spec, resume=False),
                      workdir / "run", PIPE_RANKS, PIPE_SIZES)
    resume = start_world(PIPE_RANK_CODE, dict(spec, resume=True, go=str(go)),
                         workdir / "resume", PIPE_RANKS, PIPE_SIZES)
    try:
        ranks = finish_world(run, PIPE_TIMEOUT_S, "phase 27")
        run_s = time.perf_counter() - t0
        go.touch()
        t0 = time.perf_counter()
        resumed = finish_world(resume, PIPE_TIMEOUT_S, "phase 27")
        resume_s = time.perf_counter() - t0
    finally:
        for p in resume[0]:
            if p.poll() is None:
                p.kill()
                p.wait()

    got = torch.load(workdir / "run" / "params_b.pt", weights_only=True)
    first = ranks[0]["b"]
    lr_bound = 1e-6 + 2 * ref_b["lr_sum"]
    hf_diff = max(float((got["hf"][t][k] - v).abs().max())
                  for t, d in ref_b["hf"].items() for k, v in d.items())
    checks_b = {
        "losses": first["losses"], "ref_losses": ref_b["losses"],
        "loss_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(
            first["losses"], ref_b["losses"])),
        "grad_norm_rel_diff": abs(first["grad_norms"][0]
                                  - ref_b["grad_norms"][0])
        / ref_b["grad_norms"][0],
        "replicated_equal": all(r["b"]["replicated_equal"] for r in ranks),
        "same_on_every_rank": all(r["b"]["losses"] == first["losses"]
                                  for r in ranks),
        "hf_same_names": all(sorted(got["hf"][t]) == sorted(d)
                             for t, d in ref_b["hf"].items()),
        "hf_max_abs_diff": hf_diff, "hf_bound": lr_bound,
        **params_within_update_bound(got["params"], ref_b)}
    checks_b["resume_bit_equal"] = all(
        r["b"]["digest"] == s["b"]["digest"]
        and r["b"]["losses"][1] == s["b"]["losses"][0]
        for r, s in zip(ranks, resumed))
    # (c): the stages' gradients in global layer order
    stage_files = [torch.load(workdir / "run" / f"c_rank{r}.pt",
                              weights_only=True) for r in range(PIPE_RANKS)]
    per = mesh_bert(12).num_hidden_layers // PIPE_C["pipe"]
    g_max = max(float(g.abs().max()) for g in ref_c["grads"].values())
    g_err = 0.0
    for r, f in enumerate(stage_files):
        for name, g in f["grads"].items():
            s, j, rest = name.split(".", 2)
            want = ref_c["grads"][f"{int(s) * per + int(j)}.{rest}"]
            g_err = max(g_err, float((g - want).abs().max()))
    c_out = stage_files[0]
    x_max = float(ref_c["x_grad"].abs().max())
    checks_c = {
        "out_max_abs_diff": max(float((f["out"] - ref_c["out"]).abs().max())
                                for f in stage_files),
        "out_bound": encoder_bound(ref_c["out"], 12,
                                   mesh_bert(12).intermediate_size),
        "x_grad_max_abs_diff": float((c_out["x_grad"]
                                      - ref_c["x_grad"]).abs().max()),
        "x_grad_bound": GRAD_RTOL * x_max,
        "grad_max_abs_diff": g_err, "grad_bound": GRAD_RTOL * g_max,
        "stages": [r["c"]["held"] for r in ranks]}
    probe_out = None
    if probe is not None:
        wait_ranks(*probe, 60)
        probe_out = {f"rank{r}": {
            "exit": p.returncode,
            "outcome": json.loads((workdir / "probe" / f"probe{r}.json"
                                   ).read_text())
            if (workdir / "probe" / f"probe{r}.json").exists() else None}
            for r, p in enumerate(probe[0])}
    per_rank = [{"coords": r["coords"], "route": r["route"],
                 "p2p_route": r["p2p_route"], "tf32": r["tf32"],
                 "b1_launches": r["b1_launches"] + s["b1_launches"],
                 "b2_launches": r["b2_launches"] + s["b2_launches"],
                 "b_stage": r["b"]["held"],
                 "b_step_ms": r["b"]["step_ms"],
                 "b_compute_ms": r["b"]["compute_ms"],
                 "b_wait_ms": r["b"]["wait_ms"],
                 "b_resumed_step_ms": s["b"]["step_ms"],
                 "b_peak_memory_bytes": r["b"]["peak_memory_bytes"],
                 "b_checkpoint_save_s": r["b"]["save_s"],
                 "b_checkpoint_restore_s": s["b"]["restore_s"],
                 "b_step2_collectives": r["b"]["step_collectives"],
                 "c_ms": r["c"]["ms"],
                 "c_peak_memory_bytes": r["c"]["peak_memory_bytes"],
                 "c_collectives": r["c"]["collectives"]}
                for r, s in zip(ranks, resumed)]
    bubble = {name: (m["pipe"] - 1) / (m["n_micro"] + m["pipe"] - 1)
              for name, m in (("b", PIPE_B), ("c", PIPE_C))}
    out["b_c"] = {"checks_b": checks_b, "checks_c": checks_c,
                  "ranks": per_rank, "bubble": bubble,
                  "gloo_cuda_p2p_probe": probe_out,
                  "world_s": run_s, "resume_world_s": resume_s}
    emit({"phase": "pipeline_gloo_ranks", "ranks": PIPE_RANKS,
          "b": PIPE_B, "c": PIPE_C, "questions": MESH_QUESTIONS,
          "optimizer": MESH_OPT, "loss_rtol": MESH_LOSS_RTOL,
          "grad_norm_rtol": MESH_NORM_RTOL,
          "note": "four gloo ranks share one card: the host-staged route "
                  "and the pipeline bubble, no multi-GPU speed; NCCL p2p "
                  "is not exercised (NCCL refuses two ranks on one GPU)",
          **out["b_c"]})
    check(checks_b["loss_rel_diff"] <= MESH_LOSS_RTOL
          and checks_b["grad_norm_rel_diff"] <= MESH_NORM_RTOL
          and checks_b["excess_over_bound"] <= 0
          and checks_b["replicated_equal"]
          and checks_b["same_on_every_rank"] and checks_b["hf_same_names"]
          and checks_b["hf_max_abs_diff"] <= lr_bound,
          f"phase 27 (b) against one device: {checks_b}")
    check(checks_b["resume_bit_equal"], "phase 27: the resumed world "
          "against the uninterrupted run")
    check(checks_c["out_max_abs_diff"] <= checks_c["out_bound"]
          and checks_c["x_grad_max_abs_diff"] <= checks_c["x_grad_bound"]
          and checks_c["grad_max_abs_diff"] <= checks_c["grad_bound"]
          and checks_c["stages"] == [[0], [1], [2], [3]],
          f"phase 27 (c) pipe = 4 against one device: {checks_c}")
    check(all(r["b1_launches"] == r["b2_launches"] == 0 and not r["tf32"]
              and r["p2p_route"] in ("gloo-cuda-pinned-host", "gloo")
              for r in per_rank), f"phase 27 ranks: {per_rank}")
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "pipeline_seconds", "seconds": out["seconds"]})
    return out


def pipeline_only() -> int:
    """``python3 chip_smoke.py --pipeline-only``: phase 27 alone (no
    kernel build, no kernel line), for a quick check of the pipeline on
    the card; without arguments the script runs every phase."""
    import tempfile
    from pathlib import Path

    phase_device()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=Path(__file__).parent) as tmp:
        tokenizer = bert_vocab_tokenizer(Path(tmp) / "tok",
                                         dpr.DPRConfig().bert.vocab_size)
        phase_pipeline(torch.device("cuda"), tokenizer,
                       Path(tmp) / "pipeline")
    return 0


def timed(dirs) -> int:
    """``--timed DIR ...``: each checkout's chip_smoke.py in turn, every
    line of its output prefixed with the checkout and the seconds since
    its start (the phase times of two trees on one card, in one call);
    then the exit codes as one JSON line."""
    import subprocess

    rcs = {}
    for d in dirs:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=d,
                                stdout=subprocess.PIPE, text=True)
        for line in proc.stdout:
            print(f"{d} {time.perf_counter() - t0:.1f} {line}", end="",
                  flush=True)
        rcs[d] = proc.wait()
    print(json.dumps({"timed": rcs}))
    return max(rcs.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import tempfile
    from pathlib import Path

    if sys.argv[1:] == ["--pipeline-only"]:
        return pipeline_only()
    if sys.argv[1:2] == ["--timed"]:
        return timed(sys.argv[2:])
    if sys.argv[1:] == ["--segment-attention-only"]:
        return segment_attention_only()
    if sys.argv[1:] == ["--encoder-glue-only"]:
        return encoder_glue_only()
    phase_device()
    build_logs = phase_build()
    dev = torch.device("cuda")
    phase_kernel_vs_plain(dev)
    err_f32 = phase_kbmajor_vs_plain(dev)
    main_path = phase_main_path(dev)
    kernels = [phase_kernel_table(main_path["index"], main_path["q"],
                                  main_path["launches"])]
    kernels += phase_topk_pallas(dev, main_path, err_f32)
    launches_by_path = {}
    # phases 23-24 reach no kernel: their counts are read to show it
    for name, run in (("ivf", lambda: phase_ivf(dev, main_path)),
                      ("moe", lambda: phase_moe(dev, main_path))):
        mips_fused.fused_score_segmax_qmajor.launches = 0
        mips_fused.fused_score_segmax.launches = 0
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run()
        launches_by_path[name] = {
            "b1": mips_fused.fused_score_segmax_qmajor.launches,
            "b2": mips_fused.fused_score_segmax.launches}
        emit({"phase": f"{name}_seconds", "seconds":
              time.perf_counter() - t0, "peak_memory_bytes":
              torch.cuda.max_memory_allocated(), **launches_by_path[name]})
        torch.cuda.empty_cache()
    phase_global_serve(dev, main_path)
    phase_streaming(dev, main_path)
    phase_late_fusion(dev, main_path)
    before_reader = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shared = phase_reader_step(dev, main_path)
    segattn.segment_attention.launches = 0
    glue.bias_residual_layernorm.launches = glue.bias_gelu.launches = 0
    launches_by_path.update({
        "exact_retrieval": main_path["launches"],
        "exact_retrieval_stream": main_path["stream_launches"],
        **phase_answer_path(dev, main_path, shared)})
    answer_path_launches = segattn.segment_attention.launches
    glue_entry = {"kernel": "encoder_glue",
                  "file": "viquae_torch/csrc/encoder_glue.cu",
                  "launches_by_path": {"answer_path": {
                      "bias_residual_layernorm":
                          glue.bias_residual_layernorm.launches,
                      "bias_gelu": glue.bias_gelu.launches}}}
    emit({"phase": "encoder_glue_launches", **glue_entry})
    reader_peak = torch.cuda.max_memory_allocated()
    segment_entry = phase_segment_attention(
        dev, segment_attention_ptxas(build_logs["segment_attention"]))
    segment_entry["launches_by_path"] = {"answer_path": answer_path_launches}
    kernels += [segment_entry, glue_entry]
    # one scratch directory for the rest: phase 25's BM25 arrays and ranks,
    # the tokenizer, the CLI and training files
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=Path(__file__).parent) as tmp:
        workdir = Path(tmp)
        sparse = phase_bm25(dev)
        launches_by_path.update(phase_hybrid(dev, main_path, sparse))
        launches_by_path.update(phase_server(dev, main_path, sparse,
                                             shared))
        sparse_peak = torch.cuda.max_memory_allocated()
        bm25_ref = bm25_reference(sparse, workdir)
        del sparse
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        chain = phase_towers(dev)
        fusion = phase_image_fusion(dev, main_path, chain)
        launches_by_path["image_fusion"] = fusion["launches"]
        launches_by_path.update(phase_vqa_server(dev, main_path, shared,
                                                 fusion))
        image_peak = torch.cuda.max_memory_allocated()
        del chain, fusion
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        tokenizer = bert_vocab_tokenizer(workdir / "tok",
                                         dpr.DPRConfig().bert.vocab_size)
        launches_by_path["early_fusion"] = phase_early_fusion(
            dev, main_path, tokenizer)["launches"]
        launches_by_path.update(phase_cli(dev, main_path, tokenizer,
                                          workdir))
        emit({"phase": "early_fusion_and_cli_seconds",
              "seconds": time.perf_counter() - t0})
        # phase 21 reaches no kernel: its counts are read to show it
        mips_fused.fused_score_segmax_qmajor.launches = 0
        mips_fused.fused_score_segmax.launches = 0
        t0 = time.perf_counter()
        del main_path["index"], main_path["embedder"], shared
        torch.cuda.empty_cache()
        training = phase_training(dev, tokenizer, workdir)
        launches_by_path["training"] = {
            "b1": mips_fused.fused_score_segmax_qmajor.launches,
            "b2": mips_fused.fused_score_segmax.launches}
        segment_entry["launches_by_path"]["training_steps"] = sum(
            values_of(training, "segment_attention_step_launches"))
        glue_entry["launches_by_path"]["training_steps"] = sum(
            values_of(training, "glue_step_launches"))
        emit({"phase": "training_seconds",
              "seconds": time.perf_counter() - t0})
        # phase 22 reaches no kernel either: its counts are read to show it
        mips_fused.fused_score_segmax_qmajor.launches = 0
        mips_fused.fused_score_segmax.launches = 0
        t0 = time.perf_counter()
        phase_auxiliary(dev, tokenizer, workdir)
        launches_by_path["auxiliary_models"] = {
            "b1": mips_fused.fused_score_segmax_qmajor.launches,
            "b2": mips_fused.fused_score_segmax.launches}
        emit({"phase": "auxiliary_seconds",
              "seconds": time.perf_counter() - t0})
        # phase 25, with every earlier phase's tensors freed
        torch.cuda.empty_cache()
        launches_by_path["sharded_serving"] = phase_sharded_serving(
            dev, main_path, bm25_ref, workdir / "sharded")
        # phase 26 reaches no kernel either: its counts are read to show it
        torch.cuda.empty_cache()
        mips_fused.fused_score_segmax_qmajor.launches = 0
        mips_fused.fused_score_segmax.launches = 0
        mesh_training = phase_mesh_training(
            dev, tokenizer, workdir / "mesh",
            training["dpr"].get("with_remat", {}).get("step_ms"))
        launches_by_path["mesh_training"] = {
            "b1": mips_fused.fused_score_segmax_qmajor.launches,
            "b2": mips_fused.fused_score_segmax.launches,
            "ranks": [{"b1": r["b1_launches"], "b2": r["b2_launches"]}
                      for r in mesh_training["b_c"]["ranks"]]}
        check(launches_by_path["mesh_training"]["b1"] == 0
              and launches_by_path["mesh_training"]["b2"] == 0,
              f"phase 26 launched a kernel: "
              f"{launches_by_path['mesh_training']}")
        # phase 27 reaches no kernel either: its counts are read to show it
        torch.cuda.empty_cache()
        mips_fused.fused_score_segmax_qmajor.launches = 0
        mips_fused.fused_score_segmax.launches = 0
        pipeline = phase_pipeline(dev, tokenizer, workdir / "pipeline")
        launches_by_path["pipeline"] = {
            "b1": mips_fused.fused_score_segmax_qmajor.launches,
            "b2": mips_fused.fused_score_segmax.launches,
            "ranks": [{"b1": r["b1_launches"], "b2": r["b2_launches"]}
                      for r in pipeline["b_c"]["ranks"]]}
        check(launches_by_path["pipeline"]["b1"] == 0
              and launches_by_path["pipeline"]["b2"] == 0,
              f"phase 27 launched a kernel: {launches_by_path['pipeline']}")
    kernels[0]["launches_by_path"] = launches_by_path
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
