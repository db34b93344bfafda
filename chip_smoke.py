"""Drive the PyTorch port's exact retrieval path on one NVIDIA GPU and hold
every kernel on it against its plain PyTorch version.

    python3 chip_smoke.py

Needs one CUDA GPU, nvcc (the kernels are built from viquae_torch/csrc at
first use) and this checkout; no network, no JAX. Phases, each of which
raises on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source, one nvcc each, started together;
3. kernel vs plain: (a) integer-valued inputs at awkward shapes must be
   bit-identical, (b) gaussian inputs at Q=1,280, d=768, N=262,144 must be
   >= 99.9 % bitwise equal and every score within the float32 reordering
   bound plus one bf16 ulp (see kernel_error);
4. the main path at full width: DPR BERT-base (random weights from a seed,
   bf16), 1,257 lognormal-length questions packed into 64-token rows,
   FusedRetrievalPipeline over a DenseIndex(mode="fused") of 1.5M x 768
   bf16 rows, k=100; the native packer loaded, kernel launch counts, id
   range, >= 99.9 % id agreement with the same embeddings searched by the
   plain version, and the encoder's bf16 GEMMs within rtol = atol = 2e-2
   of the same forward on f32 products of the upcast operands;
5. the kernel table: one JSON line with each kernel's launches on the main
   path, error against the plain version, its time, the plain version's
   and one library call's, and the least time the card could take.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from viquae_torch.ir.embedding import PackedTextEmbedder
from viquae_torch.ir.serving import FusedRetrievalPipeline
from viquae_torch.kernels import build as kbuild
from viquae_torch.models import convert, dpr, layers
from viquae_torch.native.build import load_packer
from viquae_torch.ops import mips, mips_fused

# H100 SXM data-sheet peaks (dense bf16 tensor cores; HBM3), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

N_KB = 1_500_000
N_GAUSS = 262_144  # KB rows of the gaussian kernel-vs-plain check
DIM = 768
N_QUERIES = 1257
BATCH = 1280
ROW_LEN = 64
K = 100


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
    j, wrapped in [CLS]=101 ... [SEP]=102, truncated to max_length."""

    def __call__(self, texts, truncation=True, max_length=512):
        out = []
        for text in texts:
            ids = [int(w[1:]) for w in text.split()]
            if truncation:
                ids = ids[: max_length - 2]
            out.append([101] + ids + [102])
        return {"input_ids": out}


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


def phase_build():
    start = time.perf_counter()
    logs = kbuild.build_all(force=True, verbose=True)
    seconds = time.perf_counter() - start
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "kernels": sorted(logs), "ptxas": ptxas})


def phase_kernel_vs_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    # (a) integer values in [-4, 4], d = 64: every f32 sum is exact
    q = torch.randint(-4, 5, (77, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    kb = torch.randint(-4, 5, (1024, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    for valid in (1000, 0, 1024):
        s, m = mips_fused.fused_score_segmax(q, kb, valid)
        ps, pm = mips_fused.fused_score_segmax_plain(q, kb, valid)
        _, ids = mips_fused.topk_fused(q, kb, 50, valid_rows=valid)
        _, pids = mips_fused.segment_topk(ps, pm, 50)
        torch.cuda.synchronize()
        same = (torch.equal(s.view(torch.int16), ps.view(torch.int16)),
                torch.equal(m.view(torch.int16), pm.view(torch.int16)),
                torch.equal(ids, pids))
        emit({"phase": "kernel_vs_plain_integer", "shape": [77, 64, 1024],
              "valid_rows": valid, "scores_bitwise": same[0],
              "segmax_bitwise": same[1], "topk_ids_equal": same[2]})
        check(all(same), f"integer inputs, valid_rows={valid}")
    # (b) gaussian at a wide shape
    q = torch.randn((BATCH, DIM), generator=gen, device=dev).to(
        torch.bfloat16)
    kb = (torch.randn((N_GAUSS, DIM), generator=gen, device=dev)
          / math.sqrt(DIM)).to(torch.bfloat16)
    s, m = mips_fused.fused_score_segmax(q, kb, N_GAUSS - 77)
    ps, pm = mips_fused.fused_score_segmax_plain(q, kb, N_GAUSS - 77)
    err = kernel_error(s, ps, q, kb)
    own_max = s.view(BATCH, -1, 128).amax(-1)
    segmax_own = torch.equal(m.view(torch.int16), own_max.view(torch.int16))
    emit({"phase": "kernel_vs_plain_gaussian",
          "shape": [BATCH, DIM, N_GAUSS], **err,
          "segmax_is_max_of_own_scores": segmax_own})
    check(err["mask_equal"] and err["within_bound"]
          and err["bitwise_fraction"] >= 0.999 and segmax_own,
          "gaussian inputs")


def phase_main_path(dev, cfg=dpr.DPRConfig()):
    """``cfg`` defaults to DPR BERT-base (no pooler)."""
    # the host pack time below is the native packer's, not the Python one's
    check(load_packer() is not None, "the native packer did not build")
    emit({"phase": "native_packer", "loaded": True})
    t0 = time.perf_counter()
    model = convert.params_from_jax(convert.init_tree(cfg, seed=0), cfg,
                                    device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    lengths = np.clip(np.round(rng.lognormal(np.log(18.0), 0.35, N_QUERIES)),
                      8, ROW_LEN).astype(int)
    queries = [" ".join(f"w{j}" for j in rng.integers(1000, 10_000, n - 2))
               for n in lengths]
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

    mips_fused.fused_score_segmax.launches = 0
    t0 = time.perf_counter()
    scores, ids = pipe.run_arrays(queries)
    first_s = time.perf_counter() - t0
    launches = mips_fused.fused_score_segmax.launches
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
        *mips_fused.fused_score_segmax_plain(qb, index.matrix, index.n), K)
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
    scored = mips_fused.fused_score_segmax(q_full, index.matrix, index.n)
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
    return index, q_full, launches


def phase_kernel_table(index, q, launches):
    kb, nv = index.matrix, index.n
    q_count, n = q.shape[0], kb.shape[0]
    s, m = mips_fused.fused_score_segmax(q, kb, nv)
    ps, pm = mips_fused.fused_score_segmax_plain(q, kb, nv)
    err = kernel_error(s, ps, q, kb)
    emit({"phase": "kernel_vs_plain_main_shapes", **err})
    check(err["mask_equal"] and err["within_bound"]
          and err["bitwise_fraction"] >= 0.999,
          "kernel vs plain at the main-path shapes")
    del s, m, ps, pm
    torch.cuda.empty_cache()

    kernel_ms = time_ms(lambda: mips_fused.fused_score_segmax(q, kb, nv),
                        reps=10, warmup=2)
    plain_ms = time_ms(
        lambda: mips_fused.fused_score_segmax_plain(q, kb, nv), reps=3)

    def library():
        scores = torch.matmul(q, kb.T)
        return scores.view(q_count, n // 128, 128).amax(-1)

    library_ms = time_ms(library, reps=5)
    flops = 2 * q_count * q.shape[1] * n
    moved = (q.numel() + kb.numel() + q_count * n + q_count * (n // 128)) * 2
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = moved / PEAK_HBM_BYTES_PER_S * 1e3
    emit({"kernels": [{
        "name": "score_segmax",
        "route": "cuda",
        "source": "viquae_torch/csrc/score_segmax.cu",
        "replaces": "viquae_tpu/ops/mips_pallas.py:89",
        "launches": launches,
        "max_abs_err": err["max_abs_err"],
        "max_ulp_err": err["max_ulp_err"],
        "bitwise_fraction": err["bitwise_fraction"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "shape": [q_count, q.shape[1], n],
        "flops": flops,
        "bytes": moved,
    }]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    dev = torch.device("cuda")
    phase_kernel_vs_plain(dev)
    index, q, launches = phase_main_path(dev)
    phase_kernel_table(index, q, launches)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
