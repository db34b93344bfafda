"""Where the time of kernels B1, B2 (bf16) and B2 (f32) goes on one NVIDIA GPU.

    python3 kernel_probe.py

Builds patched copies of viquae_torch/csrc into a temporary directory.
At the main path's shapes (Q = 1,280, d = 768, N = 1,500,032, bf16), for
B1 (score_segmax) and B2's bf16 path (score_segmax_kbmajor), and at
Q = 1,280, d = 768, N = 262,144 for B2's f32 path:

1. times, in turns on one card, the kernel as it is ("full") and
   variants that give wrong results and are for timing only: CUDA events
   over 10 launches back to back, 5 rounds. bf16: no epilogue
   ("no_epilogue": the accumulators are summed and dropped), no A-operand
   loads ("no_a_loads": a third less operand traffic). f32: "no_epilogue",
   a quarter of the shared-memory loads ("ffma_only": fragments are loaded
   at the first two of a stage's eight steps and reused), no FFMA
   ("lds_only": every loaded value is added up instead, 64 FADD for 256
   FFMA), and beside them the library call (torch.matmul, TF32 off, plus
   the 128-row amax);
2. traces the tiles of block 0 with clock64() ("trace"; for bf16 also
   without the epilogue): cycles waiting for a tile's first stage, in its
   mainloop and in its epilogue, and the SM clock that the cycles and the
   kernel's time imply;
3. runs a register-only FFMA microbenchmark (no memory traffic, 8 warps an
   SM): independent chains that share two operands ("chains": the FP32
   pipe's own rate), the f32 kernel's own 8 x 8 outer product on
   float4 operands ("outer_product": what the register file lets such a
   stream reach) and the same product with one depth's operands in
   consecutive registers ("outer_product_row_major_regs"), in FFMA per
   cycle and scheduler and in TFLOP/s;
4. counts the f32 kernel's SASS instructions by opcode (cuobjdump);
5. samples nvidia-smi's SM clock and power draw while each full kernel
   runs back to back for about two seconds.

Needs a CUDA GPU and nvcc; no JAX. Prints one JSON object per
measurement; the patches assert that they apply, so a change to the
kernels that they no longer fit makes this script fail, not mismeasure
(tests/test_torch_kernel_probe.py applies them on any host).
"""
from __future__ import annotations

import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from viquae_torch.kernels import build

Q, D, N, VALID = 1280, 768, 1_500_032, 1_500_000
N_F32 = 262_144  # KB rows of the f32 kernel's shapes
HEADER = "score_segmax_sm90.cuh"
KERNELS = {"B1": "score_segmax", "B2_bf16": "score_segmax_kbmajor",
           "B2_f32": "score_segmax_kbmajor"}
HEADER_KINDS = ["full", "no_epilogue", "no_a_loads", "trace",
                "trace_no_epilogue"]
F32_KINDS = ["full", "no_epilogue", "ffma_only", "lds_only", "trace"]

NO_EPILOGUE = ("""            Epilogue::store(acc, smem, c, m_tile, n_tile, p, &map_out);""",
               """            {
                float z = 0.f;
#pragma unroll
                for (int i = 0; i < 128; ++i) z += acc[i];
                if (z == 1234.5f) static_cast<float*>(p.segmax)[0] = z;
            }""")
NO_A_LOADS = ("""                    mbar_expect_tx(full, STAGE_BYTES);
                    tma_load(stage, &map_a, full, kb * BK, m_tile * BM);""",
              """                    mbar_expect_tx(full, B_BYTES);""")
TRACE = [
    ("namespace sm90 {\n",
     "namespace sm90 {\n__device__ long long g_trace[4 * 512];\n"),
    ("""        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
            const int q_tile = t % p.q_tiles, kb_tile = t / p.q_tiles;
            const int m_tile = Epilogue::kKbOnM ? kb_tile : q_tile;
            const int n_tile = Epilogue::kKbOnM ? q_tile : kb_tile;
            // +0""",
     """        const bool tr = blockIdx.x == 0 && threadIdx.x == 128;
        int it = 0;
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
            const int q_tile = t % p.q_tiles, kb_tile = t / p.q_tiles;
            const int m_tile = Epilogue::kKbOnM ? kb_tile : q_tile;
            const int n_tile = Epilogue::kKbOnM ? q_tile : kb_tile;
            if (tr && it < 512) g_trace[4 * it] = clock64();
            // +0"""),
    ("""                mbar_wait(full0 + 8 * s, phase);
                const uint32_t stage = ring + s * STAGE_BYTES;
                const uint64_t da""",
     """                mbar_wait(full0 + 8 * s, phase);
                if (tr && it < 512 && kb == 0) g_trace[4 * it + 1] = clock64();
                const uint32_t stage = ring + s * STAGE_BYTES;
                const uint64_t da"""),
    ("""            wgmma_wait<0>();
            fence_acc(acc);""",
     """            wgmma_wait<0>();
            fence_acc(acc);
            if (tr && it < 512) g_trace[4 * it + 2] = clock64();"""),
]
TRACE_END = ("""        }
        if (leader) bulk_wait_all();""",
             """            if (tr && it < 512) g_trace[4 * it + 3] = clock64();
        }
        if (leader) bulk_wait_all();""")
READ_TRACE = """extern "C" int read_trace(void* dst) {
    return static_cast<int>(cudaMemcpyFromSymbol(
        dst, sm90::g_trace, sizeof(long long) * 4 * 512));
}
"""

# patches of B2's f32 kernel in score_segmax_kbmajor.cu
F32_EPILOGUE = """            epilogue(acc, red + (it % 2) * 4 * BQ, p, kb_tile,
                     static_cast<int64_t>(q_tile) * BQ, row0, col0);"""
F32_NO_EPILOGUE = (F32_EPILOGUE, """            {
                float z = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) z += acc[i][j];
                if (z == 1234.5f) p.segmax[0] = z + red[0] + row0 + col0;
            }""")
F32_LOAD = """                        load_fragment(a[(c + 1) % 2], b[(c + 1) % 2], stage,
                                      at, c + 1);"""
F32_FFMA_ONLY = (F32_LOAD, "                        if (c == 0) "
                 + F32_LOAD.strip())
F32_LDS_ONLY = ("""                    fma_fragment(acc, a[c % 2], b[c % 2]);""",
                """                    {
#pragma unroll
                        for (int i = 0; i < 8; ++i) {
                            acc[i][0] += a[c % 2][i][0] + a[c % 2][i][3];
                            acc[i][1] += b[c % 2][i][1] + b[c % 2][i][2];
                            acc[i][2] += a[c % 2][i][1] + a[c % 2][i][2];
                            acc[i][3] += b[c % 2][i][0] + b[c % 2][i][3];
                        }
                    }""")
F32_TRACE = [
    ("namespace f32 {\n",
     "namespace f32 {\n__device__ long long g_trace[4 * 512];\n"),
    ("""            // +0 to start from: an exactly cancelling sum comes out +0
            float acc[8][8];""",
     """            const bool tr = blockIdx.x == 0 && threadIdx.x == 128;
            if (tr && it < 512) g_trace[4 * it] = clock64();
            float acc[8][8];"""),
    ("""            sm90::mbar_wait(full0 + 8 * s, phase);
            load_fragment(a[0], b[0], ring + s * STAGE_BYTES, at, 0);""",
     """            sm90::mbar_wait(full0 + 8 * s, phase);
            if (tr && it < 512) g_trace[4 * it + 1] = clock64();
            load_fragment(a[0], b[0], ring + s * STAGE_BYTES, at, 0);"""),
    (F32_EPILOGUE,
     "            if (tr && it < 512) g_trace[4 * it + 2] = clock64();\n"
     + F32_EPILOGUE
     + "\n            if (tr && it < 512) g_trace[4 * it + 3] = clock64();"),
]
READ_TRACE_F32 = """extern "C" int read_trace(void* dst) {
    return static_cast<int>(cudaMemcpyFromSymbol(
        dst, f32::g_trace, sizeof(long long) * 4 * 512));
}
"""

# The register-only FFMA microbenchmark: V == 0, 64 chains a thread that
# share two operands; V == 1, the f32 kernel's fma_fragment on float4
# operands held in registers (one of them nudged per step, so that nothing
# is loop-invariant): the 16 operands of one depth lie 4 registers apart,
# as LDS.128 along the depth leaves them; V == 2, the same product with the
# 8 + 8 operands of one depth in consecutive registers, as a [depth][row]
# shared-memory layout would leave them.
FFMA_PEAK = """#include <cuda_runtime.h>
template <int V>
__global__ void __launch_bounds__(256, 1)
ffma_peak(float* out, long long* cycles, int iters) {
    float acc[8][8], a[8][4], b[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            a[i][k] = out[(threadIdx.x + 4 * i + k) % 1024];
            b[i][k] = out[(threadIdx.x + 32 + 4 * i + k) % 1024];
        }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    acc[i][j] =
                        V == 0 ? fmaf(acc[i][j], a[0][0], b[0][0])
                        : V == 1
                            ? fmaf(a[i][kk], b[j][kk], acc[i][j])
                            : fmaf(a[2 * kk + i / 4][i % 4],
                                   b[2 * kk + j / 4][j % 4], acc[i][j]);
        if (V != 0) a[it & 7][it & 3] += 1.0f;
    }
    const long long t1 = clock64();
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) z += acc[i][j];
    if (z == 1234.5f) out[0] = z;
    if (threadIdx.x == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}
extern "C" int ffma_peak_launch(int variant, int blocks, int iters, float* out,
                                long long* cycles, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == 0) ffma_peak<0><<<blocks, 256, 0, s>>>(out, cycles, iters);
    if (variant == 1) ffma_peak<1><<<blocks, 256, 0, s>>>(out, cycles, iters);
    if (variant == 2) ffma_peak<2><<<blocks, 256, 0, s>>>(out, cycles, iters);
    return static_cast<int>(cudaGetLastError());
}
"""
FFMA_PEAK_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def emit(obj):
    print(json.dumps(obj), flush=True)


def patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"kernel_probe patch does not apply: {old[:60]!r}")
    return text.replace(old, new)


def variant_header(kind: str) -> str:
    text = (build.CSRC / HEADER).read_text()
    if kind in ("no_epilogue", "trace_no_epilogue"):
        text = patch(text, *NO_EPILOGUE)
    if kind == "no_a_loads":
        text = patch(text, *NO_A_LOADS)
    if kind.startswith("trace"):
        for old, new in TRACE:
            text = patch(text, old, new)
        text = patch(text, *TRACE_END)
    return text


def variant_f32_source(kind: str) -> str:
    """score_segmax_kbmajor.cu with the f32 kernel patched for ``kind``."""
    text = (build.CSRC / "score_segmax_kbmajor.cu").read_text()
    if kind == "no_epilogue":
        text = patch(text, *F32_NO_EPILOGUE)
    if kind == "ffma_only":
        text = patch(text, *F32_FFMA_ONLY)
    if kind == "lds_only":
        text = patch(text, *F32_LDS_ONLY)
    if kind == "trace":
        for old, new in F32_TRACE:
            text = patch(text, old, new)
        text += READ_TRACE_F32
    return text


def tiles_of_block0(kernel: str) -> int:
    """Tiles the persistent grid gives block 0 (tile t goes to block
    t % grid, grid = min(SMs, tiles))."""
    if kernel == "B1":
        tiles = -(-Q // 128) * -(-N // 256)
    elif kernel == "B2_bf16":
        tiles = -(-Q // 256) * (N // 128)
    else:
        tiles = -(-Q // 128) * (N_F32 // 128)
    grid = min(torch.cuda.get_device_properties(0).multi_processor_count,
               tiles)
    return -(-tiles // grid)


def build_variants(tmp: Path) -> tuple:
    """One library per (kernel, kind) and the FFMA microbenchmark, all
    nvcc started together; returns the loaded libraries and their paths."""
    procs = {}

    def start(key, header, source):
        src = tmp / "_".join(key)
        src.mkdir()
        (src / HEADER).write_text(header)
        (src / f"{key[0]}.cu").write_text(source)
        lib = src / f"lib{key[0]}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(src / f"{key[0]}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)

    plain_header = (build.CSRC / HEADER).read_text()
    for kind in HEADER_KINDS:
        for kernel in ("B1", "B2_bf16"):
            text = (build.CSRC / f"{KERNELS[kernel]}.cu").read_text()
            if kind.startswith("trace"):
                text += READ_TRACE
            start((kernel, kind), variant_header(kind), text)
    for kind in F32_KINDS:
        start(("B2_f32", kind), plain_header, variant_f32_source(kind))
    start(("ffma_peak", "full"), "", FFMA_PEAK)
    libs, paths = {}, {}
    for key, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn_name, (argtypes, restype) in build._SIGNATURES.get(
                KERNELS.get(key[0]), {}).items():
            getattr(handle, fn_name).argtypes = argtypes
            getattr(handle, fn_name).restype = restype
        libs[key], paths[key] = handle, lib
    libs[("ffma_peak", "full")].ffma_peak_launch.argtypes = FFMA_PEAK_ARGTYPES
    return libs, paths


def sass_mix(lib: Path, function: str) -> dict:
    """Opcode counts of the SASS function whose name holds ``function``."""
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        found = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", line)
        if inside and found:
            counts[found.group(1)] += 1
    return dict(counts.most_common())


def time_launches(fn, reps: int) -> float:
    """ms per call of ``fn`` over ``reps`` calls back to back (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q32 = torch.randn((Q, D), generator=gen, device=dev)
    kb32 = torch.randn((N_F32, D), generator=gen, device=dev) / D ** 0.5
    q = q32.to(torch.bfloat16)
    kb = (torch.randn((N, D), generator=gen, device=dev)
          / D ** 0.5).to(torch.bfloat16)
    # (q, kb, scores, segmax) of each kernel
    args = {"B1": (q, kb,
                   torch.empty((Q, N), dtype=torch.bfloat16, device=dev),
                   torch.empty((Q, N // 128), dtype=torch.bfloat16,
                               device=dev)),
            "B2_bf16": (q, kb,
                        torch.empty((N, Q), dtype=torch.bfloat16, device=dev),
                        torch.empty((N // 128, Q), dtype=torch.float32,
                                    device=dev)),
            "B2_f32": (q32, kb32,
                       torch.empty((N_F32, Q), dtype=torch.float32,
                                   device=dev),
                       torch.empty((N_F32 // 128, Q), dtype=torch.float32,
                                   device=dev))}
    kinds = {"B1": HEADER_KINDS, "B2_bf16": HEADER_KINDS, "B2_f32": F32_KINDS}
    flops = {k: 2 * Q * D * a[1].shape[0] for k, a in args.items()}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs, paths = build_variants(Path(tmp))

        def launch(kernel, kind):
            if kind == "library":  # the f32 kernel's yardstick
                scores_t = torch.matmul(kb32, q32.T)
                scores_t.view(N_F32 // 128, 128, Q).amax(1)
                return
            lib = libs[(kernel, kind)]
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args[kernel]]
            n = args[kernel][1].shape[0]
            if kernel == "B1":
                err = lib.score_segmax_launch(*ptrs, Q, n, D, VALID, stream)
            else:
                err = lib.score_segmax_kbmajor_launch(
                    *ptrs, Q, n, D, int(kernel == "B2_f32"), stream)
            if err:
                raise RuntimeError(f"{kernel} {kind}: launch error {err}")

        def time_ms(kernel, kind, reps=10):
            return time_launches(lambda: launch(kernel, kind), reps)

        # 1. the variants in turns
        timed = [(k, v) for k in KERNELS for v in kinds[k]
                 if not v.startswith("trace")] + [("B2_f32", "library")]
        times = {key: [] for key in timed}
        for rnd in range(5):
            for key in (timed if rnd % 2 == 0 else timed[::-1]):
                times[key].append(time_ms(*key))
        for (kernel, kind), ms in times.items():
            med = float(np.median(ms))
            emit({"probe": "variant", "kernel": kernel, "variant": kind,
                  "ms": ms, "median_ms": med,
                  "tflops": flops[kernel] / (med / 1e3) / 1e12})

        # 2. the clock64 trace of block 0's tiles
        for kernel in KERNELS:
            for kind in (k for k in kinds[kernel] if k.startswith("trace")):
                lib = libs[(kernel, kind)]
                ms = time_ms(kernel, kind, reps=1)
                buf = np.zeros(4 * 512, np.int64)
                torch.cuda.synchronize()
                lib.read_trace(ctypes.c_void_p(buf.ctypes.data))
                n_tiles = tiles_of_block0(kernel)
                t = buf.reshape(-1, 4)[: min(n_tiles, 512)].astype(np.int64)
                cycles = int(t[-1, 3] - t[0, 0])
                emit({"probe": "trace", "kernel": kernel, "variant": kind,
                      "tiles_of_block0": len(t),
                      "cycles_per_tile": cycles / len(t),
                      "median_cycles_wait_first_stage":
                          float(np.median(t[:, 1] - t[:, 0])),
                      "median_cycles_mainloop":
                          float(np.median(t[:, 2] - t[:, 1])),
                      "median_cycles_epilogue":
                          float(np.median(t[:, 3] - t[:, 2])),
                      "kernel_ms": ms,
                      "implied_sm_ghz": cycles / (ms * 1e6)})

        # 3. what a register-only FFMA stream reaches: one block of 8 warps
        # an SM, no memory traffic
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        peak = libs[("ffma_peak", "full")]
        buf = torch.zeros(1024, device=dev)
        cyc = torch.zeros(1, dtype=torch.int64, device=dev)
        iters = 20_000  # x 256 FFMA a thread
        for variant, name in enumerate(("chains", "outer_product",
                                        "outer_product_row_major_regs")):
            def run():
                if peak.ffma_peak_launch(variant, sms, iters, buf.data_ptr(),
                                         cyc.data_ptr(), stream):
                    raise RuntimeError("ffma_peak: launch error")
            ms = min(time_launches(run, reps=1) for _ in range(3))
            cycles = int(cyc.item())
            emit({"probe": "ffma_peak", "variant": name, "ms": ms,
                  "tflops": 2 * 256 * iters * 256 * sms / (ms / 1e3) / 1e12,
                  # 8 warps on 4 schedulers: 2 x 256 x iters FFMA each
                  "ffma_per_cycle_per_scheduler": 2 * 256 * iters / cycles,
                  "implied_sm_ghz": cycles / (ms * 1e6)})

        # 4. the f32 kernel's instruction mix
        mix = sass_mix(paths[("B2_f32", "full")], "kbmajor_f32_kernel")
        emit({"probe": "sass_mix", "kernel": "B2_f32",
              "instructions": sum(mix.values()), "opcodes": mix})

        # 5. the SM clock and power while each kernel runs
        for kernel in KERNELS:
            smi_log = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, text=True)
            time.sleep(0.5)
            t_end = time.perf_counter() + 2.0
            while time.perf_counter() < t_end:
                for _ in range(20):
                    launch(kernel, "full")
                torch.cuda.synchronize()
            smi_log.terminate()
            rows = [ln.split(",") for ln in smi_log.communicate()[0].split(
                "\n") if ln.strip()]
            busy = rows[5:] or rows  # past the half-second before the loop
            emit({"probe": "clocks_under_load", "kernel": kernel,
                  "samples": len(busy),
                  "median_sm_mhz": float(np.median([float(r[0])
                                                    for r in busy])),
                  "median_power_w": float(np.median([float(r[1])
                                                     for r in busy]))})
    emit({"probe": "done", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
