"""Where the time of kernels B1 and B2 (bf16) goes on one NVIDIA GPU.

    python3 kernel_probe.py

Builds patched copies of viquae_torch/csrc into a temporary directory and,
at the main path's shapes (Q = 1,280, d = 768, N = 1,500,032, bf16), for
B1 (score_segmax) and B2's bf16 path (score_segmax_kbmajor):

1. times, in turns on one card, the kernel as it is ("full"), with no
   epilogue ("no_epilogue": the accumulators are summed and dropped) and
   with no A-operand loads ("no_a_loads": a third less operand traffic;
   wrong results, timing only): CUDA events over 10 launches, 5 rounds;
2. traces the tiles of block 0 with clock64() ("trace", full and no
   epilogue): cycles waiting for a tile's first stage, in its mainloop and
   in its epilogue, and the SM clock that the cycles and the kernel's time
   imply;
3. samples nvidia-smi's SM clock and power draw while each full kernel
   runs back to back for about two seconds.

Needs a CUDA GPU and nvcc; no JAX. Prints one JSON object per
measurement; the patches assert that they apply, so a change to the
kernels that they no longer fit makes this script fail, not mismeasure.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from viquae_torch.kernels import build

Q, D, N, VALID = 1280, 768, 1_500_032, 1_500_000
HEADER = "score_segmax_sm90.cuh"
KERNELS = {"B1": "score_segmax", "B2_bf16": "score_segmax_kbmajor"}

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


def tiles_of_block0(kernel: str) -> int:
    """Tiles the persistent grid gives block 0 (tile t goes to block
    t % grid, grid = min(SMs, tiles))."""
    if kernel == "B1":
        tiles = -(-Q // 128) * -(-N // 256)
    else:
        tiles = -(-Q // 256) * (N // 128)
    grid = min(torch.cuda.get_device_properties(0).multi_processor_count,
               tiles)
    return -(-tiles // grid)


def build_variants(tmp: Path, kinds) -> dict:
    """One library per (kernel, kind), all nvcc started together."""
    procs = {}
    for kind in kinds:
        src = tmp / kind
        src.mkdir()
        (src / HEADER).write_text(variant_header(kind))
        for name in KERNELS.values():
            text = (build.CSRC / f"{name}.cu").read_text()
            if kind.startswith("trace"):
                text += READ_TRACE
            (src / f"{name}.cu").write_text(text)
            lib = src / f"lib{name}.so"
            cmd = [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                   "-o", str(lib), str(src / f"{name}.cu")]
            procs[(name, kind)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn_name, (argtypes, restype) in build._SIGNATURES[key[0]].items():
            getattr(handle, fn_name).argtypes = argtypes
            getattr(handle, fn_name).restype = restype
        libs[key] = handle
    return libs


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
    q = torch.randn((Q, D), generator=gen, device=dev).to(torch.bfloat16)
    kb = (torch.randn((N, D), generator=gen, device=dev)
          / D ** 0.5).to(torch.bfloat16)
    outs = {"B1": (torch.empty((Q, N), dtype=torch.bfloat16, device=dev),
                   torch.empty((Q, N // 128), dtype=torch.bfloat16,
                               device=dev)),
            "B2_bf16": (torch.empty((N, Q), dtype=torch.bfloat16, device=dev),
                        torch.empty((N // 128, Q), dtype=torch.float32,
                                    device=dev))}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    kinds = ["full", "no_epilogue", "no_a_loads", "trace", "trace_no_epilogue"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), kinds)

        def launch(kernel, kind):
            lib = libs[(KERNELS[kernel], kind)]
            s, m = outs[kernel]
            args = [ctypes.c_void_p(t.data_ptr()) for t in (q, kb, s, m)]
            if kernel == "B1":
                err = lib.score_segmax_launch(*args, Q, N, D, VALID, stream)
            else:
                err = lib.score_segmax_kbmajor_launch(*args, Q, N, D, 0,
                                                      stream)
            if err:
                raise RuntimeError(f"{kernel} {kind}: launch error {err}")

        def time_ms(kernel, kind, reps=10):
            launch(kernel, kind)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch(kernel, kind)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps

        # 1. the variants in turns
        timed = [(k, v) for k in KERNELS for v in kinds[:3]]
        times = {key: [] for key in timed}
        for rnd in range(5):
            for key in (timed if rnd % 2 == 0 else timed[::-1]):
                times[key].append(time_ms(*key))
        for (kernel, kind), ms in times.items():
            med = float(np.median(ms))
            emit({"probe": "variant", "kernel": kernel, "variant": kind,
                  "ms": ms, "median_ms": med,
                  "tflops": 2 * Q * D * N / (med / 1e3) / 1e12})

        # 2. the clock64 trace of block 0's tiles
        for kernel in KERNELS:
            for kind in ("trace", "trace_no_epilogue"):
                lib = libs[(KERNELS[kernel], kind)]
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

        # 3. the SM clock and power while each kernel runs
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
