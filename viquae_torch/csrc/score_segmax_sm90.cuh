// The Hopper (sm_90a) mainloop shared by kernel B1 (score_segmax.cu) and
// the bf16 path of kernel B2 (score_segmax_kbmajor.cu): a persistent,
// warp-specialised bf16 product with f32 accumulation, templated on the
// epilogue that turns each 128 x 256 f32 output tile into the kernel's
// scores and segment maxima.
//
// Both kernels compute rows . cols^T of two K-major bf16 operands, (R, d)
// and (C, d), row-major. B1 puts the queries on the wgmma M side (rows) and
// the KB on N (cols); B2 swaps them. Neither operand needs a transpose.
//
// Block: 384 threads, one block per SM, grid = the SM count.
//   - warpgroup 0, the producer (setmaxnreg 40): one thread walks the
//     block's tiles and keeps a ring of STAGES operand stages in flight with
//     TMA (128B swizzle; a stage is a 128 x 64 A tile and a 256 x 64 B
//     tile, 48 KB). full[s] completes on the TMA's bytes, empty[s] when both
//     consumers have released the stage.
//   - warpgroups 1 and 2, the consumers (setmaxnreg 232): each owns 64 of
//     the tile's 128 rows and runs wgmma.m64n256k16 on the ring (128 f32
//     accumulators a thread), releasing each stage as soon as the wgmma
//     that read it has retired; then the epilogue, while the producer
//     already refills the ring with the next tile's stages.
// Tile t walks as q_tile = t % q_tiles, kb_tile = t / q_tiles, so the
// query tiles of one KB tile run at nearly the same time on neighbouring
// blocks and the KB comes from device memory once.
//
// L2 traffic does not bound the mainloop (kernel_probe.py drops a third of
// it to little effect). Shared memory may, by an estimate from the shapes:
// per 64-deep stage the consumers' wgmmas read some 80 KB (each reads all
// of B) and TMA writes 48 KB, about 128 KB per ~1,024 cycles at the tensor
// cores' peak, near the 128 bytes a cycle an SM is usually credited with;
// the epilogue's staging traffic (64 KB in, 64 KB out by TMA) adds to it.
//
// TMA zero-fills what lies outside the operands: a ragged query edge, d not
// a multiple of 64, a half-empty last KB tile. The tensor maps are built per
// call on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so that nothing links libcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace sm90 {

constexpr int BM = 128;  // tile rows, the wgmma M side: 64 per consumer
constexpr int BN = 256;  // tile columns, the wgmma N side
constexpr int BK = 64;   // depth of one stage: 128 B of bf16, one swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGING_BYTES = 64 * BN * 2;  // one consumer's bf16 64 x 256
constexpr int RED_BYTES = 4 * CONSUMERS * BN * 4;  // a max per warp, column
constexpr int OFF_STAGING = STAGES * STAGE_BYTES;
constexpr int OFF_RED = OFF_STAGING + CONSUMERS * STAGING_BYTES;
constexpr int OFF_BARS = OFF_RED + RED_BYTES;
constexpr int SMEM_BYTES = 1024 + OFF_BARS + 2 * STAGES * 8;  // + alignment

static_assert(SMEM_BYTES <= 232448, "a block may use 227 KB");
static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0,
              "128B-swizzled tiles start on 1024-byte boundaries");

// What the epilogues read besides the accumulators.
struct Params {
    void* scores;  // B2's scores_t (N, Q), when not stored by TMA
    void* segmax;
    int64_t n_q, n_kb, valid_rows;
    int q_tiles, tiles, k_blocks;
    int tma_scores;  // B2: Q % 8 == 0, so scores_t rows can take TMA stores
};

// ---- PTX wrappers -------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// K-major operand in the 128B-swizzled layout TMA wrote: 8-row groups of
// 128-byte rows, 1024 bytes apart (SBO); LBO is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) |
           (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, K-major) . B (256 x 16, K-major)^T + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, %128, %129, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
}

// ---- the epilogues' staging tile ----------------------------------------
// Byte offset of the bf16 pair at row r, columns 8 j + byte / 2 (+ 1), of a
// consumer's 64 x 256 staging tile: four 64 x 64 boxes of 128-byte rows
// whose 16-byte chunks are swizzled by r % 8, as CU_TENSOR_MAP_SWIZZLE_128B
// reads them. A warp writing its accumulator pairs (8 rows, 4 lanes a row)
// then hits 32 different banks.
__device__ __forceinline__ uint32_t staged(int r, int j, int byte) {
    return (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) + byte;
}

// One thread stores a consumer's staging tile to the map's matrix at row
// row0, columns col0.. (four 64 x 64 boxes; TMA clips the ragged edges,
// boxes that start past them are skipped) and commits the bulk group.
__device__ __forceinline__ void store_staged(const CUtensorMap* map,
                                             const uint8_t* stage,
                                             int64_t row0, int64_t n_rows,
                                             int64_t col0, int64_t n_cols) {
    if (row0 < n_rows) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            if (col0 + 64 * b < n_cols) {
                tma_store(map, smem_u32(stage + b * 8192),
                          static_cast<int>(col0 + 64 * b),
                          static_cast<int>(row0));
            }
        }
    }
    bulk_commit();
}

// ---- the kernel ---------------------------------------------------------
// Epilogue provides:
//   static constexpr bool kKbOnM;  // KB rows on the wgmma M side (B2)
//   static void store(float (&acc)[128], uint8_t* smem, int consumer,
//                     int m_tile, int n_tile, const Params&,
//                     const CUtensorMap* out_map);
// The accumulator layout of wgmma.m64nNk16 (f32): thread T of a consumer
// holds rows 16 (T / 32) + (T % 32) / 4 (+ 8) of its 64 and, for each n8
// block j, columns 8 j + 2 (T % 4) (+ 1): acc[4 j + 2 h + e] is row
// + 8 h, column + e.
template <class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
score_segmax_sm90(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_out,
                  const Params p) {
    extern __shared__ __align__(1024) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t ring = smem_u32(smem);
    const uint32_t full0 = smem_u32(smem + OFF_BARS);
    const uint32_t empty0 = full0 + STAGES * 8;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---- producer: one thread issues every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 0) {
            int s = 0;
            uint32_t phase = 0;
            for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
                const int q_tile = t % p.q_tiles, kb_tile = t / p.q_tiles;
                const int m_tile = Epilogue::kKbOnM ? kb_tile : q_tile;
                const int n_tile = Epilogue::kKbOnM ? q_tile : kb_tile;
                for (int kb = 0; kb < p.k_blocks; ++kb) {
                    mbar_wait(empty0 + 8 * s, phase ^ 1);
                    const uint32_t full = full0 + 8 * s;
                    const uint32_t stage = ring + s * STAGE_BYTES;
                    mbar_expect_tx(full, STAGE_BYTES);
                    tma_load(stage, &map_a, full, kb * BK, m_tile * BM);
                    tma_load(stage + A_BYTES, &map_b, full, kb * BK,
                             n_tile * BN);
                    if (++s == STAGES) {
                        s = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // ---- consumers: wgmma on the ring, then the epilogue ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int c = wg - 1;
        const bool leader = threadIdx.x % 128 == 0;
        float acc[128];
        int s = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
            const int q_tile = t % p.q_tiles, kb_tile = t / p.q_tiles;
            const int m_tile = Epilogue::kKbOnM ? kb_tile : q_tile;
            const int n_tile = Epilogue::kKbOnM ? q_tile : kb_tile;
            // +0 to start from, as an f32 GEMM does: an exactly cancelling
            // sum then comes out +0, never -0
#pragma unroll
            for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
            int held = -1;  // the stage the wgmma in flight still reads
            for (int kb = 0; kb < p.k_blocks; ++kb) {
                mbar_wait(full0 + 8 * s, phase);
                const uint32_t stage = ring + s * STAGE_BYTES;
                const uint64_t da = smem_desc(stage + c * (A_BYTES / 2));
                const uint64_t db = smem_desc(stage + A_BYTES);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
                    // 16 more of k: 32 bytes further along each 128 B row
                    wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, 1);
                }
                wgmma_commit();
                wgmma_wait<1>();  // the previous stage's group has retired
                if (held >= 0 && leader) mbar_arrive(empty0 + 8 * held);
                held = s;
                if (++s == STAGES) {
                    s = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            fence_acc(acc);
            if (held >= 0 && leader) mbar_arrive(empty0 + 8 * held);
            Epilogue::store(acc, smem, c, m_tile, n_tile, p, &map_out);
        }
        if (leader) bulk_wait_all();  // the last score stores are done
    }
}

// ---- host side ----------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
        }
    }
    return fn;
}

// A row-major (rows, cols) matrix of bf16 or f32 read or written in boxes of
// box_rows x box_cols (box_cols elements == 128 bytes: one swizzle row).
inline bool make_map(CUtensorMap* map, const void* ptr, int64_t rows,
                     int64_t cols, int box_rows, int box_cols,
                     CUtensorMapDataType type =
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t elem_bytes =
        type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                   elem_bytes};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem[2] = {1, 1};
    return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Builds the operand maps, sizes the grid to the SM count and launches;
// returns cudaGetLastError() (0 on success). a is the M side, b the N side.
template <class Epilogue>
int launch(const void* a, int64_t a_rows, const void* b, int64_t b_rows,
           int64_t dim, const CUtensorMap& out_map, Params p,
           cudaStream_t stream) {
    constexpr int q_box = Epilogue::kKbOnM ? BN : BM;
    constexpr int kb_box = Epilogue::kKbOnM ? BM : BN;
    const int64_t q_rows = Epilogue::kKbOnM ? b_rows : a_rows;
    const int64_t kb_rows = Epilogue::kKbOnM ? a_rows : b_rows;
    const int64_t q_tiles = (q_rows + q_box - 1) / q_box;
    const int64_t kb_tiles = (kb_rows + kb_box - 1) / kb_box;
    const int64_t tiles = q_tiles * kb_tiles;
    if (tiles > INT_MAX || kb_rows > INT_MAX || dim > INT_MAX || dim <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    p.q_tiles = static_cast<int>(q_tiles);
    p.tiles = static_cast<int>(tiles);
    p.k_blocks = static_cast<int>((dim + BK - 1) / BK);
    CUtensorMap map_a, map_b;
    if (!make_map(&map_a, a, a_rows, dim, BM, BK) ||
        !make_map(&map_b, b, b_rows, dim, BN, BK)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(score_segmax_sm90<Epilogue>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);
    score_segmax_sm90<Epilogue><<<grid, THREADS, SMEM_BYTES, stream>>>(
        map_a, map_b, out_map, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
