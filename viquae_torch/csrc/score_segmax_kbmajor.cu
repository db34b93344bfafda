// Kernel B2, kb-major exact-MIPS scoring for Hopper (sm_90a): the
// transposed scores and the maximum of every 128-row KB segment, in one
// pass over the KB.
//
// Replaces viquae_tpu/ops/mips_pallas.py::fused_score_segmax (the Pallas
// kb-major kernel behind topk_pallas).
//
// Contract (identical values to the Pallas kernel and to
// viquae_torch/ops/mips_fused.py::fused_score_segmax_plain):
//   q (Q, d) and kb (N, d), both row-major, both bf16 or both f32,
//   N % 128 == 0, d % 8 == 0 (bf16) or d % 4 == 0 (f32), any Q;
//   scores_t[n][q] = sum_d kb[n][d] q[q][d], accumulated in f32 and rounded
//   ONCE to the input dtype (round to nearest even for bf16), written
//   (N, Q); segmax_t[s][q] = the max over rows [128 s, 128 s + 128) of the
//   UNROUNDED f32 sums, written (N/128, Q) f32.
//   Nothing is masked: topk_pallas masks rows >= valid_rows afterwards.
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W):
//   bf16 at the main path's shapes, Q = 1,280, d = 768, N = 1,500,032:
//     operations 2 Q d N = 2.95e12 FLOP / 989 TFLOP/s = 2.98 ms;
//     bytes: KB 2.30 GB + scores_t 3.84 GB + segmax_t 0.06 GB = 6.2 GB
//     / 3.35 TB/s = 1.85 ms. Bound by the tensor cores (2.98 ms).
//   f32 at Q = 1,280, d = 768, N = 262,144: 5.15e11 FLOP / 67 TFLOP/s
//     (non-tensor FP32) = 7.7 ms; bytes 0.81 + 1.34 + 0.01 GB = 2.16 GB
//     / 3.35 TB/s = 0.64 ms. Bound by operations: the FP32 pipe takes one
//     FFMA a scheduler a cycle and nothing beside it, so the design keeps
//     every other instruction out of the loop. What the loop then runs
//     into is the register file: as nvcc compiles it, an 8 x 8 outer
//     product on register operands alone (no loads at all) reaches 0.755
//     FFMA a cycle and scheduler on an H100 at 1,980 MHz, which is also
//     the rate of the library's SGEMM; this kernel's mainloop runs at 0.75
//     (kernel_probe.py measures all three).
//
// bf16 design: the Hopper GEMM mainloop of score_segmax_sm90.cuh
// (persistent, TMA ring, one producer and two wgmma consumer warpgroups)
// with KB rows on M and queries on N: a 128 x 256 tile is one whole KB
// segment by 256 queries, so a segment's max finishes inside the block.
// The epilogue runs while the tensor cores idle, so it is kept short:
//   - each f32 accumulator pair is rounded once into the 128B-swizzled
//     staging tile (no bank conflicts);
//   - the segment max of the UNROUNDED sums: in-thread over the thread's
//     two rows, a reduce-scatter over the 8 lanes that share a column
//     (56 shuffles a thread), one f32 a warp and column in shared memory,
//     combined across the 8 consumer warps by one thread per query
//     (coalesced 4-byte stores);
//   - when Q % 8 == 0 (the main path's 1,280) one thread stores the staged
//     tile with four TMA stores and the consumers go on to the next tile's
//     wgmma at once. For any other Q the (N, Q) rows are 2Q bytes apart,
//     not 16-byte aligned, so no TMA store can take them: each warp stores
//     its 16 staged rows along Q, 2 bytes a lane (coalesced).
// f32 design: CUDA-core FFMA on f32 operands (NOT TF32 or any split of it:
// the contract is IEEE f32 products and sums), fed like the bf16 path.
// One persistent block per SM: a producer warpgroup (setmaxnreg 40) and 8
// consumer warps (two warpgroups, setmaxnreg 232).
//   - The producer thread keeps a 4-stage ring in flight with TMA: a stage
//     is 32 depths of the tile's 128 KB rows and 128 queries, both K-major
//     as they lie in device memory (a 128-byte row each, 128B swizzle), so
//     no thread spends a register or an instruction on loads, transposes
//     or edge guards. TMA zero-fills past Q and d.
//   - A tile is one whole KB segment x 128 queries. Each consumer thread
//     owns 8 KB rows x 8 queries (64 accumulators) and reads its operands
//     as LDS.128 along the depth: 16 loads per 256 FFMA, the next 4 depths'
//     loads in flight under this fragment's FFMA. Its rows are 4 apart and
//     its queries 8 apart, so the rows of one load fall on different
//     swizzle phases and no load has a bank conflict.
//   - A warp releases a stage (one mbarrier arrive) when its last loads of
//     it are under way; the producer is then up to 4 stages, and a tile, ahead.
//   - Epilogue, once per 768-deep tile (about 2 % of its cycles):
//     the sums go from registers straight to scores_t, 4 rows x 32 bytes a
//     store (whole sectors when Q % 8 == 0, any Q allowed); the segment max
//     is taken in registers, over the 4 lanes that share a query by
//     shuffles, and over the 4 warps that share it in shared memory, with
//     one 256-thread barrier a tile.
// Every global offset is 64-bit: N Q reaches 1.92e9 at the main path.

#include "score_segmax_sm90.cuh"

namespace {

// ---- f32: FFMA on a TMA-fed ring ------------------------------------------
namespace f32 {

constexpr int BM = 128;    // KB rows per tile == one segment
constexpr int BQ = 128;    // queries per tile
constexpr int BK = 32;     // depth of a stage: 128 B of f32, one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = 128 + CONSUMERS;  // the producer's warpgroup first
constexpr int A_BYTES = BM * BK * 4;     // the KB rows of a stage
constexpr int B_BYTES = BQ * BK * 4;     // its queries
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RED_BYTES = 2 * 4 * BQ * 4;  // two tiles' maxima per row warp
constexpr int OFF_RED = STAGES * STAGE_BYTES;
constexpr int OFF_BARS = OFF_RED + RED_BYTES;
constexpr int SMEM_BYTES = 1024 + OFF_BARS + 2 * STAGES * 8;  // + alignment

static_assert(SMEM_BYTES <= 232448, "a block may use 227 KB");
static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0,
              "128B-swizzled tiles start on 1024-byte boundaries");
static_assert(BK == 32, "a stage row is one 128-byte swizzle row");

struct Params {
    float* scores;  // scores_t (N, Q)
    float* segmax;  // segmax_t (N/128, Q)
    int64_t n_q;
    int q_tiles, tiles, k_blocks;
};

// Where a consumer thread reads its operands in a stage, in bytes. TMA
// wrote row r of a tile (32 floats) as 128 bytes whose 16-byte chunk c
// lies at chunk c ^ (r % 8). The thread owns KB rows row0 + 4 i and queries
// col0 + 8 j (i, j < 8), with row0 % 8 == lane / 8 and col0 % 8 == lane % 8,
// so every offset is one of these bases plus a compile-time constant.
struct Lanes {
    uint32_t a[4];  // KB row row0, chunk m ^ (row0 % 8) for m < 4
    uint32_t b[8];  // query col0, chunk c ^ (col0 % 8)
};

__device__ __forceinline__ void lds128(float (&v)[4], uint32_t addr) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(addr));
}

// Depths [4 c, 4 c + 4) of the thread's 8 KB rows and 8 queries from the
// stage at shared address `stage`: 16 LDS.128. A warp's 4 x 8 lanes read 4
// KB rows (rows r..r + 3, four different chunks) or 8 queries (eight
// different chunks) at a time, each address shared by the 8 or 4 lanes of
// the other axis: no two addresses of a load share a bank.
__device__ __forceinline__ void load_fragment(float (&a)[8][4],
                                              float (&b)[8][4],
                                              uint32_t stage, const Lanes& at,
                                              int c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        // row0 + 4 i has (row0 % 8) ^ 4 (i % 2) as its swizzle phase
        const int cc = c ^ (4 * (i & 1));
        lds128(a[i], stage + at.a[cc & 3] + 512 * i + 16 * (cc & 4));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        lds128(b[j], stage + at.b[c] + 1024 * j);
    }
}

// acc[i][j] += sum over the fragment's 4 depths, in ascending depth
__device__ __forceinline__ void fma_fragment(float (&acc)[8][8],
                                             const float (&a)[8][4],
                                             const float (&b)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
}

// The thread's 8 x 8 sums -> scores_t, and the tile's share of segmax_t.
// Every consumer thread calls it (it synchronises the 256 of them once).
__device__ __forceinline__ void epilogue(const float (&acc)[8][8], float* red,
                                         const Params& p, int64_t seg,
                                         int64_t q0, int row0, int col0) {
    const int tid = threadIdx.x - 128;  // 0..255 over the consumers
    const int lane = tid % 32;
    // a store of the warp writes 4 rows x 8 consecutive queries: four
    // whole 32-byte sectors when Q % 8 == 0
    float* out = p.scores + (seg * BM + row0) * p.n_q + q0 + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (q0 + col0 + 8 * j < p.n_q) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                out[static_cast<int64_t>(4 * i) * p.n_q + 8 * j] = acc[i][j];
            }
        }
    }
    // the segment max per query: the thread's 8 rows, the 4 lanes that
    // share the query, then the 4 warps that share it (shared memory)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        float m = acc[0][j];
#pragma unroll
        for (int i = 1; i < 8; ++i) m = fmaxf(m, acc[i][j]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (lane < 8) red[(row0 / 32) * BQ + col0 + 8 * j] = m;
    }
    sm90::named_sync(1, CONSUMERS);
    if (tid < BQ && q0 + tid < p.n_q) {
        const float m01 = fmaxf(red[tid], red[BQ + tid]);
        const float m23 = fmaxf(red[2 * BQ + tid], red[3 * BQ + tid]);
        p.segmax[seg * p.n_q + q0 + tid] = fmaxf(m01, m23);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
kbmajor_f32_kernel(const __grid_constant__ CUtensorMap map_kb,
                   const __grid_constant__ CUtensorMap map_q, const Params p) {
    extern __shared__ __align__(1024) uint8_t smem_f32[];
    uint8_t* smem =
        smem_f32 + ((1024 - (sm90::smem_u32(smem_f32) & 1023)) & 1023);
    const uint32_t ring = sm90::smem_u32(smem);
    const uint32_t full0 = sm90::smem_u32(smem + OFF_BARS);
    const uint32_t empty0 = full0 + STAGES * 8;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(full0 + 8 * s, 1);
            sm90::mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // Registers are handed out to 4 warps at a time, so the producer is a
    // whole warpgroup that gives its registers up (40 each) and the two
    // consumer warpgroups take them (232 each).
    if (threadIdx.x < 128) {
        // ---- producer: one thread starts every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 0) {
            int s = 0;
            uint32_t phase = 0;
            for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
                const int q_tile = t % p.q_tiles, kb_tile = t / p.q_tiles;
                for (int kb = 0; kb < p.k_blocks; ++kb) {
                    sm90::mbar_wait(empty0 + 8 * s, phase ^ 1);
                    const uint32_t full = full0 + 8 * s;
                    const uint32_t stage = ring + s * STAGE_BYTES;
                    sm90::mbar_expect_tx(full, STAGE_BYTES);
                    sm90::tma_load(stage, &map_kb, full, kb * BK,
                                   kb_tile * BM);
                    sm90::tma_load(stage + A_BYTES, &map_q, full, kb * BK,
                                   q_tile * BQ);
                    if (++s == STAGES) {
                        s = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // ---- consumers: 4 x 2 warps of 32 KB rows x 64 queries, each
        // lane an 8 x 8 sub-tile with both axes strided ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int warp = threadIdx.x / 32 - 4, lane = threadIdx.x % 32;
        const int row0 = (warp / 2) * 32 + lane / 8;  // + 4 i
        const int col0 = (warp % 2) * 64 + lane % 8;  // + 8 j
        Lanes at;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            at.a[m] = row0 * 128 + ((m ^ (row0 & 7)) << 4);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            at.b[c] = A_BYTES + col0 * 128 + ((c ^ (col0 & 7)) << 4);
        }
        float* red = reinterpret_cast<float*>(smem + OFF_RED);
        int s = 0, it = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
            const int q_tile = t % p.q_tiles, kb_tile = t / p.q_tiles;
            // +0 to start from: an exactly cancelling sum comes out +0
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
            // two fragments in registers: the loads of the next 4 depths
            // are in flight under the 256 FFMA of these
            float a[2][8][4], b[2][8][4];
            sm90::mbar_wait(full0 + 8 * s, phase);
            load_fragment(a[0], b[0], ring + s * STAGE_BYTES, at, 0);
            for (int kb = 0; kb < p.k_blocks; ++kb) {
                const uint32_t stage = ring + s * STAGE_BYTES;
#pragma unroll
                for (int c = 0; c < BK / 4; ++c) {
                    if (c + 1 < BK / 4) {
                        load_fragment(a[(c + 1) % 2], b[(c + 1) % 2], stage,
                                      at, c + 1);
                    } else {
                        // the stage's last loads are under way: release it,
                        // then start on the next stage of this tile
                        __syncwarp();
                        if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
                        if (++s == STAGES) {
                            s = 0;
                            phase ^= 1;
                        }
                        if (kb + 1 < p.k_blocks) {
                            sm90::mbar_wait(full0 + 8 * s, phase);
                            load_fragment(a[0], b[0], ring + s * STAGE_BYTES,
                                          at, 0);
                        }
                    }
                    fma_fragment(acc, a[c % 2], b[c % 2]);
                }
            }
            epilogue(acc, red + (it % 2) * 4 * BQ, p, kb_tile,
                     static_cast<int64_t>(q_tile) * BQ, row0, col0);
        }
    }
}

// Builds the operand maps, sizes the grid to the SM count and launches;
// returns cudaGetLastError() (0 on success).
int launch(const void* q, const void* kb, void* scores_t, void* segmax_t,
           int64_t n_q, int64_t n_kb, int64_t dim, cudaStream_t stream) {
    const int64_t q_tiles = (n_q + BQ - 1) / BQ;
    const int64_t tiles = q_tiles * (n_kb / BM);
    if (tiles > INT_MAX || n_kb > INT_MAX || n_q > INT_MAX || dim > INT_MAX ||
        dim <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p{};
    p.scores = static_cast<float*>(scores_t);
    p.segmax = static_cast<float*>(segmax_t);
    p.n_q = n_q;
    p.q_tiles = static_cast<int>(q_tiles);
    p.tiles = static_cast<int>(tiles);
    p.k_blocks = static_cast<int>((dim + BK - 1) / BK);
    CUtensorMap map_kb, map_q;
    if (!sm90::make_map(&map_kb, kb, n_kb, dim, BM, BK,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
        !sm90::make_map(&map_q, q, n_q, dim, BQ, BK,
                        CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kbmajor_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);
    kbmajor_f32_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_kb, map_q,
                                                              p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---- bf16: the epilogue of the shared Hopper mainloop ----
// The column maxima of a warp's 16 rows: v[k] holds the thread's max of its
// two rows for column k (8 (k / 2) + 2 (lane % 4) + k % 2 of the tile). The
// 8 lanes of a column reduce-scatter over three shuffle rounds, each lane
// keeping half of what it held (56 shuffles instead of 192); each lane then
// writes the warp's max of 8 columns to red[0..256).
__device__ __forceinline__ void column_max(float (&v)[64], int lane,
                                           float* red) {
    const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
        const float send = up16 ? v[k] : v[k + 32];
        const float keep = up16 ? v[k + 32] : v[k];
        v[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 16));
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const float send = up8 ? v[k] : v[k + 16];
        const float keep = up8 ? v[k + 16] : v[k];
        v[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 8));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const float send = up4 ? v[k] : v[k + 8];
        const float keep = up4 ? v[k + 8] : v[k];
        v[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 4));
    }
    const int base = 32 * up16 + 16 * up8 + 8 * up4;  // v[k] is column base + k
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int col = base + k;
        red[8 * (col >> 1) + 2 * (lane & 3) + (col & 1)] = v[k];
    }
}

struct KbMajorEpilogue {
    static constexpr bool kKbOnM = true;

    __device__ static __forceinline__ void store(float (&acc)[128],
                                                 uint8_t* smem, int c,
                                                 int m_tile, int n_tile,
                                                 const sm90::Params& p,
                                                 const CUtensorMap* map) {
        const int ct = threadIdx.x - 128;  // 0..255 over both consumers
        const int warp = ct / 32, lane = ct % 32;
        uint8_t* stage = smem + sm90::OFF_STAGING + c * sm90::STAGING_BYTES;
        float* red = reinterpret_cast<float*>(smem + sm90::OFF_RED);
        const int64_t seg = m_tile;  // a tile's 128 KB rows: one segment
        const int64_t row0 = seg * sm90::BM + 64 * c;  // this consumer's
        const int64_t q0 = static_cast<int64_t>(n_tile) * sm90::BN;
        const int r0 = (warp % 4) * 16 + lane / 4;

        // both consumers have read the last tile's staging tiles and maxima
        if (ct % 128 == 0) sm90::bulk_wait_read();
        sm90::named_sync(1, 256);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                *reinterpret_cast<__nv_bfloat162*>(
                    stage + sm90::staged(r0 + 8 * h, j, 4 * (lane & 3))) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                          acc[4 * j + 2 * h + 1]);
            }
        }
        // the max of the UNROUNDED sums: the thread's two rows, the warp's
        // 16, then the 8 warps' in shared memory
        float v[64];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                v[2 * j + e] = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
            }
        }
        column_max(v, lane, red + warp * sm90::BN);
        sm90::fence_async_shared();  // the staged scores, visible to the TMA
        sm90::named_sync(1, 256);
        if (p.tma_scores && ct % 128 == 0) {
            sm90::store_staged(map, stage, row0, p.n_kb, q0, p.n_q);
        }
        if (q0 + ct < p.n_q) {
            float m = red[ct];
#pragma unroll
            for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w * sm90::BN + ct]);
            static_cast<float*>(p.segmax)[seg * p.n_q + q0 + ct] = m;
        }
        if (!p.tma_scores) {
            // (N, Q) rows are 2Q bytes apart, not 16-byte aligned: each
            // warp stores the 16 rows it staged, 2 bytes a lane
            const int64_t qn = p.n_q - q0 < sm90::BN ? p.n_q - q0 : sm90::BN;
            __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.scores) +
                                 row0 * p.n_q + q0;
            for (int r = (warp % 4) * 16; r < (warp % 4) * 16 + 16; ++r) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int col = lane + 32 * i;
                    if (col < qn) {
                        out[r * p.n_q + col] =
                            *reinterpret_cast<const __nv_bfloat16*>(
                                stage +
                                sm90::staged(r, col >> 3, 2 * (col & 7)));
                    }
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// Enqueues the kernel for the given dtype (is_f32: f32, else bf16) on
// `stream` and returns cudaGetLastError() (0 on success). Shapes, dtypes
// and alignment are validated by the Python wrapper.
int score_segmax_kbmajor_launch(const void* q, const void* kb, void* scores_t,
                                void* segmax_t, int64_t n_q, int64_t n_kb,
                                int64_t dim, int is_f32, void* stream) {
    if (n_q == 0 || n_kb == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!is_f32) {
        sm90::Params p{};
        p.scores = scores_t;
        p.segmax = segmax_t;
        p.n_q = n_q;
        p.n_kb = n_kb;
        // a TMA store needs 16-byte row strides: 2Q bytes, Q % 8 == 0
        p.tma_scores = n_q % 8 == 0;
        CUtensorMap map_scores{};
        if (p.tma_scores && !sm90::make_map(&map_scores, scores_t, n_kb, n_q, 64,
                                      64)) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        return sm90::launch<KbMajorEpilogue>(kb, n_kb, q, n_q, dim,
                                             map_scores, p, s);
    }
    return f32::launch(q, kb, scores_t, segmax_t, n_q, n_kb, dim, s);
}

const char* score_segmax_kbmajor_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
