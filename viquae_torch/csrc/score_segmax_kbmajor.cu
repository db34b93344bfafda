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
//     / 3.35 TB/s = 0.64 ms. Bound by operations.
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
// f32 design (unchanged): one block of 256 threads owns 128 KB rows (one
// whole segment) x 64 queries; CUDA-core FFMA on f32 operands, 16 columns a
// step, each thread an 8 x 4 sub-tile; NOT TF32, whose 10-bit mantissa
// would break the f32 contract. The f32 tile is staged through shared
// memory; each warp writes whole tile rows along Q (coalesced), and the
// segment max is reduced over the 128 staged rows per query. Every global
// offset is 64-bit: N Q reaches 1.92e9 at the main path.

#include "score_segmax_sm90.cuh"

namespace {

constexpr int BN = 128;          // KB rows per block == one segment
constexpr int BQ = 64;           // queries per block
constexpr int THREADS = 256;
constexpr int LDC = BQ + 4;      // f32 staging row stride
constexpr int SMEM_STAGE = BN * LDC * 4;
// f32 depth tiles, transposed [k][row]
constexpr int BK32 = 16;
constexpr int LDA32 = BN + 4;
constexpr int LDB32 = BQ + 4;
constexpr int SMEM_TILES32 = BK32 * (LDA32 + LDB32) * 4;
constexpr int SMEM_MAIN = SMEM_STAGE > SMEM_TILES32 ? SMEM_STAGE : SMEM_TILES32;
constexpr int SMEM_BYTES = SMEM_MAIN + 4 * BQ * 4;  // + the max partials

static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ float4 load_f32x4(const float* base, int64_t row,
                                             int64_t n_rows, int64_t col,
                                             int64_t dim) {
    // 4 floats of row `row`, or zeros past the edge (d % 4 == 0)
    if (row < n_rows && col < dim) {
        return __ldg(reinterpret_cast<const float4*>(base + row * dim + col));
    }
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The staged (BN x BQ) f32 tile `cs` -> scores_t rows n0.. and segmax_t row
// `seg`. Every thread of the block must call it (it synchronises).
__device__ __forceinline__ void epilogue(const float* cs, float* red,
                                         float* __restrict__ scores_t,
                                         float* __restrict__ segmax_t,
                                         int64_t n0, int64_t seg, int64_t q0,
                                         int64_t n_q) {
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // warp w writes tile rows [16 w, 16 w + 16); lane l writes the queries
    // q0 + l and q0 + l + 32 of each: consecutive lanes, consecutive bytes
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
        float* row = scores_t + (n0 + r) * n_q + q0;
#pragma unroll
        for (int c = lane; c < BQ; c += 32) {
            if (q0 + c < n_q) row[c] = cs[r * LDC + c];
        }
    }
    // the segment max of each query over the 128 UNROUNDED sums: four
    // partial maxima of 32 rows, then one thread per query combines them
    const int c = tid & (BQ - 1);
    const int part = tid / BQ;
    float m = -INFINITY;
    for (int r = part * 32; r < part * 32 + 32; ++r) {
        m = fmaxf(m, cs[r * LDC + c]);
    }
    red[part * BQ + c] = m;
    __syncthreads();
    if (tid < BQ && q0 + tid < n_q) {
        const float m01 = fmaxf(red[tid], red[BQ + tid]);
        const float m23 = fmaxf(red[2 * BQ + tid], red[3 * BQ + tid]);
        segmax_t[seg * n_q + q0 + tid] = fmaxf(m01, m23);
    }
}

__global__ void __launch_bounds__(THREADS)
kbmajor_f32_kernel(const float* __restrict__ q, const float* __restrict__ kb,
                   float* __restrict__ scores_t, float* __restrict__ segmax_t,
                   int64_t n_q, int64_t n_kb, int64_t dim, int64_t q_blocks) {
    __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
    float* as = reinterpret_cast<float*>(smem);  // BK32 x LDA32, [k][kb row]
    float* bs = as + BK32 * LDA32;               // BK32 x LDB32, [k][query]
    float* cs = reinterpret_cast<float*>(smem);  // BN x LDC, after the loop
    float* red = reinterpret_cast<float*>(smem + SMEM_MAIN);

    const int64_t bid = blockIdx.x;
    const int64_t q0 = (bid % q_blocks) * BQ;
    const int64_t seg = bid / q_blocks;
    const int64_t n0 = seg * BN;
    const int tid = threadIdx.x;
    const int tx = tid & 15;  // queries [4 tx, 4 tx + 4) of the tile
    const int ty = tid >> 4;  // KB rows [8 ty, 8 ty + 8)

    // load slots: the kb tile is 128 rows x 4 float4 (two per thread), the
    // q tile 64 rows x 4 float4 (one per thread)
    const int lr = tid >> 2;
    const int lc = (tid & 3) * 4;

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    float4 k_reg0 = load_f32x4(kb, n0 + lr, n_kb, lc, dim);
    float4 k_reg1 = load_f32x4(kb, n0 + lr + 64, n_kb, lc, dim);
    float4 q_reg = load_f32x4(q, q0 + lr, n_q, lc, dim);

    for (int64_t k0 = 0; k0 < dim; k0 += BK32) {
        __syncthreads();
        const float kv0[4] = {k_reg0.x, k_reg0.y, k_reg0.z, k_reg0.w};
        const float kv1[4] = {k_reg1.x, k_reg1.y, k_reg1.z, k_reg1.w};
        const float qv[4] = {q_reg.x, q_reg.y, q_reg.z, q_reg.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            as[(lc + e) * LDA32 + lr] = kv0[e];
            as[(lc + e) * LDA32 + lr + 64] = kv1[e];
            bs[(lc + e) * LDB32 + lr] = qv[e];
        }
        __syncthreads();
        if (k0 + BK32 < dim) {
            k_reg0 = load_f32x4(kb, n0 + lr, n_kb, k0 + BK32 + lc, dim);
            k_reg1 = load_f32x4(kb, n0 + lr + 64, n_kb, k0 + BK32 + lc, dim);
            q_reg = load_f32x4(q, q0 + lr, n_q, k0 + BK32 + lc, dim);
        }
#pragma unroll
        for (int kk = 0; kk < BK32; ++kk) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(as + kk * LDA32 + ty * 8);
            const float4 a1 =
                *reinterpret_cast<const float4*>(as + kk * LDA32 + ty * 8 + 4);
            const float4 b =
                *reinterpret_cast<const float4*>(bs + kk * LDB32 + tx * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }

    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(cs + (ty * 8 + i) * LDC + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    epilogue(cs, red, scores_t, segmax_t, n0, seg, q0, n_q);
}

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
    const int64_t q_blocks = (n_q + BQ - 1) / BQ;
    const int64_t blocks = q_blocks * (n_kb / BN);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kbmajor_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kb),
        static_cast<float*>(scores_t), static_cast<float*>(segmax_t), n_q,
        n_kb, dim, q_blocks);
    return static_cast<int>(cudaGetLastError());
}

const char* score_segmax_kbmajor_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
