// Kb-major exact-MIPS scoring for Hopper (sm_90a): the transposed scores
// and the maximum of every 128-row KB segment, in one pass over the KB.
//
// Replaces viquae_tpu/ops/mips_pallas.py::fused_score_segmax (the Pallas
// kb-major kernel behind topk_pallas).
//
// Contract (identical values to the Pallas kernel and to
// viquae_torch/ops/mips_fused.py::fused_score_segmax_plain):
//   q (Q, d) and kb (N, d), both row-major, both bf16 or both f32,
//   N % 128 == 0, d % 8 == 0 (bf16) or d % 4 == 0 (f32), any Q;
//   scores_t[n][q] = sum_d kb[n][d] q[q][d], accumulated in f32 and rounded
//   ONCE to the input dtype (__float2bfloat16, round to nearest even, for
//   bf16), written (N, Q);
//   segmax_t[s][q] = the max over rows [128 s, 128 s + 128) of the
//   UNROUNDED f32 sums, written (N/128, Q) f32.
//   Nothing is masked: topk_pallas masks rows >= valid_rows afterwards.
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W):
//   bf16 at the main path's shapes, Q = 1,280, d = 768, N = 1,500,032:
//     operations 2 Q d N = 2.95e12 FLOP / 989 TFLOP/s = 2.98 ms;
//     bytes: KB 2.30 GB + scores_t 3.84 GB + segmax_t 0.06 GB = 6.2 GB
//     / 3.35 TB/s = 1.85 ms. The bound is the tensor cores' (2.98 ms), but
//     the (N, Q) score write (3.84 GB in bf16) outweighs the KB read
//     (2.30 GB): the maxima ride in the same epilogue so that selection
//     never re-reads the scores.
//   f32 at Q = 1,280, d = 768, N = 262,144: 5.15e11 FLOP / 67 TFLOP/s
//     (non-tensor FP32) = 7.7 ms; bytes 0.81 + 1.34 + 0.01 GB = 2.16 GB
//     / 3.35 TB/s = 0.64 ms. Bound by operations.
//
// Design (simple and right first): one block of 256 threads owns 128 KB
// rows (one whole segment) x 64 queries, so a segment's max finishes inside
// the block with no atomics. bf16: the depth loop steps 32 columns through
// shared memory (register prefetch of the next step); eight warps each
// compute a 32 x 32 sub-tile with nvcuda::wmma bf16 16x16x16 fragments and
// f32 accumulators. f32: CUDA-core FFMA on f32 operands, 16 columns a step,
// each thread an 8 x 4 sub-tile; NOT TF32, whose 10-bit mantissa would
// break the f32 contract. Both stage the f32 tile through shared memory;
// each warp then writes whole tile rows along Q (coalesced), and the
// segment max is reduced over the 128 staged rows per query. The linear
// block index puts the query blocks of one segment next to each other, so
// each KB segment comes from device memory once. Every global offset is
// 64-bit: N Q reaches 1.92e9 at the main path.
//
// What this leaves out (later work): TMA, wgmma (wmma compiles to
// mma.sync), a multi-stage cp.async ring, warp specialisation and a
// persistent schedule, so loads and the epilogue do not overlap the math;
// the score stores are 2 or 4 bytes a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BN = 128;          // KB rows per block == one segment
constexpr int BQ = 64;           // queries per block
constexpr int THREADS = 256;
constexpr int LDC = BQ + 4;      // f32 staging row stride
constexpr int SMEM_STAGE = BN * LDC * 4;
// bf16 depth tiles, row-major [row][k]
constexpr int BK16 = 32;
constexpr int LDS16 = BK16 + 8;  // 80 B rows, 16-B aligned
constexpr int SMEM_TILES16 = (BN + BQ) * LDS16 * 2;
// f32 depth tiles, transposed [k][row]
constexpr int BK32 = 16;
constexpr int LDA32 = BN + 4;
constexpr int LDB32 = BQ + 4;
constexpr int SMEM_TILES32 = BK32 * (LDA32 + LDB32) * 4;
constexpr int SMEM_MAIN =
    SMEM_STAGE > SMEM_TILES16
        ? (SMEM_STAGE > SMEM_TILES32 ? SMEM_STAGE : SMEM_TILES32)
        : (SMEM_TILES16 > SMEM_TILES32 ? SMEM_TILES16 : SMEM_TILES32);
constexpr int SMEM_BYTES = SMEM_MAIN + 4 * BQ * 4;  // + the max partials

static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ uint4 load_bf16x8(const __nv_bfloat16* base,
                                             int64_t row, int64_t n_rows,
                                             int64_t col, int64_t dim) {
    // 8 bf16 of row `row`, or zeros past the edge; d % 8 == 0 makes every
    // chunk either fully inside or fully outside
    if (row < n_rows && col < dim) {
        return __ldg(reinterpret_cast<const uint4*>(base + row * dim + col));
    }
    return make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float4 load_f32x4(const float* base, int64_t row,
                                             int64_t n_rows, int64_t col,
                                             int64_t dim) {
    // 4 floats of row `row`, or zeros past the edge (d % 4 == 0)
    if (row < n_rows && col < dim) {
        return __ldg(reinterpret_cast<const float4*>(base + row * dim + col));
    }
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store_score(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

__device__ __forceinline__ void store_score(float* p, float x) { *p = x; }

// The staged (BN x BQ) f32 tile `cs` -> scores_t rows n0.. and segmax_t row
// `seg`. Every thread of the block must call it (it synchronises).
template <typename OutT>
__device__ __forceinline__ void epilogue(const float* cs, float* red,
                                         OutT* __restrict__ scores_t,
                                         float* __restrict__ segmax_t,
                                         int64_t n0, int64_t seg, int64_t q0,
                                         int64_t n_q) {
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // warp w writes tile rows [16 w, 16 w + 16); lane l writes the queries
    // q0 + l and q0 + l + 32 of each: consecutive lanes, consecutive bytes
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
        OutT* row = scores_t + (n0 + r) * n_q + q0;
#pragma unroll
        for (int c = lane; c < BQ; c += 32) {
            if (q0 + c < n_q) store_score(row + c, cs[r * LDC + c]);
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
kbmajor_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kb,
                    __nv_bfloat16* __restrict__ scores_t,
                    float* __restrict__ segmax_t, int64_t n_q, int64_t n_kb,
                    int64_t dim, int64_t q_blocks) {
    __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // BN x LDS
    __nv_bfloat16* qs = ks + BN * LDS16;                         // BQ x LDS
    float* cs = reinterpret_cast<float*>(smem);  // BN x LDC, after the loop
    float* red = reinterpret_cast<float*>(smem + SMEM_MAIN);

    const int64_t bid = blockIdx.x;
    const int64_t q0 = (bid % q_blocks) * BQ;
    const int64_t seg = bid / q_blocks;
    const int64_t n0 = seg * BN;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int wm = warp >> 1;  // KB rows [32 wm, 32 wm + 32) of the tile
    const int wn = warp & 1;   // queries [32 wn, 32 wn + 32)

    // load slots: the kb tile is 128 rows x 4 chunks (two per thread, rows
    // r and r + 64), the q tile 64 rows x 4 chunks (one per thread)
    const int lr = tid >> 2;
    const int lc = (tid & 3) * 8;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    uint4 k_reg0 = load_bf16x8(kb, n0 + lr, n_kb, lc, dim);
    uint4 k_reg1 = load_bf16x8(kb, n0 + lr + 64, n_kb, lc, dim);
    uint4 q_reg = load_bf16x8(q, q0 + lr, n_q, lc, dim);

    for (int64_t k0 = 0; k0 < dim; k0 += BK16) {
        __syncthreads();  // the previous step's fragments are loaded
        *reinterpret_cast<uint4*>(ks + lr * LDS16 + lc) = k_reg0;
        *reinterpret_cast<uint4*>(ks + (lr + 64) * LDS16 + lc) = k_reg1;
        *reinterpret_cast<uint4*>(qs + lr * LDS16 + lc) = q_reg;
        __syncthreads();
        if (k0 + BK16 < dim) {  // prefetch the next step into registers
            k_reg0 = load_bf16x8(kb, n0 + lr, n_kb, k0 + BK16 + lc, dim);
            k_reg1 = load_bf16x8(kb, n0 + lr + 64, n_kb, k0 + BK16 + lc, dim);
            q_reg = load_bf16x8(q, q0 + lr, n_q, k0 + BK16 + lc, dim);
        }
#pragma unroll
        for (int kk = 0; kk < BK16; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(
                    a[i], ks + (wm * 32 + i * 16) * LDS16 + kk, LDS16);
#pragma unroll
            for (int j = 0; j < 2; ++j)  // query rows are the columns of q^T
                wmma::load_matrix_sync(
                    b[j], qs + (wn * 32 + j * 16) * LDS16 + kk, LDS16);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
    }

    __syncthreads();  // the tiles are dead: reuse their memory for staging
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(
                cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                LDC, wmma::mem_row_major);
    __syncthreads();
    epilogue(cs, red, scores_t, segmax_t, n0, seg, q0, n_q);
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

}  // namespace

extern "C" {

// Enqueues the kernel for the given dtype (is_f32: f32, else bf16) on
// `stream` and returns cudaGetLastError() (0 on success). Shapes, dtypes
// and alignment are validated by the Python wrapper.
int score_segmax_kbmajor_launch(const void* q, const void* kb, void* scores_t,
                                void* segmax_t, int64_t n_q, int64_t n_kb,
                                int64_t dim, int is_f32, void* stream) {
    if (n_q == 0 || n_kb == 0) return 0;
    const int64_t q_blocks = (n_q + BQ - 1) / BQ;
    const int64_t blocks = q_blocks * (n_kb / BN);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f32) {
        kbmajor_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
            static_cast<const float*>(q), static_cast<const float*>(kb),
            static_cast<float*>(scores_t), static_cast<float*>(segmax_t), n_q,
            n_kb, dim, q_blocks);
    } else {
        kbmajor_bf16_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(kb),
            static_cast<__nv_bfloat16*>(scores_t),
            static_cast<float*>(segmax_t), n_q, n_kb, dim, q_blocks);
    }
    return static_cast<int>(cudaGetLastError());
}

const char* score_segmax_kbmajor_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
