// Fused exact-MIPS scoring for Hopper (sm_90a): bf16 scores + the max of
// every 128-column segment, in one pass over the KB.
//
// Replaces viquae_tpu/ops/mips_pallas.py::fused_score_segmax_qmajor (the
// Pallas q-major kernel on the TPU's exact retrieval path).
//
// Contract (identical values to the Pallas kernel and to
// viquae_torch/ops/mips_fused.py::fused_score_segmax_plain):
//   q (Q, d) bf16 and kb (N, d) bf16, both row-major, N % 128 == 0,
//   d % 8 == 0; s = q . kb^T accumulated in f32; columns >= valid_rows are
//   set to -inf ON THE F32 VALUE; s is rounded to bf16 with
//   __float2bfloat16 (round to nearest even) and written to scores (Q, N);
//   segmax[q][j] is the max of the ROUNDED scores in columns
//   [128 j, 128 j + 128), written as (Q, N/128) bf16.
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W) at the main
// path's shapes, Q = 1,280, d = 768, N = 1,500,032:
//   operations: 2 Q d N = 2.95e12 FLOP / 989 TFLOP/s (bf16 dense) = 2.98 ms;
//   bytes:      KB read 2.30 GB + scores write 3.84 GB + segmax 0.03 GB
//               = 6.18 GB / 3.35 TB/s = 1.84 ms.
// So the bound is the tensor cores' (2.98 ms), but the bf16 score write is
// the largest single byte stream, 1.7x the KB read: the segment maxima ride
// in the same epilogue so that the selection never re-reads those 3.84 GB.
//
// Design (simple and right first): one block of 256 threads owns a tile of
// 64 queries x 128 KB rows, i.e. whole 128-column segments, so a segment
// never straddles blocks and no atomics are needed. The depth loop steps 32
// columns of d at a time through shared memory (register prefetch of the
// next step while the tensor cores run the current one); eight warps each
// compute a 32 x 32 sub-tile with nvcuda::wmma bf16 16x16x16 fragments and
// f32 accumulators. The epilogue stages the f32 tile through shared memory;
// each warp then masks, rounds and stores whole 128-column rows (8 bytes a
// lane, coalesced) and reduces each row's maximum with warp shuffles. The
// linear block index puts the query blocks of one KB segment next to each
// other, so each KB segment comes from device memory once and from L2 for
// the other query blocks. Every global offset is 64-bit: Q N reaches 1.9e9
// at the main path, near 2^31.
//
// What this leaves on the table (later work): wmma compiles to mma.sync,
// which cannot reach the wgmma rate; there is no TMA, no multi-stage
// cp.async ring, no warp specialisation and no persistent scheduling, so
// loads and the epilogue do not overlap the tensor cores; the 64-query tile
// reads each KB tile from L2 once per query block (20 times at Q = 1,280).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // queries per block
constexpr int BN = 128;         // KB rows per block == one segment
constexpr int BK = 32;          // depth step
constexpr int LDS = BK + 8;     // smem row stride (bf16): 80 B, 16-B aligned
constexpr int LDC = BN + 4;     // f32 staging row stride
constexpr int THREADS = 256;    // 8 warps: 2 along queries x 4 along KB rows
constexpr int SMEM_TILES = (BM + BN) * LDS * 2;
constexpr int SMEM_STAGE = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_TILES > SMEM_STAGE ? SMEM_TILES : SMEM_STAGE;

static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* base,
                                            int64_t row, int64_t n_rows,
                                            int64_t col, int64_t dim) {
    // one 16-byte chunk (8 bf16) of row `row`, or zeros past the edge;
    // d % 8 == 0 makes every chunk either fully inside or fully outside
    if (row < n_rows && col < dim) {
        return __ldg(reinterpret_cast<const uint4*>(base + row * dim + col));
    }
    return make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(THREADS)
score_segmax_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kb,
                    __nv_bfloat16* __restrict__ scores,
                    __nv_bfloat16* __restrict__ segmax,
                    int64_t n_q, int64_t n_kb, int64_t dim,
                    int64_t valid_rows, int64_t q_blocks) {
    __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x LDS
    __nv_bfloat16* ks = qs + BM * LDS;                           // BN x LDS
    float* cs = reinterpret_cast<float*>(smem);  // BM x LDC, after the loop

    const int64_t bid = blockIdx.x;
    const int64_t q0 = (bid % q_blocks) * BM;
    const int64_t seg = bid / q_blocks;
    const int64_t n0 = seg * BN;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wm = warp >> 2;  // rows [32 wm, 32 wm + 32) of the tile
    const int wn = warp & 3;   // cols [32 wn, 32 wn + 32)

    // load slots: the q tile is 64 rows x 4 chunks (one per thread), the
    // kb tile 128 rows x 4 chunks (two per thread, rows r and r + 64)
    const int lr = tid >> 2;
    const int lc = (tid & 3) * 8;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    uint4 q_reg = load_chunk(q, q0 + lr, n_q, lc, dim);
    uint4 k_reg0 = load_chunk(kb, n0 + lr, n_kb, lc, dim);
    uint4 k_reg1 = load_chunk(kb, n0 + lr + 64, n_kb, lc, dim);

    for (int64_t k0 = 0; k0 < dim; k0 += BK) {
        __syncthreads();  // the previous step's fragments are loaded
        *reinterpret_cast<uint4*>(qs + lr * LDS + lc) = q_reg;
        *reinterpret_cast<uint4*>(ks + lr * LDS + lc) = k_reg0;
        *reinterpret_cast<uint4*>(ks + (lr + 64) * LDS + lc) = k_reg1;
        __syncthreads();
        if (k0 + BK < dim) {  // prefetch the next step into registers
            q_reg = load_chunk(q, q0 + lr, n_q, k0 + BK + lc, dim);
            k_reg0 = load_chunk(kb, n0 + lr, n_kb, k0 + BK + lc, dim);
            k_reg1 = load_chunk(kb, n0 + lr + 64, n_kb, k0 + BK + lc, dim);
        }
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], qs + (wm * 32 + i * 16) * LDS + kk,
                                       LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j)  // kb rows are the columns of kb^T
                wmma::load_matrix_sync(b[j], ks + (wn * 32 + j * 16) * LDS + kk,
                                       LDS);
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

    // epilogue: warp w owns tile rows [8 w, 8 w + 8); lane l owns columns
    // [4 l, 4 l + 4) of each. Mask on f32, round once, max of the rounded.
    const int64_t n_seg = n_kb / BN;
    const int64_t col0 = n0 + lane * 4;
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
        const int64_t qrow = q0 + r;
        if (qrow >= n_q) break;  // warp-uniform: the ragged query edge
        const float4 v = *reinterpret_cast<const float4*>(cs + r * LDC +
                                                          lane * 4);
        const float f[4] = {v.x, v.y, v.z, v.w};
        __nv_bfloat16 h[4];
        float m = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = (col0 + e < valid_rows) ? f[e] : -INFINITY;
            h[e] = __float2bfloat16(x);
            m = fmaxf(m, __bfloat162float(h[e]));
        }
        __nv_bfloat162 pair[2] = {__halves2bfloat162(h[0], h[1]),
                                  __halves2bfloat162(h[2], h[3])};
        *reinterpret_cast<uint2*>(scores + qrow * n_kb + col0) =
            *reinterpret_cast<const uint2*>(pair);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) segmax[qrow * n_seg + seg] = __float2bfloat16(m);
    }
}

}  // namespace

extern "C" {

// Enqueues the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Shapes are validated by the Python wrapper.
int score_segmax_launch(const void* q, const void* kb, void* scores,
                        void* segmax, int64_t n_q, int64_t n_kb, int64_t dim,
                        int64_t valid_rows, void* stream) {
    if (n_q == 0 || n_kb == 0) return 0;
    const int64_t q_blocks = (n_q + BM - 1) / BM;
    const int64_t blocks = q_blocks * (n_kb / BN);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    score_segmax_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kb),
        static_cast<__nv_bfloat16*>(scores),
        static_cast<__nv_bfloat16*>(segmax), n_q, n_kb, dim, valid_rows,
        q_blocks);
    return static_cast<int>(cudaGetLastError());
}

const char* score_segmax_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
