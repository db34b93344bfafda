// Kernel B1, fused exact-MIPS scoring for Hopper (sm_90a): bf16 scores +
// the max of every 128-column segment, in one pass over the KB.
//
// Replaces viquae_tpu/ops/mips_pallas.py::fused_score_segmax_qmajor (the
// Pallas q-major kernel on the TPU's exact retrieval path).
//
// Contract (identical values to the Pallas kernel and to
// viquae_torch/ops/mips_fused.py::fused_score_segmax_qmajor_plain):
//   q (Q, d) bf16 and kb (N, d) bf16, both row-major, N % 128 == 0,
//   d % 8 == 0, any Q; s = q . kb^T accumulated in f32; columns >=
//   valid_rows are set to -inf ON THE F32 VALUE; s is rounded once to bf16
//   (round to nearest even) and written to scores (Q, N); segmax[q][j] is
//   the max of the ROUNDED scores in columns [128 j, 128 j + 128), written
//   as (Q, N/128) bf16.
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W) at the main
// path's shapes, Q = 1,280, d = 768, N = 1,500,032:
//   operations: 2 Q d N = 2.95e12 FLOP / 989 TFLOP/s (bf16 dense) = 2.98 ms;
//   bytes:      KB read 2.30 GB + scores write 3.84 GB + segmax 0.03 GB
//               = 6.18 GB / 3.35 TB/s = 1.84 ms.
// The bound is the tensor cores' (2.98 ms), so the design is a Hopper GEMM
// mainloop (score_segmax_sm90.cuh: persistent, TMA ring, one producer and
// two wgmma consumer warpgroups, queries on M, KB rows on N, 128 x 256
// tiles). Its epilogue runs while the tensor cores idle, so it is kept
// short, and the bf16 score write, the largest byte stream, leaves it
// asynchronously:
//   - each consumer rounds its 64 x 256 f32 accumulators once, two at a
//     time, into a 128B-swizzled staging tile (no bank conflicts); only a
//     tile that valid_rows cuts masks first (column >= valid_rows -> -inf);
//   - a segment's 128 columns of one row sit in the 4 lanes of a quad (32
//     values each): the max of the rounded values is a bf16 pair max in
//     registers, then two quad shuffles; the 2-byte maxima go straight to
//     global memory, skipping the segments past N/128 of a half-empty last
//     tile;
//   - one thread stores the staging tile with four TMA stores (64 x 64
//     boxes; TMA clips the ragged query edge and the last tile's empty
//     half) and the consumers go on to the next tile's wgmma at once: the
//     store is waited on only before the staging tile is written again.

#include "score_segmax_sm90.cuh"

namespace {

using namespace sm90;

// Masks (when MASK: columns >= lim score -inf), rounds once and stages the
// accumulators; m2[h][sg] keeps the max of the rounded pairs of row half h
// in segment sg.
template <bool MASK>
__device__ __forceinline__ void stage_rounded(const float (&acc)[128],
                                              uint8_t* stage, int r0,
                                              int lane, int lim,
                                              __nv_bfloat162 (&m2)[2][2]) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
            if (MASK) {
                x0 = col < lim ? x0 : -INFINITY;
                x1 = col + 1 < lim ? x1 : -INFINITY;
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
            *reinterpret_cast<__nv_bfloat162*>(
                stage + staged(r0 + 8 * h, j, 4 * (lane & 3))) = v;
            m2[h][j / 16] = __hmax2(m2[h][j / 16], v);
        }
    }
}

struct QMajorEpilogue {
    static constexpr bool kKbOnM = false;

    __device__ static __forceinline__ void store(float (&acc)[128],
                                                 uint8_t* smem, int c,
                                                 int m_tile, int n_tile,
                                                 const Params& p,
                                                 const CUtensorMap* map) {
        const int tid = threadIdx.x % 128, lane = tid % 32;
        uint8_t* stage = smem + OFF_STAGING + c * STAGING_BYTES;
        const int64_t q_base = static_cast<int64_t>(m_tile) * BM + 64 * c;
        const int64_t n0 = static_cast<int64_t>(n_tile) * BN;
        const int64_t left = p.valid_rows - n0;
        const int lim = left < 0 ? 0 : (left > BN ? BN : static_cast<int>(left));
        const int r0 = (tid / 32) * 16 + lane / 4;

        if (tid == 0) bulk_wait_read();  // the last tile's store has read it
        named_sync(1 + c, 128);
        const __nv_bfloat162 lowest = __floats2bfloat162_rn(-INFINITY,
                                                            -INFINITY);
        __nv_bfloat162 m2[2][2] = {{lowest, lowest}, {lowest, lowest}};
        if (lim == BN) {
            stage_rounded<false>(acc, stage, r0, lane, lim, m2);
        } else {
            stage_rounded<true>(acc, stage, r0, lane, lim, m2);
        }
        fence_async_shared();  // the generic stores, visible to the TMA
        named_sync(1 + c, 128);
        if (tid == 0) store_staged(map, stage, q_base, p.n_q, n0, p.n_kb);

        // a segment's 128 columns of a row lie in the 4 lanes of a quad
        const int64_t n_seg = p.n_kb / 128;
        __nv_bfloat16* segmax = static_cast<__nv_bfloat16*>(p.segmax);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {
                float v = fmaxf(__low2float(m2[h][sg]),
                                __high2float(m2[h][sg]));
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
                const int64_t q = q_base + r0 + 8 * h;
                const int64_t seg = 2 * static_cast<int64_t>(n_tile) + sg;
                if ((lane & 3) == 0 && q < p.n_q && seg < n_seg) {
                    segmax[q * n_seg + seg] = __float2bfloat16(v);
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// Enqueues the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Shapes are validated by the Python wrapper.
int score_segmax_launch(const void* q, const void* kb, void* scores,
                        void* segmax, int64_t n_q, int64_t n_kb, int64_t dim,
                        int64_t valid_rows, void* stream) {
    if (n_q == 0 || n_kb == 0) return 0;
    CUtensorMap map_scores;
    if (!make_map(&map_scores, scores, n_q, n_kb, 64, 64)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p{};
    p.segmax = segmax;
    p.n_q = n_q;
    p.n_kb = n_kb;
    p.valid_rows = valid_rows;
    return launch<QMajorEpilogue>(q, n_q, kb, n_kb, dim, map_scores, p,
                                  static_cast<cudaStream_t>(stream));
}

const char* score_segmax_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
