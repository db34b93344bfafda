// Fused self-attention of a packed canvas at inference, for Hopper (sm_90a):
// one pass per (canvas row, head, tile of 64 queries) reads q, k and v
// and writes the context, with no score tensor in device memory.
//
// Replaces no TPU kernel: the JAX package's attention
// (viquae_tpu/models/layers.py::mha) is plain XLA. It replaces the plain
// path of viquae_torch/models/layers.py::mha on a packed canvas, whose
// f32 score tensor (R x H x L x L) makes about eight trips through device
// memory (product, scale, block-diagonal bias, softmax, two casts, second
// product) beside four transposing copies of q, k, v and the context.
//
// Contract (the values of viquae_torch/ops/segment_attention.py::
// segment_attention_plain, and of the plain path up to the order of f32
// sums):
//   q, k, v (R, L, width) f32, read through their row and token strides
//   (last stride 1, both multiples of 4, 16-byte aligned), width = heads x
//   64; seg (R, L) int32 or int64, 0 or less = padding (as the plain
//   path's bias treats it); ctx (R, L, width) f32 contiguous, heads
//   concatenated. For a query of segment s > 0: logits
//   (q . k) * 0.125 summed in f32 over the keys of segment s, an exact f32
//   softmax (row max, sum, one division), each probability rounded to bf16
//   (round to nearest even) when round_bf16, and an f32 product with v.
//   Keys of other segments and of padding are left out: in the plain path
//   their finite bias makes their probabilities exact zeros. A padding
//   query (segment <= 0) gets what the plain path gives it: the bias makes
//   its softmax exactly uniform over all L keys, so its context is
//   p * (sum of v over the L keys), p = 1/L (rounded as the others).
//
// What bounds it on an H100 SXM (data-sheet peaks, 700 W) at the reader's
// shapes (R ~ 384 rows of L = 256, 12 heads, one pair of ~146 tokens a
// row):
//   bytes:      q, k, v read and ctx written once, 4 x 384 x 256 x 768 x 4
//               = 1.21 GB / 3.35 TB/s = 0.36 ms a layer;
//   operations: FFMA (f32 operands, no tensor core: the logits must be f32
//               products of f32 q and k) over each segment's own keys,
//               2 x 146^2 x 64 x 2 x 12 x 384 = 25 GFLOP / 67 TFLOP/s
//               = 0.38 ms a layer.
// Both bounds are near; the design keeps every intermediate on chip and
// spends its effort on the FFMA loops:
//   - a block takes 64 queries of one (row, head); it derives the key range
//     [lo, hi] that the tile's segments cover from the row's segment ids
//     (so a pair's keys, not the row's 256), skips the work of warps whose
//     8 queries are all padding, and of the last chunk's columns that hold
//     no key; the row's last tile alone sums v for the padding queries;
//   - the softmax takes a warp's 8 rows at once, 4 lanes a row;
//   - the tile's logits, then its probabilities, stay in shared memory
//     (64 x L f32: 64 KB at L = 256, 128 KB at 512): an exact softmax
//     needs the whole row, and an online (flash) rescale would move the
//     bf16 rounding point of the probabilities;
//   - both products run on 4 x 4 register tiles from shared memory with
//     16-byte loads (rows padded to 68 floats: no bank conflicts), 64 FFMA
//     a thread per 8 loads; the next chunk of 64 keys is read from device
//     memory into registers while the current one is computed;
//   - q, k and v are read in place from the projections' (R, L, width)
//     outputs and the context is written in the layout the output
//     projection reads, so no transpose or copy is left around it;
//   - at L = 256 a block takes 105 KB of shared memory and at most 128
//     registers a thread, so two blocks (16 warps) share an SM. Measured
//     (H100 SXM, 700 W) at the reader's canvas: 1.36 ms against the bound's
//     0.38 and the plain path's 7.7; latency at 16 warps an SM, not shared
//     memory bandwidth, holds it there (halving either product's shared
//     memory loads changes nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head size
constexpr int TQ = 64;          // queries a block
constexpr int TK = 64;          // keys a chunk
constexpr int THREADS = 256;
constexpr int LDT = HD + 4;     // row stride of the q and k / v tiles
constexpr int MAX_LEN = 512;

struct Params {
    const float* q;
    const float* k;
    const float* v;
    const void* seg;
    float* ctx;
    int64_t q_rs, q_ts, k_rs, k_ts, v_rs, v_ts;   // row and token strides
    int length, heads, tiles, ld_s, round_bf16;
};

__host__ __device__ constexpr int round_up(int x, int m) {
    return (x + m - 1) / m * m;
}

// shared memory of a block for rows of `length` tokens
__host__ __device__ inline int smem_bytes(int length) {
    const int lpad = round_up(length, TK);
    return 2 * TQ * LDT * 4                  // q tile, k / v chunk
           + TQ * (lpad + 4) * 4             // logits, then probabilities
           + lpad * 8                        // the row's segment ids
           + 17 * HD * 4;                    // partial sums of v, their mean
}

__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

// rows `first + tid / 16 + 16 m` (m < 4) of a (row, head) operand, 16
// bytes a thread; rows at or past `end` read as zeros
__device__ __forceinline__ void fetch(float4 (&r)[4], const float* base,
                                      int64_t ts, int first, int end,
                                      int tid) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int t = first + tid / 16 + 16 * m;
        r[m] = t < end ? load4(base + t * ts + (tid % 16) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

__device__ __forceinline__ void stash(const float4 (&r)[4], float* tile,
                                      int tid) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        *reinterpret_cast<float4*>(tile + (tid / 16 + 16 * m) * LDT +
                                   (tid % 16) * 4) = r[m];
    }
}

__device__ __forceinline__ float rounded(float p, int round_bf16) {
    return round_bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
}

// logits of one chunk of keys: thread (ty, tx) takes queries 4 ty + r and
// keys base + tx + 16 m (m < M; the chunk's other columns hold no key);
// S row 4 ty at `sr`, -inf where key j is not of query i's segment
template <int M>
__device__ __forceinline__ void chunk_logits(const float* qs,
                                             const float* kvs, float* sr,
                                             const long long* segs,
                                             const long long (&segq)[4],
                                             int base, int hi, int ld_s,
                                             int ty, int tx) {
    float acc[4][M] = {};
    const float* qr = qs + 4 * ty * LDT;
    const float* kr = kvs + tx * LDT;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
        float4 a[4], b[M];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            a[r] = *reinterpret_cast<const float4*>(qr + r * LDT + d);
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
            b[m] = *reinterpret_cast<const float4*>(kr + 16 * m * LDT + d);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int m = 0; m < M; ++m) {
                acc[r][m] = fmaf(a[r].x, b[m].x, acc[r][m]);
                acc[r][m] = fmaf(a[r].y, b[m].y, acc[r][m]);
                acc[r][m] = fmaf(a[r].z, b[m].z, acc[r][m]);
                acc[r][m] = fmaf(a[r].w, b[m].w, acc[r][m]);
            }
        }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const int j = base + tx + 16 * m;
        const long long sj = j <= hi ? segs[j] : 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            sr[r * ld_s + tx + 16 * m] =
                sj > 0 && sj == segq[r] ? acc[r][m] * 0.125f : -INFINITY;
        }
    }
}

template <typename Seg>
__global__ void __launch_bounds__(THREADS, 2)
segment_attention_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int length = p.length, ld_s = p.ld_s;
    const int lpad = round_up(length, TK);
    float* qs = reinterpret_cast<float*>(smem);
    float* kvs = qs + TQ * LDT;
    float* S = kvs + TK * LDT;
    long long* segs = reinterpret_cast<long long*>(S + TQ * ld_s);
    float* part = reinterpret_cast<float*>(segs + lpad);   // [16][HD]
    float* mean = part + 16 * HD;
    __shared__ int s_lo, s_hi, s_pad;

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tile = blockIdx.x % p.tiles;
    const int head = (blockIdx.x / p.tiles) % p.heads;
    const int64_t row = blockIdx.x / (static_cast<int64_t>(p.tiles) *
                                      p.heads);
    const int q0 = tile * TQ;
    const int nq = min(TQ, length - q0);
    const float* qb = p.q + row * p.q_rs + head * HD;
    const float* kb = p.k + row * p.k_rs + head * HD;
    const float* vb = p.v + row * p.v_rs + head * HD;
    const Seg* segrow = static_cast<const Seg*>(p.seg) + row * length;

    if (tid == 0) {
        s_lo = length;
        s_hi = -1;
        s_pad = 0;
    }
    for (int j = tid; j < length; j += THREADS) {
        segs[j] = static_cast<long long>(segrow[j]);
    }
    {
        float4 r[4];
        fetch(r, qb + static_cast<int64_t>(q0) * p.q_ts, p.q_ts, 0, nq, tid);
        stash(r, qs, tid);
    }
    __syncthreads();

    // the keys the tile's segments cover; the row's last tile also serves
    // every padding query of the row
    const bool last = tile == p.tiles - 1;
    for (int j = tid; j < length; j += THREADS) {
        const long long sj = segs[j];
        if (sj <= 0) {
            if (last) s_pad = 1;
            continue;
        }
        bool member = false;
        for (int i = 0; i < nq; ++i) member |= segs[q0 + i] == sj;
        if (member) {
            atomicMin(&s_lo, j);
            atomicMax(&s_hi, j);
        }
    }
    __syncthreads();
    const int lo = s_lo, hi = s_hi;
    const int chunks = hi >= lo ? (hi - lo) / TK + 1 : 0;

    // thread (ty, tx) holds queries 4 ty .. 4 ty + 3; warp w the 8 queries
    // 8 w .. 8 w + 7, and skips its products when all 8 are padding
    const int ty = tid / 16, tx = tid % 16;
    const bool real = lane < 8 && 8 * warp + lane < nq &&
                      segs[q0 + 8 * warp + lane] > 0;
    const bool active = __any_sync(0xffffffffu, real);
    long long segq[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        segq[r] = 4 * ty + r < nq ? segs[q0 + 4 * ty + r] : 0;
    }

    // logits: S[i][j - lo] = (q_i . k_j) / 8 over the tile's key range,
    // -inf where key j is not of query i's segment
    if (chunks > 0) {
        float4 pre[4];
        fetch(pre, kb, p.k_ts, lo, hi + 1, tid);
        for (int c = 0; c < chunks; ++c) {
            __syncthreads();
            stash(pre, kvs, tid);
            __syncthreads();
            if (c + 1 < chunks) {
                fetch(pre, kb, p.k_ts, lo + (c + 1) * TK, hi + 1, tid);
            }
            if (!active) continue;
            // the last chunk may hold fewer keys: only its first 16, 32
            // or 48 columns are computed
            const int held = hi + 1 - (lo + c * TK);
            const int base = lo + c * TK;
            float* sr = S + 4 * ty * ld_s + c * TK;
            if (held > 48) {
                chunk_logits<4>(qs, kvs, sr, segs, segq, base, hi, ld_s,
                                ty, tx);
            } else if (held > 32) {
                chunk_logits<3>(qs, kvs, sr, segs, segq, base, hi, ld_s,
                                ty, tx);
            } else if (held > 16) {
                chunk_logits<2>(qs, kvs, sr, segs, segq, base, hi, ld_s,
                                ty, tx);
            } else {
                chunk_logits<1>(qs, kvs, sr, segs, segq, base, hi, ld_s,
                                ty, tx);
            }
        }
        __syncthreads();

        // exact softmax of each real query's row, probabilities rounded:
        // warp w's 8 rows at once, 4 lanes a row; the columns past the
        // range (to a multiple of 4) hold -inf
        const int width = round_up(hi + 1 - lo, 4);
        {
            const int i = 8 * warp + lane / 4, part4 = lane % 4;
            const bool mine = i < nq && segs[q0 + i] > 0;
            float* sr = S + i * ld_s;
            float mx = -INFINITY, sum = 0.f;
            if (mine) {
                for (int j = part4; j < width; j += 4) mx = fmaxf(mx, sr[j]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            if (mine) {
                for (int j = part4; j < width; j += 4) {
                    const float e = expf(sr[j] - mx);
                    sr[j] = e;
                    sum += e;
                }
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (mine) {
                for (int j = part4; j < width; j += 4) {
                    sr[j] = rounded(sr[j] / sum, p.round_bf16);
                }
            }
        }

        // context: probabilities times v over the same keys
        float acc[4][4] = {};
        fetch(pre, vb, p.v_ts, lo, hi + 1, tid);
        for (int c = 0; c < chunks; ++c) {
            __syncthreads();
            stash(pre, kvs, tid);
            __syncthreads();
            if (c + 1 < chunks) {
                fetch(pre, vb, p.v_ts, lo + (c + 1) * TK, hi + 1, tid);
            }
            if (!active) continue;
            const float* pr = S + 4 * ty * ld_s + c * TK;
            const float* vr = kvs + 4 * tx;
            const int held = min(TK, width - c * TK);
#pragma unroll 4
            for (int j = 0; j < held; j += 4) {
                float4 a[4], b[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    a[r] = *reinterpret_cast<const float4*>(pr + r * ld_s + j);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    b[u] = *reinterpret_cast<const float4*>(vr + (j + u) * LDT);
                }
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float w[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        acc[r][0] = fmaf(w[u], b[u].x, acc[r][0]);
                        acc[r][1] = fmaf(w[u], b[u].y, acc[r][1]);
                        acc[r][2] = fmaf(w[u], b[u].z, acc[r][2]);
                        acc[r][3] = fmaf(w[u], b[u].w, acc[r][3]);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            if (segq[r] <= 0) continue;
            const int64_t t = q0 + 4 * ty + r;
            *reinterpret_cast<float4*>(
                p.ctx + (row * length + t) * (p.heads * HD) + head * HD +
                4 * tx) = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                      acc[r][3]);
        }
    }

    // padding queries, served by the row's last tile: the uniform
    // probability times the sum of v over all L keys of the row
    if (s_pad) {
        // 16 threads a key, 16 bytes each; 16 partial sums, then their sum
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = tid / 16; j < length; j += 16) {
            const float4 x = load4(vb + j * p.v_ts + 4 * (tid % 16));
            sum.x += x.x;
            sum.y += x.y;
            sum.z += x.z;
            sum.w += x.w;
        }
        *reinterpret_cast<float4*>(part + (tid / 16) * HD +
                                   4 * (tid % 16)) = sum;
        __syncthreads();
        if (tid < HD) {
            float total = 0.f;
            for (int g = 0; g < 16; ++g) total += part[g * HD + tid];
            mean[tid] = rounded(1.0f / static_cast<float>(length),
                                p.round_bf16) * total;
        }
        __syncthreads();
        for (int e = tid; e < length * (HD / 4); e += THREADS) {
            const int i = e / (HD / 4), c4 = e % (HD / 4);
            if (segs[i] > 0) continue;
            *reinterpret_cast<float4*>(
                p.ctx + (row * length + i) * (p.heads * HD) + head * HD +
                4 * c4) = *reinterpret_cast<const float4*>(mean + 4 * c4);
        }
    }
}

template <typename Seg>
int launch(const Params& p, int64_t blocks, cudaStream_t stream) {
    const int bytes = smem_bytes(p.length);
    cudaError_t err = cudaFuncSetAttribute(
        segment_attention_kernel<Seg>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    segment_attention_kernel<Seg><<<static_cast<unsigned>(blocks), THREADS,
                                    bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueues the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Shapes, strides and alignment are validated by the Python
// wrapper; `seg_bytes` is 4 (int32 ids) or 8 (int64).
int segment_attention_launch(const void* q, const void* k, const void* v,
                             const void* seg, void* ctx, int64_t rows,
                             int64_t length, int64_t heads, int64_t q_rs,
                             int64_t q_ts, int64_t k_rs, int64_t k_ts,
                             int64_t v_rs, int64_t v_ts, int seg_bytes,
                             int round_bf16, void* stream) {
    if (rows == 0 || length == 0 || heads == 0) return 0;
    if (length > MAX_LEN || (seg_bytes != 4 && seg_bytes != 8)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p{};
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.seg = seg;
    p.ctx = static_cast<float*>(ctx);
    p.q_rs = q_rs;
    p.q_ts = q_ts;
    p.k_rs = k_rs;
    p.k_ts = k_ts;
    p.v_rs = v_rs;
    p.v_ts = v_ts;
    p.length = static_cast<int>(length);
    p.heads = static_cast<int>(heads);
    p.tiles = static_cast<int>((length + TQ - 1) / TQ);
    p.ld_s = round_up(p.length, TK) + 4;
    p.round_bf16 = round_bf16;
    const int64_t blocks = rows * heads * p.tiles;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return seg_bytes == 4 ? launch<int32_t>(p, blocks, s)
                          : launch<int64_t>(p, blocks, s);
}

const char* segment_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
