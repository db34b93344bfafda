// The elementwise glue of the post-LN encoder block at inference, for
// Hopper (sm_90a): two row kernels that read each GEMM's f32 output once
// and write what the next consumer reads.
//
// Replaces no TPU kernel: the JAX package's glue
// (viquae_tpu/models/layers.py dense / layer_norm, viquae_tpu/models/
// bert.py's block) is plain XLA. It replaces, on the plain path of
// viquae_torch/models/bert.py::_layer_forward, the bias adds of the o and
// mlp.out projections, the residual adds, two LayerNorms of about eight
// f32 passes each, the bias add and GELU of mlp.in, and the bf16 casts of
// every GEMM operand (three of the same tensor for q, k and v): some 226 KB
// a token a layer through device memory.
//
// Contract (the values of viquae_torch/ops/encoder_glue.py's plain twins,
// up to the order of the LayerNorm's f32 sums and the erff of this
// toolkit):
//   bias_residual_layernorm: y, x (T, D) f32 contiguous, 16-byte aligned,
//   D a multiple of 128 up to 1024; bias, weight, shift (D) of one type,
//   bf16 or f32. In f32, with every product and sum rounded as the plain
//   path's separate operations round them (no contraction into FMA):
//     t = x + (y + bias)
//     mean = sum(t) / D, var = sum((t - mean)^2) / D   (two passes)
//     out = (t - mean) * rsqrt(var + eps) * weight + shift
//   writes out (T, D) f32 and out rounded to bf16 (nearest even).
//   bias_gelu: g (T, F) f32 contiguous, 16-byte aligned, F a multiple of 8
//   up to 8192; bias (F) bf16 or f32. h = GELU_erf(g + bias) in f32, as
//   v * 0.5 * (1 + erff(v * sqrt(1/2))) (PyTorch's exact GELU); writes h
//   rounded to bf16 only.
//
// What bounds them on an H100 SXM (data-sheet peaks, 700 W): bytes, at a
// few operations a byte. At the reader's canvas (96,256 tokens, D 768,
// F 3,072): A reads y and x and writes out and its bf16 copy, 14 D =
// 10,752 B a token, 1.03 GB = 0.31 ms at 3.35 TB/s; B reads g and writes
// h, 6 F = 18,432 B a token, 1.77 GB = 0.53 ms. What the design does
// about it:
//   - A: a warp a row (persistent over rows); lane l holds float4 chunks
//     l, l + 32, ... of the row in registers between the two reductions
//     (warp shuffles), so each input byte is read once and each output
//     byte written once; loads are 16 bytes a lane, a warp's 2 x D x 4
//     bytes in flight at once; the bias, scale and shift are converted to
//     f32 into shared memory once a block (registers are kept for the
//     rows, so that more warps fit on an SM);
//   - B: a thread takes 8 columns (two 16-byte loads, one 16-byte bf16
//     store) of GELU_ROWS rows at a time, its 8 bias values in registers;
//   - both launch as many blocks as fit on the SMs at once and walk the
//     rows with a grid stride, so no block waits for a wave's tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;         // rows in flight a block (A)
constexpr int MAX_CHUNKS = 8;    // float4 chunks a lane (A): D <= 1024
constexpr int GELU_ROWS = 2;     // rows in flight a thread (B)
constexpr int MAX_GELU_WIDTH = 8192;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
    // a butterfly: every lane ends with the same sum, as a + b == b + a
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
    }
    return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&two);
}

template <int V, typename P>
__global__ void __launch_bounds__(WARPS * 32)
bias_residual_layernorm_kernel(const float* __restrict__ y,
                               const P* __restrict__ bias,
                               const float* __restrict__ x,
                               const P* __restrict__ weight,
                               const P* __restrict__ shift,
                               float* __restrict__ out,
                               __nv_bfloat16* __restrict__ out_low,
                               int64_t rows, float eps) {
    constexpr int D = V * 128;
    // the bias, scale and shift in f32, once a block, read as float4
    __shared__ __align__(16) float vec[3][MAX_CHUNKS * 128];
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
        vec[0][i] = as_f32(bias[i]);
        vec[1][i] = as_f32(weight[i]);
        vec[2][i] = as_f32(shift[i]);
    }
    __syncthreads();
    const float4* b4 = reinterpret_cast<const float4*>(vec[0]);
    const float4* w4 = reinterpret_cast<const float4*>(vec[1]);
    const float4* s4 = reinterpret_cast<const float4*>(vec[2]);
    const int lane = threadIdx.x & 31;
    const int64_t step = static_cast<int64_t>(gridDim.x) * WARPS;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5);
         row < rows; row += step) {
        const float4* yr = reinterpret_cast<const float4*>(y + row * D);
        const float4* xr = reinterpret_cast<const float4*>(x + row * D);
        float4 yv[V], xv[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            yv[j] = yr[lane + 32 * j];
            xv[j] = xr[lane + 32 * j];
        }
        float t[V][4];
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const float4 bv = b4[lane + 32 * j];
            const float ye[4] = {yv[j].x, yv[j].y, yv[j].z, yv[j].w};
            const float xe[4] = {xv[j].x, xv[j].y, xv[j].z, xv[j].w};
            const float be[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                t[j][e] = __fadd_rn(xe[e], __fadd_rn(ye[e], be[e]));
                sum = __fadd_rn(sum, t[j][e]);
            }
        }
        const float mean = warp_sum(sum) / static_cast<float>(D);
        float sq = 0.0f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                t[j][e] = __fsub_rn(t[j][e], mean);
                sq = __fadd_rn(sq, __fmul_rn(t[j][e], t[j][e]));
            }
        }
        const float var = warp_sum(sq) / static_cast<float>(D);
        const float r = rsqrtf(__fadd_rn(var, eps));
        float4* outr = reinterpret_cast<float4*>(out + row * D);
        uint2* lowr = reinterpret_cast<uint2*>(out_low + row * D);
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const float4 wv = w4[lane + 32 * j], sv = s4[lane + 32 * j];
            const float we[4] = {wv.x, wv.y, wv.z, wv.w};
            const float se[4] = {sv.x, sv.y, sv.z, sv.w};
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                o[e] = __fadd_rn(__fmul_rn(__fmul_rn(t[j][e], r), we[e]),
                                 se[e]);
            }
            outr[lane + 32 * j] = make_float4(o[0], o[1], o[2], o[3]);
            lowr[lane + 32 * j] =
                make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
        }
    }
}

__device__ __forceinline__ float gelu_erf(float v) {
    constexpr float kAlpha = 0.70710678118654752440f;    // sqrt(1/2)
    return v * 0.5f * (1.0f + erff(v * kAlpha));
}

template <typename P>
__global__ void bias_gelu_kernel(const float* __restrict__ g,
                                 const P* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ h, int64_t rows,
                                 int width) {
    // thread c takes columns 8c .. 8c + 7 of every row it visits
    const int c = threadIdx.x;
    float b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = as_f32(bias[8 * c + e]);
    const int64_t step = static_cast<int64_t>(gridDim.x) * GELU_ROWS;
    for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * GELU_ROWS;
         row0 < rows; row0 += step) {
        float4 v[GELU_ROWS][2];
#pragma unroll
        for (int r = 0; r < GELU_ROWS; ++r) {
            if (row0 + r < rows) {
                const float4* src = reinterpret_cast<const float4*>(
                    g + (row0 + r) * width + 8 * c);
                v[r][0] = src[0];
                v[r][1] = src[1];
            }
        }
#pragma unroll
        for (int r = 0; r < GELU_ROWS; ++r) {
            if (row0 + r >= rows) break;
            const float in[8] = {v[r][0].x, v[r][0].y, v[r][0].z, v[r][0].w,
                                 v[r][1].x, v[r][1].y, v[r][1].z, v[r][1].w};
            float o[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                o[e] = gelu_erf(__fadd_rn(in[e], b[e]));
            }
            *reinterpret_cast<uint4*>(h + (row0 + r) * width + 8 * c) =
                make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                           pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
        }
    }
}

// As many blocks of `kernel` as are resident on the card at once, at most
// `wanted`.
template <typename K>
int resident_blocks(K kernel, int threads, int64_t wanted, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    *blocks = static_cast<int>(wanted < most ? wanted : most);
    return 0;
}

template <int V, typename P>
int launch_layernorm(const void* y, const void* bias, const void* x,
                     const void* weight, const void* shift, void* out,
                     void* out_low, int64_t rows, float eps,
                     cudaStream_t stream) {
    auto kernel = bias_residual_layernorm_kernel<V, P>;
    int blocks = 0;
    const int err = resident_blocks(kernel, WARPS * 32,
                                    (rows + WARPS - 1) / WARPS, &blocks);
    if (err != 0) return err;
    kernel<<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<const float*>(y), static_cast<const P*>(bias),
        static_cast<const float*>(x), static_cast<const P*>(weight),
        static_cast<const P*>(shift), static_cast<float*>(out),
        static_cast<__nv_bfloat16*>(out_low), rows, eps);
    return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_layernorm_width(int chunks, const void* y, const void* bias,
                           const void* x, const void* weight,
                           const void* shift, void* out, void* out_low,
                           int64_t rows, float eps, cudaStream_t stream) {
    switch (chunks) {
#define GLUE_WIDTH(V)                                                      \
    case V:                                                                \
        return launch_layernorm<V, P>(y, bias, x, weight, shift, out,     \
                                      out_low, rows, eps, stream);
        GLUE_WIDTH(1) GLUE_WIDTH(2) GLUE_WIDTH(3) GLUE_WIDTH(4)
        GLUE_WIDTH(5) GLUE_WIDTH(6) GLUE_WIDTH(7) GLUE_WIDTH(8)
#undef GLUE_WIDTH
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

template <typename P>
int launch_gelu(const void* g, const void* bias, void* h, int64_t rows,
                int width, cudaStream_t stream) {
    auto kernel = bias_gelu_kernel<P>;
    const int threads = width / 8;
    int blocks = 0;
    const int err = resident_blocks(kernel, threads,
                                    (rows + GELU_ROWS - 1) / GELU_ROWS,
                                    &blocks);
    if (err != 0) return err;
    kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(g), static_cast<const P*>(bias),
        static_cast<__nv_bfloat16*>(h), rows, width);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueue kernel A on `stream`; return cudaGetLastError() (0 on success).
// Shapes, types, contiguity and alignment are validated by the Python
// wrapper; `params_bf16` says whether bias, weight and shift are bf16
// (else f32).
int bias_residual_layernorm_launch(const void* y, const void* bias,
                                   const void* x, const void* weight,
                                   const void* shift, void* out,
                                   void* out_low, int64_t rows,
                                   int64_t width, int params_bf16,
                                   float eps, void* stream) {
    if (rows == 0) return 0;
    if (width % 128 != 0 || width / 128 < 1 || width / 128 > MAX_CHUNKS) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int chunks = static_cast<int>(width / 128);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return params_bf16
        ? launch_layernorm_width<__nv_bfloat16>(chunks, y, bias, x, weight,
                                                shift, out, out_low, rows,
                                                eps, s)
        : launch_layernorm_width<float>(chunks, y, bias, x, weight, shift,
                                        out, out_low, rows, eps, s);
}

// Enqueue kernel B on `stream`; return cudaGetLastError() (0 on success).
// `bias_bf16` says whether the bias is bf16 (else f32).
int bias_gelu_launch(const void* g, const void* bias, void* h, int64_t rows,
                     int64_t width, int bias_bf16, void* stream) {
    if (rows == 0) return 0;
    if (width % 8 != 0 || width < 8 || width > MAX_GELU_WIDTH) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return bias_bf16
        ? launch_gelu<__nv_bfloat16>(g, bias, h, rows,
                                     static_cast<int>(width), s)
        : launch_gelu<float>(g, bias, h, rows, static_cast<int>(width), s);
}

const char* encoder_glue_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
