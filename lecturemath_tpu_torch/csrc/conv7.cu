// k x k SAME, stride-1 convolution + bias + optional exact GELU over bf16
// NHWC (channels_last) activations, f32 accumulation, bf16 or f32 output:
// the four full-resolution head convs of FCN-LectureNet (text_conv 32->1,
// pixels_1 35->32 with GELU, pixels_2 35->16 with GELU, out_conv 19->1, all
// k=7 at production widths).
//
// Replaces lecturemath_tpu/ops/pallas_conv7.py:42 _kernel (pallas_call at
// :120, wrappers conv7_hcw :83 and conv7_same :150).
//
// Bound on the H100: operations. Sum over the four heads of C_in*C_out is
// 1731, so 2*49*1731 FLOP per pixel, x 522,240 pixels of a 544x960 padded
// frame = 88.6 GFLOP per frame: 90 us at the 989 TFLOP/s dense bf16
// tensor-core rate, 1.3 ms at the 67 TFLOP/s f32 rate of the CUDA cores.
// pixels_1 is 65% of it. The bytes (each input read once, each output
// written once: about 181 MB per frame over the four heads) take 54 us at
// 3.35 TB/s, below the operations' 90 us.
//
// Design: a direct convolution on the CUDA cores, so it is bound by the f32
// FMA rate, not by the tensor cores (an implicit GEMM on wgmma is later
// work). A block of 256 threads owns an 8 x 32 tile of output pixels and up
// to 32 output channels; each thread keeps one pixel's accumulators in
// registers. The input channels go through shared memory in chunks of 4:
// the halo'd input tile (converted to f32 once) and the matching weights.
// In the inner loop a warp reads 32 neighbouring input pixels (no bank
// conflicts) and the same weights (16-byte broadcast loads), so each input
// value feeds up to 32 FMAs from registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;         // output rows per block
constexpr int TW = 32;        // output columns per block (one warp per row)
constexpr int CC = 4;         // input channels staged per step
constexpr int THREADS = TH * TW;
constexpr int MAX_NT = 32;    // output channels per block

template <int K, int NT>
__global__ void __launch_bounds__(THREADS)
conv_same_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ w,      // [K][K][C][N]
                 const float* __restrict__ bias,   // [N]
                 void* __restrict__ out,           // [B][H][W][N]
                 int H, int W, int C, int N, int groups, int gelu,
                 int out_f32) {
    constexpr int R = K / 2;
    constexpr int IH = TH + K - 1;
    constexpr int IW = TW + K - 1;
    __shared__ float s_in[CC][IH][IW];
    __shared__ __align__(16) float s_w[K * K * CC][NT];

    const int tid = threadIdx.x;
    const int tx = tid % TW;
    const int ty = tid / TW;
    const int b = blockIdx.z / groups;
    const int n0 = (blockIdx.z % groups) * NT;
    const int y0 = blockIdx.y * TH;
    const int x0 = blockIdx.x * TW;
    const __nv_bfloat16* xb = x + (size_t)b * H * W * C;

    float acc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n] = 0.0f;

    for (int c0 = 0; c0 < C; c0 += CC) {
        // halo'd input tile, zero outside the frame (SAME padding) and past C
        for (int i = tid; i < CC * IH * IW; i += THREADS) {
            int c = i % CC;
            int p = i / CC;
            int ix = p % IW;
            int iy = p / IW;
            int gy = y0 + iy - R;
            int gx = x0 + ix - R;
            int gc = c0 + c;
            float v = 0.0f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
                v = __bfloat162float(xb[((size_t)gy * W + gx) * C + gc]);
            s_in[c][iy][ix] = v;
        }
        // weights of this channel chunk, zero past C and past N
        for (int i = tid; i < K * K * CC * NT; i += THREADS) {
            int n = i % NT;
            int t = i / NT;
            int c = t % CC;
            int tap = t / CC;
            int gc = c0 + c;
            int gn = n0 + n;
            s_w[t][n] = (gc < C && gn < N)
                            ? w[((size_t)tap * C + gc) * N + gn] : 0.0f;
        }
        __syncthreads();

#pragma unroll
        for (int c = 0; c < CC; ++c) {
#pragma unroll
            for (int dy = 0; dy < K; ++dy) {
#pragma unroll
                for (int dx = 0; dx < K; ++dx) {
                    const float v = s_in[c][ty + dy][tx + dx];
                    const float* wr = s_w[(dy * K + dx) * CC + c];
                    if constexpr (NT % 4 == 0) {
#pragma unroll
                        for (int n = 0; n < NT; n += 4) {
                            float4 w4 = *reinterpret_cast<const float4*>(wr + n);
                            acc[n] += v * w4.x;
                            acc[n + 1] += v * w4.y;
                            acc[n + 2] += v * w4.z;
                            acc[n + 3] += v * w4.w;
                        }
                    } else {
#pragma unroll
                        for (int n = 0; n < NT; ++n) acc[n] += v * wr[n];
                    }
                }
            }
        }
        __syncthreads();
    }

    const int oy = y0 + ty;
    const int ox = x0 + tx;
    if (oy >= H || ox >= W) return;
    const size_t base = (((size_t)b * H + oy) * W + ox) * N;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int gn = n0 + n;
        if (gn < N) {
            float r = acc[n] + bias[gn];
            if (gelu) r = 0.5f * r * (1.0f + erff(r * 0.70710678118654752f));
            if (out_f32)
                static_cast<float*>(out)[base + gn] = r;
            else
                static_cast<__nv_bfloat16*>(out)[base + gn] =
                    __float2bfloat16(r);
        }
    }
}

template <int K, int NT>
int launch(const __nv_bfloat16* x, const float* w, const float* bias,
           void* out, int B, int H, int W, int C, int N, int gelu,
           int out_f32, cudaStream_t stream) {
    int groups = (N + NT - 1) / NT;
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * groups);
    conv_same_kernel<K, NT><<<grid, THREADS, 0, stream>>>(
        x, w, bias, out, H, W, C, N, groups, gelu, out_f32);
    return (int)cudaGetLastError();
}

template <int K>
int launch_k(const __nv_bfloat16* x, const float* w, const float* bias,
             void* out, int B, int H, int W, int C, int N, int gelu,
             int out_f32, cudaStream_t stream) {
    if (N == 1)
        return launch<K, 1>(x, w, bias, out, B, H, W, C, N, gelu, out_f32, stream);
    if (N <= 4)
        return launch<K, 4>(x, w, bias, out, B, H, W, C, N, gelu, out_f32, stream);
    if (N <= 8)
        return launch<K, 8>(x, w, bias, out, B, H, W, C, N, gelu, out_f32, stream);
    if (N <= 16)
        return launch<K, 16>(x, w, bias, out, B, H, W, C, N, gelu, out_f32, stream);
    return launch<K, MAX_NT>(x, w, bias, out, B, H, W, C, N, gelu, out_f32, stream);
}

}  // namespace

// x: bf16 [B, H, W, C]; w: f32 [k, k, C, N] (HWIO); bias: f32 [N];
// out: [B, H, W, N], f32 when out_f32 else bf16. k odd, 1 <= k <= 7.
// Returns the CUDA error code of the launch (0 on success), or
// cudaErrorInvalidValue for a k the kernel was not built for.
extern "C" int lm_conv_same_nhwc(const void* x, const float* w,
                                 const float* bias, void* out, int B, int H,
                                 int W, int C, int N, int k, int gelu,
                                 int out_f32, void* stream) {
    if (B == 0 || H == 0 || W == 0) return 0;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return launch_k<1>(xb, w, bias, out, B, H, W, C, N, gelu, out_f32, s);
        case 3: return launch_k<3>(xb, w, bias, out, B, H, W, C, N, gelu, out_f32, s);
        case 5: return launch_k<5>(xb, w, bias, out, B, H, W, C, N, gelu, out_f32, s);
        case 7: return launch_k<7>(xb, w, bias, out, B, H, W, C, N, gelu, out_f32, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
