// k x k SAME, stride-1 convolution + bias + optional exact GELU over bf16
// NHWC (channels_last) activations, f32 accumulation, bf16 or f32 output:
// the four full-resolution head convs of FCN-LectureNet, all k=7 at
// production widths. The input is one tensor x, or x and x2 read as if
// concatenated on the channel axis (the diff image beside a feature map),
// so the model never materialises the concat.
//
// Replaces lecturemath_tpu/ops/pallas_conv7.py:42 _kernel (pallas_call at
// :120, wrappers conv7_hcw :83 and conv7_same :150), which splits the conv
// by dy into dense (N, k*C') @ (k*C', W) products on the MXU with bf16
// operands.
//
// Bound on the H100, per batch of 96 frames padded to 544x960 (the four
// heads: text_conv 32->1, pixels_1 3+32->32, pixels_2 3+32->16, out_conv
// 3+16->1): operations, 8.5 TFLOP at the 989 TFLOP/s dense bf16 tensor-core
// rate = 8.60 ms. The bytes (each input read once, each output written
// once: about 346 B a pixel over the four heads) take 5.2 ms at 3.35 TB/s.
//
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulators) with no im2col buffer.
//   M = output pixels: a block owns 16 rows x 32 columns, each of its 8
//       warps two rows, as four m16 tiles of 16 neighbouring pixels.
//   N = output channels padded to NT n8 tiles (NT = 1, 2 or 4); N > 32 runs
//       as groups of 32 on grid.z.
//   K = channel chunks of 8 (16 bytes) x the k*k taps, chunk-major; one k16
//       step pairs taps 2s and 2s+1 of one chunk (an odd last tap is paired
//       with a zero block).
// Per chunk, the halo'd input tile ([row][col] of 16-byte pixels: eight
// neighbouring pixels are 128 contiguous bytes, so ldmatrix's row addresses
// never share a bank) and the chunk's weights, pre-packed by the wrapper in
// mma B-fragment order, go to shared memory with cp.async (zero-fill for the
// SAME padding), double-buffered so chunk c+1 loads while chunk c computes.
// A chunk whose input's pixel stride is not 16-byte aligned (the 3-channel
// diff image, odd test widths) is loaded element by element instead, zero
// past its channels. Each lane hands ldmatrix the address of its own pixel
// (y+dy, x+dx) in the tile, so the A operand is read straight from the halo.
// Bias, exact GELU (erff) and one rounding to the output type happen in
// registers; the results are stored from the accumulator fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int TH = 16;        // output rows per block
constexpr int TW = 32;        // output columns per block
constexpr int WARPS = 8;      // each: two rows = four m16 tiles
constexpr int THREADS = WARPS * 32;
constexpr int MT = 4;         // m16 tiles per warp
constexpr int CHUNK = 8;      // channels per K chunk (16 bytes of bf16)
constexpr int FRAG = 256;     // bytes of one k16 x n8 B fragment (32 lanes x 8)

struct Input {
    const __nv_bfloat16* p;   // [B][H][W][C]
    int C;
    int chunks;               // ceil(C / 8)
    int aligned;              // C % 8 == 0 and p 16-byte aligned: cp.async
};

template <int K, int NT>
struct Tile {
    static constexpr int R = K / 2;
    static constexpr int HH = TH + K - 1;                 // halo rows
    static constexpr int HW = TW + K - 1;                 // halo columns
    static constexpr int HALO_BYTES = HH * HW * 16;
    static constexpr int STEPS = (K * K + 1) / 2;         // k16 steps a chunk
    static constexpr int W_BYTES = STEPS * NT * FRAG;     // weights a chunk
    static constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
    static constexpr int SMEM_BYTES = 2 * STAGE_BYTES + 16;  // + zero block
};

// Stage `stage` <- chunk g: the halo'd input tile and the chunk's weights.
template <int K, int NT>
__device__ __forceinline__ void load_chunk(
        uint8_t* smem, int stage, int g, const Input& in1, const Input& in2,
        const uint8_t* __restrict__ wq, int b, int y0, int x0, int H, int W) {
    using T = Tile<K, NT>;
    const int tid = threadIdx.x;
    uint8_t* halo = smem + stage * T::STAGE_BYTES;
    // field by field: a reference to either kernel parameter would copy
    // both to local memory
    const bool first = g < in1.chunks;
    const __nv_bfloat16* base = first ? in1.p : in2.p;
    const int C = first ? in1.C : in2.C;
    const int c0 = (first ? g : g - in1.chunks) * CHUNK;
    const __nv_bfloat16* src = base + (size_t)b * H * W * C;

    if (first ? in1.aligned : in2.aligned) {
        for (int i = tid; i < T::HH * T::HW; i += THREADS) {
            const int gy = y0 + i / T::HW - T::R;
            const int gx = x0 + i % T::HW - T::R;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const __nv_bfloat16* p =
                inside ? src + ((size_t)gy * W + gx) * C + c0 : base;
            lm::cp_async16(lm::smem_addr(halo + i * 16), p, inside ? 16 : 0);
        }
    } else {
        for (int i = tid; i < T::HH * T::HW; i += THREADS) {
            const int gy = y0 + i / T::HW - T::R;
            const int gx = x0 + i % T::HW - T::R;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const __nv_bfloat16* p = src + ((size_t)gy * W + gx) * C + c0;
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + 2 * j;
                uint16_t lo = 0, hi = 0;
                if (inside && c < C)
                    lo = __bfloat16_as_ushort(p[2 * j]);
                if (inside && c + 1 < C)
                    hi = __bfloat16_as_ushort(p[2 * j + 1]);
                v[j] = (uint32_t)lo | ((uint32_t)hi << 16);
            }
            *reinterpret_cast<uint4*>(halo + i * 16) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
    }
    const uint8_t* wsrc = wq + (size_t)g * T::W_BYTES;
    uint8_t* wdst = halo + T::HALO_BYTES;
    for (int i = tid; i < T::W_BYTES / 16; i += THREADS)
        lm::cp_async16(lm::smem_addr(wdst + i * 16), wsrc + i * 16, 16);
}

template <int K, int NT>
__global__ void __launch_bounds__(THREADS, 2)
conv_igemm_kernel(Input in1, Input in2,
                  const uint8_t* __restrict__ wpack,  // [groups][G][STEPS][NT][32][4] bf16
                  const float* __restrict__ bias,     // [N]
                  void* __restrict__ out,             // [B][H][W][N]
                  int H, int W, int N, int groups, int gelu, int out_f32) {
    using T = Tile<K, NT>;
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.z / groups;
    const int q = blockIdx.z % groups;
    const int y0 = blockIdx.y * TH;
    const int x0 = blockIdx.x * TW;
    const int G = in1.chunks + in2.chunks;
    const uint8_t* wq = wpack + (size_t)q * G * T::W_BYTES;

    uint8_t* zero = smem + 2 * T::STAGE_BYTES;
    if (threadIdx.x == 0)
        *reinterpret_cast<uint4*>(zero) = make_uint4(0, 0, 0, 0);
    const uint32_t zero_s = lm::smem_addr(zero);

    // ldmatrix.x4 of an m16 x k16 A tile: lane l addresses row l % 8 of
    // matrix l / 8; matrices 0/1 are pixels 0-7/8-15 of tap 2s (k 0-7),
    // matrices 2/3 the same pixels of tap 2s+1 (k 8-15)
    const int mat = lane >> 3;
    const int slot = mat >> 1;
    const int pix = (lane & 7) + ((mat & 1) << 3);
    uint32_t lane_off[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
        lane_off[i] = ((2 * warp + (i >> 1)) * T::HW + 16 * (i & 1) + pix) * 16;

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.0f;

    load_chunk<K, NT>(smem, 0, 0, in1, in2, wq, b, y0, x0, H, W);
    lm::cp_async_commit();
    for (int g = 0; g < G; ++g) {
        if (g + 1 < G) {
            load_chunk<K, NT>(smem, (g + 1) & 1, g + 1, in1, in2, wq, b, y0,
                              x0, H, W);
            lm::cp_async_commit();
            lm::cp_async_wait<1>();
        } else {
            lm::cp_async_wait<0>();
        }
        __syncthreads();

        const uint32_t halo_s = lm::smem_addr(smem + (g & 1) * T::STAGE_BYTES);
        const uint32_t w_s = halo_s + T::HALO_BYTES + lane * 8;
#pragma unroll
        for (int s = 0; s < T::STEPS; ++s) {
            // taps 2s (slot 0) and 2s+1 (slot 1); an odd last tap pairs with
            // the zero block
            const int t0 = 2 * s, t1 = 2 * s + 1;
            const uint32_t off0 = ((t0 / K) * T::HW + t0 % K) * 16;
            const uint32_t off1 = ((t1 / K) * T::HW + t1 % K) * 16;
            const bool real = slot == 0 || t1 < K * K;
            const uint32_t tap_off = slot ? off1 : off0;
            uint32_t bf[NT][2];
#pragma unroll
            for (int t = 0; t < NT; ++t) lm::lds64(w_s + (s * NT + t) * FRAG, bf[t]);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                uint32_t af[4];
                lm::ldmatrix_x4(real ? halo_s + lane_off[i] + tap_off : zero_s,
                                af);
#pragma unroll
                for (int t = 0; t < NT; ++t) lm::mma_bf16_16816(acc[i][t], af, bf[t]);
            }
        }
        __syncthreads();
    }

    // accumulator fragment: c0,c1 = pixel lane/4, channels 2*(lane%4)+{0,1}
    // of the n8 tile; c2,c3 = pixel lane/4 + 8, the same channels
    const int n_base = q * NT * 8 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
        const int oy = y0 + 2 * warp + (i >> 1);
        if (oy >= H) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int ox = x0 + 16 * (i & 1) + (lane >> 2) + 8 * half;
            if (ox >= W) continue;
            const size_t base = (((size_t)b * H + oy) * W + ox) * N;
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                const int n = n_base + 8 * t;
                float r[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    r[e] = acc[i][t][2 * half + e] + (n + e < N ? bias[n + e] : 0.0f);
                    if (gelu) r[e] = 0.5f * r[e] * (1.0f + erff(r[e] * 0.70710678118654752f));
                }
                if (out_f32) {
                    float* o = static_cast<float*>(out) + base;
                    if (n < N) o[n] = r[0];
                    if (n + 1 < N) o[n + 1] = r[1];
                } else {
                    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + base;
                    if (n + 1 < N && (N & 1) == 0) {
                        *reinterpret_cast<__nv_bfloat162*>(o + n) =
                            __floats2bfloat162_rn(r[0], r[1]);
                    } else {
                        if (n < N) o[n] = __float2bfloat16(r[0]);
                        if (n + 1 < N) o[n + 1] = __float2bfloat16(r[1]);
                    }
                }
            }
        }
    }
}

template <int K, int NT>
int launch(const Input& in1, const Input& in2, const uint8_t* wpack,
           const float* bias, void* out, int B, int H, int W, int N,
           int gelu, int out_f32, cudaStream_t stream) {
    using T = Tile<K, NT>;
    const cudaError_t attr = cudaFuncSetAttribute(
        conv_igemm_kernel<K, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM_BYTES);
    if (attr != cudaSuccess) return (int)attr;
    const int groups = (N + NT * 8 - 1) / (NT * 8);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * groups);
    conv_igemm_kernel<K, NT><<<grid, THREADS, T::SMEM_BYTES, stream>>>(
        in1, in2, wpack, bias, out, H, W, N, groups, gelu, out_f32);
    return (int)cudaGetLastError();
}

template <int K>
int launch_k(int nt, const Input& in1, const Input& in2, const uint8_t* wpack,
             const float* bias, void* out, int B, int H, int W, int N,
             int gelu, int out_f32, cudaStream_t s) {
    switch (nt) {
        case 1: return launch<K, 1>(in1, in2, wpack, bias, out, B, H, W, N, gelu, out_f32, s);
        case 2: return launch<K, 2>(in1, in2, wpack, bias, out, B, H, W, N, gelu, out_f32, s);
        case 4: return launch<K, 4>(in1, in2, wpack, bias, out, B, H, W, N, gelu, out_f32, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

Input make_input(const void* p, int C) {
    Input in;
    in.p = static_cast<const __nv_bfloat16*>(p);
    in.C = C;
    in.chunks = (C + CHUNK - 1) / CHUNK;
    in.aligned = C % CHUNK == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    return in;
}

}  // namespace

// x: bf16 [B, H, W, C1]; x2: bf16 [B, H, W, C2] or NULL with C2 = 0, read as
// channels C1.. of the input; wpack: the bf16 weights in B-fragment order
// (lecturemath_tpu_torch/ops/conv7.py pack_weights with the same nt); bias:
// f32 [N]; out: [B, H, W, N], f32 when out_f32 else bf16. k odd, 1 <= k <=
// 7; nt (n8 tiles a group of output channels) 1, 2 or 4. Returns the CUDA
// error code of the launch (0 on success), or cudaErrorInvalidValue for a k
// or nt the kernel was not built for.
extern "C" int lm_conv_same_nhwc(const void* x, int C1, const void* x2,
                                 int C2, const void* wpack, const float* bias,
                                 void* out, int B, int H, int W, int N, int k,
                                 int nt, int gelu, int out_f32, void* stream) {
    if (B == 0 || H == 0 || W == 0) return 0;
    if (C1 <= 0 || C2 < 0 || (C2 > 0 && x2 == nullptr))
        return (int)cudaErrorInvalidValue;
    const Input in1 = make_input(x, C1);
    const Input in2 = make_input(C2 > 0 ? x2 : x, C2);
    const uint8_t* w = static_cast<const uint8_t*>(wpack);
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return launch_k<1>(nt, in1, in2, w, bias, out, B, H, W, N, gelu, out_f32, s);
        case 3: return launch_k<3>(nt, in1, in2, w, bias, out, B, H, W, N, gelu, out_f32, s);
        case 5: return launch_k<5>(nt, in1, in2, w, bias, out, B, H, W, N, gelu, out_f32, s);
        case 7: return launch_k<7>(nt, in1, in2, w, bias, out, B, H, W, N, gelu, out_f32, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
