// Stage-01 tail: f32 logits -> sigmoid -> x255 -> truncate -> >= threshold
// -> MSB-first packed bitmap, cropped to the frame.
//
// Replaces lecturemath_tpu/ops/pallas_postprocess.py:25 _postprocess_kernel
// (pallas_call at :43), fused with the [:h, :w] crop and pack_bits
// (lecturemath_tpu/models/fcn_lecturenet.py:965, 1058-1060): the whole tail
// of make_packed_binarizer in one pass.
//
// Bound on the H100: bytes. A 960x540 frame reads 960*540*4 B of logits and
// writes 540*120 B of bits, about 2.15 MB, so 0.64 us per frame at 3.35 TB/s;
// the arithmetic (one expf and a few flops per pixel) is far below the
// card's rate. Design: one thread per output byte reads its eight logits
// (two 16-byte loads where the row allows it, so neighbouring threads read
// neighbouring 32-byte spans), and writes one byte: the logits are read once
// and nothing but the packed bits is written. Padding bits past w stay 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int pixel_bit(float logit, int threshold) {
    // the same f32 operation order as the plain version: sigmoid, x255,
    // truncation toward zero (not rounding), compare
    float p = 1.0f / (1.0f + expf(-logit));
    int scaled = (int)(p * 255.0f);
    return scaled >= threshold;
}

__global__ void threshold_pack_kernel(const float* __restrict__ logits,
                                      uint8_t* __restrict__ out,
                                      long long total, int h, int hp, int wp,
                                      int w, int wb, int threshold,
                                      int vector_loads) {
    long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    int j = (int)(idx % wb);
    long long row = idx / wb;
    int b = (int)(row / h);
    int r = (int)(row % h);
    const float* src = logits + ((long long)b * hp + r) * wp + 8LL * j;
    int valid = min(8, w - 8 * j);

    float v[8];
    if (vector_loads && valid == 8) {
        float4 lo = reinterpret_cast<const float4*>(src)[0];
        float4 hi = reinterpret_cast<const float4*>(src)[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = i < valid ? src[i] : 0.0f;
    }

    unsigned byte = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (i < valid && pixel_bit(v[i], threshold)) byte |= 0x80u >> i;
    }
    out[idx] = (uint8_t)byte;
}

}  // namespace

// logits: f32 [batch, hp, wp] contiguous; out: u8 [batch, h, ceil(w/8)].
// Returns the CUDA error code of the launch (0 on success).
extern "C" int lm_threshold_pack(const float* logits, uint8_t* out, int batch,
                                 int hp, int wp, int h, int w, int threshold,
                                 void* stream) {
    int wb = (w + 7) / 8;
    long long total = (long long)batch * h * wb;
    if (total == 0) return 0;
    // 16-byte loads need 16-byte aligned rows: wp % 4 == 0 and an aligned base
    int vector_loads = (wp % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(logits) % 16 == 0);
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    threshold_pack_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        logits, out, total, h, hp, wp, w, wb, threshold, vector_loads);
    return (int)cudaGetLastError();
}
