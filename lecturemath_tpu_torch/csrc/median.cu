// K4: cv2.medianBlur's exact median of a uint8 batch [B, H, W, C] with an
// odd window k (3 to 255): the value of rank k*k / 2 in each k x k window,
// each channel on its own, rows and columns past the crop's edge
// replicated (the contract of native.median_u8).
//
// Replaces no TPU kernel: the JAX package makes the reconstruction
// pretraining's median targets with cv2.medianBlur on the host, one crop at
// a time, as the port did on its batch prefetch thread (native.median_u8,
// 27-31 ms a 256x256x3 crop at k = 35). Here a whole batch is one launch.
//
// The training data's median targets take the float32 m / 127.5 - 1 of
// each median straight from the kernel, from crops that K5 left on the card.
//
// Bound on the H100: the function reads 1 B and writes 1 B a pixel, 3.1 MB
// for [8, 256, 256, 3], 0.94 us at 3.35 TB/s; what takes the time is the
// k*k values each output ranks. Huang's sliding histogram cuts that to 2k
// histogram updates an output (70 at k = 35): a thread owns one output
// column (image, x, channel) over a strip of STRIP rows and walks down it,
// each row step removing the k values of the row that leaves the window and
// adding the k of the row that enters, then moving the median pointer and
// the count of values below it as native.median_u8 does. The walk's
// direction does not change the answer: the pointer stops at the least
// value whose count of values at or below it passes the rank.
//   A thread's 256 bins are 16-bit counts in shared memory (k*k <= 65025),
//   a block of two warps holds 32 KB, so seven blocks share an SM. Lane l of
//   warp w keeps bin v in the half-word v*64 + 2l + w: every lane reads and
//   writes its own bank whatever value it counts, and no bin is shared, so
//   there are no atomics. Reads of the crop go through the read-only cache;
//   neighbouring lanes hold neighbouring (x, channel) columns, so a warp's
//   load of one window position covers 32 contiguous bytes of a row. The
//   strip of 32 rows keeps every thread of a [8, 256, 256, 3] batch resident
//   at once (49,152 threads) at the cost of a k x k histogram to fill per
//   strip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // two warps
constexpr int STRIP = 32;    // output rows a thread walks down

__device__ __forceinline__ int clamp_to(int v, int hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ void store(uint8_t* dst, float* unit,
                                      long long at, int m) {
    if (unit)  // x / 127.5 - 1, rounded as numpy's float32 does
        unit[at] = __fsub_rn(__fdiv_rn((float)m, 127.5f), 1.0f);
    else
        dst[at] = (uint8_t)m;
}

__global__ void __launch_bounds__(THREADS)
median_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
              float* __restrict__ unit, int height, int width, int channels,
              int ksize, int strips, long long columns) {
    __shared__ uint16_t hist[256 * THREADS];
    const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (gid >= columns) return;
    const int row_bytes = width * channels;
    const int col = (int)(gid % row_bytes);
    const long long rest = gid / row_bytes;
    const int strip = (int)(rest % strips);
    const long long image = rest / strips;
    const int x = col / channels;
    const uint8_t* img = src + image * height * row_bytes + (col - x * channels);
    const long long out = image * height * row_bytes + col;
    uint16_t* bins = hist + (threadIdx.x & 31) * 2 + (threadIdx.x >> 5);
    for (int v = 0; v < 256; ++v) bins[v * THREADS] = 0;

    const int r = ksize / 2, rank = ksize * ksize / 2;
    const int y0 = strip * STRIP, y1 = min(height, y0 + STRIP);
    for (int dy = -r; dy <= r; ++dy) {
        const uint8_t* row = img + (long long)clamp_to(y0 + dy, height - 1)
                                   * row_bytes;
        for (int dx = -r; dx <= r; ++dx)
            ++bins[__ldg(row + clamp_to(x + dx, width - 1) * channels)
                   * THREADS];
    }
    int m = 0, below = 0;  // the median, and the count of values under it
    while (below + bins[m * THREADS] <= rank) below += bins[m++ * THREADS];
    store(dst, unit, out + (long long)y0 * row_bytes, m);

    for (int y = y0 + 1; y < y1; ++y) {
        const uint8_t* leaving = img + (long long)clamp_to(y - 1 - r, height - 1)
                                       * row_bytes;
        const uint8_t* entering = img + (long long)clamp_to(y + r, height - 1)
                                        * row_bytes;
        for (int dx = -r; dx <= r; ++dx) {
            const int at = clamp_to(x + dx, width - 1) * channels;
            const int gone = __ldg(leaving + at), come = __ldg(entering + at);
            --bins[gone * THREADS];
            below -= gone < m;
            ++bins[come * THREADS];
            below += come < m;
        }
        while (below > rank) below -= bins[--m * THREADS];
        while (below + bins[m * THREADS] <= rank) below += bins[m++ * THREADS];
        store(dst, unit, out + (long long)y * row_bytes, m);
    }
}

}  // namespace

// src: contiguous uint8 [batch, height, width, channels] on the card; the
// medians go to dst, of the same shape and type, or where unit is not null
// to it as float32 m / 127.5 - 1 (the training data's median targets);
// ksize odd, 3 to 255 (the wrapper checks). Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int lm_median_u8(const uint8_t* src, uint8_t* dst, float* unit,
                            int batch, int height, int width, int channels,
                            int ksize, void* stream) {
    if (batch == 0 || height == 0 || width == 0 || channels == 0) return 0;
    const int strips = (height + STRIP - 1) / STRIP;
    const long long columns = (long long)batch * strips * width * channels;
    const long long blocks = (columns + THREADS - 1) / THREADS;
    median_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        src, dst, unit, height, width, channels, ksize, strips, columns);
    return (int)cudaGetLastError();
}
