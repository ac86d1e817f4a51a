// K5: a training batch's colour augmentation and targets, one launch a batch.
//
// For uint8 crops [B, H, W, 3] whose draws the host made (train/dataset.py),
// each sample in the host's order (train/augment.py): the inversion 255 - x;
// the hue rotation by the drawn shift (hue_rotate) through OpenCV's 8-bit
// RGB->HSV (12-bit fixed point with its rounded reciprocal tables) and
// float32 HSV->RGB, which truncates in each row's whole blocks of 32 pixels
// and rounds past them; the float64 noise add, clip and truncation
// (add_noise); then the float32 image x / 127.5 - 1 and, where K4 makes
// median targets of them, the uint8 crops. From the uint8 ground truth
// [B, H, W], where there is one: the target gt / 255, the text mask
// (255 - erode(gt, E)) / 255 and the weights 1 + fg_extra where
// erode(gt, E') is 0, E and E' OpenCV's ellipses of side 2e + 1 and 2w + 1,
// pixels outside the crop never winning the minimum. Every rounding is
// spelt out with the _rn intrinsics as numpy rounds it (a product of two
// float32 taken exactly in float64 and rounded once to float32 where the
// host does so), so nvcc's multiply-add contraction changes no value: the
// tests hold K5 to the host functions byte for byte.
//
// Replaces no TPU kernel: the JAX package augments and makes these targets
// with numpy and OpenCV on the host, a sample at a time, as the port did on
// its batch prefetch thread (about 5 ms a 256x256 sample on one core, and
// the interpreter held against the trainer's launches meanwhile).
//
// Bound on the H100: bytes, and at a batch's size the launch. [8, 256, 256,
// 3] with ground truth reads 2.1 MB (crops, truth) and 1.6 MB of float64
// noise a noisy sample, and writes 12.6 MB (the float32 image, target, text
// mask and weights): about 4.4 us at 3.35 TB/s. A block takes a 32 x 64
// tile of one sample with 256 threads.
//   Colour: where a row holds whole 16-pixel groups (W a multiple of 16 and
//   the tile inside the crop) a thread takes 16 pixels with three 16-byte
//   loads and writes them with twelve 16-byte float stores (and three of
//   uint8), neighbouring threads on neighbouring groups; elsewhere a pixel a
//   thread.
//   Erosion: the tile's ground truth with its halo (the largest radius in
//   use) sits in shared memory, 255 outside the crop. As utils/image.py
//   _morphology takes the ellipse row-run by row-run, the run minima of
//   every halo row grow a column pair at a time through the runs' half
//   widths 0, 1, ..., and at each width every output takes the minimum over
//   the kernel rows whose run has that width: 2r + 1 halo reads a run
//   minimum and 2r + 1 run minima an output, where the ellipse itself holds
//   about 0.79 (2r + 1)^2 pixels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;       // rows of a block's tile
constexpr int TILE_W = 64;       // columns of a block's tile
constexpr int THREADS = 256;
constexpr int OUTS = TILE_H * TILE_W / THREADS;  // tile pixels a thread
constexpr int GROUP = 16;        // pixels a thread takes on the vector path
constexpr int MAX_RADIUS = 64;   // the largest erosion radius (ops/augment.py)

// one erosion: the half width of each kernel row dy = -radius..radius
// (radius -1: not made)
struct Erosion {
    int radius;
    int half[2 * MAX_RADIUS + 1];
};

struct Args {
    const uint8_t* images;  // [B, H, W, 3]
    const uint8_t* truths;  // [B, H, W] or null
    const int* params;      // [B, 4]: invert, hue, shift, noise row (-1 none)
    const double* noise;    // [rows, H, W, 3]
    float* image;           // [B, H, W, 3]
    uint8_t* crops;         // [B, H, W, 3] or null
    float* target;          // [B, H, W] or null
    float* text_mask;       // [B, H, W] or null
    float* weights;         // [B, H, W] or null
    double level;
    float heavy;            // the weight of an eroded ink pixel
    int height, width, halo;
    bool vector;            // rows of whole groups on 16-byte boundaries
    Erosion mask, weight;
};

// sectors of OpenCV's HSV2RGB: the (v, v(1-s), v(1-sh), v(1-s(1-h))) entry
// each of b, g, r takes
__constant__ int8_t SECTORS[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                     {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

__device__ __forceinline__ float pick(int k, float t0, float t1, float t2,
                                      float t3) {
    return k == 0 ? t0 : (k == 1 ? t1 : (k == 2 ? t2 : t3));
}

__device__ __forceinline__ int to_u8(float x, bool truncate) {
    const float v = truncate ? truncf(x) : rintf(x);
    return (int)fminf(fmaxf(v, 0.0f), 255.0f);
}

// utils/image.py rgb_to_hsv, the shift, then hsv_to_rgb
__device__ __forceinline__ void rotate_hue(int& r, int& g, int& b, int shift,
                                           bool truncate, const int* sdiv,
                                           const int* hdiv) {
    const int v = max(max(r, g), b);
    const int diff = v - min(min(r, g), b);
    const int s = (diff * sdiv[v] + 2048) >> 12;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + 2048) >> 12;
    if (h < 0) h += 180;
    h = min(max(h, 0), 255);
    h = ((h + shift) % 180 + 180) % 180;

    const float hf = __fmul_rn((float)h, (float)(6.0 / 180.0));
    const float sf = __fmul_rn((float)s, (float)(1.0 / 255.0));
    const float vf = __fmul_rn((float)v, (float)(1.0 / 255.0));
    const float sector = floorf(hf);
    const float frac = __fsub_rn(hf, sector);
    const int k = (int)sector;
    const double s64 = (double)sf;
    const float t1 = __fmul_rn(vf, __fsub_rn(1.0f, sf));
    const float t2 = __fmul_rn(vf, __double2float_rn(
        __dsub_rn(1.0, __dmul_rn(s64, (double)frac))));
    const float t3 = __fmul_rn(vf, __double2float_rn(
        __dsub_rn(1.0, __dmul_rn(s64, (double)__fsub_rn(1.0f, frac)))));
    b = to_u8(__fmul_rn(pick(SECTORS[k][0], vf, t1, t2, t3), 255.0f),
              truncate);
    g = to_u8(__fmul_rn(pick(SECTORS[k][1], vf, t1, t2, t3), 255.0f),
              truncate);
    r = to_u8(__fmul_rn(pick(SECTORS[k][2], vf, t1, t2, t3), 255.0f),
              truncate);
}

// train/augment.py add_noise of one value
__device__ __forceinline__ int noisy(int x, double n, double level) {
    const double v = __dadd_rn((double)x, __dmul_rn(n, level));
    return (int)fmin(fmax(v, 0.0), 255.0);
}

__device__ __forceinline__ float unit(int x) {  // x / 127.5 - 1
    return __fsub_rn(__fdiv_rn((float)x, 127.5f), 1.0f);
}

struct Sample {
    int invert, hue, shift;
    const double* noise;  // the sample's noise, or null
};

// the colour chain of the pixel at column x; `noise` its three values
__device__ __forceinline__ void colour(int& r, int& g, int& b, int x,
                                       const Sample& s, const double* noise,
                                       double level, int vector_end,
                                       const int* sdiv, const int* hdiv) {
    if (s.invert) {
        r = 255 - r;
        g = 255 - g;
        b = 255 - b;
    }
    if (s.hue) rotate_hue(r, g, b, s.shift, x < vector_end, sdiv, hdiv);
    if (noise) {
        r = noisy(r, noise[0], level);
        g = noisy(g, noise[1], level);
        b = noisy(b, noise[2], level);
    }
}

// the erosion of the tile by `e`: acc[j] for the thread's pixel j; g is the
// halo tile (row stride TILE_W + 2 * halo), runs a scratch of its rows
__device__ void erode(const uint8_t* g, uint8_t* runs, int halo,
                      const int* half, int radius, uint8_t (&acc)[OUTS]) {
    const int gw = TILE_W + 2 * halo;
    int widest = 0;
    for (int i = 0; i <= 2 * radius; ++i) widest = max(widest, half[i]);
    const int first = halo - radius, rows = TILE_H + 2 * radius;
#pragma unroll
    for (int j = 0; j < OUTS; ++j) acc[j] = 255;
    for (int w = 0; w <= widest; ++w) {
        __syncthreads();  // the last width's reads are done
        for (int p = threadIdx.x; p < rows * TILE_W; p += THREADS) {
            const int row = first + p / TILE_W, c = p % TILE_W;
            const uint8_t* at = g + row * gw + halo + c;
            uint8_t m = w ? runs[row * TILE_W + c] : 255;
            m = min(m, min(at[-w], at[w]));
            runs[row * TILE_W + c] = m;
        }
        __syncthreads();
        for (int i = 0; i <= 2 * radius; ++i) {
            if (half[i] != w) continue;
            const int dy = i - radius;
#pragma unroll
            for (int j = 0; j < OUTS; ++j) {
                const int p = threadIdx.x + j * THREADS;
                const uint8_t v = runs[(halo + p / TILE_W + dy) * TILE_W
                                       + p % TILE_W];
                acc[j] = min(acc[j], v);
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
augment_kernel(const __grid_constant__ Args a) {
    extern __shared__ uint8_t smem[];
    __shared__ int sdiv[256], hdiv[256];
    __shared__ int mask_half[2 * MAX_RADIUS + 1];
    __shared__ int weight_half[2 * MAX_RADIUS + 1];

    const int height = a.height, width = a.width;
    const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
    const long long b = blockIdx.z;
    const long long plane = (long long)height * width;
    const int* p = a.params + 4 * b;
    Sample s{p[0], p[1], p[2],
             p[3] >= 0 ? a.noise + p[3] * plane * 3 : nullptr};

    if (s.hue) {  // OpenCV's RGB2HSV_b tables
        for (int i = threadIdx.x; i < 256; i += THREADS) {
            sdiv[i] = i ? (int)rint(__ddiv_rn(1044480.0, (double)i)) : 0;
            hdiv[i] = i ? (int)rint(__ddiv_rn(737280.0, 6.0 * i)) : 0;
        }
    }
    for (int i = threadIdx.x; i <= 2 * MAX_RADIUS; i += THREADS) {
        mask_half[i] = a.mask.half[i];
        weight_half[i] = a.weight.half[i];
    }
    __syncthreads();

    // ---- colour
    const int vector_end = width / 32 * 32;
    const uint8_t* src = a.images + b * plane * 3;
    if (a.vector && x0 + TILE_W <= width) {
        const int groups = TILE_H * TILE_W / GROUP;
        for (int q = threadIdx.x; q < groups; q += THREADS) {
            const int y = y0 + q / (TILE_W / GROUP);
            if (y >= height) continue;
            const int x = x0 + q % (TILE_W / GROUP) * GROUP;
            const long long at = ((long long)y * width + x) * 3;
            uint32_t w[12];
            const uint4* in = reinterpret_cast<const uint4*>(src + at);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const uint4 v = in[k];
                w[4 * k] = v.x;
                w[4 * k + 1] = v.y;
                w[4 * k + 2] = v.z;
                w[4 * k + 3] = v.w;
            }
            uint32_t o[12] = {};
            float f[48];
#pragma unroll
            for (int i = 0; i < GROUP; ++i) {
                int c[3];
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) {
                    const int byte = 3 * i + ch;
                    c[ch] = (w[byte >> 2] >> ((byte & 3) * 8)) & 255;
                }
                colour(c[0], c[1], c[2], x + i, s,
                       s.noise ? s.noise + at + 3 * i : nullptr, a.level,
                       vector_end, sdiv, hdiv);
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) {
                    const int byte = 3 * i + ch;
                    o[byte >> 2] |= (uint32_t)c[ch] << ((byte & 3) * 8);
                    f[byte] = unit(c[ch]);
                }
            }
            float4* out = reinterpret_cast<float4*>(a.image + b * plane * 3
                                                    + at);
#pragma unroll
            for (int k = 0; k < 12; ++k)
                out[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2],
                                     f[4 * k + 3]);
            if (a.crops) {
                uint4* kept = reinterpret_cast<uint4*>(a.crops + b * plane * 3
                                                       + at);
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    kept[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                                         o[4 * k + 3]);
            }
        }
    } else {
        for (int q = threadIdx.x; q < TILE_H * TILE_W; q += THREADS) {
            const int y = y0 + q / TILE_W, x = x0 + q % TILE_W;
            if (y >= height || x >= width) continue;
            const long long at = ((long long)y * width + x) * 3;
            int r = src[at], g = src[at + 1], bl = src[at + 2];
            colour(r, g, bl, x, s, s.noise ? s.noise + at : nullptr,
                   a.level, vector_end, sdiv, hdiv);
            float* out = a.image + b * plane * 3 + at;
            out[0] = unit(r);
            out[1] = unit(g);
            out[2] = unit(bl);
            if (a.crops) {
                uint8_t* kept = a.crops + b * plane * 3 + at;
                kept[0] = (uint8_t)r;
                kept[1] = (uint8_t)g;
                kept[2] = (uint8_t)bl;
            }
        }
    }
    if (!a.truths) return;

    // ---- ground truth: the halo tile, 255 outside the crop
    const int halo = a.halo, gw = TILE_W + 2 * halo;
    uint8_t* g = smem;
    uint8_t* runs = smem + (TILE_H + 2 * halo) * gw;
    const uint8_t* truth = a.truths + b * plane;
    for (int q = threadIdx.x; q < (TILE_H + 2 * halo) * gw; q += THREADS) {
        const int y = y0 - halo + q / gw, x = x0 - halo + q % gw;
        g[q] = (y >= 0 && y < height && x >= 0 && x < width)
                   ? truth[(long long)y * width + x] : 255;
    }
    __syncthreads();
    const long long base = b * plane;
    if (a.target) {
#pragma unroll
        for (int j = 0; j < OUTS; ++j) {
            const int q = threadIdx.x + j * THREADS;
            const int y = y0 + q / TILE_W, x = x0 + q % TILE_W;
            if (y < height && x < width)
                a.target[base + (long long)y * width + x] = __fdiv_rn(
                    (float)g[(halo + q / TILE_W) * gw + halo + q % TILE_W],
                    255.0f);
        }
    }
    uint8_t acc[OUTS];
    if (a.text_mask) {
        erode(g, runs, halo, mask_half, a.mask.radius, acc);
#pragma unroll
        for (int j = 0; j < OUTS; ++j) {
            const int q = threadIdx.x + j * THREADS;
            const int y = y0 + q / TILE_W, x = x0 + q % TILE_W;
            if (y < height && x < width)
                a.text_mask[base + (long long)y * width + x] = __fdiv_rn(
                    (float)(255 - acc[j]), 255.0f);
        }
    }
    if (a.weights) {
        erode(g, runs, halo, weight_half, a.weight.radius, acc);
#pragma unroll
        for (int j = 0; j < OUTS; ++j) {
            const int q = threadIdx.x + j * THREADS;
            const int y = y0 + q / TILE_W, x = x0 + q % TILE_W;
            if (y < height && x < width)
                a.weights[base + (long long)y * width + x] =
                    acc[j] == 0 ? a.heavy : 1.0f;
        }
    }
}

void set_erosion(Erosion& e, int radius, const int* half) {
    e.radius = radius;
    for (int i = 0; i <= 2 * MAX_RADIUS; ++i)
        e.half[i] = half && i <= 2 * radius ? half[i] : 0;
}

}  // namespace

// images, truths, params, noise and the outputs: contiguous on the card (the
// wrapper checks); truths, crops, target, text_mask and weights may be null.
// mask_half and weight_half: HOST arrays of 2r + 1 half widths (null: not
// made), r at most 64; they travel with the launch. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int lm_augment(const uint8_t* images, const uint8_t* truths,
                          const int* params, const double* noise,
                          double level, float* image, uint8_t* crops,
                          float* target, float* text_mask, float* weights,
                          float heavy, int mask_radius, const int* mask_half,
                          int weight_radius, const int* weight_half,
                          int batch, int height, int width, void* stream) {
    if (batch == 0 || height == 0 || width == 0) return 0;
    Args a;
    a.images = images;
    a.truths = truths;
    a.params = params;
    a.noise = noise;
    a.image = image;
    a.crops = crops;
    a.target = truths ? target : nullptr;
    a.text_mask = truths && mask_half ? text_mask : nullptr;
    a.weights = truths && weight_half ? weights : nullptr;
    a.level = level;
    a.heavy = heavy;
    a.height = height;
    a.width = width;
    a.vector = width % GROUP == 0
               && (((uintptr_t)images | (uintptr_t)image | (uintptr_t)crops)
                   % 16) == 0;
    set_erosion(a.mask, a.text_mask ? mask_radius : -1, mask_half);
    set_erosion(a.weight, a.weights ? weight_radius : -1, weight_half);
    a.halo = max(0, max(a.mask.radius, a.weight.radius));
    const size_t shared = truths ? (size_t)(TILE_H + 2 * a.halo)
                                       * (2 * TILE_W + 2 * a.halo) : 0;
    const dim3 grid((width + TILE_W - 1) / TILE_W,
                    (height + TILE_H - 1) / TILE_H, batch);
    augment_kernel<<<grid, THREADS, shared, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
