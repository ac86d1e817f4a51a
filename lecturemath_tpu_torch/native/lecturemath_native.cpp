// lecturemath_native: host-side runtime kernels for the TPU-native
// lecture-summarization framework.
//
// Replaces the reference's C helpers (reference: accessmath_lib.c — ctypes
// CC_AgeBoundaries / adapthisteq / combine_results) with a C++ library that
// fuses the whole host-side CC path:
//   * cc_runs_label / cc_runs_take: connected-component labeling by runs of
//     ink (4-connectivity, scipy-compatible raster numbering), each
//     component's bbox/size/min age, and each kept component's crop, in
//     one call that makes no frame-sized buffer
//   * batch_mask_overlap: matched-pixel counts for a list of candidate CC
//     pairs over packed mask crops (the tracker / grouping hot loop)
//   * render_masks: paint packed CC crops back onto a frame
//   * png_unfilter: undo PNG row filters (Avg and Paeth are sequential
//     along a row, so numpy cannot do them a row at a time)
//   * resample_u8: one pass of Pillow's fixed-point separable resample
//     (stage 01's LANCZOS halving above the pixel cap)
//   * median_u8: cv2.medianBlur's exact median with a replicated border
//     (the reconstruction pretraining's k=35 targets), by a sliding
//     histogram
//
// Build: g++ -O3 -march=native -shared -fPIC lecturemath_native.cpp -o liblecturemath_native.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the run scan reads a row's bytes a little-endian word at a time");

namespace {

// One frame's labelled components, held between cc_runs_label and
// cc_runs_take.
struct CCRuns {
    std::vector<int32_t> stats;   // [stored * 5] min_x, max_x, min_y, max_y, size
    std::vector<float> min_ages;  // [stored] where ages were given
    std::vector<uint8_t> crops;   // kept components' crops, 0/255, packed
};

inline uint64_t load_word(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, sizeof v);
    return v;
}

// The first nonzero byte of the row at or after x (width if none).
inline int32_t next_ink(const uint8_t* row, int32_t x, int32_t width) {
    // a board row is mostly background: test 32 bytes a step first
    for (; x + 32 <= width; x += 32) {
        if (load_word(row + x) | load_word(row + x + 8) |
            load_word(row + x + 16) | load_word(row + x + 24)) break;
    }
    for (; x + 8 <= width; x += 8) {
        const uint64_t v = load_word(row + x);
        if (v) return x + (__builtin_ctzll(v) >> 3);
    }
    while (x < width && !row[x]) ++x;
    return x;
}

// The first zero byte of the row at or after x (width if none).
inline int32_t next_background(const uint8_t* row, int32_t x, int32_t width) {
    constexpr uint64_t ones = 0x0101010101010101ull;
    constexpr uint64_t highs = 0x8080808080808080ull;
    for (; x + 8 <= width; x += 8) {
        const uint64_t v = load_word(row + x);
        // the lowest set bit marks the lowest zero byte exactly (a borrow
        // can only mark bytes above it)
        const uint64_t zero = (v - ones) & ~v & highs;
        if (zero) return x + (__builtin_ctzll(zero) >> 3);
    }
    while (x < width && row[x]) ++x;
    return x;
}

inline int32_t find_root(int32_t* parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

}  // namespace

extern "C" {

// Label a binary frame (nonzero = ink, 4-connectivity) by its runs of ink.
//
// Each run is unioned with the runs of the row above that share a column
// with it (diagonal contact does not join). A set's root is its lowest run,
// so numbering the roots 1..n in run order numbers the components in the
// raster order of their first pixel (scipy.ndimage.label's order). Every
// component counts; only the first max_components get stats. Each of those
// with at least min_pixels pixels is kept: its runs are painted 255 into
// its own zeroed crop (other components inside its box stay 0), the crops
// packed row-major in label order.
//
// info_out: int64 [4] = components, runs, stored components (at most
// max_components), crop bytes. Returns the result, which cc_runs_take
// copies out and frees, or null when memory runs out. Keeps no state
// between calls, so threads may call it at once.
void* cc_runs_label(const uint8_t* binary, int32_t height, int32_t width,
                    const float* ages, int32_t max_components,
                    int32_t min_pixels, int64_t* info_out) {
    CCRuns* out = nullptr;
    try {
        out = new CCRuns;
        std::vector<int32_t> run_x0, run_end, parent;  // run_end exclusive
        std::vector<int32_t> row_first(static_cast<size_t>(height) + 1);
        run_x0.reserve(4096);
        run_end.reserve(4096);
        parent.reserve(4096);

        // pass 1: each row's runs, unioned with the overlapping runs above
        int32_t above = 0;  // the first run of the row above
        for (int32_t y = 0; y < height; ++y) {
            const uint8_t* row = binary + static_cast<int64_t>(y) * width;
            const int32_t first = static_cast<int32_t>(run_x0.size());
            row_first[y] = first;
            int32_t j = above;
            for (int32_t x = next_ink(row, 0, width); x < width;
                 x = next_ink(row, x, width)) {
                const int32_t start = x;
                x = next_background(row, x, width);
                const int32_t run = static_cast<int32_t>(run_x0.size());
                run_x0.push_back(start);
                run_end.push_back(x);
                parent.push_back(run);
                // runs above that end before this one starts cannot touch
                // it or any later run of this row
                while (j < first && run_end[j] <= start) ++j;
                for (int32_t k = j; k < first && run_x0[k] < x; ++k) {
                    const int32_t a = find_root(parent.data(), k);
                    const int32_t b = find_root(parent.data(), run);
                    if (a < b) parent[b] = a; else parent[a] = b;
                }
            }
            above = first;
        }
        const int32_t n_runs = static_cast<int32_t>(run_x0.size());
        row_first[height] = n_runs;

        // pass 2: number the roots in run order; stats of the stored ones
        std::vector<int32_t> label(n_runs);
        std::vector<int32_t>& stats = out->stats;
        std::vector<float>& min_ages = out->min_ages;
        int32_t n_components = 0;
        for (int32_t y = 0; y < height; ++y) {
            for (int32_t i = row_first[y]; i < row_first[y + 1]; ++i) {
                const int32_t root = find_root(parent.data(), i);
                if (root == i) {
                    label[i] = ++n_components;
                    if (n_components <= max_components) {
                        stats.insert(stats.end(),
                                     {run_x0[i], run_end[i] - 1, y, y, 0});
                        if (ages) min_ages.push_back(3.0e38f);
                    }
                } else {
                    label[i] = label[root];
                }
                const int32_t c = label[i] - 1;
                if (c >= max_components) continue;
                int32_t* s = stats.data() + static_cast<int64_t>(c) * 5;
                s[0] = std::min(s[0], run_x0[i]);
                s[1] = std::max(s[1], run_end[i] - 1);
                s[3] = y;
                s[4] += run_end[i] - run_x0[i];
                if (ages) {
                    const float* a = ages + static_cast<int64_t>(y) * width;
                    float m = min_ages[c];
                    for (int32_t x = run_x0[i]; x < run_end[i]; ++x)
                        if (a[x] < m) m = a[x];
                    min_ages[c] = m;
                }
            }
        }
        const int32_t n_stored = std::min(n_components, max_components);

        // pass 3: each kept component's runs painted into its own crop
        std::vector<int64_t> offset(n_stored, -1);
        int64_t crop_bytes = 0;
        for (int32_t c = 0; c < n_stored; ++c) {
            const int32_t* s = stats.data() + static_cast<int64_t>(c) * 5;
            if (s[4] < min_pixels) continue;
            offset[c] = crop_bytes;
            crop_bytes += static_cast<int64_t>(s[1] - s[0] + 1) * (s[3] - s[2] + 1);
        }
        out->crops.assign(crop_bytes, 0);
        for (int32_t y = 0; y < height; ++y) {
            for (int32_t i = row_first[y]; i < row_first[y + 1]; ++i) {
                const int32_t c = label[i] - 1;
                if (c >= n_stored || offset[c] < 0) continue;
                const int32_t* s = stats.data() + static_cast<int64_t>(c) * 5;
                const int64_t crop_width = s[1] - s[0] + 1;
                std::memset(out->crops.data() + offset[c] +
                                (y - s[2]) * crop_width + (run_x0[i] - s[0]),
                            255, run_end[i] - run_x0[i]);
            }
        }

        info_out[0] = n_components;
        info_out[1] = n_runs;
        info_out[2] = n_stored;
        info_out[3] = crop_bytes;
        return out;
    } catch (const std::bad_alloc&) {
        delete out;
        return nullptr;
    }
}

// Copy cc_runs_label's stats (int32 [stored * 5]), min ages (float
// [stored], where ages were given) and packed crops into the caller's
// buffers, each skipped where null, and free the result.
void cc_runs_take(void* result, int32_t* stats_out, float* ages_out,
                  uint8_t* crops_out) {
    CCRuns* runs = static_cast<CCRuns*>(result);
    if (stats_out)
        std::copy(runs->stats.begin(), runs->stats.end(), stats_out);
    if (ages_out)
        std::copy(runs->min_ages.begin(), runs->min_ages.end(), ages_out);
    if (crops_out)
        std::copy(runs->crops.begin(), runs->crops.end(), crops_out);
    delete runs;
}

// Matched-pixel counts for candidate CC pairs.
//
// Masks are packed: masks_a is the concatenation of all A-side crops
// (uint8 0/255, row-major); offsets_a[i] is the start of crop i; boxes are
// int32 [n * 4] = min_x, max_x, min_y, max_y in frame coordinates.
// pairs: int32 [n_pairs * 2] indices into the A and B sets.
// out_counts: int64 [n_pairs].
void batch_mask_overlap(const uint8_t* masks_a, const int64_t* offsets_a,
                        const int32_t* boxes_a, const uint8_t* masks_b,
                        const int64_t* offsets_b, const int32_t* boxes_b,
                        const int32_t* pairs, int64_t n_pairs,
                        int64_t* out_counts) {
    for (int64_t p = 0; p < n_pairs; ++p) {
        const int32_t ia = pairs[p * 2];
        const int32_t ib = pairs[p * 2 + 1];
        const int32_t* ba = boxes_a + static_cast<int64_t>(ia) * 4;
        const int32_t* bb = boxes_b + static_cast<int64_t>(ib) * 4;

        const int32_t o_min_x = ba[0] > bb[0] ? ba[0] : bb[0];
        const int32_t o_max_x = ba[1] < bb[1] ? ba[1] : bb[1];
        const int32_t o_min_y = ba[2] > bb[2] ? ba[2] : bb[2];
        const int32_t o_max_y = ba[3] < bb[3] ? ba[3] : bb[3];

        if (o_min_x > o_max_x || o_min_y > o_max_y) {
            out_counts[p] = 0;
            continue;
        }

        const int32_t wa = ba[1] - ba[0] + 1;
        const int32_t wb = bb[1] - bb[0] + 1;
        const uint8_t* crop_a = masks_a + offsets_a[ia];
        const uint8_t* crop_b = masks_b + offsets_b[ib];

        int64_t count = 0;
        for (int32_t y = o_min_y; y <= o_max_y; ++y) {
            const uint8_t* row_a =
                crop_a + static_cast<int64_t>(y - ba[2]) * wa + (o_min_x - ba[0]);
            const uint8_t* row_b =
                crop_b + static_cast<int64_t>(y - bb[2]) * wb + (o_min_x - bb[0]);
            const int32_t span = o_max_x - o_min_x + 1;
            for (int32_t x = 0; x < span; ++x) {
                count += (row_a[x] & row_b[x]) ? 1 : 0;
            }
        }
        out_counts[p] = count;
    }
}

// Paint packed CC crops back onto a frame buffer (uint8 additive).
void render_masks(const uint8_t* masks, const int64_t* offsets,
                  const int32_t* boxes, int32_t n_masks, uint8_t* frame,
                  int32_t height, int32_t width) {
    for (int32_t i = 0; i < n_masks; ++i) {
        const int32_t* box = boxes + static_cast<int64_t>(i) * 4;
        const int32_t crop_w = box[1] - box[0] + 1;
        const uint8_t* crop = masks + offsets[i];
        for (int32_t y = box[2]; y <= box[3]; ++y) {
            uint8_t* row = frame + static_cast<int64_t>(y) * width + box[0];
            const uint8_t* crop_row =
                crop + static_cast<int64_t>(y - box[2]) * crop_w;
            for (int32_t x = 0; x < crop_w; ++x) {
                row[x] = static_cast<uint8_t>(row[x] + crop_row[x]);
            }
        }
    }
}

// Undo the row filters of 8-bit PNG scanlines (PNG spec, section 9.2):
// `raw` holds `height` rows of one filter-type byte and `stride` bytes,
// `bpp` bytes a pixel; `out` receives the height x stride pixel bytes.
// Returns -1, or the first row whose filter type is unknown.
int32_t png_unfilter(const uint8_t* raw, int32_t height, int32_t stride,
                     int32_t bpp, uint8_t* out) {
    std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
    for (int32_t y = 0; y < height; ++y) {
        const uint8_t* line = raw + static_cast<int64_t>(y) * (stride + 1);
        const uint8_t kind = *line++;
        uint8_t* recon = out + static_cast<int64_t>(y) * stride;
        const uint8_t* prior = y ? recon - stride : zeros.data();
        switch (kind) {
            case 0:
                std::memcpy(recon, line, static_cast<size_t>(stride));
                break;
            case 1:
                for (int32_t x = 0; x < stride; ++x)
                    recon[x] = static_cast<uint8_t>(
                        line[x] + (x >= bpp ? recon[x - bpp] : 0));
                break;
            case 2:
                for (int32_t x = 0; x < stride; ++x)
                    recon[x] = static_cast<uint8_t>(line[x] + prior[x]);
                break;
            case 3:
                for (int32_t x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? recon[x - bpp] : 0;
                    recon[x] = static_cast<uint8_t>(
                        line[x] + ((left + prior[x]) >> 1));
                }
                break;
            case 4:
                for (int32_t x = 0; x < stride; ++x) {
                    const int left = x >= bpp ? recon[x - bpp] : 0;
                    const int up = prior[x];
                    const int up_left = x >= bpp ? prior[x - bpp] : 0;
                    const int p = left + up - up_left;
                    const int pa = p > left ? p - left : left - p;
                    const int pb = p > up ? p - up : up - p;
                    const int pc = p > up_left ? p - up_left : up_left - p;
                    const int pred = (pa <= pb && pa <= pc) ? left
                                     : (pb <= pc ? up : up_left);
                    recon[x] = static_cast<uint8_t>(line[x] + pred);
                }
                break;
            default:
                return y;
        }
    }
    return -1;
}

// One pass of Pillow's separable 8-bit resample (ImagingResampleHorizontal
// / Vertical_8bpc) along the middle axis of `src` [outer, src_len, inner]
// into `out` [outer, dst_len, inner]: output d sums taps k < ksize of
// source min(first[d] + k, src_len - 1) times weights[d * ksize + k]
// (fixed point, `bits` fractional bits; unused taps weigh 0) in int32 from
// half a unit, and rounds as Pillow's clip8.
void resample_u8(const uint8_t* src, int64_t outer, int32_t src_len,
                 int64_t inner, const int64_t* first, const int32_t* weights,
                 int32_t ksize, int32_t dst_len, int32_t bits, uint8_t* out) {
    if (inner <= 4) {
        // pixels of a row (the horizontal pass): taps outermost per value
        for (int64_t o = 0; o < outer; ++o) {
            const uint8_t* plane = src + o * src_len * inner;
            uint8_t* dst = out + o * dst_len * inner;
            for (int32_t d = 0; d < dst_len; ++d) {
                const int32_t* w = weights + static_cast<int64_t>(d) * ksize;
                for (int64_t i = 0; i < inner; ++i) {
                    int32_t acc = 1 << (bits - 1);
                    for (int32_t k = 0; k < ksize; ++k) {
                        int64_t s = first[d] + k;
                        if (s > src_len - 1) s = src_len - 1;
                        acc += plane[s * inner + i] * w[k];
                    }
                    const int32_t v = acc >> bits;
                    dst[d * inner + i] =
                        static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
                }
            }
        }
        return;
    }
    // whole rows (the vertical pass): one accumulator row, vectorised
    std::vector<int32_t> acc(static_cast<size_t>(inner));
    for (int64_t o = 0; o < outer; ++o) {
        const uint8_t* plane = src + o * src_len * inner;
        for (int32_t d = 0; d < dst_len; ++d) {
            std::fill(acc.begin(), acc.end(), 1 << (bits - 1));
            for (int32_t k = 0; k < ksize; ++k) {
                const int32_t w = weights[static_cast<int64_t>(d) * ksize + k];
                if (w == 0) continue;
                int64_t s = first[d] + k;
                if (s > src_len - 1) s = src_len - 1;
                const uint8_t* row = plane + s * inner;
                for (int64_t i = 0; i < inner; ++i) acc[i] += row[i] * w;
            }
            uint8_t* dst = out + (o * dst_len + d) * inner;
            for (int64_t i = 0; i < inner; ++i) {
                const int32_t v = acc[i] >> bits;
                dst[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
            }
        }
    }
}

// cv2.medianBlur of uint8 `src` [height, width, channels] with an odd
// `ksize`: the exact median (rank ksize^2 / 2) of each ksize x ksize window,
// rows and columns past the image replicated, each channel on its own.
// Huang's sliding histogram along each row, the median tracked by a
// pointer and the count of values below it.
void median_u8(const uint8_t* src, int32_t height, int32_t width,
               int32_t channels, int32_t ksize, uint8_t* out) {
    const int32_t r = ksize / 2;
    const int32_t rank = ksize * ksize / 2;
    auto clamp = [](int32_t v, int32_t hi) {
        return v < 0 ? 0 : (v > hi ? hi : v);
    };
    auto at = [&](int32_t y, int32_t x, int32_t c) {
        return src[(static_cast<int64_t>(clamp(y, height - 1)) * width
                    + clamp(x, width - 1)) * channels + c];
    };
    for (int32_t c = 0; c < channels; ++c) {
        for (int32_t y = 0; y < height; ++y) {
            int32_t hist[256] = {0};
            for (int32_t dy = -r; dy <= r; ++dy)
                for (int32_t dx = -r; dx <= r; ++dx) ++hist[at(y + dy, dx, c)];
            int32_t m = 0, below = 0;
            for (int32_t x = 0; x < width; ++x) {
                if (x > 0) {
                    for (int32_t dy = -r; dy <= r; ++dy) {
                        const int32_t gone = at(y + dy, x - 1 - r, c);
                        const int32_t come = at(y + dy, x + r, c);
                        --hist[gone];
                        if (gone < m) --below;
                        ++hist[come];
                        if (come < m) ++below;
                    }
                }
                while (below > rank) below -= hist[--m];
                while (below + hist[m] <= rank) below += hist[m++];
                out[(static_cast<int64_t>(y) * width + x) * channels + c] =
                    static_cast<uint8_t>(m);
            }
        }
    }
}

}  // extern "C"
