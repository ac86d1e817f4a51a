// lecturemath_native: host-side runtime kernels for the TPU-native
// lecture-summarization framework.
//
// Replaces the reference's C helpers (reference: accessmath_lib.c — ctypes
// CC_AgeBoundaries / adapthisteq / combine_results) with a C++ library that
// fuses the whole host-side CC path:
//   * label_and_stats: one call does union-find connected-component labeling
//     (4-connectivity, scipy-compatible raster numbering) AND per-component
//     bbox/size/min-age extraction, instead of scipy.label + a second pass
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
#include <vector>

namespace {

struct UnionFind {
    std::vector<int32_t> parent;

    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }

    int32_t find(int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }

    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;
    }
};

}  // namespace

extern "C" {

// Label a binary image (nonzero = foreground, 4-connectivity) and emit
// per-component stats in one pass.
//
// labels_out:  int32 [h*w], 0 = background, components numbered 1..n in
//              raster order of their first pixel (scipy.ndimage.label order)
// stats_out:   int32 [max_components * 5] = min_x, max_x, min_y, max_y, size
// ages_out:    float [max_components] = min age per component (ages may be null)
// Returns the component count (clamped to max_components; extra components
// are labeled but their stats are dropped).
int32_t label_and_stats(const uint8_t* binary, int32_t height, int32_t width,
                        const float* ages, int32_t* labels_out,
                        int32_t* stats_out, float* ages_out,
                        int32_t max_components) {
    const int64_t n_pixels = static_cast<int64_t>(height) * width;

    // pass 1: provisional labels with union on left/up neighbors
    std::vector<int32_t> provisional(n_pixels, -1);
    UnionFind uf(0);
    uf.parent.reserve(1024);
    int32_t next_label = 0;

    for (int32_t y = 0; y < height; ++y) {
        const uint8_t* row = binary + static_cast<int64_t>(y) * width;
        int32_t* prov_row = provisional.data() + static_cast<int64_t>(y) * width;
        const int32_t* prov_up =
            (y > 0) ? prov_row - width : nullptr;
        for (int32_t x = 0; x < width; ++x) {
            if (!row[x]) continue;
            int32_t left = (x > 0 && row[x - 1]) ? prov_row[x - 1] : -1;
            int32_t up = (prov_up && binary[(static_cast<int64_t>(y) - 1) * width + x])
                             ? prov_up[x] : -1;
            if (left < 0 && up < 0) {
                prov_row[x] = next_label;
                uf.parent.push_back(next_label);
                ++next_label;
            } else if (left >= 0 && up >= 0) {
                prov_row[x] = left;
                uf.unite(left, up);
            } else {
                prov_row[x] = (left >= 0) ? left : up;
            }
        }
    }

    // pass 2: compact roots to 1..n in raster-first-pixel order + stats
    std::vector<int32_t> compact(next_label, 0);
    int32_t n_components = 0;

    for (int64_t i = 0; i < n_pixels; ++i) {
        int32_t prov = provisional[i];
        if (prov < 0) {
            labels_out[i] = 0;
            continue;
        }
        int32_t root = uf.find(prov);
        int32_t label = compact[root];
        if (label == 0) {
            label = ++n_components;
            compact[root] = label;
            if (label <= max_components) {
                int32_t* stats = stats_out + static_cast<int64_t>(label - 1) * 5;
                stats[0] = width;   // min_x
                stats[1] = -1;      // max_x
                stats[2] = height;  // min_y
                stats[3] = -1;      // max_y
                stats[4] = 0;       // size
                if (ages_out) ages_out[label - 1] = 3.0e38f;
            }
        }
        labels_out[i] = label;

        if (label <= max_components) {
            const int32_t x = static_cast<int32_t>(i % width);
            const int32_t y = static_cast<int32_t>(i / width);
            int32_t* stats = stats_out + static_cast<int64_t>(label - 1) * 5;
            if (x < stats[0]) stats[0] = x;
            if (x > stats[1]) stats[1] = x;
            if (y < stats[2]) stats[2] = y;
            if (y > stats[3]) stats[3] = y;
            ++stats[4];
            if (ages && ages_out) {
                const float age = ages[i];
                if (age < ages_out[label - 1]) ages_out[label - 1] = age;
            }
        }
    }

    return n_components;
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
