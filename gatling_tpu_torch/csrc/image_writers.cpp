// The per-pixel loops of the image writers (imgio/resample.py,
// quantize.py, gif.py, pcx.py, qoi.py), as Pillow 12.1's C code runs them:
//
// - Resample.c: the two-pass 8-bit resampling (BICUBIC, LANCZOS), its
//   coefficient tables in double and their 22-bit fixed-point rounding, the
//   horizontal pass over the rows the vertical one reads; Convert.c's
//   premultiplication of RGBA around it (rgba2rgbA, rgbA2rgba).
// - Quant.c: the median cut (method 0) over RGB: the pixel hash and its
//   scale, the lists sorted by each channel, the heap of boxes by pixel
//   count, the split at the median of the widest weighted axis, the
//   box averages and the mapping through the sorted distance tables.
// - QuantOctree.c: the fast octree (method 2) over RGBA: the fine and
//   coarse colour cubes, their buckets sorted by count, the lookup cube.
// - GifEncode.c: LZW at 8 bits, a clear code first and whenever the table
//   is full, the rows in interlaced order when asked, 255-byte sub-blocks.
// - PcxEncode.c: the run-length rows of each plane, padded to an even
//   stride.
// - QoiImagePlugin.QoiEncoder: runs, the index, diffs, luma, RGB and RGBA.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Resample.c
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;

double bicubic_filter(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
}

double sinc_filter(double x) {
    if (x == 0.0) return 1.0;
    x = x * M_PI;
    return sin(x) / x;
}

double lanczos_filter(double x) {
    if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
    return 0.0;
}

// precompute_coeffs + normalize_coeffs_8bpc: bounds [out, 2] (first input
// index, count) and the fixed-point coefficients [out, ksize]
int coeffs(int in_size, float in0, float in1, int out_size, int filter, std::vector<int>& bounds,
           std::vector<int32_t>& kk) {
    double (*fn)(double) = filter == 1 ? lanczos_filter : bicubic_filter;
    const double support0 = filter == 1 ? 3.0 : 2.0;
    double scale = (double)(in1 - in0) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = support0 * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;
    std::vector<double> k((size_t)out_size * ksize, 0.0);
    bounds.assign((size_t)out_size * 2, 0);
    for (int xx = 0; xx < out_size; xx++) {
        double center = in0 + (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* kp = &k[(size_t)xx * ksize];
        for (int x = 0; x < xmax; x++) {
            double w = fn((x + xmin - center + 0.5) * ss);
            kp[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; x++)
            if (ww != 0.0) kp[x] /= ww;
        bounds[xx * 2] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    kk.resize(k.size());
    for (size_t i = 0; i < k.size(); i++)
        kk[i] = k[i] < 0 ? (int32_t)(-0.5 + k[i] * (1 << PRECISION_BITS))
                         : (int32_t)(0.5 + k[i] * (1 << PRECISION_BITS));
    return ksize;
}

inline uint8_t clip8(int32_t in) {
    int32_t v = in >> PRECISION_BITS;
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// MULDIV255 of Convert.c's rgba2rgbA, and rgbA2rgba's truncating division
void premultiply(uint8_t* px, int64_t n) {
    for (int64_t i = 0; i < n; i++, px += 4) {
        unsigned a = px[3];
        for (int c = 0; c < 3; c++) {
            unsigned tmp = px[c] * a + 128;
            px[c] = (uint8_t)(((tmp >> 8) + tmp) >> 8);
        }
    }
}

void unpremultiply(uint8_t* px, int64_t n) {
    for (int64_t i = 0; i < n; i++, px += 4) {
        unsigned a = px[3];
        if (a == 255 || a == 0) continue;
        for (int c = 0; c < 3; c++) {
            unsigned v = 255u * px[c] / a;
            px[c] = (uint8_t)(v > 255 ? 255 : v);
        }
    }
}

// ---------------------------------------------------------------------------
// Quant.c: median cut
// ---------------------------------------------------------------------------

inline uint32_t pixel_hash(uint32_t r, uint32_t g, uint32_t b) {
    return (r * 463u) ^ ((g << 8) * 10069u) ^ ((b << 16) * 64997u);
}

struct PixelList {
    PixelList* next[3];
    PixelList* prev[3];
    uint8_t v[3];
    int flag;
    uint32_t count;
};

struct BoxNode {
    BoxNode* l = nullptr;
    BoxNode* r = nullptr;
    PixelList* head[3] = {nullptr, nullptr, nullptr};
    PixelList* tail[3] = {nullptr, nullptr, nullptr};
    int volume = -1;
    uint32_t pixel_count = 0;
};

PixelList* mergesort_pixels(PixelList* head, int i) {
    PixelList *c, *t, *a, *b, *p;
    if (!head || !head->next[i]) {
        if (head) {
            head->next[i] = nullptr;
            head->prev[i] = nullptr;
        }
        return head;
    }
    for (c = t = head; c && t; c = c->next[i], t = (t->next[i]) ? t->next[i]->next[i] : nullptr) {
    }
    if (c) {
        if (c->prev[i]) c->prev[i]->next[i] = nullptr;
        c->prev[i] = nullptr;
    }
    a = mergesort_pixels(head, i);
    b = mergesort_pixels(c, i);
    head = nullptr;
    p = nullptr;
    while (a && b) {
        if (a->v[i] > b->v[i]) {
            c = a;
            a = a->next[i];
        } else {
            c = b;
            b = b->next[i];
        }
        c->prev[i] = p;
        c->next[i] = nullptr;
        if (p) p->next[i] = c;
        p = c;
        if (!head) head = c;
    }
    if (a) {
        c->next[i] = a;
        a->prev[i] = c;
    } else if (b) {
        c->next[i] = b;
        b->prev[i] = c;
    }
    return head;
}

int box_volume(BoxNode* b) {
    if (b->volume >= 0) return b->volume;
    if (!b->head[0]) {
        b->volume = 0;
    } else {
        int rh = b->head[0]->v[0], rl = b->tail[0]->v[0];
        int gh = b->head[1]->v[1], gl = b->tail[1]->v[1];
        int bh = b->head[2]->v[2], bl = b->tail[2]->v[2];
        b->volume = (rh - rl + 1) * (gh - gl + 1) * (bh - bl + 1);
    }
    return b->volume;
}

// QuantHeap.c: a max-heap of boxes by pixel count, 1-based
struct Heap {
    std::vector<BoxNode*> heap{nullptr};
    static int cmp(const BoxNode* a, const BoxNode* b) {
        return (int)a->pixel_count - (int)b->pixel_count;
    }
    bool remove(BoxNode** r) {
        int n = (int)heap.size() - 1;
        if (!n) return false;
        *r = heap[1];
        BoxNode* v = heap[n];
        heap.pop_back();
        n--;
        int k, l;
        for (k = 1; k * 2 <= n; k = l) {
            l = k * 2;
            if (l < n && cmp(heap[l], heap[l + 1]) < 0) l++;
            if (cmp(v, heap[l]) > 0) break;
            heap[k] = heap[l];
        }
        if (n) heap[k] = v;
        return true;
    }
    void add(BoxNode* val) {
        heap.push_back(nullptr);
        int k = (int)heap.size() - 1;
        while (k != 1) {
            if (cmp(val, heap[k / 2]) <= 0) break;
            heap[k] = heap[k / 2];
            k >>= 1;
        }
        heap[k] = val;
    }
};

void split(BoxNode* node, std::vector<BoxNode*>& nodes) {
    int rh = node->head[0]->v[0], rl = node->tail[0]->v[0];
    int gh = node->head[1]->v[1], gl = node->tail[1]->v[1];
    int bh = node->head[2]->v[2], bl = node->tail[2]->v[2];
    int f[3] = {(rh - rl) * 77, (gh - gl) * 150, (bh - bl) * 29};
    int best = f[0], axis = 0;
    for (int i = 1; i < 3; i++)
        if (best < f[i]) {
            best = f[i];
            axis = i;
        }
    // splitlists
    uint32_t left = 0;
    int n_right = 0;
    PixelList* c;
    for (c = node->head[axis]; c;) {
        left += c->count;
        c->flag = 0;
        c = c->next[axis];
        if (left * 2 > node->pixel_count) break;
    }
    if (c) {
        int split_val = c->prev[axis]->v[axis];
        for (; c; c = c->next[axis]) {
            if (split_val != c->v[axis]) break;
            c->flag = 0;
            left += c->count;
        }
    }
    for (; c; c = c->next[axis]) {
        c->flag = 1;
        n_right++;
    }
    if (!n_right) {
        int split_val = node->tail[axis]->v[axis];
        for (c = node->tail[axis]; c; c = c->prev[axis]) {
            if (split_val != c->v[axis]) break;
            c->flag = 1;
            n_right++;
            left -= c->count;
        }
    }
    BoxNode* lb = new BoxNode();
    BoxNode* rb = new BoxNode();
    nodes.push_back(lb);
    nodes.push_back(rb);
    for (int i = 0; i < 3; i++) {
        PixelList *l = nullptr, *r = nullptr, *n;
        for (c = node->head[i]; c; c = n) {
            n = c->next[i];
            if (c->flag) {
                if (r) r->next[i] = c; else rb->head[i] = c;
                c->prev[i] = r;
                r = c;
            } else {
                if (l) l->next[i] = c; else lb->head[i] = c;
                c->prev[i] = l;
                l = c;
            }
        }
        if (l) l->next[i] = nullptr;
        if (r) r->next[i] = nullptr;
        lb->tail[i] = l;
        rb->tail[i] = r;
        node->head[i] = node->tail[i] = nullptr;
    }
    lb->pixel_count = left;
    rb->pixel_count = node->pixel_count - left;
    node->l = lb;
    node->r = rb;
}

void annotate(BoxNode* n, std::unordered_map<uint32_t, uint32_t>& box_of, int scale,
              uint32_t* box) {
    if (n->l && n->r) {
        annotate(n->l, box_of, scale, box);
        annotate(n->r, box_of, scale, box);
        return;
    }
    for (PixelList* p = n->head[0]; p; p = p->next[0])
        box_of[pixel_hash(p->v[0], p->v[1], p->v[2])] = *box;
    if (n->head[0]) (*box)++;
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
    int dr = (int)a[0] - b[0], dg = (int)a[1] - b[1], db = (int)a[2] - b[2];
    return (uint32_t)(dr * dr + dg * dg + db * db);
}

constexpr uint32_t MAX_HASH_ENTRIES = 65536;

// ---------------------------------------------------------------------------
// QuantOctree.c
// ---------------------------------------------------------------------------

struct Bucket {
    uint32_t count = 0;
    uint64_t r = 0, g = 0, b = 0, a = 0;
};

struct Cube {
    unsigned bits[4], width[4], offset[4];
    std::vector<Bucket> buckets;
    Cube(unsigned r, unsigned g, unsigned b, unsigned a) {
        bits[0] = r; bits[1] = g; bits[2] = b; bits[3] = a;
        for (int i = 0; i < 4; i++) width[i] = 1u << bits[i];
        offset[0] = g + b + a;
        offset[1] = b + a;
        offset[2] = a;
        offset[3] = 0;
        buckets.resize((size_t)width[0] * width[1] * width[2] * width[3]);
    }
    size_t pos(unsigned r, unsigned g, unsigned b, unsigned a) const {
        return r << offset[0] | g << offset[1] | b << offset[2] | a << offset[3];
    }
    Bucket& of(const uint8_t* p) {
        return buckets[pos(p[0] >> (8 - bits[0]), p[1] >> (8 - bits[1]), p[2] >> (8 - bits[2]),
                           p[3] >> (8 - bits[3]))];
    }
    size_t used() const {
        size_t n = 0;
        for (const Bucket& b : buckets) n += b.count > 0;
        return n;
    }
};

inline uint8_t clip8i(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void avg_color(const Bucket& b, uint8_t* dst) {
    float count = (float)b.count;
    if (count != 0) {
        dst[0] = clip8i((int)((float)b.r / count));
        dst[1] = clip8i((int)((float)b.g / count));
        dst[2] = clip8i((int)((float)b.b / count));
        dst[3] = clip8i((int)((float)b.a / count));
    } else {
        dst[0] = dst[1] = dst[2] = dst[3] = 0;
    }
}

Cube copy_cube(const Cube& cube, unsigned r, unsigned g, unsigned b, unsigned a) {
    Cube result(r, g, b, a);
    unsigned src_reduce[4] = {0, 0, 0, 0}, dst_reduce[4] = {0, 0, 0, 0}, width[4];
    for (int i = 0; i < 4; i++) {
        if (cube.bits[i] > result.bits[i]) {
            dst_reduce[i] = cube.bits[i] - result.bits[i];
            width[i] = cube.width[i];
        } else {
            src_reduce[i] = result.bits[i] - cube.bits[i];
            width[i] = result.width[i];
        }
    }
    for (unsigned x0 = 0; x0 < width[0]; x0++)
        for (unsigned x1 = 0; x1 < width[1]; x1++)
            for (unsigned x2 = 0; x2 < width[2]; x2++)
                for (unsigned x3 = 0; x3 < width[3]; x3++) {
                    const Bucket& s = cube.buckets[cube.pos(x0 >> src_reduce[0], x1 >> src_reduce[1],
                                                            x2 >> src_reduce[2], x3 >> src_reduce[3])];
                    Bucket& d = result.buckets[result.pos(x0 >> dst_reduce[0], x1 >> dst_reduce[1],
                                                          x2 >> dst_reduce[2], x3 >> dst_reduce[3])];
                    d.count += s.count;
                    d.r += s.r; d.g += s.g; d.b += s.b; d.a += s.a;
                }
    return result;
}

std::vector<Bucket> sorted_palette(const Cube& cube) {
    std::vector<Bucket> out = cube.buckets;
    std::stable_sort(out.begin(), out.end(),
                     [](const Bucket& x, const Bucket& y) { return x.count > y.count; });
    return out;
}

void subtract(Cube& cube, const Bucket* buckets, long n) {
    uint8_t p[4];
    for (long i = 0; i < n; i++) {
        const Bucket& s = buckets[i];
        if (s.count == 0) continue;
        avg_color(s, p);
        Bucket& m = cube.of(p);
        m.count -= s.count;
        m.r -= s.r; m.g -= s.g; m.b -= s.b; m.a -= s.a;
    }
}

void add_lookup(Cube& cube, const std::vector<Bucket>& palette, long n, long offset) {
    uint8_t p[4];
    for (long i = offset + n - 1; i >= offset; i--) {
        avg_color(palette[i], p);
        cube.of(p).count = (uint32_t)i;
    }
}

// ---------------------------------------------------------------------------
// GifEncode.c
// ---------------------------------------------------------------------------

struct BitWriter {
    uint8_t* out;
    int64_t cap, n = 0;
    uint8_t block[255];
    int fill = 0;
    uint32_t acc = 0;
    int nbits = 0;
    bool overflow = false;
    void byte(uint8_t b) {
        block[fill++] = b;
        if (fill == 255) flush_block();
    }
    void flush_block() {
        if (!fill) return;
        if (n + 1 + fill > cap) {
            overflow = true;
        } else {
            out[n++] = (uint8_t)fill;
            memcpy(out + n, block, (size_t)fill);
            n += fill;
        }
        fill = 0;
    }
    void code(uint32_t c, int width) {
        acc |= c << nbits;
        nbits += width;
        while (nbits >= 8) {
            byte((uint8_t)(acc & 0xFF));
            acc >>= 8;
            nbits -= 8;
        }
    }
    void finish() {
        if (nbits > 0) byte((uint8_t)(acc & 0xFF));
        acc = 0;
        nbits = 0;
        flush_block();
    }
};

// ---------------------------------------------------------------------------
// PcxEncode.c
// ---------------------------------------------------------------------------

struct Out {
    uint8_t* p;
    int64_t cap, n = 0;
    bool overflow = false;
    void put(uint8_t b) {
        if (n < cap) p[n++] = b; else overflow = true;
    }
};

}  // namespace

extern "C" {

// Resize src [h, w, c] (c 1, 3 or 4) to dst [oh, ow, c] with Pillow's
// filter (0 BICUBIC, 1 LANCZOS) over the box (0, 0, w, h); `premultiply`:
// an RGBA image goes through "RGBa" as Image.resize takes it.
void gatling_resample(const uint8_t* src, int32_t w, int32_t h, int32_t c, int32_t ow, int32_t oh,
                      int32_t filter, int32_t premul, uint8_t* dst) {
    if (ow == w && oh == h) {  // Image.resize returns a copy
        memcpy(dst, src, (size_t)w * h * c);
        return;
    }
    std::vector<uint8_t> in(src, src + (size_t)w * h * c);
    if (premul) premultiply(in.data(), (int64_t)w * h);
    std::vector<int> bh, bv;
    std::vector<int32_t> kh, kv;
    int ksh = coeffs(w, 0.0f, (float)w, ow, filter, bh, kh);
    int ksv = coeffs(h, 0.0f, (float)h, oh, filter, bv, kv);
    const bool need_h = ow != w, need_v = oh != h;
    int ybox_first = bv[0];
    int ybox_last = bv[(size_t)oh * 2 - 2] + bv[(size_t)oh * 2 - 1];
    std::vector<uint8_t> tmp;
    const uint8_t* cur = in.data();
    int cw = w, ch = h;
    if (need_h) {
        for (int i = 0; i < oh; i++) bv[(size_t)i * 2] -= ybox_first;
        ch = ybox_last - ybox_first;
        tmp.assign((size_t)ow * ch * c, 0);
        for (int yy = 0; yy < ch; yy++) {
            const uint8_t* row = cur + (size_t)(yy + ybox_first) * w * c;
            uint8_t* orow = tmp.data() + (size_t)yy * ow * c;
            for (int xx = 0; xx < ow; xx++) {
                int xmin = bh[(size_t)xx * 2], xmax = bh[(size_t)xx * 2 + 1];
                const int32_t* k = &kh[(size_t)xx * ksh];
                for (int b = 0; b < c; b++) {
                    int32_t ss = 1 << (PRECISION_BITS - 1);
                    for (int x = 0; x < xmax; x++) ss += row[(size_t)(x + xmin) * c + b] * k[x];
                    orow[(size_t)xx * c + b] = clip8(ss);
                }
            }
        }
        cur = tmp.data();
        cw = ow;
    }
    std::vector<uint8_t> res;
    if (need_v) {
        res.assign((size_t)cw * oh * c, 0);
        for (int yy = 0; yy < oh; yy++) {
            int ymin = bv[(size_t)yy * 2], ymax = bv[(size_t)yy * 2 + 1];
            const int32_t* k = &kv[(size_t)yy * ksv];
            uint8_t* orow = res.data() + (size_t)yy * cw * c;
            for (int xx = 0; xx < cw * c; xx++) {
                int32_t ss = 1 << (PRECISION_BITS - 1);
                for (int y = 0; y < ymax; y++) ss += cur[(size_t)(y + ymin) * cw * c + xx] * k[y];
                orow[xx] = clip8(ss);
            }
        }
        cur = res.data();
    }
    memcpy(dst, cur, (size_t)ow * oh * c);
    if (premul) unpremultiply(dst, (int64_t)ow * oh);
}

// Median cut of px [n, 4] (RGB and a byte Pillow ignores) into at most
// `colors` entries: the palette [len, 3] and each pixel's index; returns
// the palette's length.
int32_t gatling_quantize_mediancut(const uint8_t* px, int64_t n, int32_t colors, uint8_t* palette,
                                   uint8_t* index) {
    if (n <= 0) return 0;
    // create_pixel_hash: distinct colours by their hash at the scale; the
    // scale grows while there are more than MAX_HASH_ENTRIES
    int scale = 0;
    std::unordered_map<uint32_t, std::pair<uint32_t, uint32_t>> counts;  // hash -> (rgb, count)
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = px + i * 4;
        uint32_t key = pixel_hash(p[0] >> scale, p[1] >> scale, p[2] >> scale);
        auto it = counts.find(key);
        if (it != counts.end()) {
            it->second.second++;
            continue;
        }
        counts.emplace(key, std::make_pair((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16,
                                           1u));
        while (counts.size() > MAX_HASH_ENTRIES) {
            scale++;
            std::unordered_map<uint32_t, std::pair<uint32_t, uint32_t>> merged;
            for (const auto& kv : counts) {
                uint32_t rgb = kv.second.first;
                uint32_t k2 = pixel_hash((rgb & 0xFF) >> scale, ((rgb >> 8) & 0xFF) >> scale,
                                         ((rgb >> 16) & 0xFF) >> scale);
                auto m = merged.find(k2);
                if (m == merged.end()) merged.emplace(k2, kv.second);
                else m->second.second += kv.second.second;
            }
            counts.swap(merged);
        }
    }
    // the lists of distinct (scaled) colours, sorted by each channel
    std::vector<PixelList> items(counts.size());
    PixelList* hl[3] = {nullptr, nullptr, nullptr};
    size_t j = 0;
    for (const auto& kv : counts) {
        PixelList* p = &items[j++];
        uint32_t rgb = kv.second.first;
        p->v[0] = (uint8_t)((rgb & 0xFF) >> scale);
        p->v[1] = (uint8_t)(((rgb >> 8) & 0xFF) >> scale);
        p->v[2] = (uint8_t)(((rgb >> 16) & 0xFF) >> scale);
        p->flag = 0;
        p->count = kv.second.second;
        for (int i = 0; i < 3; i++) {
            p->next[i] = hl[i];
            p->prev[i] = nullptr;
            if (hl[i]) hl[i]->prev[i] = p;
            hl[i] = p;
        }
    }
    for (int i = 0; i < 3; i++) hl[i] = mergesort_pixels(hl[i], i);
    std::vector<BoxNode*> nodes;
    BoxNode* root = new BoxNode();
    nodes.push_back(root);
    for (int i = 0; i < 3; i++) {
        root->head[i] = hl[i];
        PixelList* t = hl[i];
        while (t && t->next[i]) t = t->next[i];
        root->tail[i] = t;
    }
    root->pixel_count = (uint32_t)n;
    Heap heap;
    heap.add(root);
    int left = colors;
    while (--left) {
        BoxNode* node;
        bool got;
        do {
            got = heap.remove(&node);
        } while (got && box_volume(node) == 1);
        if (!got) break;
        split(node, nodes);
        heap.add(node->l);
        heap.add(node->r);
    }
    std::unordered_map<uint32_t, uint32_t> box_of;
    uint32_t n_entries = 0;
    annotate(root, box_of, scale, &n_entries);
    for (BoxNode* b : nodes) delete b;
    // compute_palette_from_median_cut
    std::vector<uint32_t> sum((size_t)n_entries * 3, 0), cnt(n_entries, 0), box(n);
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = px + i * 4;
        uint32_t e = box_of.at(pixel_hash(p[0] >> scale, p[1] >> scale, p[2] >> scale));
        box[i] = e;
        for (int c = 0; c < 3; c++) sum[(size_t)e * 3 + c] += p[c];
        cnt[e]++;
    }
    std::vector<uint8_t> pal((size_t)n_entries * 3);
    for (uint32_t e = 0; e < n_entries; e++)
        for (int c = 0; c < 3; c++)
            pal[(size_t)e * 3 + c] = (uint8_t)(int)(.5 + (double)sum[(size_t)e * 3 + c] / (double)cnt[e]);
    // build_distance_tables: each entry's others by distance (glibc's
    // qsort is a merge sort here: ties keep their order)
    std::vector<uint32_t> dist((size_t)n_entries * n_entries);
    std::vector<uint32_t> order((size_t)n_entries * n_entries);
    for (uint32_t a = 0; a < n_entries; a++)
        for (uint32_t b = 0; b < n_entries; b++)
            dist[(size_t)a * n_entries + b] = dist2(&pal[(size_t)a * 3], &pal[(size_t)b * 3]);
    for (uint32_t a = 0; a < n_entries; a++) {
        uint32_t* o = &order[(size_t)a * n_entries];
        const uint32_t* d = &dist[(size_t)a * n_entries];
        for (uint32_t b = 0; b < n_entries; b++) o[b] = b;
        std::stable_sort(o, o + n_entries, [d](uint32_t x, uint32_t y) { return d[x] < d[y]; });
    }
    // map_image_pixels_from_median_box, memoised by exact colour
    std::unordered_map<uint32_t, uint32_t> seen;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = px + i * 4;
        uint32_t rgb = (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
        auto it = seen.find(rgb);
        if (it != seen.end()) {
            index[i] = (uint8_t)it->second;
            continue;
        }
        uint32_t own = box[i];
        uint32_t best = dist2(&pal[(size_t)own * 3], p), match = own;
        uint32_t bound = best << 2;
        const uint32_t* o = &order[(size_t)own * n_entries];
        const uint32_t* d = &dist[(size_t)own * n_entries];
        for (uint32_t k = 0; k < n_entries; k++) {
            uint32_t idx = o[k];
            if (d[idx] > bound) break;
            uint32_t dd = dist2(&pal[(size_t)idx * 3], p);
            if (dd < best) {
                best = dd;
                match = idx;
            }
        }
        index[i] = (uint8_t)match;
        seen.emplace(rgb, match);
    }
    memcpy(palette, pal.data(), pal.size());
    return (int32_t)n_entries;
}

// The fast octree of px [n, 4] RGBA into `colors` entries: the palette
// [colors, 4] and each pixel's index; returns `colors`. Pillow's
// ImagingQuantize first gives every fully transparent pixel the colour of
// the first one; the caller passes pixels so prepared.
int32_t gatling_quantize_octree(const uint8_t* px, int64_t n, int32_t colors, uint8_t* palette,
                                uint8_t* index) {
    static const unsigned LEVELS[8] = {3, 4, 3, 3, 2, 2, 2, 2};
    Cube fine(LEVELS[0], LEVELS[1], LEVELS[2], LEVELS[3]);
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = px + i * 4;
        Bucket& b = fine.of(p);
        b.count++;
        b.r += p[0]; b.g += p[1]; b.b += p[2]; b.a += p[3];
    }
    Cube coarse = copy_cube(fine, LEVELS[4], LEVELS[5], LEVELS[6], LEVELS[7]);
    unsigned long n_coarse = coarse.used();
    if (n_coarse > (unsigned long)colors) n_coarse = colors;
    unsigned long n_fine = colors - n_coarse;
    std::vector<Bucket> fine_sorted = sorted_palette(fine);
    subtract(coarse, fine_sorted.data(), (long)n_fine);
    while (n_coarse > coarse.used()) {
        unsigned long done = n_fine;
        n_coarse = coarse.used();
        n_fine = colors - n_coarse;
        subtract(coarse, &fine_sorted[done], (long)(n_fine - done));
    }
    std::vector<Bucket> coarse_sorted = sorted_palette(coarse);
    std::vector<Bucket> pal(n_coarse + n_fine);
    for (unsigned long i = 0; i < n_coarse; i++) pal[i] = coarse_sorted[i];
    for (unsigned long i = 0; i < n_fine; i++) pal[n_coarse + i] = fine_sorted[i];
    Cube coarse_lookup(LEVELS[4], LEVELS[5], LEVELS[6], LEVELS[7]);
    add_lookup(coarse_lookup, pal, (long)n_coarse, 0);
    Cube lookup = copy_cube(coarse_lookup, LEVELS[0], LEVELS[1], LEVELS[2], LEVELS[3]);
    add_lookup(lookup, pal, (long)n_fine, (long)n_coarse);
    for (int64_t i = 0; i < n; i++) index[i] = (uint8_t)lookup.of(px + i * 4).count;
    for (int32_t i = 0; i < colors; i++) avg_color(pal[i], palette + (size_t)i * 4);
    return colors;
}

// GIF LZW of idx [h, w] at 8 bits: the sub-blocks (each a length byte and
// up to 255 bytes), without the terminator; rows in interlaced order when
// `interlace`. Returns the byte count, or -1 if `cap` is too small.
int64_t gatling_gif_lzw_encode(const uint8_t* idx, int32_t w, int32_t h, int32_t interlace,
                               uint8_t* out, int64_t cap) {
    const int bits = 8;
    const uint32_t clear = 1u << bits, eoi = clear + 1;
    BitWriter bw{out, cap};
    std::vector<int32_t> table((size_t)4096 * 256, -1);  // (prefix, byte) -> code
    std::vector<int32_t> touched;
    int width = bits + 1;
    uint32_t next = clear + 2;
    bw.code(clear, width);
    std::vector<int32_t> rows;
    if (interlace) {
        static const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
        for (int p = 0; p < 4; p++)
            for (int y = start[p]; y < h; y += step[p]) rows.push_back(y);
    } else {
        for (int y = 0; y < h; y++) rows.push_back(y);
    }
    int32_t prefix = -1;
    for (int32_t y : rows) {
        const uint8_t* row = idx + (size_t)y * w;
        for (int32_t x = 0; x < w; x++) {
            uint8_t s = row[x];
            if (prefix < 0) {
                prefix = s;
                continue;
            }
            int32_t& slot = table[(size_t)prefix * 256 + s];
            if (slot >= 0) {
                prefix = slot;
                continue;
            }
            bw.code((uint32_t)prefix, width);
            if (next < 4096) {
                slot = (int32_t)next;
                touched.push_back(prefix * 256 + s);
                if (next == (1u << width) && width < 12) width++;
                next++;
            } else {
                bw.code(clear, width);
                for (int32_t t : touched) table[(size_t)t] = -1;
                touched.clear();
                width = bits + 1;
                next = clear + 2;
            }
            prefix = s;
        }
    }
    if (prefix >= 0) bw.code((uint32_t)prefix, width);
    bw.code(eoi, width);
    bw.finish();
    return bw.overflow ? -1 : bw.n;
}

// PCX run-length rows: rows [h, planes * nbytes] (each plane's bytes of a
// row, one after the other), each plane's run then `padding` zeros (the
// even stride). Returns the byte count, or -1 if `cap` is too small.
int64_t gatling_pcx_encode(const uint8_t* rows, int32_t h, int32_t planes, int32_t nbytes,
                           int32_t padding, uint8_t* out, int64_t cap) {
    Out o{out, cap};
    for (int32_t y = 0; y < h; y++) {
        const uint8_t* line = rows + (size_t)y * planes * nbytes;
        int count = 1;
        uint8_t last = line[0];
        int x = 1;
        do {
            while (x % nbytes) {
                if (count == 63) {
                    o.put((uint8_t)(0xC0 | count));
                    o.put(last);
                    count = 0;
                }
                uint8_t cur = line[x];
                if (cur == last) {
                    x++;
                    count++;
                } else {
                    if (count == 1 && last < 0xC0) {
                        o.put(last);
                    } else if (count > 0) {
                        o.put((uint8_t)(0xC0 | count));
                        o.put(last);
                    }
                    last = cur;
                    count = 1;
                    x++;
                }
            }
            if (count == 1 && last < 0xC0) {
                o.put(last);
            } else if (count > 0) {
                o.put((uint8_t)(0xC0 | count));
                o.put(last);
            }
            for (int i = 0; i < padding; i++) o.put(0);
            if (x < planes * nbytes) {
                count = 1;
                last = line[x];
                x++;
            }
        } while (x < planes * nbytes);
    }
    return o.overflow ? -1 : o.n;
}

// QOI ops of px [n, c] (c 3 or 4) as Pillow's QoiEncoder writes them, the
// 8-byte end marker included. Returns the byte count, or -1 if `cap` is
// too small.
int64_t gatling_qoi_encode(const uint8_t* px, int64_t n, int32_t c, uint8_t* out, int64_t cap) {
    Out o{out, cap};
    uint8_t seen[64][4];
    bool has[64] = {false};
    has[0] = true;
    memset(seen, 0, sizeof(seen));
    uint8_t prev[4] = {0, 0, 0, 255};
    int run = 0;
    auto delta = [](int a, int b) {
        int r = (a - b) & 255;
        return r >= 128 ? r - 256 : r;
    };
    for (int64_t i = 0; i < n; i++) {
        uint8_t p[4] = {px[i * c], px[i * c + 1], px[i * c + 2], (uint8_t)(c == 4 ? px[i * c + 3] : 255)};
        if (!memcmp(p, prev, 4)) {
            if (++run == 62) {
                o.put((uint8_t)(0xC0 | (run - 1)));
                run = 0;
            }
        } else {
            if (run) {
                o.put((uint8_t)(0xC0 | (run - 1)));
                run = 0;
            }
            int hash = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
            if (has[hash] && !memcmp(seen[hash], p, 4)) {
                o.put((uint8_t)hash);
            } else {
                has[hash] = true;
                memcpy(seen[hash], p, 4);
                if (prev[3] == p[3]) {
                    int dr = delta(p[0], prev[0]), dg = delta(p[1], prev[1]), db = delta(p[2], prev[2]);
                    if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
                        o.put((uint8_t)(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2)));
                    } else {
                        int dgr = delta(dr, dg), dgb = delta(db, dg);
                        if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
                            o.put((uint8_t)(0x80 | (dg + 32)));
                            o.put((uint8_t)((dgr + 8) << 4 | (dgb + 8)));
                        } else {
                            o.put(0xFE);
                            o.put(p[0]); o.put(p[1]); o.put(p[2]);
                        }
                    }
                } else {
                    o.put(0xFF);
                    o.put(p[0]); o.put(p[1]); o.put(p[2]); o.put(p[3]);
                }
            }
        }
        memcpy(prev, p, 4);
    }
    if (run) o.put((uint8_t)(0xC0 | (run - 1)));
    static const uint8_t pad[8] = {0, 0, 0, 0, 0, 0, 0, 1};
    for (uint8_t b : pad) o.put(b);
    return o.overflow ? -1 : o.n;
}

}  // extern "C"
