// Native host library of gatling_tpu_torch: the scene build's and the
// image codecs' loops that NumPy cannot vectorise.
//
// The first six functions are the JAX package's native library
// (native/gatling_native.cpp), copied function for function so that the
// two packages build equal trees and equal byte streams: Morton ordering,
// threaded-BVH construction (the output contract of ops/bvh.py
// build_bvh_ref), vertex deduplication, the byteshuffle + deflate mesh
// codec and the LZ4 block decoder of the crate reader. The rest serve
// imgio: the JPEG entropy coder (Huffman decoding of baseline and
// progressive scans, and encoding of a baseline scan), libjpeg's integer
// transforms (jidctint.c's islow IDCT, jfdctint.c's islow FDCT with
// jcdctmgr.c's reciprocal quantiser), the TIFF LZW and PackBits
// decoders, the GIF LZW decoder (Pillow's GifDecode.c) and the BC1-BC7
// block decoders of DDS textures (Pillow's BcnDecode.c).
//
// A plain C ABI, loaded through ctypes (gatling_tpu_torch/native.py, which
// builds it with g++ -O3 -std=c++17 -shared -fPIC ... -lz into
// build/torch_ext/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>

#include <zlib.h>
#include <vector>

namespace {

inline uint64_t spread_bits(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

inline uint64_t morton3(float x, float y, float z) {
  auto q = [](float f) -> uint64_t {
    float c = f * 1024.0f;
    if (c < 0.0f) c = 0.0f;
    if (c > 1023.0f) c = 1023.0f;
    return (uint64_t)c;
  };
  return (spread_bits(q(x)) << 2) | (spread_bits(q(y)) << 1) | spread_bits(q(z));
}

struct BuildFrame {
  int64_t start;
  int64_t count;
  int64_t patch_slot;  // parent's right_child entry to fill, -1 = none
};

}  // namespace

extern "C" {

// Morton-order triangle centroids. order[T] receives the sort permutation.
void gatling_morton_order(const float* tri_min, const float* tri_max,
                          int64_t t, int32_t* order) {
  std::vector<std::pair<uint64_t, int32_t>> keys(t);
  float lo[3] = {1e38f, 1e38f, 1e38f};
  float hi[3] = {-1e38f, -1e38f, -1e38f};
  std::vector<float> cx(t), cy(t), cz(t);
  for (int64_t i = 0; i < t; ++i) {
    cx[i] = 0.5f * (tri_min[i * 3 + 0] + tri_max[i * 3 + 0]);
    cy[i] = 0.5f * (tri_min[i * 3 + 1] + tri_max[i * 3 + 1]);
    cz[i] = 0.5f * (tri_min[i * 3 + 2] + tri_max[i * 3 + 2]);
    lo[0] = std::min(lo[0], cx[i]); hi[0] = std::max(hi[0], cx[i]);
    lo[1] = std::min(lo[1], cy[i]); hi[1] = std::max(hi[1], cy[i]);
    lo[2] = std::min(lo[2], cz[i]); hi[2] = std::max(hi[2], cz[i]);
  }
  float ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-12f);
  for (int64_t i = 0; i < t; ++i) {
    keys[i] = {morton3((cx[i] - lo[0]) / ext[0], (cy[i] - lo[1]) / ext[1],
                       (cz[i] - lo[2]) / ext[2]),
               (int32_t)i};
  }
  std::stable_sort(keys.begin(), keys.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  for (int64_t i = 0; i < t; ++i) order[i] = keys[i].second;
}

// Threaded-BVH build over Morton-sorted triangle bounds. Outputs are sized
// for at most 2*ceil(T/1)... the caller allocates max_nodes = 2*T entries.
// Returns the node count, or -1 if max_nodes was insufficient.
int64_t gatling_build_bvh(const float* tri_min_in, const float* tri_max_in,
                          int64_t t, int32_t leaf_size,
                          float* bbox_min, float* bbox_max, int32_t* skip,
                          int32_t* leaf_start, int32_t* leaf_count,
                          int32_t* order, int64_t max_nodes) {
  if (t <= 0) return 0;
  gatling_morton_order(tri_min_in, tri_max_in, t, order);

  std::vector<float> tmin(t * 3), tmax(t * 3);
  for (int64_t i = 0; i < t; ++i) {
    const int64_t s = order[i];
    std::memcpy(&tmin[i * 3], &tri_min_in[s * 3], 3 * sizeof(float));
    std::memcpy(&tmax[i * 3], &tri_max_in[s * 3], 3 * sizeof(float));
  }

  std::vector<int32_t> right_child;
  right_child.reserve(2 * t);
  int64_t n = 0;

  std::vector<BuildFrame> stack;
  stack.push_back({0, t, -1});
  while (!stack.empty()) {
    BuildFrame f = stack.back();
    stack.pop_back();
    const int64_t idx = n;
    if (idx >= max_nodes) return -1;
    if (f.patch_slot >= 0) right_child[f.patch_slot] = (int32_t)idx;
    float bmin[3] = {1e38f, 1e38f, 1e38f};
    float bmax[3] = {-1e38f, -1e38f, -1e38f};
    for (int64_t i = f.start; i < f.start + f.count; ++i) {
      for (int k = 0; k < 3; ++k) {
        bmin[k] = std::min(bmin[k], tmin[i * 3 + k]);
        bmax[k] = std::max(bmax[k], tmax[i * 3 + k]);
      }
    }
    std::memcpy(&bbox_min[idx * 3], bmin, sizeof(bmin));
    std::memcpy(&bbox_max[idx * 3], bmax, sizeof(bmax));
    if (f.count <= leaf_size) {
      leaf_start[idx] = (int32_t)f.start;
      leaf_count[idx] = (int32_t)f.count;
      right_child.push_back(-1);
    } else {
      leaf_start[idx] = 0;
      leaf_count[idx] = 0;
      right_child.push_back(0);
      const int64_t half = f.count / 2;
      stack.push_back({f.start + half, f.count - half, idx});
      stack.push_back({f.start, half, -1});
    }
    ++n;
  }

  // skip links: preorder threading (matches ops/bvh.py pass 2)
  std::vector<std::pair<int64_t, int64_t>> frames;
  frames.push_back({0, n});
  while (!frames.empty()) {
    auto [i, s] = frames.back();
    frames.pop_back();
    skip[i] = (int32_t)s;
    if (leaf_count[i] == 0) {
      const int64_t rc = right_child[i];
      frames.push_back({i + 1, rc});
      frames.push_back({rc, s});
    }
  }
  return n;
}

// Vertex deduplication: hash rows of `stride` floats; remap[i] = index of the
// first identical row (bitwise). Returns the unique count.
// (meshoptimizer generateVertexRemap analog, MeshProcessing.cpp:159-192)
int64_t gatling_dedup(const float* data, int64_t n, int64_t stride,
                      int32_t* remap) {
  struct RowHash {
    const float* data;
    int64_t stride;
    size_t operator()(int64_t i) const {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(data + i * stride);
      uint64_t h = 1469598103934665603ull;
      for (int64_t k = 0; k < stride; ++k) {
        h ^= p[k];
        h *= 1099511628211ull;
      }
      return (size_t)h;
    }
  };
  struct RowEq {
    const float* data;
    int64_t stride;
    bool operator()(int64_t a, int64_t b) const {
      return std::memcmp(data + a * stride, data + b * stride,
                         stride * sizeof(float)) == 0;
    }
  };
  std::unordered_map<int64_t, int32_t, RowHash, RowEq> seen(
      16, RowHash{data, stride}, RowEq{data, stride});
  seen.reserve((size_t)n);
  int64_t unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto [it, inserted] = seen.emplace(i, (int32_t)unique);
    if (inserted) {
      remap[i] = (int32_t)unique;
      ++unique;
    } else {
      remap[i] = it->second;
    }
  }
  return unique;
}

// Mesh-buffer compression: byteshuffle (split byte planes, the blosc
// SHUFFLE filter) + zlib deflate level 3 — the giProcessMeshData analog
// (reference: MeshProcessing.cpp:56-78 blosc level 3 BITSHUFFLE per buffer
// >= 1 KiB). Returns the compressed size, or -1 when dst_cap is too small
// (callers fall back to storing raw).
int64_t gatling_compress(const uint8_t* src, int64_t n, int64_t elem_size,
                         uint8_t* dst, int64_t dst_cap) {
  if (n <= 0 || elem_size <= 0 || n % elem_size != 0) return -1;
  const int64_t count = n / elem_size;
  std::vector<uint8_t> shuffled((size_t)n);
  for (int64_t b = 0; b < elem_size; ++b) {
    uint8_t* plane = shuffled.data() + b * count;
    for (int64_t i = 0; i < count; ++i) plane[i] = src[i * elem_size + b];
  }
  uLongf out_len = (uLongf)dst_cap;
  if (compress2(dst, &out_len, shuffled.data(), (uLong)n, 3) != Z_OK)
    return -1;
  return (int64_t)out_len;
}

// Inverse of gatling_compress. Returns n on success, -1 on corrupt input.
int64_t gatling_decompress(const uint8_t* src, int64_t csize,
                           int64_t elem_size, uint8_t* dst, int64_t n) {
  if (n <= 0 || elem_size <= 0 || n % elem_size != 0) return -1;
  const int64_t count = n / elem_size;
  std::vector<uint8_t> shuffled((size_t)n);
  uLongf out_len = (uLongf)n;
  if (uncompress(shuffled.data(), &out_len, src, (uLong)csize) != Z_OK ||
      (int64_t)out_len != n)
    return -1;
  for (int64_t b = 0; b < elem_size; ++b) {
    const uint8_t* plane = shuffled.data() + b * count;
    for (int64_t i = 0; i < count; ++i) dst[i * elem_size + b] = plane[i];
  }
  return n;
}

// LZ4 block decode (lz4 block format spec) for the binary-USD (crate)
// reader: pxr compresses every token/field/path/spec table and most value
// arrays with LZ4 (crateFile.cpp TfFastCompression); multi-MB sections
// through the pure-python decoder would dominate stage-open time.
// Returns bytes written, or -1 on malformed input / overrun.
int64_t gatling_lz4_decompress(const uint8_t* src, int64_t n,
                               uint8_t* dst, int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n) {
    const uint8_t token = src[i++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n || o + lit > cap) return -1;
    std::memcpy(dst + o, src + i, (size_t)lit);
    i += lit;
    o += lit;
    if (i >= n) break;  // last sequence: literals only
    if (i + 2 > n) return -1;
    const int64_t off = (int64_t)src[i] | ((int64_t)src[i + 1] << 8);
    i += 2;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        mlen += b;
      } while (b == 255);
    }
    int64_t start = o - off;
    if (start < 0 || o + mlen > cap) return -1;
    if (off >= mlen) {
      std::memcpy(dst + o, dst + start, (size_t)mlen);
    } else {  // overlapping match: byte-serial semantics
      for (int64_t k = 0; k < mlen; ++k) dst[o + k] = dst[start + k];
    }
    o += mlen;
  }
  return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG (ITU-T T.81) entropy coding and libjpeg's integer transforms. imgio/
// jpeg.py parses the markers and drives these; every function here follows
// libjpeg-turbo's C code (jdhuff.c, jdphuff.c, jchuff.c, jidctint.c,
// jfdctint.c, jcdctmgr.c) so that decodes equal its output code for code.
// ---------------------------------------------------------------------------

namespace {

// jpeg_natural_order with jutils.c's 16 guard entries: a corrupt run past
// coefficient 63 lands on 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A decoding table from a DHT spec (16 code counts, then the symbols):
// the canonical codes of each length are consecutive.
struct HuffDecode {
  int32_t maxcode[18];  // the largest code of length l, -1 if none
  int32_t valoff[18];   // symbol index minus code, for length l
  uint8_t val[256];
};

bool make_huff_decode(const uint8_t* spec, HuffDecode* h) {
  int total = 0;
  for (int l = 0; l < 16; ++l) total += spec[l];
  if (total > 256) return false;
  std::memcpy(h->val, spec + 16, 256);
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int cnt = spec[l - 1];
    h->valoff[l] = k - code;
    code += cnt;
    k += cnt;
    h->maxcode[l] = cnt ? code - 1 : -1;
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  return true;
}

// The entropy-coded segment's bit stream: 0xFF 0x00 is a data byte 0xFF,
// 0xFF fill bytes are skipped, and at a marker the reader stops and feeds
// zeros (libjpeg's fill_bit_buffer), leaving `pos` on the marker's 0xFF.
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;  // the next bits, MSB first
  int cnt = 0;
  bool marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!marker && pos < n) {
        if (d[pos] == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
          } else {
            marker = true;
          }
        } else {
          b = d[pos++];
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int32_t bits(int k) {  // k in 1..16
    if (cnt < k) fill();
    const int32_t v = (int32_t)(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int32_t bit() { return bits(1); }
  int decode(const HuffDecode& h) {
    if (cnt < 16) fill();
    for (int l = 1; l <= 16; ++l) {
      const int32_t code = (int32_t)(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return h.val[(code + h.valoff[l]) & 0xFF];
      }
    }
    buf <<= 16;  // no code of 16 bits or fewer: a zero, as libjpeg fakes it
    cnt -= 16;
    return 0;
  }
  // at a restart: drop the buffered bits and step over the RSTn marker
  void restart() {
    buf = 0;
    cnt = 0;
    if (!marker) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)) ++pos;
      marker = pos + 1 < n;
    }
    if (marker) {
      int64_t q = pos + 1;
      while (q < n && d[q] == 0xFF) ++q;
      if (q < n && d[q] >= 0xD0 && d[q] <= 0xD7) {
        pos = q + 1;
        marker = false;
      }
    }
  }
  // after the scan's last MCU: the offset of the next marker's 0xFF
  int64_t end() {
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)) ++pos;
    return pos + 1 < n ? pos : n;
  }
};

inline int32_t extend(int32_t v, int s) {  // HUFF_EXTEND
  return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v);
}

// libjpeg's fixed-point constants (CONST_BITS 13)
constexpr int32_t kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

struct HuffEncode {
  uint32_t code[256];
  uint8_t size[256];
};

void make_huff_encode(const uint8_t* spec, HuffEncode* h) {
  std::memset(h->size, 0, sizeof(h->size));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < spec[l - 1]; ++i, ++k) {
      h->code[spec[16 + k]] = code++;
      h->size[spec[16 + k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int cnt = 0;
  bool overflow = false;

  void put(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;  // byte stuffing
  }
  void emit(uint32_t v, int k) {
    acc = (acc << k) | (v & ((1u << k) - 1));
    cnt += k;
    while (cnt >= 8) {
      put((uint8_t)(acc >> (cnt - 8)));
      cnt -= 8;
    }
  }
};

}  // namespace

extern "C" {

// Huffman-decode one scan of a baseline or progressive JPEG, starting at
// data[pos] (the first byte after the SOS header), into the components'
// coefficient blocks (int16, natural order, 64 a block). comp holds six
// int32 a scan component: h and v (the blocks an MCU holds; 1 and 1 in a
// scan of one component), the block stride of its rows, its DC and AC
// table numbers, and 0. An MCU (mr, mc) covers the blocks (mr * v + y,
// mc * h + x). tables: eight DHT specs of 272 bytes (16 code counts, 256
// symbols), DC 0-3 then AC 0-3, with `present` flags. ss, se, ah, al: the
// spectral selection and successive approximation of the scan (0, 63, 0,
// 0 for a sequential scan). Returns the offset of the marker that follows
// the scan, -1 when a table the scan needs is missing or malformed.
int64_t gatling_jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t pos,
                                 int32_t ncomp, const int32_t* comp, int16_t* const* coefs,
                                 int32_t mcu_cols, int32_t mcu_rows, const uint8_t* tables,
                                 const int32_t* present, int32_t progressive, int32_t ss,
                                 int32_t se, int32_t ah, int32_t al, int32_t restart) {
  HuffDecode dc[4], ac[4];
  const bool dc_scan = !progressive || ss == 0;
  const bool ac_scan = !progressive || ss > 0;
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* ci = comp + 6 * c;
    if (ci[3] < 0 || ci[3] > 3 || ci[4] < 0 || ci[4] > 3) return -1;
    // a DC refinement needs no table; a first DC scan and a sequential scan do
    if (dc_scan && !(progressive && ah != 0)) {
      if (!present[ci[3]] || !make_huff_decode(tables + 272 * ci[3], &dc[ci[3]])) return -1;
    }
    if (ac_scan) {
      if (!present[4 + ci[4]] || !make_huff_decode(tables + 272 * (4 + ci[4]), &ac[ci[4]]))
        return -1;
    }
  }
  BitReader br{data, n, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  const int32_t p1 = 1 << al, m1 = -(1 << al);
  const int64_t total = (int64_t)mcu_cols * mcu_rows;
  for (int64_t m = 0; m < total; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      br.restart();
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    const int64_t mr = m / mcu_cols, mc = m % mcu_cols;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* ci = comp + 6 * c;
      const int32_t h = ci[0], v = ci[1], stride = ci[2];
      for (int32_t y = 0; y < v; ++y) {
        for (int32_t x = 0; x < h; ++x) {
          int16_t* blk = coefs[c] + ((mr * v + y) * (int64_t)stride + mc * h + x) * 64;
          if (!progressive) {  // jdhuff.c decode_mcu
            const int s = std::min(br.decode(dc[ci[3]]), 16);
            pred[c] += extend(s ? br.bits(s) : 0, s);
            blk[0] = (int16_t)pred[c];
            const HuffDecode& t = ac[ci[4]];
            for (int k = 1; k < 64; ++k) {
              int r = br.decode(t);
              const int sz = r & 15;
              r >>= 4;
              if (sz) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(br.bits(sz), sz);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          } else if (ss == 0 && ah == 0) {  // jdphuff.c decode_mcu_DC_first
            const int s = std::min(br.decode(dc[ci[3]]), 16);
            pred[c] += extend(s ? br.bits(s) : 0, s);
            blk[0] = (int16_t)(pred[c] * (1 << al));
          } else if (ss == 0) {  // decode_mcu_DC_refine
            if (br.bit()) blk[0] |= (int16_t)p1;
          } else if (ah == 0) {  // decode_mcu_AC_first
            if (eobrun > 0) {
              --eobrun;
              continue;
            }
            const HuffDecode& t = ac[ci[4]];
            for (int k = ss; k <= se; ++k) {
              int r = br.decode(t);
              const int sz = r & 15;
              r >>= 4;
              if (sz) {
                k += r;
                blk[kNatural[k]] = (int16_t)(extend(br.bits(sz), sz) * (1 << al));
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = (int64_t)1 << r;
                if (r) eobrun += br.bits(r);
                --eobrun;
                break;
              }
            }
          } else {  // decode_mcu_AC_refine
            const HuffDecode& t = ac[ci[4]];
            int k = ss;
            if (eobrun == 0) {
              for (; k <= se; ++k) {
                int r = br.decode(t);
                int s = r & 15;
                r >>= 4;
                if (s) {
                  s = br.bit() ? p1 : m1;
                } else if (r != 15) {
                  eobrun = (int64_t)1 << r;
                  if (r) eobrun += br.bits(r);
                  break;
                }
                do {
                  int16_t* coef = blk + kNatural[k];
                  if (*coef != 0) {
                    if (br.bit() && (*coef & p1) == 0) *coef += (int16_t)(*coef >= 0 ? p1 : m1);
                  } else if (--r < 0) {
                    break;
                  }
                  ++k;
                } while (k <= se);
                if (s) blk[kNatural[k]] = (int16_t)s;
              }
            }
            if (eobrun > 0) {
              for (; k <= se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && br.bit() && (*coef & p1) == 0)
                  *coef += (int16_t)(*coef >= 0 ? p1 : m1);
              }
              --eobrun;
            }
          }
        }
      }
    }
  }
  return br.end();
}

// Dequantise and inverse-transform nblocks coefficient blocks (natural
// order) with jidctint.c's jpeg_idct_islow, into 8x8 samples a block.
// quant: 64 entries, natural order. The last step saturates to 0..255, as
// libjpeg-turbo's SIMD islow IDCT does.
void gatling_jpeg_idct_islow(const int16_t* coefs, int64_t nblocks, const uint16_t* quant,
                             uint8_t* out) {
  for (int64_t b = 0; b < nblocks; ++b) {
    const int16_t* in = coefs + b * 64;
    int64_t ws[64];
    for (int col = 0; col < 8; ++col) {  // pass 1: columns
      auto q = [&](int r) { return (int64_t)in[r * 8 + col] * quant[r * 8 + col]; };
      int64_t z2 = q(2), z3 = q(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = q(0);
      z3 = q(4);
      int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
      int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = q(7);
      tmp1 = q(5);
      tmp2 = q(3);
      tmp3 = q(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      ws[0 * 8 + col] = descale(tmp10 + tmp3, sh);
      ws[7 * 8 + col] = descale(tmp10 - tmp3, sh);
      ws[1 * 8 + col] = descale(tmp11 + tmp2, sh);
      ws[6 * 8 + col] = descale(tmp11 - tmp2, sh);
      ws[2 * 8 + col] = descale(tmp12 + tmp1, sh);
      ws[5 * 8 + col] = descale(tmp12 - tmp1, sh);
      ws[3 * 8 + col] = descale(tmp13 + tmp0, sh);
      ws[4 * 8 + col] = descale(tmp13 - tmp0, sh);
    }
    uint8_t* o = out + b * 64;
    for (int row = 0; row < 8; ++row) {  // pass 2: rows
      const int64_t* w = ws + row * 8;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
      int64_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits + kPass1Bits + 3;
      const int64_t vals[8] = {tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                               tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3};
      for (int k = 0; k < 8; ++k) {
        const int64_t x = descale(vals[k], sh) + 128;
        o[row * 8 + k] = (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
      }
    }
  }
}

// Forward-transform nblocks blocks of 8x8 samples with jfdctint.c's
// jpeg_fdct_islow and quantise them as jcdctmgr.c does (the reciprocal
// of 8 x the table entry with its rounding correction, 16-bit DCTELEMs as
// in libjpeg-turbo's SIMD build) into int16 coefficients, natural order.
void gatling_jpeg_fdct_islow(const uint8_t* samples, int64_t nblocks, const uint16_t* quant,
                             int16_t* coefs) {
  uint32_t recip[64], corr[64];
  int shift[64];
  for (int i = 0; i < 64; ++i) {  // compute_reciprocal
    const uint32_t divisor = (uint32_t)quant[i] << 3;
    int b = 31;
    while (!(divisor >> b)) --b;  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
    const uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      --r;
    } else if (fr <= divisor / 2) {
      ++c;
    } else {
      ++fq;
    }
    recip[i] = fq;
    corr[i] = c;
    shift[i] = r;
  }
  for (int64_t b = 0; b < nblocks; ++b) {
    int64_t d[64];
    for (int i = 0; i < 64; ++i) d[i] = (int64_t)samples[b * 64 + i] - 128;
    for (int pass = 0; pass < 2; ++pass) {
      const int step = pass == 0 ? 1 : 8;   // along a row, then along a column
      const int next = pass == 0 ? 8 : 1;   // the next row, the next column
      for (int line = 0; line < 8; ++line) {
        int64_t* p = d + line * next;
        const int64_t tmp0 = p[0 * step] + p[7 * step], tmp7 = p[0 * step] - p[7 * step];
        const int64_t tmp1 = p[1 * step] + p[6 * step], tmp6 = p[1 * step] - p[6 * step];
        const int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
        const int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        const int sh = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
        if (pass == 0) {
          p[0 * step] = (tmp10 + tmp11) * (1 << kPass1Bits);
          p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
        } else {
          p[0 * step] = descale(tmp10 + tmp11, kPass1Bits);
          p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
        }
        int64_t z1 = (tmp12 + tmp13) * F0541;
        p[2 * step] = descale(z1 + tmp13 * F0765, sh);
        p[6 * step] = descale(z1 + tmp12 * -F1847, sh);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        const int64_t z5 = (z3 + z4) * F1175;
        const int64_t t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072,
                      t7 = tmp7 * F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        p[7 * step] = descale(t4 + z1 + z3, sh);
        p[5 * step] = descale(t5 + z2 + z4, sh);
        p[3 * step] = descale(t6 + z2 + z3, sh);
        p[1 * step] = descale(t7 + z1 + z4, sh);
      }
    }
    for (int i = 0; i < 64; ++i) {  // quantize
      const int64_t t = d[i];
      const uint64_t a = (uint64_t)(t < 0 ? -t : t);
      const int64_t q = (int64_t)(((a + corr[i]) * recip[i]) >> shift[i]);
      coefs[b * 64 + i] = (int16_t)(t < 0 ? -q : q);
    }
  }
}

// Huffman-encode one interleaved baseline scan (jchuff.c encode_one_block)
// of the components' quantised blocks, laid out as gatling_jpeg_decode_scan
// reads them; comp holds six int32 a component as there (h, v, stride, DC
// table, AC table, 0) and tables four DHT specs: DC 0, DC 1, AC 0, AC 1.
// Writes the stuffed entropy-coded bytes, the last byte padded with ones,
// and returns their count, or -1 when `cap` is too small.
int64_t gatling_jpeg_encode_scan(int32_t ncomp, const int32_t* comp,
                                 const int16_t* const* coefs, int32_t mcu_cols, int32_t mcu_rows,
                                 const uint8_t* tables, uint8_t* out, int64_t cap) {
  HuffEncode dc[2], ac[2];
  for (int t = 0; t < 2; ++t) {
    make_huff_encode(tables + 272 * t, &dc[t]);
    make_huff_encode(tables + 272 * (2 + t), &ac[t]);
  }
  BitWriter bw{out, cap};
  int32_t pred[4] = {0, 0, 0, 0};
  for (int64_t mr = 0; mr < mcu_rows; ++mr) {
    for (int64_t mc = 0; mc < mcu_cols; ++mc) {
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* ci = comp + 6 * c;
        const HuffEncode& dct = dc[ci[3]];
        const HuffEncode& act = ac[ci[4]];
        for (int32_t y = 0; y < ci[1]; ++y) {
          for (int32_t x = 0; x < ci[0]; ++x) {
            const int16_t* blk = coefs[c] + ((mr * ci[1] + y) * (int64_t)ci[2] + mc * ci[0] + x) * 64;
            int32_t temp = blk[0] - pred[c], temp2 = temp;
            pred[c] = blk[0];
            if (temp < 0) {
              temp = -temp;
              --temp2;
            }
            int nbits = 0;
            while (temp) {
              ++nbits;
              temp >>= 1;
            }
            bw.emit(dct.code[nbits], dct.size[nbits]);
            if (nbits) bw.emit((uint32_t)temp2, nbits);
            int r = 0;
            for (int k = 1; k < 64; ++k) {
              temp = blk[kNatural[k]];
              if (temp == 0) {
                ++r;
                continue;
              }
              while (r > 15) {
                bw.emit(act.code[0xF0], act.size[0xF0]);
                r -= 16;
              }
              temp2 = temp;
              if (temp < 0) {
                temp = -temp;
                --temp2;
              }
              nbits = 1;
              while ((temp >>= 1)) ++nbits;
              const int sym = (r << 4) + nbits;
              bw.emit(act.code[sym], act.size[sym]);
              bw.emit((uint32_t)temp2, nbits);
              r = 0;
            }
            if (r > 0) bw.emit(act.code[0], act.size[0]);
          }
        }
      }
    }
  }
  if (bw.cnt > 0) bw.emit(0x7F, 8 - bw.cnt);  // pad with ones (jchuff.c flush_bits)
  return bw.overflow ? -1 : bw.n;
}

// ---------------------------------------------------------------------------
// TIFF strip and tile codecs (imgio/tiff.py)
// ---------------------------------------------------------------------------

// TIFF LZW (TIFF 6.0 section 13, libtiff's LZWDecode): MSB-first codes of
// 9-12 bits, Clear 256, EOI 257, the code width growing one code early.
// Decodes at most `cap` bytes; returns the count written, -1 on a code
// that is not in the table.
int64_t gatling_tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int nbits = 9, next = 258, old = -1;
  int64_t bitpos = 0, o = 0;
  auto read_code = [&]() -> int {
    if (bitpos + nbits > n * 8) return 257;  // out of data: end
    int v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos)
      v = (v << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return v;
  };
  auto put = [&](int code) {  // the string of `code`, written back to front
    const int64_t len = length[code];
    for (int64_t k = len - 1; k >= 0; --k, code = prefix[code])
      if (o + k < cap) dst[o + k] = suffix[code];
    o += len;
  };
  while (o < cap) {
    int code = read_code();
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      code = read_code();
      if (code == 257) break;
      if (code > 256) return -1;
      put(code);
      old = code;
      continue;
    }
    if (old < 0) return -1;
    if (code < next) {
      put(code);
      if (next < 4096) {
        prefix[next] = old;
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = length[old] + 1;
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = old;
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = length[old] + 1;
      ++next;
      put(code);
    } else {
      return -1;
    }
    old = code;
    if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  return o < cap ? o : cap;
}

// Old-style TIFF LZW (libtiff's LZWDecodeCompat): codes LSB-first, the
// code width growing one code later than in the new style. Returns the
// bytes written (at most cap), or -1 for a corrupt table.
int64_t gatling_tiff_lzw_compat_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                                       int64_t cap) {
  const int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12, kSize = 5119;
  static thread_local int next_of[5119], length[5119];
  static thread_local uint8_t value[5119], firstchar[5119];
  for (int c = 0; c < 256; ++c) {
    next_of[c] = -1;
    length[c] = 1;
    value[c] = firstchar[c] = (uint8_t)c;
  }
  int nbits = 9, free_ent = kFirst, maxcode = (1 << 9) - 1, old = -2;
  int64_t pos = 0, o = 0, bitsleft = n * 8;
  uint64_t nextdata = 0;
  int nextbits = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < nbits) return kEoi;
    nextdata |= (uint64_t)src[pos++] << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= (uint64_t)src[pos++] << nextbits;
      nextbits += 8;
    }
    const int code = (int)(nextdata & ((1u << nbits) - 1));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (o < cap) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        nbits = 9;
        maxcode = (1 << 9) - 1;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return -1;
      dst[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= kSize || code > free_ent) return -1;
    next_of[free_ent] = old;
    firstchar[free_ent] = firstchar[old];
    length[free_ent] = length[old] + 1;
    value[free_ent] = code < free_ent ? firstchar[code] : firstchar[free_ent];
    if (++free_ent > maxcode) {
      if (++nbits > kMaxBits) nbits = kMaxBits;
      maxcode = (1 << nbits) - 1;
    }
    old = code;
    if (code >= 256) {
      const int len = length[code];
      if (len == 0) return -1;
      const int64_t keep = std::min<int64_t>(len, cap - o);
      int c = code;
      for (int k = len - 1; k >= 0; --k, c = next_of[c]) {
        if (k < keep) dst[o + k] = value[c];
      }
      o += keep;
    } else {
      dst[o++] = (uint8_t)code;
    }
  }
  return o;
}

// PackBits (TIFF 6.0 section 9): returns the bytes written, at most cap.
int64_t gatling_tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n && o < cap) {
    const int c = (int8_t)src[i++];
    if (c >= 0) {
      const int64_t k = std::min<int64_t>({(int64_t)c + 1, n - i, cap - o});
      std::memcpy(dst + o, src + i, (size_t)k);
      i += c + 1;
      o += k;
    } else if (c != -128) {
      if (i >= n) break;
      const int64_t k = std::min<int64_t>(1 - c, cap - o);
      std::memset(dst + o, src[i++], (size_t)k);
      o += k;
    }
  }
  return o;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// GIF LZW (Pillow's GifDecode.c): the indices of one frame of xsize x ysize
// pixels, rows in the order the frame stores them (interlaced: passes of
// every 8th row from 0, every 8th from 4, every 4th from 2, every 2nd from
// 1). The code stream's sub-blocks start at src[0]. Returns 0 when the frame
// is filled, -1 for a broken stream or a bad code size, -2 when the data
// ends first (Pillow's "image file is truncated"), -3 on an overrun.
int64_t gatling_gif_lzw_decode(const uint8_t* src, int64_t n, int bits, int interlace,
                               int xsize, int ysize, uint8_t* out) {
  const int GIFTABLE = 4096, GIFBITS = 12;
  if (bits < 0 || bits > 12) return -1;
  if (xsize <= 0 || ysize <= 0) return 0;
  static thread_local uint8_t data[4096], buffer[4096];
  static thread_local uint16_t link[4096];
  const int clear = 1 << bits, end = clear + 1;
  int step = 1, pass = 0;
  if (interlace) {
    pass = 1;
    step = 8;
  }
  int state = 1, next = 0, codesize = 0, codemask = 0, bufferindex = GIFTABLE;
  int lastdata = 0, lastcode = 0, blocksize = 0, bitcount = 0;
  int64_t bitbuffer = 0, pos = 0;
  int x = 0, y = 0;
  uint8_t last = 0;
  // NEWLINE: returns true when the frame is complete
  auto newline = [&]() -> bool {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return true;
      }
    }
    return false;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = GIFTABLE;
      state = 2;
    }
    const uint8_t* p;
    int count;
    if (bufferindex < GIFTABLE) {
      count = GIFTABLE - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = GIFTABLE;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= (int64_t)src[pos++] << bitcount;
          bitcount += 8;
          --blocksize;
        } else {
          if (pos >= n) return -2;
          const int c = src[pos];
          if (n - pos < c + 1) return -2;
          blocksize = c;
          ++pos;
        }
      }
      int c = (int)(bitbuffer & codemask);
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end) return -2;  // the frame is not filled: Pillow waits for data to its end
      count = 1;
      if (state == 2) {
        if (c > clear) return -1;
        lastdata = lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) return -1;
        if (c == next) {
          if (bufferindex <= 0) return -1;
          buffer[--bufferindex] = (uint8_t)lastdata;
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 0 || c >= GIFTABLE) return -1;
          buffer[--bufferindex] = data[c];
          c = link[c];
        }
        lastdata = c;
        if (next < GIFTABLE) {
          data[next] = (uint8_t)c;
          link[next] = (uint16_t)lastcode;
          if (next == codemask && codesize < GIFBITS) {
            ++codesize;
            codemask = (1 << codesize) - 1;
          }
          ++next;
        }
        lastcode = thiscode;
      }
      last = (uint8_t)lastdata;
      p = &last;
    }
    if (y >= ysize) return -3;
    for (int k = 0; k < count; ++k) {
      out[(int64_t)y * xsize + x] = p[k];
      if (++x >= xsize && newline()) return 0;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BCn block decoders (Pillow's BcnDecode.c): `n_blocks` blocks of 4x4
// texels, row-major over a w x h image of `out_bytes` bytes a texel (4:
// RGBA, 1: BC4's L); the texels past the right and bottom edges dropped.
// format 1-7 (BC1 ... BC7); sign: BC5 and BC6H signed.

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(uint16_t x) {
  Rgba c;
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  c.r = (uint8_t)r;
  c.g = (uint8_t)g;
  c.b = (uint8_t)b;
  c.a = 0xff;
  return c;
}

void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = src[0] | (src[1] << 8), c1 = src[2] | (src[3] << 8);
  const uint32_t lut = src[4] | (src[5] << 8) | (src[6] << 16) | ((uint32_t)src[7] << 24);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = Rgba{(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3),
                (uint8_t)((2 * b0 + b1) / 3), 0xff};
    p[3] = Rgba{(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3),
                (uint8_t)((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = Rgba{(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2),
                0xff};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int k = 0; k < 16; ++k) dst[k] = p[3 & (lut >> (2 * k))];
}

// BC3's alpha block (and BC4/BC5's channels) into byte o of each texel
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0, a1;
  if (sign) {
    a0 = (int8_t)src[0] + 128;
    a1 = (int8_t)src[1] + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  const int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  const int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  uint8_t a[8];
  a[0] = (uint8_t)a0;
  a[1] = (uint8_t)a1;
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; ++k) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int k = 0; k < 8; ++k) dst[stride * k + o] = a[7 & (lut1 >> (3 * k))];
  for (int k = 0; k < 8; ++k) dst[stride * (8 + k) + o] = a[7 & (lut2 >> (3 * k))];
}

uint8_t get_bits(const uint8_t* src, int bit, int count) {
  const int by = bit >> 3;
  bit &= 7;
  if (!count) return 0;
  if (bit + count <= 8) return (uint8_t)((src[by] >> bit) & ((1 << count) - 1));
  const int x = src[by] | (src[by + 1] << 8);
  return (uint8_t)((x >> bit) & ((1 << count) - 1));
}

struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// the BPTC partitions (the BC7 specification's tables): two subsets, one bit
// a texel; three subsets, two bits a texel; the anchor texels
const uint16_t kSi2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kSi3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
const uint8_t kAi0[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                          15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                          15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                          6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAi1[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                          3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                          8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                          3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAi2[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                          15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                          15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                          15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kW2[4] = {0, 21, 43, 64};
const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* bc7_weights(int n) {
  return n == 2 ? kW2 : n == 3 ? kW3 : kW4;
}

int bc7_subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kSi2[partition] >> n);
  if (ns == 3) return 3 & (kSi3[partition] >> (2 * n));
  return 0;
}

uint8_t expand_quantized(uint8_t v, int bits) {
  v = (uint8_t)(v << (8 - bits));
  return (uint8_t)(v | (v >> bits));
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = (uint8_t)((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = (uint8_t)((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = (uint8_t)((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = (uint8_t)((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  int mode = src[0];
  if (!mode) {
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(mode & (1 << bit++))) {
  }
  mode = bit - 1;
  const Bc7Mode& info = kBc7Modes[mode];
  int cb = info.cb, ab = info.ab;
  const uint8_t* cw = bc7_weights(info.ib);
  const uint8_t* aw = bc7_weights((ab && info.ib2) ? info.ib2 : info.ib);
  auto load = [&](int nb) {
    const uint8_t v = get_bits(src, bit, nb);
    bit += nb;
    return v;
  };
  const int partition = load(info.pb), rotation = load(info.rb), index_sel = load(info.isb);
  const int numep = info.ns << 1;
  Rgba ep[6];
  for (int i = 0; i < numep; ++i) ep[i].r = load(cb);
  for (int i = 0; i < numep; ++i) ep[i].g = load(cb);
  for (int i = 0; i < numep; ++i) ep[i].b = load(cb);
  for (int i = 0; i < numep; ++i) ep[i].a = ab ? load(ab) : 255;
  auto assign_p = [](uint8_t& x, int v) { x = (uint8_t)((x << 1) | v); };
  if (info.epb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      const int v = load(1);
      assign_p(ep[i].r, v);
      assign_p(ep[i].g, v);
      assign_p(ep[i].b, v);
      if (ab) assign_p(ep[i].a, v);
    }
  }
  if (info.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      const int v = load(1);
      for (int j = 0; j < 2; ++j) {
        assign_p(ep[i + j].r, v);
        assign_p(ep[i + j].g, v);
        assign_p(ep[i + j].b, v);
        if (ab) assign_p(ep[i + j].a, v);
      }
    }
  }
  for (int i = 0; i < numep; ++i) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit, aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = bc7_subset(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (i == 0) {
      --ib;
    } else if (info.ns == 2) {
      if (i == kAi0[partition]) --ib;
    } else if (info.ns == 3) {
      if (i == kAi1[partition]) {
        --ib;
      } else if (i == kAi2[partition]) {
        --ib;
      }
    }
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && info.ib2) {
      int ib2 = info.ib2;
      if (i == 0) --ib2;
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      } else {
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
      }
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    if (rotation == 1) {
      std::swap(col[i].r, col[i].a);
    } else if (rotation == 2) {
      std::swap(col[i].g, col[i].a);
    } else if (rotation == 3) {
      std::swap(col[i].b, col[i].a);
    }
  }
}

struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// The BC6H endpoint bits of each mode, in block order from its first
// endpoint bit: (endpoint component << 4) | bit, the component indexing
// rw gw bw rx gx bx ry gy by rz gz bz (0-11).
#define BC6_RW(b) (0 << 4 | (b))
#define BC6_GW(b) (1 << 4 | (b))
#define BC6_BW(b) (2 << 4 | (b))
#define BC6_RX(b) (3 << 4 | (b))
#define BC6_GX(b) (4 << 4 | (b))
#define BC6_BX(b) (5 << 4 | (b))
#define BC6_RY(b) (6 << 4 | (b))
#define BC6_GY(b) (7 << 4 | (b))
#define BC6_BY(b) (8 << 4 | (b))
#define BC6_RZ(b) (9 << 4 | (b))
#define BC6_GZ(b) (10 << 4 | (b))
#define BC6_BZ(b) (11 << 4 | (b))
#define BC6_R10(F) F(0), F(1), F(2), F(3), F(4), F(5), F(6), F(7), F(8), F(9)
#define BC6_R9(F) F(0), F(1), F(2), F(3), F(4), F(5), F(6), F(7), F(8)
#define BC6_R8(F) F(0), F(1), F(2), F(3), F(4), F(5), F(6), F(7)
#define BC6_R7(F) F(0), F(1), F(2), F(3), F(4), F(5), F(6)
#define BC6_R6(F) F(0), F(1), F(2), F(3), F(4), F(5)
#define BC6_R5(F) F(0), F(1), F(2), F(3), F(4)
#define BC6_R4(F) F(0), F(1), F(2), F(3)
const uint8_t kBc6Bits[14][75] = {
    // mode 0 (2-bit mode 00), bits 2-76
    {BC6_GY(4), BC6_BY(4), BC6_BZ(4), BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW),
     BC6_R5(BC6_RX), BC6_GZ(4), BC6_R4(BC6_GY), BC6_R5(BC6_GX), BC6_BZ(0), BC6_R4(BC6_GZ),
     BC6_R5(BC6_BX), BC6_BZ(1), BC6_R4(BC6_BY), BC6_R5(BC6_RY), BC6_BZ(2), BC6_R5(BC6_RZ),
     BC6_BZ(3)},
    // mode 1 (01)
    {BC6_GY(5), BC6_GZ(4), BC6_GZ(5), BC6_R7(BC6_RW), BC6_BZ(0), BC6_BZ(1), BC6_BY(4),
     BC6_R7(BC6_GW), BC6_BY(5), BC6_BZ(2), BC6_GY(4), BC6_R7(BC6_BW), BC6_BZ(3), BC6_BZ(5),
     BC6_BZ(4), BC6_R6(BC6_RX), BC6_R4(BC6_GY), BC6_R6(BC6_GX), BC6_R4(BC6_GZ),
     BC6_R6(BC6_BX), BC6_R4(BC6_BY), BC6_R6(BC6_RY), BC6_R6(BC6_RZ)},
    // mode 2 (00010), bits 5-76
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R5(BC6_RX), BC6_RW(10),
     BC6_R4(BC6_GY), BC6_R4(BC6_GX), BC6_GW(10), BC6_BZ(0), BC6_R4(BC6_GZ), BC6_R4(BC6_BX),
     BC6_BW(10), BC6_BZ(1), BC6_R4(BC6_BY), BC6_R5(BC6_RY), BC6_BZ(2), BC6_R5(BC6_RZ),
     BC6_BZ(3)},
    // mode 3 (00110)
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R4(BC6_RX), BC6_RW(10),
     BC6_GZ(4), BC6_R4(BC6_GY), BC6_R5(BC6_GX), BC6_GW(10), BC6_R4(BC6_GZ), BC6_R4(BC6_BX),
     BC6_BW(10), BC6_BZ(1), BC6_R4(BC6_BY), BC6_R4(BC6_RY), BC6_BZ(0), BC6_BZ(2),
     BC6_R4(BC6_RZ), BC6_GY(4), BC6_BZ(3)},
    // mode 4 (01010)
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R4(BC6_RX), BC6_RW(10),
     BC6_BY(4), BC6_R4(BC6_GY), BC6_R4(BC6_GX), BC6_GW(10), BC6_BZ(0), BC6_R4(BC6_GZ),
     BC6_R5(BC6_BX), BC6_BW(10), BC6_R4(BC6_BY), BC6_R4(BC6_RY), BC6_BZ(1), BC6_BZ(2),
     BC6_R4(BC6_RZ), BC6_BZ(4), BC6_BZ(3)},
    // mode 5 (01110)
    {BC6_R9(BC6_RW), BC6_BY(4), BC6_R9(BC6_GW), BC6_GY(4), BC6_R9(BC6_BW), BC6_BZ(4),
     BC6_R5(BC6_RX), BC6_GZ(4), BC6_R4(BC6_GY), BC6_R5(BC6_GX), BC6_BZ(0), BC6_R4(BC6_GZ),
     BC6_R5(BC6_BX), BC6_BZ(1), BC6_R4(BC6_BY), BC6_R5(BC6_RY), BC6_BZ(2), BC6_R5(BC6_RZ),
     BC6_BZ(3)},
    // mode 6 (10010)
    {BC6_R8(BC6_RW), BC6_GZ(4), BC6_BY(4), BC6_R8(BC6_GW), BC6_BZ(2), BC6_GY(4),
     BC6_R8(BC6_BW), BC6_BZ(3), BC6_BZ(4), BC6_R6(BC6_RX), BC6_R4(BC6_GY), BC6_R5(BC6_GX),
     BC6_BZ(0), BC6_R4(BC6_GZ), BC6_R5(BC6_BX), BC6_BZ(1), BC6_R4(BC6_BY), BC6_R6(BC6_RY),
     BC6_R6(BC6_RZ)},
    // mode 7 (10110)
    {BC6_R8(BC6_RW), BC6_BZ(0), BC6_BY(4), BC6_R8(BC6_GW), BC6_GY(5), BC6_GY(4),
     BC6_R8(BC6_BW), BC6_GZ(5), BC6_BZ(4), BC6_R5(BC6_RX), BC6_GZ(4), BC6_R4(BC6_GY),
     BC6_R6(BC6_GX), BC6_R4(BC6_GZ), BC6_R5(BC6_BX), BC6_BZ(1), BC6_R4(BC6_BY),
     BC6_R5(BC6_RY), BC6_BZ(2), BC6_R5(BC6_RZ), BC6_BZ(3)},
    // mode 8 (11010)
    {BC6_R8(BC6_RW), BC6_BZ(1), BC6_BY(4), BC6_R8(BC6_GW), BC6_BY(5), BC6_GY(4),
     BC6_R8(BC6_BW), BC6_BZ(5), BC6_BZ(4), BC6_R5(BC6_RX), BC6_GZ(4), BC6_R4(BC6_GY),
     BC6_R5(BC6_GX), BC6_BZ(0), BC6_R4(BC6_GZ), BC6_R6(BC6_BX), BC6_R4(BC6_BY),
     BC6_R5(BC6_RY), BC6_BZ(2), BC6_R5(BC6_RZ), BC6_BZ(3)},
    // mode 9 (11110)
    {BC6_R6(BC6_RW), BC6_GZ(4), BC6_BZ(0), BC6_BZ(1), BC6_BY(4), BC6_R6(BC6_GW), BC6_GY(5),
     BC6_BY(5), BC6_BZ(2), BC6_GY(4), BC6_R6(BC6_BW), BC6_GZ(5), BC6_BZ(3), BC6_BZ(5),
     BC6_BZ(4), BC6_R6(BC6_RX), BC6_R4(BC6_GY), BC6_R6(BC6_GX), BC6_R4(BC6_GZ),
     BC6_R6(BC6_BX), BC6_R4(BC6_BY), BC6_R6(BC6_RY), BC6_R6(BC6_RZ)},
    // mode 10 (00011), bits 5-64
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R10(BC6_RX), BC6_R10(BC6_GX),
     BC6_R10(BC6_BX)},
    // mode 11 (00111)
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R9(BC6_RX), BC6_RW(10),
     BC6_R9(BC6_GX), BC6_GW(10), BC6_R9(BC6_BX), BC6_BW(10)},
    // mode 12 (01011)
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R8(BC6_RX), BC6_RW(11),
     BC6_RW(10), BC6_R8(BC6_GX), BC6_GW(11), BC6_GW(10), BC6_R8(BC6_BX), BC6_BW(11),
     BC6_BW(10)},
    // mode 13 (01111)
    {BC6_R10(BC6_RW), BC6_R10(BC6_GW), BC6_R10(BC6_BW), BC6_R4(BC6_RX), BC6_RW(15),
     BC6_RW(14), BC6_RW(13), BC6_RW(12), BC6_RW(11), BC6_RW(10), BC6_R4(BC6_GX), BC6_GW(15),
     BC6_GW(14), BC6_GW(13), BC6_GW(12), BC6_GW(11), BC6_GW(10), BC6_R4(BC6_BX), BC6_BW(15),
     BC6_BW(14), BC6_BW(13), BC6_BW(12), BC6_BW(11), BC6_BW(10)},
};

void bc6_sign_extend(uint16_t* v, int prec) {
  int x = *v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  *v = (uint16_t)x;
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == ((1 << prec) - 1)) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = (int16_t)v;
  if (prec >= 16) return x;
  bool s = false;
  if (x < 0) {
    s = true;
    x = -x;
  }
  if (x != 0) {
    if (x >= ((1 << (prec - 1)) - 1)) {
      x = 0x7fff;
    } else {
      x = ((x << 15) + 0x4000) >> (prec - 1);
    }
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (uint32_t)(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) {
      v = ((-v) * 31) / 32;
      return half_to_float((uint16_t)(0x8000 | v));
    }
    return half_to_float((uint16_t)((v * 31) / 32));
  }
  return half_to_float((uint16_t)((v * 31) / 64));
}

uint8_t bc6_clamp(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return (uint8_t)(value * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  uint16_t ep[12] = {0};
  int ueps[12];
  int bit = 5, epbits = 75, ib = 3;
  int mode = src[0] & 0x1f;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 0};
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  const uint8_t* cw = bc7_weights(ib);
  const int numep = info.ns == 2 ? 12 : 6;
  for (int i = 0; i < epbits; ++i) {
    const int di = kBc6Bits[mode][i];
    ep[di >> 4] |= (uint16_t)(get_bits(src, bit + i, 1) << (di & 15));
  }
  bit += epbits;
  const int partition = get_bits(src, bit, info.pb);
  bit += info.pb;
  const int mask = (1 << info.epb) - 1;
  if (sign) {
    for (int i = 0; i < 3; ++i) bc6_sign_extend(&ep[i], info.epb);
  }
  if (sign || info.tr) {
    for (int i = 3; i < numep; i += 3) {
      bc6_sign_extend(&ep[i], info.rb);
      bc6_sign_extend(&ep[i + 1], info.gb);
      bc6_sign_extend(&ep[i + 2], info.bb);
    }
  }
  if (info.tr) {
    // the sums are not sign-extended again, as in Pillow's decoder
    for (int i = 3; i < numep; i += 3) {
      for (int c = 0; c < 3; ++c) ep[i + c] = (uint16_t)((ep[i + c] + ep[c]) & mask);
    }
  }
  for (int i = 0; i < numep; ++i) ueps[i] = bc6_unquantize(ep[i], info.epb, sign);
  for (int i = 0; i < 16; ++i) {
    const int s = bc7_subset(info.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0) {
      --ib2;
    } else if (info.ns == 2 && i == kAi0[partition]) {
      --ib2;
    }
    const int w = cw[get_bits(src, bit, ib2)];
    bit += ib2;
    const int t = 64 - w;
    const int* e0 = &ueps[s];
    const int* e1 = &ueps[s + 3];
    col[i].r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * w) >> 6, sign));
    col[i].g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * w) >> 6, sign));
    col[i].b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * w) >> 6, sign));
  }
}

}  // namespace

extern "C" {

// Decodes the blocks of src (8 bytes a block for BC1 and BC4, else 16) over
// a w x h image; returns the blocks used, or -1 for an unknown format.
int64_t gatling_bcn_decode(const uint8_t* src, int64_t n_blocks, int format, int sign, int w,
                           int h, uint8_t* out) {
  if (format < 1 || format > 7) return -1;
  const int size = (format == 1 || format == 4) ? 8 : 16;
  const int out_bytes = format == 4 ? 1 : 4;
  const int bw = (w + 3) / 4;
  int64_t k = 0;
  for (; k < n_blocks; ++k) {
    const uint8_t* b = src + k * size;
    Rgba col[16];
    std::memset(col, 0, sizeof(col));
    uint8_t lum[16] = {0};
    switch (format) {
      case 1: bc1_color(col, b, false); break;
      case 2:
        bc1_color(col, b + 8, true);
        for (int i = 0; i < 16; ++i) {
          int av = 0xf & (b[(i * 4) >> 3] >> ((i * 4) & 7));
          col[i].a = (uint8_t)((av << 4) | av);
        }
        break;
      case 3:
        bc1_color(col, b + 8, true);
        bc3_alpha(reinterpret_cast<uint8_t*>(col), b, 4, 3, false);
        break;
      case 4: bc3_alpha(lum, b, 1, 0, false); break;
      case 5:
        bc3_alpha(reinterpret_cast<uint8_t*>(col), b, 4, 0, sign != 0);
        bc3_alpha(reinterpret_cast<uint8_t*>(col), b + 8, 4, 1, sign != 0);
        if (sign) {
          for (int i = 0; i < 16; ++i) col[i].b = 128;
        }
        break;
      case 6: bc6_block(col, b, sign != 0); break;
      default: bc7_block(col, b); break;
    }
    const int64_t by = k / bw, bx = k % bw;
    for (int j = 0; j < 4; ++j) {
      const int64_t y = by * 4 + j;
      if (y >= h) continue;
      for (int i = 0; i < 4; ++i) {
        const int64_t x = bx * 4 + i;
        if (x >= w) continue;
        if (out_bytes == 1) {
          out[y * w + x] = lum[j * 4 + i];
        } else {
          std::memcpy(out + (y * w + x) * 4, &col[j * 4 + i], 4);
        }
      }
    }
  }
  return k;
}

}  // extern "C"
