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
// jcdctmgr.c's reciprocal quantiser), and the TIFF LZW and PackBits
// decoders.
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
