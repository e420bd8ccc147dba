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
// decoders, the GIF LZW decoder (Pillow's GifDecode.c), the BC1-BC7
// block decoders of DDS textures (Pillow's BcnDecode.c) and libwebp's
// VP8 and VP8L decoders with the ALPH unfilters and the fancy upsampler.
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

// The entropy-coded segment's bit stream, read as jdhuff.c reads it
// (jpeg_fill_bit_buffer, the HUFF_DECODE and CHECK_BIT_BUFFER macros,
// jpeg_huff_decode): a fill loads bytes until 57 bits are held; 0xFF 0x00
// (after any 0xFF fill bytes) is a data byte 0xFF; at a marker the reader
// stops and keeps the marker unread; a read of more bits than are held
// then sets `insufficient` (libjpeg's insufficient_data: every later MCU
// of the restart interval is left as it is) and pads with zeros. A fill
// that reaches the data's end first is libjpeg's suspension, for a whole
// file a failure: `suspended`.
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t get_buffer = 0;  // bits_left valid bits at the bottom
  int bits_left = 0;
  int marker = 0;     // the unread marker's code, 0 when none
  int64_t mpos = -1;  // the offset of its 0xFF
  bool insufficient = false, suspended = false;

  bool fill(int nbits) {
    if (suspended) return false;
    if (!marker) {
      while (bits_left < 57) {
        if (pos >= n) return !(suspended = true);
        int c = d[pos++];
        if (c == 0xFF) {
          do {
            if (pos >= n) return !(suspended = true);
            c = d[pos++];
          } while (c == 0xFF);
          if (c != 0) {
            marker = c;
            mpos = pos - 2;
            break;
          }
          c = 0xFF;
        }
        get_buffer = (get_buffer << 8) | (uint64_t)c;
        bits_left += 8;
      }
    }
    if (marker && nbits > bits_left) {
      insufficient = true;
      get_buffer <<= 57 - bits_left;
      bits_left = 57;
    }
    return true;
  }
  int32_t bits(int k) {  // CHECK_BIT_BUFFER then GET_BITS, k in 1..16
    if (bits_left < k && !fill(k)) return 0;
    bits_left -= k;
    return (int32_t)((get_buffer >> bits_left) & ((1u << k) - 1));
  }
  int32_t bit() { return bits(1); }
  // HUFF_DECODE: an 8-bit look-ahead when 8 bits are held, else (or for a
  // longer code) jpeg_huff_decode, one bit at a time to the sentinel
  // length 17, which gives a zero
  int decode(const HuffDecode& h) {
    int l = 1;
    if (bits_left < 8) {
      if (!fill(0)) return 0;
    }
    if (bits_left >= 8) {
      const int32_t look = (int32_t)((get_buffer >> (bits_left - 8)) & 0xFF);
      for (l = 1; l <= 8; ++l) {
        const int32_t code = look >> (8 - l);
        if (code <= h.maxcode[l]) {
          bits_left -= l;
          return h.val[(code + h.valoff[l]) & 0xFF];
        }
      }
      l = 9;
    }
    int32_t code = bits(l);
    while (l <= 16 && code > h.maxcode[l]) {
      code = (code << 1) | bits(1);
      ++l;
    }
    if (l > 16 || suspended) return 0;
    return h.val[(code + h.valoff[l]) & 0xFF];
  }
  // jdmarker.c next_marker: skip to the next marker, FF 00 included
  bool next_marker() {
    for (;;) {
      if (pos >= n) return false;
      int c = d[pos++];
      while (c != 0xFF) {
        if (pos >= n) return false;
        c = d[pos++];
      }
      do {
        if (pos >= n) return false;
        c = d[pos++];
      } while (c == 0xFF);
      if (c != 0) {
        marker = c;
        mpos = pos - 2;
        return true;
      }
    }
  }
  // jdhuff.c process_restart with read_restart_marker and the default
  // jpeg_resync_to_restart: the held bits dropped, the expected RSTn
  // swallowed; another marker scanned past (an invalid one, or an
  // earlier RSTn), left unread (a non-restart marker or one of the next
  // two RSTn: the interval then reads as empty) or dropped (any other
  // RSTn). The out-of-data flag is cleared unless a marker stays unread.
  void restart(int& next_restart_num) {
    get_buffer = 0;
    bits_left = 0;
    if (!marker && !next_marker()) {
      suspended = true;
      return;
    }
    if (marker == 0xD0 + next_restart_num) {
      marker = 0;
    } else {
      const int desired = next_restart_num;
      for (;;) {
        const int m = marker;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        marker = 0;
        if (!next_marker()) {
          suspended = true;
          return;
        }
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
    if (!marker) insufficient = false;
  }
  // after the scan's last MCU: the offset of the next marker's 0xFF, or
  // the data's end
  int64_t end() {
    if (marker) return mpos;
    return next_marker() ? mpos : n;
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
// the scan (or the data's end: libjpeg reads on for more markers), -1
// when a table the scan needs is missing or malformed, -2 when the data
// ends within the scan (libjpeg's suspension: Pillow's truncated file).
// state: [0] the MCU rows of an iMCU row (1 in an interleaved scan, the
// component's v in a single-component one), [1] in and out: jdcoefct.c's
// last_good_iMCU_row, the iMCU row of the last MCU begun while the data
// had not run out (block smoothing reads it).
int64_t gatling_jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t pos,
                                 int32_t ncomp, const int32_t* comp, int16_t* const* coefs,
                                 int32_t mcu_cols, int32_t mcu_rows, const uint8_t* tables,
                                 const int32_t* present, int32_t progressive, int32_t ss,
                                 int32_t se, int32_t ah, int32_t al, int32_t restart,
                                 int32_t* state) {
  HuffDecode dc[4], ac[4];
  const bool dc_scan = !progressive || ss == 0;
  const bool ac_scan = !progressive || ss > 0;
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* ci = comp + 6 * c;
    // a DC refinement needs no table (its selector is never read); a first
    // DC scan and a sequential scan do
    if (dc_scan && !(progressive && ah != 0)) {
      if (ci[3] < 0 || ci[3] > 3) return -1;
      if (!present[ci[3]] || !make_huff_decode(tables + 272 * ci[3], &dc[ci[3]])) return -1;
      // jpeg_make_d_derived_tbl: a DC table's symbols are sizes 0-15
      const uint8_t* spec = tables + 272 * ci[3];
      int count = 0;
      for (int l = 0; l < 16; ++l) count += spec[l];
      for (int i = 0; i < count; ++i)
        if (spec[16 + i] > 15) return -1;
    }
    if (ac_scan) {
      if (ci[4] < 0 || ci[4] > 3) return -1;
      if (!present[4 + ci[4]] || !make_huff_decode(tables + 272 * (4 + ci[4]), &ac[ci[4]]))
        return -1;
    }
  }
  BitReader br{data, n, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  int next_restart_num = 0;
  const int32_t p1 = 1 << al, m1 = -(1 << al);
  const int64_t total = (int64_t)mcu_cols * mcu_rows;
  for (int64_t m = 0; m < total; ++m) {
    if (!br.insufficient) state[1] = (int32_t)(m / mcu_cols / state[0]);
    if (restart > 0 && m > 0 && m % restart == 0) {
      br.restart(next_restart_num);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    if (br.suspended) return -2;
    // out of data: the MCU stays as it is (zero, or its earlier scans'
    // coefficients) and the DC prediction stays where it was
    if (br.insufficient) continue;
    const int64_t mr = m / mcu_cols, mc = m % mcu_cols;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* ci = comp + 6 * c;
      const int32_t h = ci[0], v = ci[1], stride = ci[2];
      for (int32_t y = 0; y < v; ++y) {
        for (int32_t x = 0; x < h; ++x) {
          int16_t* blk = coefs[c] + ((mr * v + y) * (int64_t)stride + mc * h + x) * 64;
          if (!progressive) {  // jdhuff.c decode_mcu
            const int s = br.decode(dc[ci[3]]);
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
            const int s = br.decode(dc[ci[3]]);
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
  if (br.suspended) return -2;
  return br.end();
}

}  // extern "C"

namespace {

// jaricom.c jpeg_aritab: Table D.2 of T.81 as (Qe << 16) | (Next_Index_MPS
// << 8) | (Switch_MPS << 7) | Next_Index_LPS, the last entry the fixed
// probability 0.5 of T.851
#define ARI(i, qe, nlps, nmps, sw) (((int64_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    ARI(0, 0x5a1d, 1, 1, 1),      ARI(1, 0x2586, 14, 2, 0),    ARI(2, 0x1114, 16, 3, 0),
    ARI(3, 0x080b, 18, 4, 0),     ARI(4, 0x03d8, 20, 5, 0),    ARI(5, 0x01da, 23, 6, 0),
    ARI(6, 0x00e5, 25, 7, 0),     ARI(7, 0x006f, 28, 8, 0),    ARI(8, 0x0036, 30, 9, 0),
    ARI(9, 0x001a, 33, 10, 0),    ARI(10, 0x000d, 35, 11, 0),  ARI(11, 0x0006, 9, 12, 0),
    ARI(12, 0x0003, 10, 13, 0),   ARI(13, 0x0001, 12, 13, 0),  ARI(14, 0x5a7f, 15, 15, 1),
    ARI(15, 0x3f25, 36, 16, 0),   ARI(16, 0x2cf2, 38, 17, 0),  ARI(17, 0x207c, 39, 18, 0),
    ARI(18, 0x17b9, 40, 19, 0),   ARI(19, 0x1182, 42, 20, 0),  ARI(20, 0x0cef, 43, 21, 0),
    ARI(21, 0x09a1, 45, 22, 0),   ARI(22, 0x072f, 46, 23, 0),  ARI(23, 0x055c, 48, 24, 0),
    ARI(24, 0x0406, 49, 25, 0),   ARI(25, 0x0303, 51, 26, 0),  ARI(26, 0x0240, 52, 27, 0),
    ARI(27, 0x01b1, 54, 28, 0),   ARI(28, 0x0144, 56, 29, 0),  ARI(29, 0x00f5, 57, 30, 0),
    ARI(30, 0x00b7, 59, 31, 0),   ARI(31, 0x008a, 60, 32, 0),  ARI(32, 0x0068, 62, 33, 0),
    ARI(33, 0x004e, 63, 34, 0),   ARI(34, 0x003b, 32, 35, 0),  ARI(35, 0x002c, 33, 9, 0),
    ARI(36, 0x5ae1, 37, 37, 1),   ARI(37, 0x484c, 64, 38, 0),  ARI(38, 0x3a0d, 65, 39, 0),
    ARI(39, 0x2ef1, 67, 40, 0),   ARI(40, 0x261f, 68, 41, 0),  ARI(41, 0x1f33, 69, 42, 0),
    ARI(42, 0x19a8, 70, 43, 0),   ARI(43, 0x1518, 72, 44, 0),  ARI(44, 0x1177, 73, 45, 0),
    ARI(45, 0x0e74, 74, 46, 0),   ARI(46, 0x0bfb, 75, 47, 0),  ARI(47, 0x09f8, 77, 48, 0),
    ARI(48, 0x0861, 78, 49, 0),   ARI(49, 0x0706, 79, 50, 0),  ARI(50, 0x05cd, 48, 51, 0),
    ARI(51, 0x04de, 50, 52, 0),   ARI(52, 0x040f, 50, 53, 0),  ARI(53, 0x0363, 51, 54, 0),
    ARI(54, 0x02d4, 52, 55, 0),   ARI(55, 0x025c, 53, 56, 0),  ARI(56, 0x01f8, 54, 57, 0),
    ARI(57, 0x01a4, 55, 58, 0),   ARI(58, 0x0160, 56, 59, 0),  ARI(59, 0x0125, 57, 60, 0),
    ARI(60, 0x00f6, 58, 61, 0),   ARI(61, 0x00cb, 59, 62, 0),  ARI(62, 0x00ab, 61, 63, 0),
    ARI(63, 0x008f, 61, 32, 0),   ARI(64, 0x5b12, 65, 65, 1),  ARI(65, 0x4d04, 80, 66, 0),
    ARI(66, 0x412c, 81, 67, 0),   ARI(67, 0x37d8, 82, 68, 0),  ARI(68, 0x2fe8, 83, 69, 0),
    ARI(69, 0x293c, 84, 70, 0),   ARI(70, 0x2379, 86, 71, 0),  ARI(71, 0x1edf, 87, 72, 0),
    ARI(72, 0x1aa9, 87, 73, 0),   ARI(73, 0x174e, 72, 74, 0),  ARI(74, 0x1424, 72, 75, 0),
    ARI(75, 0x119c, 74, 76, 0),   ARI(76, 0x0f6b, 74, 77, 0),  ARI(77, 0x0d51, 75, 78, 0),
    ARI(78, 0x0bb6, 77, 79, 0),   ARI(79, 0x0a40, 77, 48, 0),  ARI(80, 0x5832, 80, 81, 1),
    ARI(81, 0x4d1c, 88, 82, 0),   ARI(82, 0x438e, 89, 83, 0),  ARI(83, 0x3bdd, 90, 84, 0),
    ARI(84, 0x34ee, 91, 85, 0),   ARI(85, 0x2eae, 92, 86, 0),  ARI(86, 0x299a, 93, 87, 0),
    ARI(87, 0x2516, 86, 71, 0),   ARI(88, 0x5570, 88, 89, 1),  ARI(89, 0x4ca9, 95, 90, 0),
    ARI(90, 0x44d9, 96, 91, 0),   ARI(91, 0x3e22, 97, 92, 0),  ARI(92, 0x3824, 99, 93, 0),
    ARI(93, 0x32b4, 99, 94, 0),   ARI(94, 0x2e17, 93, 86, 0),  ARI(95, 0x56a8, 95, 96, 1),
    ARI(96, 0x4f46, 101, 97, 0),  ARI(97, 0x47e5, 102, 98, 0), ARI(98, 0x41cf, 103, 99, 0),
    ARI(99, 0x3c3d, 104, 100, 0), ARI(100, 0x375e, 99, 93, 0), ARI(101, 0x5231, 105, 102, 0),
    ARI(102, 0x4c0f, 106, 103, 0), ARI(103, 0x4639, 107, 104, 0), ARI(104, 0x415e, 103, 99, 0),
    ARI(105, 0x5627, 105, 106, 1), ARI(106, 0x50e7, 108, 107, 0), ARI(107, 0x4b85, 109, 103, 0),
    ARI(108, 0x5597, 110, 109, 0), ARI(109, 0x504f, 111, 107, 0), ARI(110, 0x5a10, 110, 111, 1),
    ARI(111, 0x5522, 112, 109, 0), ARI(112, 0x59eb, 112, 111, 1), ARI(113, 0x5a1d, 113, 113, 0)};
#undef ARI

// jdarith.c's decoder: the C register holds the interval's base and the
// bits read ahead, ct the bits left; at a marker, zeros are fed in (legal
// in arithmetic coding). The data running out is a suspension, which
// jdarith.c does not support: an error.
struct ArithDecoder {
  BitReader br;
  int64_t c = 0, a = 0;
  int ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = 113;

  int get_byte() {
    if (br.pos >= br.n) {
      br.suspended = true;
      return 0;
    }
    return br.d[br.pos++];
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data;
        if (br.marker) {
          data = 0;
        } else {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte();
            while (data == 0xFF && !br.suspended);
            if (data == 0) {
              data = 0xFF;
            } else {
              br.marker = data;
              br.mpos = br.pos - 2;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF);
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void reset_coder() {
    c = 0;
    a = 0;
    ct = -16;
  }
};

// Figures F.19-F.24: a DC difference's value under statistics st0 (the
// context's bins, dc_stats + dc_context) and the table's bins; returns
// false on a magnitude overflow (jdarith.c's "ct = -1")
bool arith_dc_diff(ArithDecoder& e, uint8_t* bins, int* context, int L, int U, int* diff) {
  uint8_t* st = bins + *context;
  if (e.decode(st) == 0) {
    *context = 0;
    *diff = 0;
    return true;
  }
  const int sign = e.decode(st + 1);
  st += 2 + sign;
  int m = e.decode(st);
  if (m != 0) {
    st = bins + 20;
    while (e.decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      st += 1;
    }
  }
  if (m < (int)((1L << L) >> 1)) *context = 0;
  else if (m > (int)((1L << U) >> 1)) *context = 12 + sign * 4;
  else *context = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (e.decode(st)) v |= m;
  v += 1;
  *diff = sign ? -v : v;
  return true;
}

// Figures F.21-F.24 for an AC coefficient at k whose bins are st (the
// table's + 3 * (k - 1) + 2 after the sign); false on overflow
bool arith_ac_value(ArithDecoder& e, uint8_t* table_bins, uint8_t* st, int k, int K, int sign,
                    int* value) {
  int m = e.decode(st);
  if (m != 0) {
    if (e.decode(st)) {
      m <<= 1;
      st = table_bins + (k <= K ? 189 : 217);
      while (e.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (e.decode(st)) v |= m;
  v += 1;
  *value = sign ? -v : v;
  return true;
}

// jdlossls.c's predictors (PREDICTOR1-7)
inline int lossless_predict(int psv, int Ra, int Rb, int Rc) {
  switch (psv) {
    case 1: return Ra;
    case 2: return Rb;
    case 3: return Rc;
    case 4: return (int)((int64_t)Ra + Rb - Rc);
    case 5: return (int)((int64_t)Ra + (((int64_t)Rb - Rc) >> 1));
    case 6: return (int)((int64_t)Rb + (((int64_t)Ra - Rc) >> 1));
    default: return (int)(((int64_t)Ra + Rb) >> 1);
  }
}

}  // namespace

extern "C" {

// Arithmetic-decode one scan of a sequential (SOF9) or progressive (SOF10)
// JPEG as jdarith.c does, into the coefficient blocks; the arguments as
// gatling_jpeg_decode_scan's, with dac: the conditioning of the 16 tables
// (L[16], U[16], K[16], jdmarker.c get_dac over the SOI defaults 0, 1, 5).
// Restart intervals reset the statistics. Returns the offset of the next
// marker, -1 for a table number out of range, -2 when the data ends within
// the scan.
int64_t gatling_jpeg_decode_arith_scan(const uint8_t* data, int64_t n, int64_t pos, int32_t ncomp,
                                       const int32_t* comp, int16_t* const* coefs,
                                       int32_t mcu_cols, int32_t mcu_rows, const int32_t* dac,
                                       int32_t progressive, int32_t ss, int32_t se, int32_t ah,
                                       int32_t al, int32_t restart, int32_t* state) {
  ArithDecoder e;
  e.br = BitReader{data, n, pos};
  std::memset(e.dc_stats, 0, sizeof(e.dc_stats));
  std::memset(e.ac_stats, 0, sizeof(e.ac_stats));
  const bool dc_stats = !progressive || (ss == 0 && ah == 0);
  const bool ac_stats = !progressive || ss != 0;
  int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* ci = comp + 6 * c;
    if ((dc_stats && (ci[3] < 0 || ci[3] > 15)) || (ac_stats && (ci[4] < 0 || ci[4] > 15)))
      return -1;
  }
  const int* L = dac;
  const int* U = dac + 16;
  const int* K = dac + 32;
  int next_restart_num = 0;
  int64_t restarts_to_go = restart;
  const int32_t p1 = 1 << al, m1 = (int32_t)((uint32_t)-1 << al);
  const int64_t total = (int64_t)mcu_cols * mcu_rows;
  for (int64_t m = 0; m < total; ++m) {
    state[1] = (int32_t)(m / mcu_cols / state[0]);
    if (restart) {
      if (restarts_to_go == 0) {  // process_restart
        e.br.restart(next_restart_num);
        if (e.br.suspended) return -2;
        for (int c = 0; c < ncomp; ++c) {
          const int32_t* ci = comp + 6 * c;
          if (dc_stats) {
            std::memset(e.dc_stats[ci[3]], 0, 64);
            last_dc[c] = 0;
            context[c] = 0;
          }
          if (ac_stats) std::memset(e.ac_stats[ci[4]], 0, 256);
        }
        e.reset_coder();
        restarts_to_go = restart;
      }
      --restarts_to_go;
    }
    if (e.ct == -1 && !(progressive && ss == 0 && ah != 0)) continue;  // after an error
    const int64_t mr = m / mcu_cols, mc = m % mcu_cols;
    bool failed = false;
    for (int c = 0; c < ncomp && !failed; ++c) {
      const int32_t* ci = comp + 6 * c;
      const int32_t h = ci[0], v = ci[1], stride = ci[2];
      for (int32_t y = 0; y < v && !failed; ++y) {
        for (int32_t x = 0; x < h && !failed; ++x) {
          int16_t* blk = coefs[c] + ((mr * v + y) * (int64_t)stride + mc * h + x) * 64;
          if (!progressive || (ss == 0 && ah == 0)) {  // decode_mcu's DC, decode_mcu_DC_first
            int diff;
            if (!arith_dc_diff(e, e.dc_stats[ci[3]], &context[c], L[ci[3]], U[ci[3]], &diff)) {
              failed = true;
              break;
            }
            last_dc[c] = (last_dc[c] + diff) & 0xffff;
            blk[0] = progressive ? (int16_t)(uint32_t)((uint32_t)last_dc[c] << al)
                                 : (int16_t)last_dc[c];
            if (progressive) continue;
            // decode_mcu's AC coefficients
            uint8_t* tb = e.ac_stats[ci[4]];
            int k = 0;
            do {
              uint8_t* st = tb + 3 * k;
              if (e.decode(st)) break;  // EOB
              for (;;) {
                ++k;
                if (e.decode(st + 1)) break;
                st += 3;
                if (k >= 63) {
                  failed = true;
                  break;
                }
              }
              if (failed) break;
              const int sign = e.decode(&e.fixed_bin);
              int val;
              if (!arith_ac_value(e, tb, st + 2, k, K[ci[4]], sign, &val)) {
                failed = true;
                break;
              }
              blk[kNatural[k]] = (int16_t)val;
            } while (k < 63);
          } else if (ss == 0) {  // decode_mcu_DC_refine
            if (e.decode(&e.fixed_bin)) blk[0] = (int16_t)(blk[0] | p1);
          } else if (ah == 0) {  // decode_mcu_AC_first
            uint8_t* tb = e.ac_stats[ci[4]];
            for (int k = ss; k <= se; ++k) {
              uint8_t* st = tb + 3 * (k - 1);
              if (e.decode(st)) break;  // EOB
              while (e.decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                  failed = true;
                  break;
                }
              }
              if (failed) break;
              const int sign = e.decode(&e.fixed_bin);
              int val;
              if (!arith_ac_value(e, tb, st + 2, k, K[ci[4]], sign, &val)) {
                failed = true;
                break;
              }
              blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)val << al);
            }
          } else {  // decode_mcu_AC_refine
            uint8_t* tb = e.ac_stats[ci[4]];
            int kex = se;
            for (; kex > 0; --kex)
              if (blk[kNatural[kex]]) break;
            for (int k = ss; k <= se; ++k) {
              uint8_t* st = tb + 3 * (k - 1);
              if (k > kex)
                if (e.decode(st)) break;  // EOB
              for (;;) {
                int16_t* coef = blk + kNatural[k];
                if (*coef) {
                  if (e.decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
                  break;
                }
                if (e.decode(st + 1)) {
                  *coef = (int16_t)(e.decode(&e.fixed_bin) ? m1 : p1);
                  break;
                }
                st += 3;
                if (++k > se) {
                  failed = true;
                  break;
                }
              }
              if (failed) break;
            }
          }
        }
      }
    }
    if (failed) e.ct = -1;
    if (e.br.suspended) return -2;
  }
  if (e.br.suspended) return -2;
  return e.br.end();
}

// Decode the one scan of a lossless Huffman-coded JPEG (SOF3) as
// libjpeg-turbo 3.x does (jdlhuff.c, jddiffct.c, jdlossls.c): each
// sample's difference (category 16 is 32768 with no extra bits), the
// undifferencing with predictor psv (the first row of the scan and of each
// restart interval from 2^(P - Pt - 1) and the left sample, every other
// row's first column from the sample above), modulo 2^16, and the point
// transform's left shift into an 8-bit sample. Out of data, a row's
// differences are zero and the undifferencing starts afresh (jdlhuff.c
// decode_mcus). comp: h, v, width and height (in samples), DC table, 0
// for each component; mcu_cols, imcu_rows: as libjpeg counts them for the
// scan; out: per component, height rows of `width` samples (rounded up to
// whole iMCU rows). Returns the offset of the next marker, -1 for a
// missing or malformed table, -2 when the data ends within the scan, -3
// for a restart interval that is not a whole number of MCU rows.
int64_t gatling_jpeg_decode_lossless(const uint8_t* data, int64_t n, int64_t pos, int32_t ncomp,
                                     const int32_t* comp, uint8_t* const* out, int32_t mcu_cols,
                                     int32_t imcu_rows, const uint8_t* tables,
                                     const int32_t* present, int32_t psv, int32_t pt,
                                     int32_t restart, int32_t precision) {
  HuffDecode dc[4];
  for (int c = 0; c < ncomp; ++c) {
    const int32_t t = comp[6 * c + 4];
    if (t < 0 || t > 3 || !present[t] || !make_huff_decode(tables + 272 * t, &dc[t])) return -1;
    const uint8_t* spec = tables + 272 * t;
    int count = 0;
    for (int l = 0; l < 16; ++l) count += spec[l];
    for (int i = 0; i < count; ++i)
      if (spec[16 + i] > 16) return -1;
  }
  const bool interleaved = ncomp > 1;
  std::vector<std::vector<int32_t>> diff(ncomp), undiff(ncomp);
  std::vector<int32_t> width_alloc(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* ci = comp + 6 * c;
    width_alloc[c] = interleaved ? mcu_cols * ci[0] : ci[2];
    diff[c].assign((size_t)width_alloc[c] * ci[1], 0);
    undiff[c].assign((size_t)width_alloc[c] * ci[1], 0);
  }
  BitReader br{data, n, pos};
  std::vector<uint8_t> first_row(ncomp, 1);  // the undifferencer to use
  int next_restart_num = 0;
  const int64_t mcus_per_row = interleaved ? mcu_cols : comp[2];
  if (restart % mcus_per_row) return -3;
  int64_t restart_rows_to_go = restart / mcus_per_row;
  const int32_t initial = 1 << (precision - pt - 1);
  for (int32_t imcu = 0; imcu < imcu_rows; ++imcu) {
    int32_t mcu_rows_here = 1;
    if (!interleaved)
      mcu_rows_here = imcu < imcu_rows - 1 ? comp[1] : (comp[3] % comp[1] ? comp[3] % comp[1] : comp[1]);
    for (int32_t yoff = 0; yoff < mcu_rows_here; ++yoff) {
      if (restart && restart_rows_to_go == 0) {  // jddiffct.c process_restart
        br.restart(next_restart_num);
        if (br.suspended) return -2;
        std::fill(first_row.begin(), first_row.end(), 1);
        restart_rows_to_go = restart / mcus_per_row;
      }
      for (int c = 0; c < ncomp; ++c) {
        if (!br.insufficient) break;
        const int32_t hh = interleaved ? comp[6 * c] : 1, vv = interleaved ? comp[6 * c + 1] : 1;
        const int32_t row0 = interleaved ? 0 : yoff;
        for (int32_t y = 0; y < vv; ++y) {
          auto first = diff[c].begin() + (size_t)(row0 + y) * width_alloc[c];
          std::fill(first, first + (size_t)mcus_per_row * hh, 0);
        }
      }
      if (br.insufficient) {
        std::fill(first_row.begin(), first_row.end(), 1);
      } else {
        for (int64_t mc = 0; mc < mcus_per_row; ++mc) {
          for (int c = 0; c < ncomp; ++c) {
            const int32_t* ci = comp + 6 * c;
            const int32_t hh = interleaved ? ci[0] : 1, vv = interleaved ? ci[1] : 1;
            for (int32_t y = 0; y < vv; ++y)
              for (int32_t x = 0; x < hh; ++x) {
                int32_t s = br.decode(dc[ci[4]]);
                if (s) s = s == 16 ? 32768 : extend(br.bits(s), s);
                const int32_t row = interleaved ? y : yoff;
                diff[c][(size_t)row * width_alloc[c] + mc * hh + x] = s;
              }
          }
          if (br.suspended) return -2;
        }
      }
      if (restart) --restart_rows_to_go;
    }
    // undifference and scale each component's rows of this iMCU row
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* ci = comp + 6 * c;
      const int32_t v = ci[1], width = ci[2];
      const int32_t rows = imcu < imcu_rows - 1 ? v : (ci[3] % v ? ci[3] % v : v);
      for (int32_t row = 0, prev = v - 1; row < rows; prev = row, ++row) {
        const int32_t* d = diff[c].data() + (size_t)row * width_alloc[c];
        const int32_t* p = undiff[c].data() + (size_t)prev * width_alloc[c];
        int32_t* u = undiff[c].data() + (size_t)row * width_alloc[c];
        if (first_row[c]) {
          int32_t Ra = (d[0] + initial) & 0xFFFF;
          u[0] = Ra;
          for (int32_t x = 1; x < width; ++x) u[x] = Ra = (d[x] + Ra) & 0xFFFF;
          first_row[c] = 0;
        } else {
          int32_t Rb = p[0];
          int32_t Ra = (d[0] + Rb) & 0xFFFF;
          u[0] = Ra;
          for (int32_t x = 1; x < width; ++x) {
            const int32_t Rc = Rb;
            Rb = p[x];
            u[x] = Ra = (d[x] + lossless_predict(psv, Ra, Rb, Rc)) & 0xFFFF;
          }
        }
        uint8_t* o = out[c] + ((size_t)imcu * v + row) * width;
        for (int32_t x = 0; x < width; ++x) o[x] = (uint8_t)((uint32_t)u[x] << pt);
      }
    }
  }
  if (br.suspended) return -2;
  return br.end();
}

// Dequantise and inverse-transform nblocks coefficient blocks (natural
// order) with jidctint.c's jpeg_idct_islow, as libjpeg-turbo's SIMD islow
// IDCT computes it (jidctint-sse2/avx2.asm): the dequantised
// coefficients, the even part's in0 +- in4 and the odd part's z3, z4 are
// 16-bit words (they wrap), the products 32-bit; each pass saturates its
// outputs to 16 bits, the last to 0..255. A block whose AC coefficients
// are all zero takes pass 1's shortcut, its DC word shifted left by
// PASS1_BITS (wrapping). For coefficients that fit, the same bits as the
// C code. quant: 64 entries, natural order.
namespace {

inline int32_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t sat16(int32_t x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); }

// one 1-D pass over words in[0..7] (stride 1): outputs before descaling
void idct_1d(const int32_t* in, int32_t* out) {
  const int32_t F054 = (int32_t)F0541, F130 = (int32_t)(F0541 + F0765),
                MF130 = (int32_t)(F0541 - F1847), F117 = (int32_t)F1175,
                MF078 = (int32_t)(F1175 - F1961), F078 = (int32_t)(F1175 - F0390),
                MF060 = (int32_t)(F0298 - F0899), MF089 = -(int32_t)F0899,
                F060 = (int32_t)(F1501 - F0899), MF050 = (int32_t)(F2053 - F2562),
                MF256 = -(int32_t)F2562, F050 = (int32_t)(F3072 - F2562);
  const int32_t tmp3e = in[2] * F130 + in[6] * F054;
  const int32_t tmp2e = in[2] * F054 + in[6] * MF130;
  const int32_t tmp0e = w16(in[0] + in[4]) * (1 << kConstBits);
  const int32_t tmp1e = w16(in[0] - in[4]) * (1 << kConstBits);
  const int32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int32_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
  const int32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  const int32_t z3 = w16(t0 + t2), z4 = w16(t1 + t3);
  const int32_t Z3 = z3 * MF078 + z4 * F117, Z4 = z3 * F117 + z4 * F078;
  const int32_t T0 = t0 * MF060 + t3 * MF089 + Z3, T3 = t0 * MF089 + t3 * F060 + Z4;
  const int32_t T1 = t1 * MF050 + t2 * MF256 + Z4, T2 = t1 * MF256 + t2 * F050 + Z3;
  out[0] = tmp10 + T3;
  out[7] = tmp10 - T3;
  out[1] = tmp11 + T2;
  out[6] = tmp11 - T2;
  out[2] = tmp12 + T1;
  out[5] = tmp12 - T1;
  out[3] = tmp13 + T0;
  out[4] = tmp13 - T0;
}

}  // namespace

void gatling_jpeg_idct_islow(const int16_t* coefs, int64_t nblocks, const uint16_t* quant,
                             uint8_t* out) {
  for (int64_t b = 0; b < nblocks; ++b) {
    const int16_t* in = coefs + b * 64;
    int32_t ws[64];
    bool ac_zero = true;
    for (int k = 8; k < 64; ++k) ac_zero = ac_zero && in[k] == 0;
    for (int col = 0; col < 8; ++col) {  // pass 1: columns
      int32_t v[8], o[8];
      for (int r = 0; r < 8; ++r) v[r] = w16((int32_t)in[r * 8 + col] * quant[r * 8 + col]);
      if (ac_zero) {
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = w16(v[0] * (1 << kPass1Bits));
        continue;
      }
      idct_1d(v, o);
      const int sh = kConstBits - kPass1Bits;
      for (int r = 0; r < 8; ++r) ws[r * 8 + col] = sat16((o[r] + (1 << (sh - 1))) >> sh);
    }
    uint8_t* dst = out + b * 64;
    for (int row = 0; row < 8; ++row) {  // pass 2: rows
      int32_t o[8];
      idct_1d(ws + row * 8, o);
      const int sh = kConstBits + kPass1Bits + 3;
      for (int k = 0; k < 8; ++k) {
        const int32_t x = sat16((o[k] + (1 << (sh - 1))) >> sh);
        dst[row * 8 + k] = (uint8_t)((x < -128 ? -128 : (x > 127 ? 127 : x)) + 128);
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
// 9-12 bits, Clear 256, EOI 257, the code width growing one code early; a
// table without a Clear fills at libtiff's 5,119 entries.
// Decodes at most `cap` bytes; returns the count written, or -2 - the count
// written before a code that is not in the table (libtiff's buffer keeps
// those bytes).
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
      if (code > 256) return -2 - o;
      put(code);
      old = code;
      continue;
    }
    // libtiff's table has CSIZE = 5119 entries: past 4095 it goes on adding
    // entries no 12-bit code can name, and once it is full any code but
    // Clear and EOI is "not yet in table"
    if (old < 0 || next >= 5119) return -2 - o;
    if (code < next) {
      put(code);
      if (next < 4096) {
        prefix[next] = old;
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = length[old] + 1;
      }
      ++next;
    } else if (code == next && next < 4096) {
      prefix[next] = old;
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = length[old] + 1;
      ++next;
      put(code);
    } else {
      return -2 - o;
    }
    old = code;
    if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  return o < cap ? o : cap;
}

// Old-style TIFF LZW (libtiff's LZWDecodeCompat): codes LSB-first, the
// code width growing one code later than in the new style. Returns the
// bytes written (at most cap), or -2 - the bytes written before a corrupt
// table entry.
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
      if (code > kClear) return -2 - o;
      dst[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= kSize || code > free_ent) return -2 - o;
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
      if (len == 0) return -2 - o;
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

// ---------------------------------------------------------------------------
// WebP (imgio/webp.py, vp8.py, vp8l.py): the loops of libwebp 1.6.0's
// decoder, which Pillow's WebP plugin decodes with, followed statement for
// statement so that decodes equal its output code for code. VP8 (lossy,
// RFC 6386): the boolean decoder (bit_reader_inl_utils.h), the frame
// header's boolean-coded part, the intra modes and coefficient tokens
// (tree_dec.c, vp8_dec.c), dequantisation (quant_dec.c), the inverse WHT
// and DCT, the intra predictors and the loop filters (dsp/dec.c) over the
// reconstruction's work buffer (frame_dec.c). VP8L (lossless, RFC 9649):
// the bit reader, prefix codes with libwebp's two-level tables
// (huffman_utils.c), the meta prefix codes, LZ77 with the distance map,
// the colour cache and the four inverse transforms (vp8l_dec.c,
// lossless.c). Then the stages after the decoders: the ALPH unfilters
// (dsp/filters.c) and the fancy upsampler with the YUV -> RGB conversion
// (dsp/upsampling.c, dsp/yuv.h).
// ---------------------------------------------------------------------------

namespace {

static const uint8_t kVp8DcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kVp8AcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t kVp8BModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kVp8CoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kVp8CoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kVp8lCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kVp8Zigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kVp8Bands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kVp8Cat3[] = {173, 148, 140, 0};
const uint8_t kVp8Cat4[] = {176, 155, 140, 135, 0};
const uint8_t kVp8Cat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kVp8Cat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kVp8Cat3456[] = {kVp8Cat3, kVp8Cat4, kVp8Cat5, kVp8Cat6};
// the 4x4 intra modes in libwebp's order, and its tree over them
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kVp8YModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                     -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
const int kBps = 32;  // the work buffer's stride (frame_dec.c BPS)

// VP8BitReader, one byte at a time (bulk loads read the same bits): eof is
// set at the first load past the data's end
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 254;  // the range minus 1, in [127, 254]
  int bits = -8;
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  int eof = 0;

  void init(const uint8_t* start, size_t size) {
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    buf = start;
    end = start + size;
    load();
  }
  void load() {  // VP8LoadFinalBytes
    if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {  // VP8GetSigned: a sign at probability 1/2
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t value32 = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - value32) >> 31;  // -1 or 0
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int32_t get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get_value(1) ? -v : v;
  }
};

inline int clip8(int v) { return (v & ~0xff) == 0 ? v : (v < 0 ? 0 : 255); }
inline int clip_range(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

struct Vp8Filter {  // VP8FInfo
  uint8_t limit, ilevel, inner, hev_thresh;
};

struct Vp8Mb {  // the per-macroblock parse state (VP8MB and VP8MBData)
  uint8_t nz, nz_dc;
};

struct Vp8Decoder {
  int mb_w = 0, mb_h = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0, num_parts_minus_one = 0, base_q = 0;
  BoolReader br, parts[8];
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  Vp8Filter fstrengths[4][2];
};

// VP8GetHeaders from the colour space bit on: the segment and filter
// headers, the token partitions, the quantisers and the coefficient
// probabilities. 0, or a negative code (see gatling_vp8_decode).
int vp8_parse_header(Vp8Decoder& d, const uint8_t* part0, size_t part0_size,
                     const uint8_t* rest, size_t rest_size, int32_t* info) {
  BoolReader& br = d.br;
  br.init(part0, part0_size);
  info[0] = (int32_t)br.get_value(1);  // colour space
  info[1] = (int32_t)br.get_value(1);  // clamping type
  d.use_segment = (int)br.get_value(1);
  if (d.use_segment) {  // ParseSegmentHeader
    d.update_map = (int)br.get_value(1);
    if (br.get_value(1)) {
      d.absolute_delta = (int)br.get_value(1);
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        d.filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s) d.segment_probs[s] = br.get_value(1) ? br.get_value(8) : 255;
  } else {
    d.update_map = 0;
  }
  if (br.eof) return -1;
  d.simple = (int)br.get_value(1);  // ParseFilterHeader
  d.level = (int)br.get_value(6);
  d.sharpness = (int)br.get_value(3);
  d.use_lf_delta = (int)br.get_value(1);
  if (d.use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) d.ref_lf_delta[i] = br.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) d.mode_lf_delta[i] = br.get_signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : (d.simple ? 1 : 2);
  if (br.eof) return -2;
  {  // ParsePartitions
    d.num_parts_minus_one = (1 << br.get_value(2)) - 1;
    const size_t last_part = (size_t)d.num_parts_minus_one;
    if (rest_size < 3 * last_part) return -3;
    const uint8_t* sz = rest;
    const uint8_t* part_start = rest + last_part * 3;
    size_t size_left = rest_size - last_part * 3;
    for (size_t p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      d.parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    d.parts[last_part].init(part_start, size_left);
    if (!(part_start < rest + rest_size)) return -3;
  }
  {  // VP8ParseQuant
    const int base_q0 = (int)br.get_value(7);
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    d.base_q = base_q0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (d.use_segment) {
        q = d.quantizer[i];
        if (!d.absolute_delta) q += base_q0;
      } else if (i > 0) {
        for (int k = 0; k < 2; ++k) {
          d.y1[i][k] = d.y1[0][k];
          d.y2[i][k] = d.y2[0][k];
          d.uv[i][k] = d.uv[0][k];
        }
        continue;
      } else {
        q = base_q0;
      }
      d.y1[i][0] = kVp8DcTable[clip_range(q + dqy1_dc, 0, 127)];
      d.y1[i][1] = kVp8AcTable[clip_range(q, 0, 127)];
      d.y2[i][0] = kVp8DcTable[clip_range(q + dqy2_dc, 0, 127)] * 2;
      d.y2[i][1] = (kVp8AcTable[clip_range(q + dqy2_ac, 0, 127)] * 101581) >> 16;
      if (d.y2[i][1] < 8) d.y2[i][1] = 8;
      d.uv[i][0] = kVp8DcTable[clip_range(q + dquv_dc, 0, 117)];
      d.uv[i][1] = kVp8AcTable[clip_range(q + dquv_ac, 0, 127)];
    }
  }
  br.get_value(1);  // update_proba, ignored
  for (int t = 0; t < 4; ++t)  // VP8ParseProba
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 11 * 3; ++c) {
        const int ctx = c / 11, p = c % 11;
        d.proba[t][b][ctx][p] = br.get_bit(kVp8CoeffsUpdateProba[t][b][ctx][p])
                                    ? (uint8_t)br.get_value(8)
                                    : kVp8CoeffsProba0[t][b][ctx][p];
      }
  d.use_skip_proba = (int)br.get_value(1);
  if (d.use_skip_proba) d.skip_p = (int)br.get_value(8);
  // PrecomputeFilterStrengths
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      Vp8Filter& f = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = clip_range(level, 0, 63);
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        f.ilevel = (uint8_t)ilevel;
        f.limit = (uint8_t)(2 * level + ilevel);
        f.hev_thresh = (uint8_t)(level >= 40 ? 2 : (level >= 15 ? 1 : 0));
      } else {
        f.limit = 0;
        f.ilevel = 0;
        f.hev_thresh = 0;
      }
      f.inner = (uint8_t)i4x4;
    }
  }
  info[2] = d.use_segment;
  info[3] = d.update_map;
  info[4] = d.filter_type;
  info[5] = d.level;
  info[6] = d.sharpness;
  info[7] = d.num_parts_minus_one + 1;
  info[8] = d.base_q;
  info[9] = d.use_skip_proba;
  return 0;
}

// GetLargeValue (RFC 6386 13.2)
int vp8_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    v = !br.get_bit(p[4]) ? 2 : 3 + br.get_bit(p[5]);
  } else if (!br.get_bit(p[6])) {
    if (!br.get_bit(p[7])) {
      v = 5 + br.get_bit(159);
    } else {
      v = 7 + 2 * br.get_bit(165);
      v += br.get_bit(145);
    }
  } else {
    const int bit1 = br.get_bit(p[8]);
    const int bit0 = br.get_bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kVp8Cat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// GetCoeffs: the position after the last non-zero coefficient
int vp8_coeffs(BoolReader& br, uint8_t (*band)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = band[kVp8Bands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = band[kVp8Bands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = band[kVp8Bands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = vp8_large_value(br, p);
      p = p_ctx[2];
    }
    out[kVp8Zigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void vp8_transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ParseResiduals: 1 when the macroblock has no non-zero coefficient; nz[0]
// and nz[1] the 2-bit transform codes of its luma and chroma blocks
int vp8_residuals(Vp8Decoder& d, Vp8Mb* mb, Vp8Mb* left, int segment, int is_i4x4,
                  BoolReader& br, int16_t* coeffs, uint32_t* nz) {
  int16_t* dst = coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  uint8_t(*ac_proba)[3][11];
  std::memset(dst, 0, 384 * sizeof(int16_t));
  if (!is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb->nz_dc + left->nz_dc;
    const int nz = vp8_coeffs(br, d.proba[1], ctx, d.y2[segment], 0, dc);
    mb->nz_dc = left->nz_dc = (uint8_t)(nz > 0);
    if (nz > 1) {
      vp8_transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint8_t tnz = mb->nz & 0x0f;
  uint8_t lnz = left->nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = vp8_coeffs(br, ac_proba, ctx, d.y1[segment], first, dst);
      l = (nz > first);
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(mb->nz >> (4 + ch));
    lnz = (uint8_t)(left->nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = vp8_coeffs(br, d.proba[2], ctx, d.uv[segment], 0, dst);
        l = (nz > 0);
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb->nz = (uint8_t)out_t_nz;
  left->nz = (uint8_t)out_l_nz;
  nz[0] = non_zero_y;
  nz[1] = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne (C, 32-bit ints): the inverse DCT added to the prediction;
// TransformDC and TransformAC3, libwebp's C shortcuts for the blocks of
// transform code 1 and 2, give the same bits
void vp8_transform(const int16_t* in, uint8_t* dst) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]);
    const int dd = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + dd;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - dd;
    tmp += 4;
    in++;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]);
    const int dd = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = (uint8_t)clip8(dst[0] + ((a + dd) >> 3));
    dst[1] = (uint8_t)clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = (uint8_t)clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = (uint8_t)clip8(dst[3] + ((a - dd) >> 3));
    tmp++;
    dst += kBps;
  }
}

// Transform_SSE2, which libwebp on x86 runs for the blocks of transform
// code 3 (and every chroma block of a macroblock with chroma AC): the
// same transform in 16-bit lanes (sums wrap, the multiplications by
// 35468 / 65536 and 85627 / 65536 as mulhi by -30068 and 20091 plus the
// input), then the prediction added in 16 bits and saturated to 0..255.
// It equals TransformOne unless a damaged stream's coefficients overflow.
void vp8_transform_simd(const int16_t* in, uint8_t* dst) {
  auto w = [](int x) { return (int)(int16_t)(uint16_t)(unsigned)x; };
  auto mulhi = [](int x, int k) { return (x * k) >> 16; };
  auto pass = [&](int i0, int i1, int i2, int i3, int* o) {  // a column or a row
    const int a = w(i0 + i2), b = w(i0 - i2);
    const int c = w(w(i1 - i3) + w(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int d = w(w(i1 + i3) + w(mulhi(i1, 20091) + mulhi(i3, -30068)));
    o[0] = w(a + d);
    o[1] = w(b + c);
    o[2] = w(b - c);
    o[3] = w(a - d);
  };
  int tmp[4][4], col[4], row[4];
  for (int j = 0; j < 4; ++j) {
    pass(in[j], in[4 + j], in[8 + j], in[12 + j], col);
    for (int k = 0; k < 4; ++k) tmp[j][k] = col[k];
  }
  for (int r = 0; r < 4; ++r) {
    pass(w(tmp[0][r] + 4), tmp[1][r], tmp[2][r], tmp[3][r], row);
    for (int c = 0; c < 4; ++c) {
      const int v = w(dst[r * kBps + c] + (row[c] >> 3));
      dst[r * kBps + c] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// frame_dec.c DoTransform: a luma block by its 2-bit transform code
inline void vp8_do_transform(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) {
    vp8_transform_simd(in, dst);
  } else if (code) {
    vp8_transform(in, dst);
  }
}

// DoUVTransform: a chroma plane's four blocks (codes in bits 0-7)
inline void vp8_do_uv_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * kBps;
    if (bits & 0xaa) {
      vp8_transform_simd(in + n * 16, d);
    } else if (in[n * 16]) {
      vp8_transform(in + n * 16, d);
    }
  }
}

#define DST(x, y) dst[(x) + (y) * kBps]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = (uint8_t)clip8(top[x] + dst[-1] - top[-1]);
    dst += kBps;
  }
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - kBps;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - kBps] + dst[-1 + i * kBps];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * kBps, (int)dc, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * kBps, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - kBps], B = dst[-1], C = dst[-1 + kBps], D = dst[-1 + 2 * kBps],
                E = dst[-1 + 3 * kBps];
      std::memset(dst + 0 * kBps, avg3(A, B, C), 4);
      std::memset(dst + 1 * kBps, avg3(B, C, D), 4);
      std::memset(dst + 2 * kBps, avg3(C, D, E), 4);
      std::memset(dst + 3 * kBps, avg3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps],
                X = dst[-1 - kBps], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], X = dst[-1 - kBps],
                A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps],
                X = dst[-1 - kBps], A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: {  // B_HU
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
  }
}
#undef DST

// the 16x16 luma (size 16) and 8x8 chroma (size 8) predictors; DC checks
// which neighbours exist (CheckMode)
void pred_block(int mode, uint8_t* dst, int size, int has_top, int has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_TM:
      true_motion(dst, size);
      return;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * kBps, dst - kBps, size);
      return;
    case B_HE:
      for (int j = 0; j < size; ++j) std::memset(dst + j * kBps, dst[j * kBps - 1], size);
      return;
    default: {
      int dc;
      if (has_top && has_left) {
        dc = size;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * kBps] + dst[j - kBps];
        dc >>= shift + 1;
      } else if (has_left) {
        dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * kBps];
        dc >>= shift;
      } else if (has_top) {
        dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[j - kBps];
        dc >>= shift;
      } else {
        dc = 0x80;
      }
      for (int j = 0; j < size; ++j) std::memset(dst + j * kBps, dc, size);
    }
  }
}

// the loop filters (dsp/dec.c, RFC 6386 15)
inline int sclip1(int v) { return clip_range(v, -128, 127); }
inline int sclip2(int v) { return clip_range(v, -16, 15); }
inline int uclip(int v) { return clip_range(v, 0, 255); }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)uclip(p0 + a2);
  p[0] = (uint8_t)uclip(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)uclip(p1 + a3);
  p[-step] = (uint8_t)uclip(p0 + a2);
  p[0] = (uint8_t)uclip(q0 - a1);
  p[step] = (uint8_t)uclip(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)uclip(p2 + a3);
  p[-2 * step] = (uint8_t)uclip(p1 + a2);
  p[-step] = (uint8_t)uclip(p0 + a1);
  p[0] = (uint8_t)uclip(q0 - a1);
  p[step] = (uint8_t)uclip(q1 - a2);
  p[2 * step] = (uint8_t)uclip(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {  // 16 pixels
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// DoFilter on macroblock (mb_x, mb_y) of the frame's planes
void vp8_filter_mb(int filter_type, const Vp8Filter& f, int mb_x, int mb_y, uint8_t* yp,
                   uint8_t* up, uint8_t* vp, int ys, int uvs) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* y_dst = yp + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u_dst = up + (size_t)mb_y * 8 * uvs + mb_x * 8;
  uint8_t* v_dst = vp + (size_t)mb_y * 8 * uvs + mb_x * 8;
  const int il = f.ilevel, ht = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop26(y_dst, 1, ys, 16, limit + 4, il, ht);
    filter_loop26(u_dst, 1, uvs, 8, limit + 4, il, ht);
    filter_loop26(v_dst, 1, uvs, 8, limit + 4, il, ht);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, il, ht);
    filter_loop24(u_dst + 4, 1, uvs, 8, limit, il, ht);
    filter_loop24(v_dst + 4, 1, uvs, 8, limit, il, ht);
  }
  if (mb_y > 0) {
    filter_loop26(y_dst, ys, 1, 16, limit + 4, il, ht);
    filter_loop26(u_dst, uvs, 1, 8, limit + 4, il, ht);
    filter_loop26(v_dst, uvs, 1, 8, limit + 4, il, ht);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, il, ht);
    filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, il, ht);
    filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, il, ht);
  }
}

// ---- VP8L ----

// VP8LBitReader: 64 bits held, bit_pos the bits used of them; eos once
// every byte is loaded and more than 64 bits are used
struct LBitReader {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0;
  int eos = 0;

  void init(const uint8_t* start, size_t length) {
    len = length;
    val = 0;
    bit_pos = 0;
    eos = 0;
    const size_t n = length > 8 ? 8 : length;
    for (size_t i = 0; i < n; ++i) val |= (uint64_t)start[i] << (8 * i);
    pos = n;
    buf = start;
  }
  bool is_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (is_end()) set_end();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
};

struct HuffmanCode {
  uint8_t bits;
  uint16_t value;
};

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HuffmanCode* table, int step, int end, HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < 15) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// BuildHuffmanTable: the table's size, 0 for an invalid code (incomplete
// or oversubscribed; a code of one symbol is valid and reads no bit).
// root == nullptr checks the code alone.
int build_huffman(HuffmanCode* root, int root_bits, const int* lengths, int n) {
  int count[16] = {0}, offset[16];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = (uint16_t)s;
  int total_size = 1 << root_bits;
  if (offset[15] == 1) {
    if (root) replicate(root, 1, total_size, HuffmanCode{0, sorted[0]});
    return total_size;
  }
  HuffmanCode* table = root;
  uint32_t low = 0xffffffffu, mask = (uint32_t)total_size - 1, key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << table_bits;
  int symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if (root) replicate(&table[key], step, table_size, HuffmanCode{(uint8_t)len, sorted[symbol]});
      ++symbol;
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= 15; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = (uint8_t)(table_bits + root_bits);
          root[low].value = (uint16_t)((table - root) - low);
        }
      }
      if (root)
        replicate(&table[key >> root_bits], step, table_size,
                  HuffmanCode{(uint8_t)(len - root_bits), sorted[symbol]});
      ++symbol;
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[15] - 1) return 0;
  return total_size;
}

struct Huffman {  // one prefix code's tables
  std::vector<HuffmanCode> table;
  bool build(int root_bits, const int* lengths, int n) {
    const int size = build_huffman(nullptr, root_bits, lengths, n);
    if (size == 0) return false;
    table.assign(size, HuffmanCode{0, 0});
    return build_huffman(table.data(), root_bits, lengths, n) != 0;
  }
  int read(LBitReader& br) const {  // ReadSymbol
    const HuffmanCode* t = table.data();
    uint32_t v = br.prefetch();
    t += v & 0xff;
    const int nbits = t->bits - 8;
    if (nbits > 0) {
      br.bit_pos += 8;
      v = br.prefetch();
      t += t->value;
      t += v & ((1u << nbits) - 1);
    }
    br.bit_pos += t->bits;
    return t->value;
  }
  int bits0() const { return table[0].bits; }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                                      13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

struct HTreeGroup {
  Huffman htrees[5];  // green (with lengths and cache codes), red, blue, alpha, distance
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Vp8lDecoder {
  LBitReader br;
  int next_transform = 0;
  uint32_t transforms_seen = 0;
  Transform transforms[4];
  int32_t* info = nullptr;
};

// ReadHuffmanCodeLengths
bool read_code_lengths(LBitReader& br, const int* cl_code_lengths, int num_symbols,
                       int* code_lengths) {
  Huffman table;
  if (!table.build(7, cl_code_lengths, 19)) return false;
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev_code_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HuffmanCode& p = table.table[br.prefetch() & 127];
    br.bit_pos += p.bits;
    const int code_len = p.value;
    if (code_len < 16) {
      code_lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const int kExtraBits[3] = {2, 3, 7}, kRepeatOffsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = (int)br.read(kExtraBits[slot]) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) code_lengths[symbol++] = length;
    }
  }
  return true;
}

// ReadHuffmanCode into `out` (nullptr: checked and dropped)
bool read_huffman_code(LBitReader& br, int alphabet_size, std::vector<int>& code_lengths,
                       Huffman* out) {
  std::fill(code_lengths.begin(), code_lengths.end(), 0);
  bool ok;
  if (br.read(1)) {  // simple code: one or two symbols of length 1
    const int num_symbols = (int)br.read(1) + 1;
    const int first_symbol_len_code = (int)br.read(1);
    int symbol = (int)br.read(first_symbol_len_code == 0 ? 1 : 8);
    code_lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = (int)br.read(8);
      code_lengths[symbol] = 1;
    }
    ok = true;
  } else {
    int cl_code_lengths[19] = {0};
    const int num_codes = (int)br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl_code_lengths[kCodeLengthCodeOrder[i]] = (int)br.read(3);
    ok = read_code_lengths(br, cl_code_lengths, alphabet_size, code_lengths.data());
  }
  ok = ok && !br.eos;
  if (!ok) return false;
  if (out) return out->build(8, code_lengths.data(), alphabet_size);
  return build_huffman(nullptr, 8, code_lengths.data(), alphabet_size) != 0;
}

inline int sub_sample_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int copy_distance(int symbol, LBitReader& br) {  // GetCopyDistance / GetCopyLength
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + (int)br.read(extra_bits) + 1;
}

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kVp8lCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

bool decode_image_stream(Vp8lDecoder& dec, int xsize, int ysize, int is_level0,
                         std::vector<uint32_t>* out, int alpha_mode);

// the entropy-coded pixels of one image: 0 ok, 1 eos, 2 a bad backward
// reference. `lenient`: libwebp's 8-bit alpha path (DecodeAlphaData), which
// accepts an eos once every pixel is decoded.
int decode_pixels(LBitReader& br, std::vector<HTreeGroup>& groups, const std::vector<uint32_t>& meta,
                  int meta_bits, int meta_xsize, int cache_bits, int width, int height,
                  uint32_t* data, bool lenient) {
  const int64_t end = (int64_t)width * height;
  const int len_code_limit = 256 + 24;
  const int cache_limit = len_code_limit + (cache_bits > 0 ? 1 << cache_bits : 0);
  std::vector<uint32_t> cache(cache_bits > 0 ? (size_t)1 << cache_bits : 0, 0);
  const int hash_shift = 32 - cache_bits;
  int64_t src = 0, last_cached = 0;
  int col = 0, row = 0;
  auto insert_cached = [&]() {
    if (cache_bits > 0)
      while (last_cached < src) {
        const uint32_t argb = data[last_cached++];
        cache[(uint32_t)(argb * 0x1e35a7bdu) >> hash_shift] = argb;
      }
  };
  while (src < end) {
    const HTreeGroup& g =
        groups[meta_bits == 0 ? 0 : meta[(size_t)meta_xsize * (row >> meta_bits) + (col >> meta_bits)]];
    br.fill();
    const int code = g.htrees[0].read(br);
    if (!lenient && br.is_end()) break;
    if (code < 256) {
      if (lenient) {
        data[src] = (uint32_t)code << 8;
      } else {
        const int red = g.htrees[1].read(br);
        br.fill();
        const int blue = g.htrees[2].read(br);
        const int alpha = g.htrees[3].read(br);
        if (br.is_end()) break;
        data[src] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) |
                    (uint32_t)blue;
      }
      ++src;
      if (++col >= width) {
        col = 0;
        ++row;
        insert_cached();
      }
    } else if (code < len_code_limit) {
      const int length = copy_distance(code - 256, br);
      const int dist_symbol = g.htrees[4].read(br);
      br.fill();
      const int dist_code = copy_distance(dist_symbol, br);
      const int dist = plane_code_to_distance(width, dist_code);
      if (!lenient && br.is_end()) break;
      if (src < dist || end - src < length) return 2;
      for (int i = 0; i < length; ++i) data[src + i] = data[src + i - dist];
      src += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      insert_cached();
    } else if (code < cache_limit) {
      insert_cached();
      data[src] = cache[code - len_code_limit];
      ++src;
      if (++col >= width) {
        col = 0;
        ++row;
        insert_cached();
      }
    } else {
      return 2;
    }
    if (lenient) {
      br.eos = br.is_end() ? 1 : br.eos;
      if (br.eos) break;
    }
  }
  if (lenient) return (br.is_end() && src < end) ? 1 : 0;
  return br.is_end() ? 1 : 0;
}

// ReadHuffmanCodes (with the meta prefix codes at level 0) and the pixels
bool decode_image_stream(Vp8lDecoder& dec, int xsize, int ysize, int is_level0,
                         std::vector<uint32_t>* out, int alpha_mode) {
  LBitReader& br = dec.br;
  int transform_xsize = xsize;
  const int transform_ysize = ysize;
  bool ok = true;
  if (is_level0) {
    while (ok && br.read(1)) {  // ReadTransform
      const int type = (int)br.read(2);
      if (dec.transforms_seen & (1u << type)) return false;
      dec.transforms_seen |= 1u << type;
      Transform& t = dec.transforms[dec.next_transform++];
      t.type = type;
      t.xsize = transform_xsize;
      t.ysize = transform_ysize;
      t.bits = 0;
      t.data.clear();
      if (type == 0 || type == 1) {
        t.bits = 2 + (int)br.read(3);
        ok = decode_image_stream(dec, sub_sample_size(t.xsize, t.bits),
                                 sub_sample_size(t.ysize, t.bits), 0, &t.data, 0);
      } else if (type == 3) {
        const int num_colors = (int)br.read(8) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        transform_xsize = sub_sample_size(t.xsize, bits);
        t.bits = bits;
        ok = decode_image_stream(dec, num_colors, 1, 0, &t.data, 0);
        if (ok) {  // ExpandColorMap: deltas, then a black tail
          const int final_num_colors = 1 << (8 >> bits);
          std::vector<uint32_t> map(final_num_colors, 0);
          uint8_t* nd = reinterpret_cast<uint8_t*>(map.data());
          const uint8_t* od = reinterpret_cast<const uint8_t*>(t.data.data());
          map[0] = t.data[0];
          for (int i = 4; i < 4 * num_colors; ++i) nd[i] = (uint8_t)((od[i] + nd[i - 4]) & 0xff);
          t.data.swap(map);
        }
      }
    }
  }
  int cache_bits = 0;
  if (ok && br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  if (!ok) return false;
  // ReadHuffmanCodes
  std::vector<uint32_t> meta;
  int meta_bits = 0, meta_xsize = 0;
  int num_groups = 1, num_groups_max = 1;
  std::vector<int> mapping;
  if (is_level0 && br.read(1)) {
    const int precision = 2 + (int)br.read(3);
    const int hx = sub_sample_size(transform_xsize, precision);
    const int hy = sub_sample_size(transform_ysize, precision);
    if (!decode_image_stream(dec, hx, hy, 0, &meta, 0)) return false;
    meta_bits = precision;
    meta_xsize = hx;
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      if ((int)m >= num_groups_max) num_groups_max = (int)m + 1;
    }
    if (num_groups_max > 1000 || (int64_t)num_groups_max > (int64_t)transform_xsize * transform_ysize) {
      mapping.assign(num_groups_max, -1);
      num_groups = 0;
      for (auto& m : meta) {
        int& mapped = mapping[m];
        if (mapped == -1) mapped = num_groups++;
        m = (uint32_t)mapped;
      }
    } else {
      num_groups = num_groups_max;
    }
  }
  if (br.eos) return false;
  const int max_alphabet = kAlphabetSize[0] + (cache_bits > 0 ? 1 << cache_bits : 0);
  std::vector<int> code_lengths(max_alphabet, 0);
  std::vector<HTreeGroup> groups(num_groups);
  for (int i = 0; i < num_groups_max; ++i) {
    const bool unused = !mapping.empty() && mapping[i] == -1;
    HTreeGroup* g = unused ? nullptr : &groups[mapping.empty() ? i : mapping[i]];
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet_size += 1 << cache_bits;
      if (!read_huffman_code(br, alphabet_size, code_lengths, g ? &g->htrees[j] : nullptr))
        return false;
    }
  }
  if (dec.info && is_level0) {
    dec.info[0] = dec.next_transform;
    for (int k = 0; k < dec.next_transform; ++k) {
      dec.info[1 + k] = dec.transforms[k].type;
      dec.info[5 + k] = dec.transforms[k].bits;
    }
    dec.info[9] = cache_bits;
    dec.info[10] = meta_bits;
    dec.info[11] = num_groups;
  }
  bool lenient = false;
  if (alpha_mode) {  // Is8bOptimizable, with the colour-indexing transform alone
    lenient = dec.next_transform == 1 && dec.transforms[0].type == 3 && cache_bits == 0;
    for (const auto& g : groups)
      lenient = lenient && g.htrees[1].bits0() == 0 && g.htrees[2].bits0() == 0 &&
                g.htrees[3].bits0() == 0;
  }
  out->assign((size_t)transform_xsize * transform_ysize, 0);
  const int status = decode_pixels(br, groups, meta, meta_bits, meta_xsize, cache_bits,
                                   transform_xsize, transform_ysize, out->data(), lenient);
  if (dec.info && is_level0) dec.info[12] = lenient;
  if (status != 0) return false;
  return is_level0 && lenient ? true : !br.eos;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int s = sub3(a >> 24, b >> 24, c >> 24) +
                sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                sub3(a & 0xff, b & 0xff, c & 0xff);
  return s <= 0 ? a : b;
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= clip255((uint32_t)((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                              (int)((c2 >> s) & 0xff))) << s;
  return out;
}
inline uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
    out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

// VP8LPredictors[mode](left, top): top points at the pixel above
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return clamped_add_sub_full(left, top[0], top[-1]);
    case 13: return clamped_add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

inline int8_t color_delta(int8_t pred, int8_t color) { return (int8_t)(((int)pred * color) >> 5); }

// VP8LInverseTransform over a whole image: `in` holds ysize rows of the
// transform's input width, `out` ysize rows of xsize (they may alias for
// every type but colour indexing with bits > 0)
void inverse_transform(int type, int bits, int xsize, int ysize, const uint32_t* tdata,
                       const uint32_t* in, uint32_t* out) {
  const int64_t n = (int64_t)xsize * ysize;
  if (type == 2) {  // AddGreenToBlueAndRed
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t argb = in[i];
      const uint32_t green = (argb >> 8) & 0xff;
      uint32_t red_blue = argb & 0x00ff00ffu;
      red_blue += (green << 16) | green;
      out[i] = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
    }
  } else if (type == 0) {  // PredictorInverseTransform
    const int tiles_per_row = sub_sample_size(xsize, bits);
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = in + (int64_t)y * xsize;
      uint32_t* dst = out + (int64_t)y * xsize;
      if (y == 0) {
        dst[0] = add_pixels(src[0], 0xff000000u);
        for (int x = 1; x < xsize; ++x) dst[x] = add_pixels(src[x], dst[x - 1]);
        continue;
      }
      const uint32_t* modes = tdata + (int64_t)(y >> bits) * tiles_per_row;
      dst[0] = add_pixels(src[0], dst[-xsize]);
      for (int x = 1; x < xsize; ++x) {
        const int mode = (modes[x >> bits] >> 8) & 0xf;
        dst[x] = add_pixels(src[x], predict(mode, dst[x - 1], dst + x - xsize));
      }
    }
  } else if (type == 1) {  // ColorSpaceInverseTransform
    const int tiles_per_row = sub_sample_size(xsize, bits);
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* codes = tdata + (int64_t)(y >> bits) * tiles_per_row;
      for (int x = 0; x < xsize; ++x) {
        const uint32_t code = codes[x >> bits];
        const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
                     r2b = (int8_t)((code >> 16) & 0xff);
        const int64_t i = (int64_t)y * xsize + x;
        const uint32_t argb = in[i];
        const int8_t green = (int8_t)(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += color_delta(g2r, green);
        new_red &= 0xff;
        new_blue += color_delta(g2b, green);
        new_blue += color_delta(r2b, (int8_t)new_red);
        new_blue &= 0xff;
        out[i] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
      }
    }
  } else {  // ColorIndexInverseTransform: indices packed LSB first in green
    const int bits_per_pixel = 8 >> bits;
    const int count_mask = (1 << bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    const int in_width = sub_sample_size(xsize, bits);
    std::vector<uint32_t> row(in_width);
    for (int y = 0; y < ysize; ++y) {
      std::memcpy(row.data(), in + (int64_t)y * in_width, in_width * sizeof(uint32_t));
      uint32_t packed = 0;
      const uint32_t* src = row.data();
      uint32_t* dst = out + (int64_t)y * xsize;
      for (int x = 0; x < xsize; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = tdata[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
  }
}

}  // namespace

extern "C" {

// The macroblocks of one VP8 key frame. part0 / part0_size: the first
// partition (the boolean-coded frame header from the colour space bit on,
// then the intra modes); rest / rest_size: the bytes after it (the token
// partitions' sizes, then the partitions). mb_w, mb_h: the frame in 16x16
// macroblocks. y, u, v: planes of mb_w * 16 x mb_h * 16 and mb_w * 8 x
// mb_h * 8, written filtered. info[10]: colour space, clamping, segments
// used, segment map updated, filter type (0 none, 1 simple, 2 normal),
// filter level, sharpness, partitions, base quantiser, skip probability
// used. Returns 0, or libwebp's failure: -1 segment header, -2 filter
// header, -3 partitions past the data, -4 partition 0 ended early, -5 a
// token partition ended early.
int64_t gatling_vp8_decode(const uint8_t* part0, int64_t part0_size, const uint8_t* rest,
                           int64_t rest_size, int32_t mb_w, int32_t mb_h, uint8_t* y, uint8_t* u,
                           uint8_t* v, int32_t* info) {
  Vp8Decoder d;
  d.mb_w = mb_w;
  d.mb_h = mb_h;
  const int status = vp8_parse_header(d, part0, (size_t)part0_size, rest, (size_t)rest_size, info);
  if (status) return status;
  const int ys = mb_w * 16, uvs = mb_w * 8;
  std::vector<Vp8Mb> mbs(mb_w + 1, Vp8Mb{0, 0});  // [0] is the left neighbour
  std::vector<Vp8Filter> finfo((size_t)mb_w * mb_h);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<uint8_t> imodes(16 * (size_t)mb_w), is_i4x4(mb_w), segments(mb_w), skips(mb_w),
      uvmodes(mb_w);
  int16_t coeffs[384];
  uint8_t work[kBps * 17 + kBps * 9];
  uint8_t* const y_dst = work + kBps + 8;
  uint8_t* const u_dst = work + kBps * 18 + 8;
  uint8_t* const v_dst = u_dst + 16;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& tbr = d.parts[mb_y & d.num_parts_minus_one];
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {  // VP8ParseIntraModeRow
      BoolReader& br = d.br;
      uint8_t* top = &intra_t[4 * mb_x];
      segments[mb_x] = d.update_map ? (!br.get_bit(d.segment_probs[0])
                                           ? br.get_bit(d.segment_probs[1])
                                           : br.get_bit(d.segment_probs[2]) + 2)
                                    : 0;
      skips[mb_x] = d.use_skip_proba ? br.get_bit(d.skip_p) : 0;
      is_i4x4[mb_x] = !br.get_bit(145);
      uint8_t* modes = &imodes[16 * mb_x];
      if (!is_i4x4[mb_x]) {
        const int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM : B_HE)
                                          : (br.get_bit(163) ? B_VE : B_DC);
        modes[0] = (uint8_t)ymode;
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int yy = 0; yy < 4; ++yy) {
          int ymode = intra_l[yy];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kVp8BModesProba[top[x]][ymode];
            int i = kVp8YModesIntra4[br.get_bit(prob[0])];
            while (i > 0) i = kVp8YModesIntra4[2 * i + br.get_bit(prob[i])];
            ymode = -i;
            top[x] = (uint8_t)ymode;
          }
          std::memcpy(modes + 4 * yy, top, 4);
          intra_l[yy] = (uint8_t)ymode;
        }
      }
      uvmodes[mb_x] = !br.get_bit(142) ? B_DC
                      : !br.get_bit(114) ? B_VE
                      : br.get_bit(183) ? B_TM : B_HE;
    }
    if (d.br.eof) return -4;
    mbs[0] = Vp8Mb{0, 0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {  // VP8DecodeMB, then ReconstructRow
      Vp8Mb* left = &mbs[0];
      Vp8Mb* mb = &mbs[1 + mb_x];
      int skip = d.use_skip_proba ? skips[mb_x] : 0;
      uint32_t nz[2] = {0, 0};
      if (!skip) {
        skip = vp8_residuals(d, mb, left, segments[mb_x], is_i4x4[mb_x], tbr, coeffs, nz);
      } else {
        left->nz = mb->nz = 0;
        if (!is_i4x4[mb_x]) left->nz_dc = mb->nz_dc = 0;
      }
      Vp8Filter f = d.fstrengths[segments[mb_x]][is_i4x4[mb_x]];
      f.inner |= !skip;
      finfo[(size_t)mb_y * mb_w + mb_x] = f;
      if (tbr.eof) return -5;
      // the work buffer: the left column (129 at the frame's left edge), the
      // row above (127 on the first row) and its top-left, the top-right
      const int px = mb_x * 16, py = mb_y * 16;
      for (int j = 0; j < 16; ++j)
        y_dst[j * kBps - 1] = mb_x > 0 ? y[(size_t)(py + j) * ys + px - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        u_dst[j * kBps - 1] = mb_x > 0 ? u[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8 - 1] : 129;
        v_dst[j * kBps - 1] = mb_x > 0 ? v[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8 - 1] : 129;
      }
      if (mb_y > 0) {
        const uint8_t* ya = y + (size_t)(py - 1) * ys;
        const uint8_t* ua = u + (size_t)(mb_y * 8 - 1) * uvs;
        const uint8_t* va = v + (size_t)(mb_y * 8 - 1) * uvs;
        std::memcpy(y_dst - kBps, ya + px, 16);
        std::memcpy(u_dst - kBps, ua + mb_x * 8, 8);
        std::memcpy(v_dst - kBps, va + mb_x * 8, 8);
        y_dst[-1 - kBps] = mb_x > 0 ? ya[px - 1] : 129;
        u_dst[-1 - kBps] = mb_x > 0 ? ua[mb_x * 8 - 1] : 129;
        v_dst[-1 - kBps] = mb_x > 0 ? va[mb_x * 8 - 1] : 129;
        if (mb_x >= mb_w - 1) {
          std::memset(y_dst - kBps + 16, ya[px + 15], 4);
        } else {
          std::memcpy(y_dst - kBps + 16, ya + px + 16, 4);
        }
      } else {
        std::memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - kBps - 1, 127, 8 + 1);
        std::memset(v_dst - kBps - 1, 127, 8 + 1);
      }
      const uint8_t* modes = &imodes[16 * mb_x];
      if (is_i4x4[mb_x]) {
        for (int r = 1; r < 4; ++r) std::memcpy(y_dst + (4 * r - 1) * kBps + 16, y_dst - kBps + 16, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
          pred_luma4(modes[n], dst);
          vp8_do_transform((nz[0] << (2 * n)) >> 30, coeffs + n * 16, dst);
        }
      } else {
        pred_block(modes[0], y_dst, 16, mb_y > 0, mb_x > 0);
        for (int n = 0; n < 16; ++n)
          vp8_do_transform((nz[0] << (2 * n)) >> 30, coeffs + n * 16,
                           y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps);
      }
      pred_block(uvmodes[mb_x], u_dst, 8, mb_y > 0, mb_x > 0);
      pred_block(uvmodes[mb_x], v_dst, 8, mb_y > 0, mb_x > 0);
      vp8_do_uv_transform(nz[1], coeffs + 256, u_dst);
      vp8_do_uv_transform(nz[1] >> 8, coeffs + 320, v_dst);
      for (int j = 0; j < 16; ++j) std::memcpy(y + (size_t)(py + j) * ys + px, y_dst + j * kBps, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8, u_dst + j * kBps, 8);
        std::memcpy(v + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8, v_dst + j * kBps, 8);
      }
    }
  }
  if (d.filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        vp8_filter_mb(d.filter_type, finfo[(size_t)mb_y * mb_w + mb_x], mb_x, mb_y, y, u, v, ys, uvs);
  return 0;
}

// VP8's inverse transform of n 4x4 blocks (in: 16 coefficients a block,
// natural order) added to their predictions (dst: 16 bytes a block, rows
// of 4), by libwebp's C TransformOne (simd 0) or its Transform_SSE2
// (simd 1), which gatling_vp8_decode picks per block as libwebp does.
void gatling_vp8_transform(const int16_t* in, int64_t n, int32_t simd, uint8_t* dst) {
  uint8_t work[4 * kBps];
  for (int64_t b = 0; b < n; ++b) {
    for (int r = 0; r < 4; ++r) std::memcpy(work + r * kBps, dst + b * 16 + r * 4, 4);
    if (simd) {
      vp8_transform_simd(in + b * 16, work);
    } else {
      vp8_transform(in + b * 16, work);
    }
    for (int r = 0; r < 4; ++r) std::memcpy(dst + b * 16 + r * 4, work + r * kBps, 4);
  }
}

// The fancy upsampler and libwebp's YUV -> RGB (dsp/upsampling.c,
// dsp/yuv.h) over the w x h picture: rgba [h, w, 4], alpha 255.
void gatling_webp_yuv_to_rgba(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t w,
                              int32_t h, int32_t y_stride, int32_t uv_stride, uint8_t* rgba) {
  auto put = [](int yy, int uu, int vv, uint8_t* dst) {
    auto hi = [](int a, int k) { return (a * k) >> 8; };
    auto clip = [](int a) { return (a & ~16383) == 0 ? a >> 6 : (a < 0 ? 0 : 255); };
    dst[0] = (uint8_t)clip(hi(yy, 19077) + hi(vv, 26149) - 14234);
    dst[1] = (uint8_t)clip(hi(yy, 19077) - hi(uu, 6419) - hi(vv, 13320) + 8708);
    dst[2] = (uint8_t)clip(hi(yy, 19077) + hi(uu, 33050) - 17685);
    dst[3] = 0xff;
  };
  const int last_pair = (w - 1) >> 1;
  for (int row = 0; row < h; ++row) {
    // output row `row` lies between chroma rows r0 (above) and r1 (below);
    // `near` 0 where r0 weighs 3/4, 1 where r1 does
    int r0, r1, near;
    if (row == 0) {
      r0 = r1 = 0;
      near = 0;
    } else if (row & 1) {
      r0 = (row - 1) >> 1;
      r1 = (row + 1) >> 1;
      if (r1 > (h - 1) >> 1) r1 = r0;
      near = 0;
    } else {
      r0 = (row >> 1) - 1;
      r1 = row >> 1;
      near = 1;
    }
    const uint8_t* yr = y + (size_t)row * y_stride;
    const uint8_t* tu = u + (size_t)(near ? r1 : r0) * uv_stride;  // the nearer chroma row
    const uint8_t* tv = v + (size_t)(near ? r1 : r0) * uv_stride;
    const uint8_t* fu = u + (size_t)(near ? r0 : r1) * uv_stride;  // the farther one
    const uint8_t* fv = v + (size_t)(near ? r0 : r1) * uv_stride;
    uint8_t* dst = rgba + (size_t)row * w * 4;
    int tl_u = tu[0], tl_v = tv[0], l_u = fu[0], l_v = fv[0];
    put(yr[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst);
    for (int x = 1; x <= last_pair; ++x) {
      const int t_u = tu[x], t_v = tv[x], c_u = fu[x], c_v = fv[x];
      const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
      put(yr[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + (2 * x - 1) * 4);
      put(yr[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + (2 * x) * 4);
      tl_u = t_u;
      tl_v = t_v;
      l_u = c_u;
      l_v = c_v;
    }
    if (!(w & 1))
      put(yr[w - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst + (w - 1) * 4);
  }
}

// The ALPH chunk's unfilters (dsp/filters.c) over a w x h plane, in place
// allowed: filter 0 none, 1 horizontal, 2 vertical, 3 gradient.
void gatling_webp_unfilter(const uint8_t* in, int32_t w, int32_t h, int32_t filter, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int r = 0; r < h; ++r) {
    const uint8_t* src = in + (size_t)r * w;
    uint8_t* dst = out + (size_t)r * w;
    if (filter == 0) {
      if (src != dst) std::memcpy(dst, src, w);
    } else if (filter == 1 || prev == nullptr) {
      uint8_t pred = (filter == 1 && prev != nullptr) ? prev[0] : 0;
      for (int i = 0; i < w; ++i) {
        dst[i] = (uint8_t)(pred + src[i]);
        pred = dst[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < w; ++i) dst[i] = (uint8_t)(prev[i] + src[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < w; ++i) {
        top = prev[i];
        left = (uint8_t)(src[i] + clip8(left + top - top_left));
        top_left = top;
        dst[i] = left;
      }
    }
    prev = dst;
  }
}

// A VP8L image: alpha 0, a whole image (data from its signature byte; the
// 5-byte header is read again, w and h must be its sizes); alpha 1, the
// headerless stream of an ALPH chunk of w x h. argb [h * w] (0xAARRGGBB).
// info[13]: the transforms (count, 4 types, 4 bits), colour-cache bits,
// meta-code bits, prefix-code groups, whether the 8-bit alpha path's end
// rule applied. Returns 0, or -1 when libwebp rejects the stream.
int64_t gatling_vp8l_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h, int32_t alpha,
                            uint32_t* argb, int32_t* info) {
  Vp8lDecoder dec;
  dec.info = info;
  dec.br.init(data, (size_t)n);
  if (!alpha) {  // ReadImageInfo
    if (dec.br.read(8) != 0x2f) return -1;
    const int ww = (int)dec.br.read(14) + 1, hh = (int)dec.br.read(14) + 1;
    dec.br.read(1);
    if (dec.br.read(3) != 0 || dec.br.eos || ww != w || hh != h) return -1;
  }
  std::vector<uint32_t> pixels;
  if (!decode_image_stream(dec, w, h, 1, &pixels, alpha)) return -1;
  // the inverse transforms, last read first
  for (int k = dec.next_transform - 1; k >= 0; --k) {
    const Transform& t = dec.transforms[k];
    std::vector<uint32_t> next((size_t)t.xsize * t.ysize);
    inverse_transform(t.type, t.bits, t.xsize, t.ysize, t.data.data(), pixels.data(), next.data());
    pixels.swap(next);
  }
  std::memcpy(argb, pixels.data(), (size_t)w * h * sizeof(uint32_t));
  return 0;
}

// One VP8L inverse transform alone (the twins' counterpart): type 0
// predictor, 1 cross-colour, 2 subtract-green, 3 colour indexing (in:
// ysize rows of the packed width, tdata the expanded colour map).
void gatling_vp8l_inverse_transform(int32_t type, int32_t bits, int32_t xsize, int32_t ysize,
                                    const uint32_t* tdata, const uint32_t* in, uint32_t* out) {
  inverse_transform(type, bits, xsize, ysize, tdata, in, out);
}

}  // extern "C"
