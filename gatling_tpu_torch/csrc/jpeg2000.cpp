// JPEG 2000 (ITU-T T.800) tile decoding as OpenJPEG 2.5 decodes it: the
// packet headers and bodies of tier 2 (t2.c, pi.c, tgt.c, bio.c), the MQ
// and raw decoders and the three coding passes of tier 1 (mqc.c, t1.c),
// dequantisation, the inverse 5/3 and 9/7 wavelets (dwt.c), the inverse
// RCT and ICT (mct.c) and the DC level shift with its clamp (tcd.c).
// imgio/jpeg2000.py reads the boxes and the marker segments and calls
// gatling_j2k_decode_tile once a tile with everything the tile-part
// headers set. Where OpenJPEG's SIMD and scalar paths exist, both compute
// the same operations in the same order; this file is scalar.
//
// Built into the same library as gatling_native.cpp (native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// the parameter block (imgio/jpeg2000.py builds it; the offsets are shared)
// ---------------------------------------------------------------------------
enum {
  H_TX0 = 0, H_TY0, H_TX1, H_TY1, H_IX0, H_IY0, H_IX1, H_IY1, H_NCOMP, H_NLAYERS, H_PRG,
  H_MCT, H_CSTY, H_NPOC, H_EXTHDR, H_POC = 16, H_POC_SIZE = 6, H_MAXPOC = 32,
  H_COMP = H_POC + H_POC_SIZE * H_MAXPOC
};
enum {
  C_DX = 0, C_DY, C_PREC, C_SGND, C_NUMRES, C_CBLKW, C_CBLKH, C_CBLKSTY, C_QMFBID, C_QNTSTY,
  C_NUMGBITS, C_ROISHIFT, C_DCSHIFT, C_PRCW, C_PRCH = C_PRCW + 33, C_EXPN = C_PRCH + 33,
  C_MANT = C_EXPN + 97, C_SIZE = C_MANT + 97
};

// the code-block styles the decoder reads (PTERM only changes how the encoder
// terminates a pass)
constexpr uint32_t kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32;
constexpr uint32_t kCstySop = 2, kCstyEph = 4;

inline int32_t ceildiv(int32_t a, int32_t b) { return (int32_t)(((int64_t)a + b - 1) / b); }
inline uint32_t uceildiv(uint32_t a, uint32_t b) {
  return b ? (uint32_t)(((uint64_t)a + b - 1) / b) : 0;
}
inline int32_t ceildivpow2(int32_t a, int32_t b) {
  return (int32_t)(((int64_t)a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int64_ceildivpow2(int64_t a, int32_t b) {
  return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t floordivpow2(int32_t a, int32_t b) { return a >> b; }
inline uint32_t uceildivpow2(uint32_t a, uint32_t b) {
  return (uint32_t)((a + ((uint64_t)1 << b) - 1) >> b);
}
inline uint32_t umin(uint32_t a, uint32_t b) { return a < b ? a : b; }
inline uint32_t umax(uint32_t a, uint32_t b) { return a > b ? a : b; }
inline uint32_t uadds(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  return s > 0xFFFFFFFFu ? 0xFFFFFFFFu : (uint32_t)s;
}
inline uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

// ---------------------------------------------------------------------------
// bio.c: the packet header's bit reader (a 0xFF byte is followed by 7 bits)
// ---------------------------------------------------------------------------
struct Bio {
  const uint8_t *start, *end, *bp;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, uint32_t len) : start(p), end(p + len), bp(p) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t getbit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; --i) v |= getbit() << i;
    return v;
  }
  void inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) {
      bytein();
      ct = 0;
    }
  }
  uint32_t numbytes() const { return (uint32_t)(bp - start); }
};

// ---------------------------------------------------------------------------
// tgt.c: tag trees
// ---------------------------------------------------------------------------
struct TagTree {
  std::vector<int32_t> parent, value, low;
  void create(uint32_t nh, uint32_t nv) {
    parent.clear();
    if ((uint64_t)nh * nv == 0) return;
    int32_t nplh[64], nplv[64];
    uint32_t numlvls = 0, numnodes = 0, n;
    nplh[0] = (int32_t)nh;
    nplv[0] = (int32_t)nv;
    do {
      n = (uint32_t)(nplh[numlvls] * nplv[numlvls]);
      nplh[numlvls + 1] = (nplh[numlvls] + 1) / 2;
      nplv[numlvls + 1] = (nplv[numlvls] + 1) / 2;
      numnodes += n;
      ++numlvls;
    } while (n > 1);
    parent.assign(numnodes, -1);
    uint32_t first = 0;
    for (uint32_t i = 0; i + 1 < numlvls; ++i) {
      const uint32_t next = first + (uint32_t)(nplh[i] * nplv[i]);
      for (int32_t y = 0; y < nplv[i]; ++y)
        for (int32_t x = 0; x < nplh[i]; ++x)
          parent[first + (uint32_t)(y * nplh[i] + x)] =
              (int32_t)(next + (uint32_t)((y / 2) * nplh[i + 1] + x / 2));
      first = next;
    }
    reset();
  }
  void reset() {
    value.assign(parent.size(), 999);
    low.assign(parent.size(), 0);
  }
  uint32_t decode(Bio& bio, uint32_t leaf, int32_t threshold) {
    int32_t stk[64];
    int sp = 0;
    int32_t node = (int32_t)leaf;
    while (parent[node] >= 0) {
      stk[sp++] = node;
      node = parent[node];
    }
    int32_t lo = 0;
    for (;;) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.read(1)) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return value[node] < threshold ? 1 : 0;
  }
};

// ---------------------------------------------------------------------------
// the tile's structure (tcd.h)
// ---------------------------------------------------------------------------
struct Seg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
           newlen = 0;
};
struct Chunk {
  uint32_t off, len;  // into the tile's data
};
struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
  std::vector<Seg> segs;
  std::vector<Chunk> chunks;
};
struct Precinct {
  int32_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};
struct Band {
  uint32_t bandno;
  int32_t x0, y0, x1, y1, numbps;
  float stepsize;
  std::vector<Precinct> prec;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};
struct Res {
  int32_t x0, y0, x1, y1;
  uint32_t pw, ph, pdx, pdy, numbands;
  Band bands[3];
};
struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres, dx, dy, prec, sgnd, cblksty, qmfbid, roishift;
  int32_t dcshift;
  std::vector<Res> res;
  std::vector<int32_t> data;  // int32 codes, or float bits on the 9/7 path
};

// ---------------------------------------------------------------------------
// mqc.c: the MQ decoder (C.3.2) and the raw (bypass) decoder
// ---------------------------------------------------------------------------
const uint16_t kQe[47] = {0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
                          0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
                          0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
                          0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
                          0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
                          0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

constexpr int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

struct Mqc {
  uint8_t* bp;
  uint8_t* end;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];
  uint8_t backup[2];

  void resetstates() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  // opj_mqc_init_dec_common: an artificial 0xFF 0xFF after the segment
  void init_common(uint8_t* p, uint32_t len) {
    end = p + len;
    backup[0] = end[0];
    backup[1] = end[1];
    end[0] = 0xFF;
    end[1] = 0xFF;
    bp = p;
  }
  void finish() {
    end[0] = backup[0];
    end[1] = backup[1];
  }
  void bytein() {
    const uint32_t l_c = bp[1];
    if (*bp == 0xff) {
      if (l_c > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += l_c << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += l_c << 8;
      ct = 8;
    }
  }
  void init_dec(uint8_t* p, uint32_t len) {
    init_common(p, len);
    c = len == 0 ? 0xffu << 16 : (uint32_t)*bp << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(uint8_t* p, uint32_t len) {
    init_common(p, len);
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  uint32_t decode(int cx) {
    const uint32_t s = state[cx];
    const uint32_t qe = kQe[s];
    uint32_t d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = kNmps[s];
      } else {
        a = qe;
        d = 1u - mps[cx];
        if (kSwitch[s]) mps[cx] ^= 1;
        state[cx] = kNlps[s];
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1u - mps[cx];
          if (kSwitch[s]) mps[cx] ^= 1;
          state[cx] = kNlps[s];
        } else {
          d = mps[cx];
          state[cx] = kNmps[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  uint32_t raw_decode() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          ++bp;
          ct = 7;
        }
      } else {
        c = *bp;
        ++bp;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1u;
  }
};

// ---------------------------------------------------------------------------
// t1.c: the coding passes over one code-block. The state of each sample:
// significant, negative, visited in this bit-plane's significance pass,
// refined. A border of insignificant samples surrounds the block.
// ---------------------------------------------------------------------------
constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;

uint8_t g_zc[4][256];  // orientation, 8 neighbours -> zero-coding context

struct ZcInit {
  ZcInit() {
    for (int orient = 0; orient < 4; ++orient)
      for (int m = 0; m < 256; ++m) {
        // bits: 0 N, 1 S, 2 W, 3 E, 4 NW, 5 NE, 6 SW, 7 SE
        int h = ((m >> 2) & 1) + ((m >> 3) & 1);
        int v = (m & 1) + ((m >> 1) & 1);
        const int d = ((m >> 4) & 1) + ((m >> 5) & 1) + ((m >> 6) & 1) + ((m >> 7) & 1);
        int n = 0;
        if (orient == 3) {
          const int hv = h + v;
          if (!d) n = !hv ? 0 : (hv == 1 ? 1 : 2);
          else if (d == 1) n = !hv ? 3 : (hv == 1 ? 4 : 5);
          else if (d == 2) n = !hv ? 6 : 7;
          else n = 8;
        } else {
          if (orient == 1) {  // HL: horizontal and vertical swapped
            const int t = h;
            h = v;
            v = t;
          }
          if (!h) {
            if (!v) n = !d ? 0 : (d == 1 ? 1 : 2);
            else n = v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = !v ? (!d ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        }
        g_zc[orient][m] = (uint8_t)(kCtxZc + n);
      }
  }
} g_zc_init;

struct T1 {
  int w = 0, h = 0, fw = 0;
  bool vsc = false;
  int orient = 0;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags;
  Mqc mqc;

  void allocate(int width, int height) {
    w = width;
    h = height;
    fw = w + 2;
    data.assign((size_t)w * h, 0);
    flags.assign((size_t)fw * (h + 2), 0);
  }
  uint8_t* f(int x, int y) { return &flags[(size_t)(y + 1) * fw + (x + 1)]; }
  // the 8 neighbours' significance; the row below the stripe counts as
  // insignificant in vertically causal mode
  int neighbours(int x, int y) {
    const uint8_t* p = f(x, y);
    const bool cut = vsc && (y & 3) == 3;
    int m = (p[-fw] & kSig) | ((p[-1] & kSig) << 2) | ((p[1] & kSig) << 3) |
            ((p[-fw - 1] & kSig) << 4) | ((p[-fw + 1] & kSig) << 5);
    if (!cut) m |= ((p[fw] & kSig) << 1) | ((p[fw - 1] & kSig) << 6) | ((p[fw + 1] & kSig) << 7);
    return m;
  }
  // the sign context and the sign prediction bit (Table D.3)
  void sign_ctx(int x, int y, int* ctx, uint32_t* spb) {
    const uint8_t* p = f(x, y);
    const bool cut = vsc && (y & 3) == 3;
    auto contrib = [](uint8_t q, int* pos, int* neg) {
      if (q & kSig) {
        if (q & kNeg) ++*neg;
        else ++*pos;
      }
    };
    int hp = 0, hn = 0, vp = 0, vn = 0;
    contrib(p[-1], &hp, &hn);
    contrib(p[1], &hp, &hn);
    contrib(p[-fw], &vp, &vn);
    if (!cut) contrib(p[fw], &vp, &vn);
    int hc = (hp > 0) - (hn > 0), vc = (vp > 0) - (vn > 0);
    const int h0 = hc, v0 = vc;
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
    }
    int n = 0;
    if (!hc) n = vc == 0 ? 0 : 1;
    else n = vc == -1 ? 2 : (vc == 0 ? 3 : 4);
    *ctx = kCtxSc + n;
    *spb = (!h0 && !v0) ? 0u : (uint32_t)!(h0 > 0 || (!h0 && v0 > 0));
  }
  void set_sig(int x, int y, uint32_t neg, int32_t val) {
    data[(size_t)y * w + x] = neg ? -val : val;
    *f(x, y) |= (uint8_t)(kSig | (neg ? kNeg : 0));
  }

  void sigpass(int32_t bpno, bool raw) {
    const int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          uint8_t* p = f(x, y);
          if ((*p & (kSig | kVisit)) || !neighbours(x, y)) continue;
          if (raw) {
            if (mqc.raw_decode()) {
              const uint32_t v = mqc.raw_decode();
              set_sig(x, y, v, oneplushalf);
            }
          } else if (mqc.decode(g_zc[orient][neighbours(x, y)])) {
            int ctx;
            uint32_t spb;
            sign_ctx(x, y, &ctx, &spb);
            const uint32_t v = mqc.decode(ctx) ^ spb;
            set_sig(x, y, v, oneplushalf);
          }
          *p |= kVisit;
        }
  }
  void refpass(int32_t bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < k + 4 && y < h; ++y) {
          uint8_t* p = f(x, y);
          if ((*p & (kSig | kVisit)) != kSig) continue;
          uint32_t v;
          if (raw) {
            v = mqc.raw_decode();
          } else {
            const int ctx = (*p & kRefined) ? kCtxMag + 2 : (neighbours(x, y) ? kCtxMag + 1 : kCtxMag);
            v = mqc.decode(ctx);
          }
          int32_t& d = data[(size_t)y * w + x];
          d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
          *p |= kRefined;
        }
  }
  void clnpass_sample(int x, int y, int32_t oneplushalf, bool known) {
    if (!known) {
      if (!mqc.decode(g_zc[orient][neighbours(x, y)])) return;
    }
    int ctx;
    uint32_t spb;
    sign_ctx(x, y, &ctx, &spb);
    const uint32_t v = mqc.decode(ctx) ^ spb;
    set_sig(x, y, v, oneplushalf);
  }
  // a full stripe's column takes the run mode when none of its four
  // samples nor their neighbours is significant and none was visited
  bool run_mode(int x, int k) {
    const bool cut = vsc;  // the row below the stripe
    for (int y = k - 1; y <= k + 4; ++y) {
      if (y == k + 4 && cut) continue;
      for (int dx = -1; dx <= 1; ++dx)
        if (*f(x + dx, y) & kSig) return false;
    }
    for (int y = k; y < k + 4; ++y)
      if (*f(x, y) & kVisit) return false;
    return true;
  }
  void clnpass(int32_t bpno, bool segsym) {
    const int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
    int k = 0;
    for (; k + 4 <= h; k += 4)
      for (int x = 0; x < w; ++x) {
        if (run_mode(x, k)) {
          if (!mqc.decode(kCtxAgg)) continue;
          uint32_t runlen = mqc.decode(kCtxUni);
          runlen = (runlen << 1) | mqc.decode(kCtxUni);
          clnpass_sample(x, k + (int)runlen, oneplushalf, true);
          for (int y = k + (int)runlen + 1; y < k + 4; ++y) clnpass_sample(x, y, oneplushalf, false);
        } else {
          for (int y = k; y < k + 4; ++y)
            if (!(*f(x, y) & (kSig | kVisit))) clnpass_sample(x, y, oneplushalf, false);
        }
        for (int y = k; y < k + 4; ++y) *f(x, y) &= (uint8_t)~kVisit;
      }
    if (k < h)
      for (int x = 0; x < w; ++x) {
        for (int y = k; y < h; ++y)
          if (!(*f(x, y) & (kSig | kVisit))) clnpass_sample(x, y, oneplushalf, false);
        for (int y = k; y < h; ++y) *f(x, y) &= (uint8_t)~kVisit;
      }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mqc.decode(kCtxUni);
    }
  }
};

// opj_t1_decode_cblk: false where OpenJPEG gives up on the block
bool decode_cblk(T1& t1, Cblk& cb, const uint8_t* tiledata, uint32_t orient,
                 uint32_t roishift, uint32_t cblksty) {
  t1.allocate(cb.x1 - cb.x0, cb.y1 - cb.y0);
  t1.orient = (int)orient;
  t1.vsc = (cblksty & kVsc) != 0;
  int32_t bpno_plus_one = (int32_t)(roishift + cb.numbps);
  if (bpno_plus_one >= 31) return false;
  uint32_t passtype = 2;
  t1.mqc.resetstates();
  if (cb.chunks.empty()) return true;
  uint32_t total = 0;
  for (const Chunk& c : cb.chunks) total += c.len;
  std::vector<uint8_t> buf(total + 2, 0);
  uint32_t at = 0;
  for (const Chunk& c : cb.chunks) {
    std::memcpy(buf.data() + at, tiledata + c.off, c.len);
    at += c.len;
  }
  uint32_t index = 0;
  for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
    const Seg& seg = cb.segs[segno];
    const bool raw = (bpno_plus_one <= (int32_t)cb.numbps - 4) && passtype < 2 &&
                     (cblksty & kLazy);
    if (index + seg.len > total) return false;  // cannot happen for a consistent block
    if (raw) t1.mqc.raw_init(buf.data() + index, seg.len);
    else t1.mqc.init_dec(buf.data() + index, seg.len);
    index += seg.len;
    for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
      if (passtype == 0) t1.sigpass(bpno_plus_one, raw);
      else if (passtype == 1) t1.refpass(bpno_plus_one, raw);
      else t1.clnpass(bpno_plus_one, (cblksty & kSegSym) != 0);
      if ((cblksty & kReset) && !raw) t1.mqc.resetstates();
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
    t1.mqc.finish();
  }
  return true;
}

// ---------------------------------------------------------------------------
// dwt.c: the inverse transforms of one line, then of a tile-component
// ---------------------------------------------------------------------------

// opj_dwt_decode_1_: in-place 5/3 lifting of an interleaved line a (low-pass
// samples at even positions when cas is 0, at odd ones when 1)
void idwt53_line(int32_t* a, int32_t dn, int32_t sn, int32_t cas) {
  auto S = [&](int32_t i) -> int32_t& { return a[i * 2]; };
  auto D = [&](int32_t i) -> int32_t& { return a[1 + i * 2]; };
  if (!cas) {
    if (dn > 0 || sn > 1) {
      auto D_ = [&](int32_t i) { return i < 0 ? D(0) : (i >= dn ? D(dn - 1) : D(i)); };
      auto S_ = [&](int32_t i) { return i < 0 ? S(0) : (i >= sn ? S(sn - 1) : S(i)); };
      for (int32_t i = 0; i < sn; ++i) S(i) -= (D_(i - 1) + D_(i) + 2) >> 2;
      for (int32_t i = 0; i < dn; ++i) D(i) += (S_(i) + S_(i + 1)) >> 1;
    }
  } else {
    if (!sn && dn == 1) {
      S(0) /= 2;
    } else {
      auto SS_ = [&](int32_t i) { return i < 0 ? S(0) : (i >= dn ? S(dn - 1) : S(i)); };
      auto DD_ = [&](int32_t i) { return i < 0 ? D(0) : (i >= sn ? D(sn - 1) : D(i)); };
      for (int32_t i = 0; i < sn; ++i) D(i) -= (SS_(i) + SS_(i + 1) + 2) >> 2;
      for (int32_t i = 0; i < dn; ++i) S(i) += (DD_(i) + DD_(i - 1)) >> 1;
    }
  }
}

// dwt.c's constants of the 9/7 lifting, as the inverse steps apply them
// (BUG_WEIRD_TWO_INVK: the high-pass samples are scaled by the historic 2/K)
const float kAlpha = 1.586134342f, kBeta = 0.052980118f, kGamma = -0.882911075f,
            kDelta = -0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

// opj_v8dwt_decode_step1: w[2i] *= c for i in [0, end)
inline void step1(float* w, uint32_t end, float c) {
  for (uint32_t i = 0; i < end; ++i) w[2 * i] *= c;
}
// opj_v8dwt_decode_step2 over one lane: l is the first neighbour of the
// sample before w
inline void step2(const float* l, float* w, uint32_t end, uint32_t m, float c) {
  const uint32_t imax = umin(end, m);
  uint32_t i = 0;
  if (imax >= 1) {
    w[-1] = w[-1] + (l[0] + w[0]) * c;
    w += 2;
    i = 1;
  }
  for (; i < imax; ++i) {
    w[-1] = w[-1] + (w[-2] + w[0]) * c;
    w += 2;
  }
  if (m < end) {
    const float c2 = c + c;
    w[-1] = w[-1] + c2 * w[-2];
  }
}

// opj_v8dwt_decode over one interleaved line W (sn low, dn high samples)
void idwt97_line(float* W, int32_t dn, int32_t sn, int32_t cas) {
  int32_t a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  step1(W + a, (uint32_t)sn, kK);
  step1(W + b, (uint32_t)dn, kTwoInvK);
  auto m1 = [](int32_t x, int32_t y) { return (uint32_t)(x < y ? x : y); };
  step2(W + b, W + a + 1, (uint32_t)sn, m1(sn, dn - a), kDelta);
  step2(W + a, W + b + 1, (uint32_t)dn, m1(dn, sn - b), kGamma);
  step2(W + b, W + a + 1, (uint32_t)sn, m1(sn, dn - a), kBeta);
  step2(W + a, W + b + 1, (uint32_t)dn, m1(dn, sn - b), kAlpha);
}

// opj_dwt_decode_tile / opj_dwt_decode_tile_97 over `numres` resolutions
// of a tile-component whose resolution rectangles are rx (x0, y0, x1, y1
// each); data has a row stride of w
template <typename T, void (*LINE)(T*, int32_t, int32_t, int32_t)>
void idwt_tile(T* data, const int32_t* rx, uint32_t numres, uint32_t w) {
  if (numres <= 1) return;
  uint32_t rw = (uint32_t)(rx[2] - rx[0]), rh = (uint32_t)(rx[3] - rx[1]);
  std::vector<T> line;
  for (uint32_t r = 1; r < numres; ++r) {
    const int32_t* t = rx + 4 * r;
    const int32_t hsn = (int32_t)rw, vsn = (int32_t)rh;
    rw = (uint32_t)(t[2] - t[0]);
    rh = (uint32_t)(t[3] - t[1]);
    const int32_t hdn = (int32_t)rw - hsn, hcas = t[0] % 2;
    line.assign((size_t)rw + (size_t)rh + 4, T(0));
    for (uint32_t j = 0; j < rh; ++j) {
      T* row = data + (size_t)j * w;
      for (int32_t i = 0; i < hsn; ++i) line[hcas + 2 * i] = row[i];
      for (int32_t i = 0; i < hdn; ++i) line[1 - hcas + 2 * i] = row[hsn + i];
      LINE(line.data(), hdn, hsn, hcas);
      for (uint32_t i = 0; i < rw; ++i) row[i] = line[i];
    }
    const int32_t vdn = (int32_t)rh - vsn, vcas = t[1] % 2;
    line.assign((size_t)rw + (size_t)rh + 4, T(0));
    for (uint32_t i = 0; i < rw; ++i) {
      T* col = data + i;
      for (int32_t k = 0; k < vsn; ++k) line[vcas + 2 * k] = col[(size_t)k * w];
      for (int32_t k = 0; k < vdn; ++k) line[1 - vcas + 2 * k] = col[(size_t)(vsn + k) * w];
      LINE(line.data(), vdn, vsn, vcas);
      for (uint32_t k = 0; k < rh; ++k) col[(size_t)k * w] = line[k];
    }
  }
}

void idwt53_line_cb(int32_t* a, int32_t dn, int32_t sn, int32_t cas) { idwt53_line(a, dn, sn, cas); }
void idwt97_line_cb(float* a, int32_t dn, int32_t sn, int32_t cas) { idwt97_line(a, dn, sn, cas); }

// mct.c
void mct_rev(int32_t* c0, int32_t* c1, int32_t* c2, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t y = c0[i], u = c1[i], v = c2[i];
    const int32_t g = y - ((u + v) >> 2);
    c0[i] = v + g;
    c1[i] = g;
    c2[i] = u + g;
  }
}
void mct_real(float* c0, float* c1, float* c2, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const float y = c0[i], u = c1[i], v = c2[i];
    const float r = y + (v * 1.402f);
    const float g = y - (u * 0.34413f) - (v * 0.71414f);
    const float b = y + (u * 1.772f);
    c0[i] = r;
    c1[i] = g;
    c2[i] = b;
  }
}

// opj_lrintf on x86-64 (cvtss2si: round half to even, out of range INT_MIN)
inline int64_t lrintf_x86(float f) {
  if (!(f >= -2147483648.0f && f < 2147483648.0f)) return INT32_MIN;
  return (int64_t)std::nearbyint(f);
}

// ---------------------------------------------------------------------------
// pi.c: the packet order of a tile
// ---------------------------------------------------------------------------
struct Packet {
  uint32_t layno, resno, compno, precno;
};
struct PiRes {
  uint32_t pdx, pdy, pw, ph;
};
struct PiComp {
  uint32_t dx, dy, numres;
  std::vector<PiRes> res;
};
struct Poc {
  uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

void packet_order(const std::vector<PiComp>& comps, uint32_t tx0, uint32_t ty0, uint32_t tx1,
                  uint32_t ty1, uint32_t numlayers, const std::vector<Poc>& pocs,
                  uint32_t max_prec, uint32_t max_res, bool* unknown_prg,
                  std::vector<std::vector<Packet>>* out) {
  const uint32_t numcomps = (uint32_t)comps.size();
  const uint64_t step_p = 1, step_c = max_prec * step_p, step_r = numcomps * step_c,
                 step_l = max_res * step_r;
  const uint64_t include_size = (numlayers + 1ull) * step_l;
  std::vector<uint8_t> include(include_size, 0);
  *unknown_prg = false;
  out->clear();
  for (const Poc& poc : pocs) {
    out->emplace_back();
    std::vector<Packet>& seq = out->back();
    if (poc.prg == 0xFFFFFFFFu) {
      *unknown_prg = true;
      return;
    }
    if (poc.compno0 >= numcomps || poc.compno1 >= numcomps + 1) continue;
    bool stop = false;
    auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
      const uint64_t index = l * step_l + r * step_r + c * step_c + p * step_p;
      if (index >= include_size) {
        stop = true;
        return;
      }
      if (!include[index]) {
        include[index] = 1;
        seq.push_back({l, r, c, p});
      }
    };
    // the body of the position-driven orders at one (x, y, comp, res)
    auto position = [&](uint32_t x, uint32_t y, uint32_t compno, uint32_t resno) {
      const PiComp& comp = comps[compno];
      if (resno >= comp.numres) return;
      const PiRes& res = comp.res[resno];
      const uint32_t levelno = comp.numres - 1 - resno;
      if ((uint32_t)(((uint64_t)comp.dx << levelno) >> levelno) != comp.dx ||
          (uint32_t)(((uint64_t)comp.dy << levelno) >> levelno) != comp.dy)
        return;
      auto cdiv = [](uint64_t a, uint64_t b) { return (uint32_t)((a + b - 1) / b); };
      const uint32_t trx0 = cdiv(tx0, (uint64_t)comp.dx << levelno);
      const uint32_t try0 = cdiv(ty0, (uint64_t)comp.dy << levelno);
      const uint32_t trx1 = cdiv(tx1, (uint64_t)comp.dx << levelno);
      const uint32_t try1 = cdiv(ty1, (uint64_t)comp.dy << levelno);
      const uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
      if (rpx >= 64 || rpy >= 64) return;
      if ((uint32_t)(((uint64_t)comp.dx << rpx) >> rpx) != comp.dx ||
          (uint32_t)(((uint64_t)comp.dy << rpy) >> rpy) != comp.dy)
        return;
      if (!(((uint64_t)y % ((uint64_t)comp.dy << rpy) == 0) ||
            ((y == ty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
        return;
      if (!(((uint64_t)x % ((uint64_t)comp.dx << rpx) == 0) ||
            ((x == tx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
        return;
      if (res.pw == 0 || res.ph == 0) return;
      if (trx0 == trx1 || try0 == try1) return;
      const uint32_t prci = (cdiv(x, (uint64_t)comp.dx << levelno) >> res.pdx) - (trx0 >> res.pdx);
      const uint32_t prcj = (cdiv(y, (uint64_t)comp.dy << levelno) >> res.pdy) - (try0 >> res.pdy);
      const uint32_t precno = prci + prcj * res.pw;
      for (uint32_t l = 0; l < poc.layno1 && !stop; ++l) emit(l, resno, compno, precno);
    };
    auto min_steps = [&](uint32_t c0, uint32_t c1, uint32_t* pdx, uint32_t* pdy) {
      *pdx = 0;
      *pdy = 0;
      for (uint32_t compno = c0; compno < c1; ++compno) {
        const PiComp& comp = comps[compno];
        for (uint32_t resno = 0; resno < comp.numres; ++resno) {
          const PiRes& res = comp.res[resno];
          const uint32_t sx = res.pdx + comp.numres - 1 - resno;
          const uint32_t sy = res.pdy + comp.numres - 1 - resno;
          if (sx < 32 && comp.dx <= 0xFFFFFFFFu / (1u << sx)) {
            const uint32_t d = comp.dx * (1u << sx);
            *pdx = !*pdx ? d : umin(*pdx, d);
          }
          if (sy < 32 && comp.dy <= 0xFFFFFFFFu / (1u << sy)) {
            const uint32_t d = comp.dy * (1u << sy);
            *pdy = !*pdy ? d : umin(*pdy, d);
          }
        }
      }
    };
    switch (poc.prg) {
      case 0:  // LRCP
        for (uint32_t l = 0; l < poc.layno1 && !stop; ++l)
          for (uint32_t r = poc.resno0; r < poc.resno1 && !stop; ++r)
            for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) {
              if (r >= comps[c].numres) continue;
              const PiRes& res = comps[c].res[r];
              for (uint32_t p = 0; p < res.pw * res.ph && !stop; ++p) emit(l, r, c, p);
            }
        break;
      case 1:  // RLCP
        for (uint32_t r = poc.resno0; r < poc.resno1 && !stop; ++r)
          for (uint32_t l = 0; l < poc.layno1 && !stop; ++l)
            for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) {
              if (r >= comps[c].numres) continue;
              const PiRes& res = comps[c].res[r];
              for (uint32_t p = 0; p < res.pw * res.ph && !stop; ++p) emit(l, r, c, p);
            }
        break;
      case 2: {  // RPCL
        uint32_t dx, dy;
        min_steps(0, numcomps, &dx, &dy);
        if (!dx || !dy) break;
        for (uint32_t r = poc.resno0; r < poc.resno1 && !stop; ++r)
          for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx))
              for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) position(x, y, c, r);
        break;
      }
      case 3: {  // PCRL
        uint32_t dx, dy;
        min_steps(0, numcomps, &dx, &dy);
        if (!dx || !dy) break;
        for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
          for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx))
            for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c)
              for (uint32_t r = poc.resno0; r < umin(poc.resno1, comps[c].numres) && !stop; ++r)
                position(x, y, c, r);
        break;
      }
      case 4:  // CPRL
        for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) {
          uint32_t dx, dy;
          min_steps(c, c + 1, &dx, &dy);
          if (!dx || !dy) {
            stop = true;
            break;
          }
          for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx))
              for (uint32_t r = poc.resno0; r < umin(poc.resno1, comps[c].numres) && !stop; ++r)
                position(x, y, c, r);
        }
        break;
      default:
        break;
    }
  }
}

// ---------------------------------------------------------------------------
// the tile
// ---------------------------------------------------------------------------
struct Tile {
  const int32_t* hdr;
  uint32_t numcomps, numlayers;
  std::vector<TileComp> comps;
};

// opj_tcd_init_tile for decoding: false where it fails
bool init_tile(Tile& t) {
  const int32_t* hdr = t.hdr;
  t.numcomps = (uint32_t)hdr[H_NCOMP];
  t.numlayers = (uint32_t)hdr[H_NLAYERS];
  t.comps.resize(t.numcomps);
  const int32_t tx0 = hdr[H_TX0], ty0 = hdr[H_TY0], tx1 = hdr[H_TX1], ty1 = hdr[H_TY1];
  if (tx0 >= tx1 || ty0 >= ty1) return false;
  for (uint32_t compno = 0; compno < t.numcomps; ++compno) {
    const int32_t* cp = hdr + H_COMP + C_SIZE * compno;
    TileComp& tc = t.comps[compno];
    tc.dx = (uint32_t)cp[C_DX];
    tc.dy = (uint32_t)cp[C_DY];
    tc.prec = (uint32_t)cp[C_PREC];
    tc.sgnd = (uint32_t)cp[C_SGND];
    tc.numres = (uint32_t)cp[C_NUMRES];
    tc.cblksty = (uint32_t)cp[C_CBLKSTY];
    tc.qmfbid = (uint32_t)cp[C_QMFBID];
    tc.roishift = (uint32_t)cp[C_ROISHIFT];
    tc.dcshift = cp[C_DCSHIFT];
    tc.x0 = ceildiv(tx0, (int32_t)tc.dx);
    tc.y0 = ceildiv(ty0, (int32_t)tc.dy);
    tc.x1 = ceildiv(tx1, (int32_t)tc.dx);
    tc.y1 = ceildiv(ty1, (int32_t)tc.dy);
    const uint64_t size = (uint64_t)(tc.x1 - tc.x0) * (uint64_t)(tc.y1 - tc.y0);
    if (size > ((uint64_t)1 << 31)) return false;
    tc.data.assign(size, 0);
    tc.res.resize(tc.numres);
    uint32_t step = 0;  // index of the band's step size
    for (uint32_t resno = 0; resno < tc.numres; ++resno) {
      Res& r = tc.res[resno];
      const int32_t level = (int32_t)(tc.numres - 1 - resno);
      r.x0 = ceildivpow2(tc.x0, level);
      r.y0 = ceildivpow2(tc.y0, level);
      r.x1 = ceildivpow2(tc.x1, level);
      r.y1 = ceildivpow2(tc.y1, level);
      r.pdx = (uint32_t)cp[C_PRCW + resno];
      r.pdy = (uint32_t)cp[C_PRCH + resno];
      const int32_t tlprcxstart = floordivpow2(r.x0, (int32_t)r.pdx) << r.pdx;
      const int32_t tlprcystart = floordivpow2(r.y0, (int32_t)r.pdy) << r.pdy;
      const uint32_t bx = (uint32_t)ceildivpow2(r.x1, (int32_t)r.pdx) << r.pdx;
      const uint32_t by = (uint32_t)ceildivpow2(r.y1, (int32_t)r.pdy) << r.pdy;
      if (bx > 0x7FFFFFFFu || by > 0x7FFFFFFFu) return false;
      const int32_t brprcxend = (int32_t)bx, brprcyend = (int32_t)by;
      r.pw = r.x0 == r.x1 ? 0u : (uint32_t)((brprcxend - tlprcxstart) >> r.pdx);
      r.ph = r.y0 == r.y1 ? 0u : (uint32_t)((brprcyend - tlprcystart) >> r.pdy);
      if (r.pw != 0 && 0xFFFFFFFFu / r.pw < r.ph) return false;
      const uint64_t nprec = (uint64_t)r.pw * r.ph;
      if (nprec > (1u << 24)) return false;
      int32_t tlcbgxstart, tlcbgystart;
      uint32_t cbgwidthexpn, cbgheightexpn;
      if (resno == 0) {
        tlcbgxstart = tlprcxstart;
        tlcbgystart = tlprcystart;
        cbgwidthexpn = r.pdx;
        cbgheightexpn = r.pdy;
        r.numbands = 1;
      } else {
        tlcbgxstart = ceildivpow2(tlprcxstart, 1);
        tlcbgystart = ceildivpow2(tlprcystart, 1);
        cbgwidthexpn = r.pdx - 1;
        cbgheightexpn = r.pdy - 1;
        r.numbands = 3;
      }
      const uint32_t cblkw = umin((uint32_t)cp[C_CBLKW], cbgwidthexpn);
      const uint32_t cblkh = umin((uint32_t)cp[C_CBLKH], cbgheightexpn);
      for (uint32_t bandno = 0; bandno < r.numbands; ++bandno, ++step) {
        Band& b = r.bands[bandno];
        if (resno == 0) {
          b.bandno = 0;
          b.x0 = ceildivpow2(tc.x0, level);
          b.y0 = ceildivpow2(tc.y0, level);
          b.x1 = ceildivpow2(tc.x1, level);
          b.y1 = ceildivpow2(tc.y1, level);
        } else {
          b.bandno = bandno + 1;
          const int64_t x0b = b.bandno & 1, y0b = b.bandno >> 1;
          b.x0 = int64_ceildivpow2(tc.x0 - (x0b << level), level + 1);
          b.y0 = int64_ceildivpow2(tc.y0 - (y0b << level), level + 1);
          b.x1 = int64_ceildivpow2(tc.x1 - (x0b << level), level + 1);
          b.y1 = int64_ceildivpow2(tc.y1 - (y0b << level), level + 1);
        }
        const uint32_t s = step < 97 ? step : 96;
        const int32_t expn = cp[C_EXPN + s], mant = cp[C_MANT + s];
        // tcd.c: no gain on the irreversible path when decoding
        const int32_t log2_gain = tc.qmfbid == 0 ? 0 : (b.bandno == 0 ? 0 : (b.bandno == 3 ? 2 : 1));
        const int32_t Rb = (int32_t)tc.prec + log2_gain;
        b.stepsize = (float)((1.0 + mant / 2048.0) * std::pow(2.0, (int32_t)(Rb - expn)));
        b.numbps = expn + cp[C_NUMGBITS] - 1;
        b.prec.resize(nprec);
        for (uint32_t precno = 0; precno < nprec; ++precno) {
          Precinct& p = b.prec[precno];
          const int32_t cbgxstart = tlcbgxstart + (int32_t)(precno % r.pw) * (1 << cbgwidthexpn);
          const int32_t cbgystart = tlcbgystart + (int32_t)(precno / r.pw) * (1 << cbgheightexpn);
          const int32_t cbgxend = cbgxstart + (1 << cbgwidthexpn);
          const int32_t cbgyend = cbgystart + (1 << cbgheightexpn);
          p.x0 = cbgxstart > b.x0 ? cbgxstart : b.x0;
          p.y0 = cbgystart > b.y0 ? cbgystart : b.y0;
          p.x1 = cbgxend < b.x1 ? cbgxend : b.x1;
          p.y1 = cbgyend < b.y1 ? cbgyend : b.y1;
          const int32_t tlcblkxstart = floordivpow2(p.x0, (int32_t)cblkw) << cblkw;
          const int32_t tlcblkystart = floordivpow2(p.y0, (int32_t)cblkh) << cblkh;
          const int32_t brcblkxend = ceildivpow2(p.x1, (int32_t)cblkw) << cblkw;
          const int32_t brcblkyend = ceildivpow2(p.y1, (int32_t)cblkh) << cblkh;
          p.cw = (uint32_t)((brcblkxend - tlcblkxstart) >> cblkw);
          p.ch = (uint32_t)((brcblkyend - tlcblkystart) >> cblkh);
          const uint64_t ncb = (uint64_t)p.cw * p.ch;
          if (ncb > (1u << 24)) return false;
          p.incl.create(p.cw, p.ch);
          p.imsb.create(p.cw, p.ch);
          p.cblks.resize(ncb);
          for (uint32_t cblkno = 0; cblkno < ncb; ++cblkno) {
            Cblk& c = p.cblks[cblkno];
            const int32_t cx = tlcblkxstart + (int32_t)(cblkno % p.cw) * (1 << cblkw);
            const int32_t cy = tlcblkystart + (int32_t)(cblkno / p.cw) * (1 << cblkh);
            c.x0 = cx > p.x0 ? cx : p.x0;
            c.y0 = cy > p.y0 ? cy : p.y0;
            c.x1 = cx + (1 << cblkw) < p.x1 ? cx + (1 << cblkw) : p.x1;
            c.y1 = cy + (1 << cblkh) < p.y1 ? cy + (1 << cblkh) : p.y1;
          }
        }
      }
    }
  }
  return true;
}

// opj_tcd_is_subband_area_of_interest over the whole image
bool area_of_interest(const Tile& t, const TileComp& tc, uint32_t resno, uint32_t bandno,
                      uint32_t bx0, uint32_t by0, uint32_t bx1, uint32_t by1) {
  const int32_t* hdr = t.hdr;
  const uint32_t margin = tc.qmfbid == 1 ? 2 : 3;
  const uint32_t tcx0 = umax((uint32_t)tc.x0, uceildiv((uint32_t)hdr[H_IX0], tc.dx));
  const uint32_t tcy0 = umax((uint32_t)tc.y0, uceildiv((uint32_t)hdr[H_IY0], tc.dy));
  const uint32_t tcx1 = umin((uint32_t)tc.x1, uceildiv((uint32_t)hdr[H_IX1], tc.dx));
  const uint32_t tcy1 = umin((uint32_t)tc.y1, uceildiv((uint32_t)hdr[H_IY1], tc.dy));
  const uint32_t nb = resno == 0 ? tc.numres - 1 : tc.numres - resno;
  const uint32_t x0b = bandno & 1, y0b = bandno >> 1;
  auto map = [&](uint32_t v, uint32_t ob) -> uint32_t {
    if (nb == 0) return v;
    const uint64_t off = ((uint64_t)1 << (nb - 1)) * ob;
    if (v <= off) return 0;
    return uceildivpow2((uint32_t)(v - off), nb);
  };
  uint32_t tbx0 = map(tcx0, x0b), tby0 = map(tcy0, y0b);
  uint32_t tbx1 = map(tcx1, x0b), tby1 = map(tcy1, y0b);
  tbx0 = tbx0 < margin ? 0 : tbx0 - margin;
  tby0 = tby0 < margin ? 0 : tby0 - margin;
  tbx1 = uadds(tbx1, margin);
  tby1 = uadds(tby1, margin);
  return bx0 < tbx1 && by0 < tby1 && bx1 > tbx0 && by1 > tby0;
}

// opj_t2_init_seg
void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Seg& seg = cb.segs[index];
  seg = Seg();
  if (cblksty & kTermAll) {
    seg.maxpasses = 1;
  } else if (cblksty & kLazy) {
    if (first) seg.maxpasses = 10;
    else seg.maxpasses = (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
  } else {
    seg.maxpasses = 109;
  }
}

uint32_t getnumpasses(Bio& bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

struct HeaderSource {
  const uint8_t* data;  // the external packet headers (PPM or PPT), or null
  uint32_t len;         // bytes left there
};

// opj_t2_read_packet_header, then opj_t2_read_packet_data, or with `keep`
// false opj_t2_skip_packet_data, which consumes the same bytes and keeps
// no code-block data: false on OpenJPEG's errors
bool decode_packet(Tile& t, const Packet& pk, const uint8_t* src, uint32_t max_len,
                   uint32_t src_off, HeaderSource& ext, bool keep, uint32_t* read) {
  TileComp& tc = t.comps[pk.compno];
  Res& res = tc.res[pk.resno];
  const uint32_t csty = (uint32_t)t.hdr[H_CSTY];
  if (pk.layno == 0) {
    for (uint32_t bandno = 0; bandno < res.numbands; ++bandno) {
      Band& b = res.bands[bandno];
      if (b.empty()) continue;
      if (pk.precno >= b.prec.size()) return false;  // "Invalid precinct"
      Precinct& p = b.prec[pk.precno];
      if (!p.incl.parent.empty()) p.incl.reset();
      if (!p.imsb.parent.empty()) p.imsb.reset();
      for (Cblk& c : p.cblks) {
        c.numsegs = 0;
        c.real_num_segs = 0;
      }
    }
  }
  uint32_t cur = 0;  // l_current_data - p_src_data
  if (csty & kCstySop) {
    if (max_len >= 6 && src[0] == 0xff && src[1] == 0x91) cur += 6;
  }
  const uint8_t* hstart;
  uint32_t hlen;
  const bool external = ext.data != nullptr;
  if (external) {
    hstart = ext.data;
    hlen = ext.len;
  } else {
    hstart = src + cur;
    hlen = max_len - cur;
  }
  Bio bio(hstart, hlen);
  const uint32_t present = bio.read(1);
  bool data_present = false;
  if (present) {
    for (uint32_t bandno = 0; bandno < res.numbands; ++bandno) {
      Band& b = res.bands[bandno];
      if (b.empty()) continue;
      Precinct& p = b.prec[pk.precno];
      const uint32_t ncb = p.cw * p.ch;
      for (uint32_t cblkno = 0; cblkno < ncb; ++cblkno) {
        Cblk& c = p.cblks[cblkno];
        uint32_t included;
        if (!c.numsegs) included = p.incl.decode(bio, cblkno, (int32_t)(pk.layno + 1));
        else included = bio.read(1);
        if (!included) {
          c.numnewpasses = 0;
          continue;
        }
        if (!c.numsegs) {
          uint32_t i = 0;
          while (!p.imsb.decode(bio, cblkno, (int32_t)i)) ++i;
          c.numbps = (uint32_t)b.numbps + 1 - i;
          c.numlenbits = 3;
        }
        c.numnewpasses = getnumpasses(bio);
        uint32_t increment = 0;
        while (bio.read(1)) ++increment;
        c.numlenbits += increment;
        uint32_t segno = 0;
        if (!c.numsegs) {
          init_seg(c, 0, tc.cblksty, true);
        } else {
          segno = c.numsegs - 1;
          if (c.segs[segno].numpasses == c.segs[segno].maxpasses) {
            ++segno;
            init_seg(c, segno, tc.cblksty, false);
          }
        }
        int32_t n = (int32_t)c.numnewpasses;
        do {
          Seg& s = c.segs[segno];
          const int32_t room = (int32_t)(s.maxpasses - s.numpasses);
          s.numnewpasses = (uint32_t)(room < n ? room : n);
          const uint32_t bit_number = c.numlenbits + floorlog2(s.numnewpasses);
          if (bit_number > 32) return false;
          s.newlen = bio.read(bit_number);
          n -= (int32_t)s.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(c, segno, tc.cblksty, false);
          }
        } while (n > 0);
      }
    }
    data_present = true;
  }
  bio.inalign();
  uint32_t hdr_bytes = bio.numbytes();
  // a missing SOP is a warning, a missing EPH (or no room for it) an error
  if (csty & kCstyEph) {
    if (hlen - hdr_bytes < 2 || hstart[hdr_bytes] != 0xff || hstart[hdr_bytes + 1] != 0x92)
      return false;
    hdr_bytes += 2;
  }
  if (external) {
    ext.data += hdr_bytes;
    ext.len -= hdr_bytes;
  } else {
    cur += hdr_bytes;
  }
  if (!data_present) {
    *read = cur;
    return true;
  }
  // opj_t2_read_packet_data (strict: a segment past the data is an error)
  const uint32_t body = max_len - cur;
  uint32_t at = 0;
  for (uint32_t bandno = 0; bandno < res.numbands; ++bandno) {
    Band& b = res.bands[bandno];
    if (b.empty()) continue;
    Precinct& p = b.prec[pk.precno];
    const uint32_t ncb = p.cw * p.ch;
    for (uint32_t cblkno = 0; cblkno < ncb; ++cblkno) {
      Cblk& c = p.cblks[cblkno];
      if (!c.numnewpasses) continue;
      uint32_t segi;
      if (!c.numsegs) {
        segi = 0;
        ++c.numsegs;
      } else {
        segi = c.numsegs - 1;
        if (c.segs[segi].numpasses == c.segs[segi].maxpasses) {
          ++segi;
          ++c.numsegs;
        }
      }
      do {
        Seg& s = c.segs[segi];
        if ((uint64_t)at + s.newlen > body) return false;
        if (keep) {
          c.chunks.push_back({src_off + cur + at, s.newlen});
          s.len += s.newlen;
        }
        at += s.newlen;
        s.numpasses += s.numnewpasses;
        c.numnewpasses -= s.numnewpasses;
        if (keep) s.real_num_passes = s.numpasses;
        if (c.numnewpasses > 0) {
          ++segi;
          ++c.numsegs;
        }
      } while (c.numnewpasses > 0);
      if (keep) c.real_num_segs = c.numsegs;
    }
  }
  *read = cur + at;
  return true;
}

}  // namespace

extern "C" {

// Decode one tile (gatling_j2k_decode_tile). hdr: the parameter block
// (H_*, then C_* for each component). data[0:n]: the tile's tile-part
// bodies in order, with two writable bytes after them. ext, ext_n,
// ext_pos: the packet headers of PPM or PPT (hdr[H_EXTHDR] set), read
// from *ext_pos on and advanced. resno_decoded: per component, in and out
// (OpenJPEG keeps it across tiles). out: per component a buffer of the
// tile-component's size; on return it holds the decoded resolution's
// samples packed, and dims its width and height. Returns 0, -1 where
// OpenJPEG fails ("broken data stream" in Pillow), -2 for a code-block
// style this decoder does not implement (high throughput).
int64_t gatling_j2k_decode_tile(const int32_t* hdr, uint8_t* data, int64_t n, const uint8_t* ext,
                                int64_t ext_n, int64_t* ext_pos, int32_t* resno_decoded,
                                int32_t* const* out, int32_t* dims) {
  Tile t;
  t.hdr = hdr;
  for (int32_t c = 0; c < hdr[H_NCOMP]; ++c)
    if (hdr[H_COMP + C_SIZE * c + C_CBLKSTY] & 0x40) return -2;
  if (!init_tile(t)) return -1;
  // the packet order
  std::vector<PiComp> pcomps(t.numcomps);
  uint32_t max_prec = 0, max_res = 0;
  const uint32_t tx0 = (uint32_t)hdr[H_TX0], ty0 = (uint32_t)hdr[H_TY0];
  const uint32_t tx1 = (uint32_t)hdr[H_TX1], ty1 = (uint32_t)hdr[H_TY1];
  for (uint32_t c = 0; c < t.numcomps; ++c) {
    const TileComp& tc = t.comps[c];
    PiComp& pc = pcomps[c];
    pc.dx = tc.dx;
    pc.dy = tc.dy;
    pc.numres = tc.numres;
    pc.res.resize(tc.numres);
    if (tc.numres > max_res) max_res = tc.numres;
    const uint32_t tcx0 = uceildiv(tx0, tc.dx), tcy0 = uceildiv(ty0, tc.dy);
    const uint32_t tcx1 = uceildiv(tx1, tc.dx), tcy1 = uceildiv(ty1, tc.dy);
    for (uint32_t r = 0; r < tc.numres; ++r) {
      const uint32_t level = tc.numres - 1 - r;
      PiRes& pr = pc.res[r];
      pr.pdx = tc.res[r].pdx;
      pr.pdy = tc.res[r].pdy;
      const uint32_t rx0 = uceildivpow2(tcx0, level), ry0 = uceildivpow2(tcy0, level);
      const uint32_t rx1 = uceildivpow2(tcx1, level), ry1 = uceildivpow2(tcy1, level);
      const uint32_t px0 = (rx0 >> pr.pdx) << pr.pdx, py0 = (ry0 >> pr.pdy) << pr.pdy;
      const uint32_t px1 = uceildivpow2(rx1, pr.pdx) << pr.pdx;
      const uint32_t py1 = uceildivpow2(ry1, pr.pdy) << pr.pdy;
      pr.pw = rx0 == rx1 ? 0 : (px1 - px0) >> pr.pdx;
      pr.ph = ry0 == ry1 ? 0 : (py1 - py0) >> pr.pdy;
      if (pr.pw * pr.ph > max_prec) max_prec = pr.pw * pr.ph;
    }
  }
  std::vector<Poc> pocs;
  if (hdr[H_NPOC] > 0) {
    for (int32_t i = 0; i < hdr[H_NPOC]; ++i) {
      const int32_t* q = hdr + H_POC + H_POC_SIZE * i;
      pocs.push_back({(uint32_t)q[0], (uint32_t)q[1], umin((uint32_t)q[2], t.numlayers),
                      (uint32_t)q[3], (uint32_t)q[4], (uint32_t)q[5]});
    }
  } else {
    pocs.push_back({0, 0, t.numlayers, max_res, t.numcomps, (uint32_t)hdr[H_PRG]});
  }
  if ((uint64_t)max_prec * t.numcomps * max_res * (t.numlayers + 1ull) > (1ull << 31)) return -1;
  std::vector<std::vector<Packet>> order;
  bool unknown = false;
  packet_order(pcomps, tx0, ty0, tx1, ty1, t.numlayers, pocs, max_prec, max_res, &unknown, &order);
  // tier 2
  HeaderSource ext_src{nullptr, 0};
  if (hdr[H_EXTHDR]) {
    ext_src.data = ext + *ext_pos;
    ext_src.len = (uint32_t)(ext_n - *ext_pos);
  }
  uint32_t pos = 0, max_len = (uint32_t)n;
  for (size_t pino = 0; pino < order.size(); ++pino) {
    if (unknown && pino + 1 == order.size()) return -1;
    std::vector<uint8_t> first_pass_failed(t.numcomps, 1);
    for (const Packet& pk : order[pino]) {
      TileComp& tc = t.comps[pk.compno];
      bool skip = pk.layno >= t.numlayers || pk.resno >= tc.numres;
      if (!skip) {
        skip = true;
        Res& r = tc.res[pk.resno];
        for (uint32_t bandno = 0; bandno < r.numbands; ++bandno) {
          const Band& b = r.bands[bandno];
          if (pk.precno >= b.prec.size()) continue;
          const Precinct& p = b.prec[pk.precno];
          if (area_of_interest(t, tc, pk.resno, b.bandno, (uint32_t)p.x0, (uint32_t)p.y0,
                               (uint32_t)p.x1, (uint32_t)p.y1)) {
            skip = false;
            break;
          }
        }
      }
      uint32_t got = 0;
      if (!skip) first_pass_failed[pk.compno] = 0;
      if (!decode_packet(t, pk, data + pos, max_len, pos, ext_src, !skip, &got)) return -1;
      if (!skip)
        resno_decoded[pk.compno] = (int32_t)umax(pk.resno, (uint32_t)resno_decoded[pk.compno]);
      if (first_pass_failed[pk.compno] && resno_decoded[pk.compno] == 0)
        resno_decoded[pk.compno] = (int32_t)tc.numres - 1;
      pos += got;
      max_len -= got;
    }
  }
  if (hdr[H_EXTHDR]) *ext_pos = ext_n - ext_src.len;
  // tier 1 and dequantisation (opj_t1_clbl_decode_processor)
  T1 t1;
  for (uint32_t compno = 0; compno < t.numcomps; ++compno) {
    TileComp& tc = t.comps[compno];
    const uint32_t tile_w = (uint32_t)(tc.x1 - tc.x0);
    for (uint32_t resno = 0; resno < tc.numres; ++resno) {
      Res& r = tc.res[resno];
      for (uint32_t bandno = 0; bandno < r.numbands; ++bandno) {
        Band& b = r.bands[bandno];
        for (Precinct& p : b.prec) {
          if (!area_of_interest(t, tc, resno, b.bandno, (uint32_t)p.x0, (uint32_t)p.y0,
                                (uint32_t)p.x1, (uint32_t)p.y1))
            continue;
          for (Cblk& cb : p.cblks) {
            if (cb.x1 < cb.x0 || cb.y1 < cb.y0) return -1;
            if (!decode_cblk(t1, cb, data, b.bandno, tc.roishift, tc.cblksty)) return -1;
            int32_t x = cb.x0 - b.x0, y = cb.y0 - b.y0;
            if (b.bandno & 1) x += tc.res[resno - 1].x1 - tc.res[resno - 1].x0;
            if (b.bandno & 2) y += tc.res[resno - 1].y1 - tc.res[resno - 1].y0;
            int32_t* datap = t1.data.data();
            const int cw = t1.w, ch = t1.h;
            if (tc.roishift) {
              if (tc.roishift >= 31) {
                std::fill(t1.data.begin(), t1.data.end(), 0);
              } else {
                const int32_t thresh = 1 << tc.roishift;
                for (int32_t& v : t1.data) {
                  int32_t mag = v < 0 ? -v : v;
                  if (mag >= thresh) {
                    mag >>= tc.roishift;
                    v = v < 0 ? -mag : mag;
                  }
                }
              }
            }
            int32_t* tiledp = tc.data.data() + (size_t)y * tile_w + x;
            if (tc.qmfbid == 1) {
              for (int j = 0; j < ch; ++j)
                for (int i = 0; i < cw; ++i) tiledp[(size_t)j * tile_w + i] = datap[j * cw + i] / 2;
            } else {
              const float stepsize = 0.5f * b.stepsize;
              for (int j = 0; j < ch; ++j)
                for (int i = 0; i < cw; ++i) {
                  const float v = (float)datap[j * cw + i] * stepsize;
                  std::memcpy(&tiledp[(size_t)j * tile_w + i], &v, 4);
                }
            }
          }
        }
      }
    }
  }
  // the inverse wavelet over the decoded resolutions
  for (uint32_t compno = 0; compno < t.numcomps; ++compno) {
    TileComp& tc = t.comps[compno];
    std::vector<int32_t> rx(4 * tc.numres);
    for (uint32_t r = 0; r < tc.numres; ++r) {
      rx[4 * r] = tc.res[r].x0;
      rx[4 * r + 1] = tc.res[r].y0;
      rx[4 * r + 2] = tc.res[r].x1;
      rx[4 * r + 3] = tc.res[r].y1;
    }
    const uint32_t w = (uint32_t)(tc.x1 - tc.x0);
    const uint32_t numres = (uint32_t)resno_decoded[compno] + 1;
    if (tc.qmfbid == 1)
      idwt_tile<int32_t, idwt53_line_cb>(tc.data.data(), rx.data(), numres, w);
    else
      idwt_tile<float, idwt97_line_cb>(reinterpret_cast<float*>(tc.data.data()), rx.data(), numres, w);
  }
  // opj_tcd_mct_decode
  if (hdr[H_MCT] != 0 && t.numcomps >= 3) {
    const TileComp& c0 = t.comps[0];
    const size_t samples = c0.data.size();
    for (int k = 1; k < 3; ++k)
      if (t.comps[k].numres != c0.numres || resno_decoded[k] != resno_decoded[0] ||
          t.comps[k].data.size() != samples)
        return -1;
    if (c0.qmfbid == 1)
      mct_rev(t.comps[0].data.data(), t.comps[1].data.data(), t.comps[2].data.data(), (int64_t)samples);
    else
      mct_real(reinterpret_cast<float*>(t.comps[0].data.data()),
               reinterpret_cast<float*>(t.comps[1].data.data()),
               reinterpret_cast<float*>(t.comps[2].data.data()), (int64_t)samples);
  }
  // opj_tcd_dc_level_shift_decode, then opj_tcd_update_tile_data's copy
  for (uint32_t compno = 0; compno < t.numcomps; ++compno) {
    TileComp& tc = t.comps[compno];
    const Res& r = tc.res[resno_decoded[compno]];
    const uint32_t width = (uint32_t)(r.x1 - r.x0), height = (uint32_t)(r.y1 - r.y0);
    const uint32_t stride = (uint32_t)(tc.x1 - tc.x0);
    dims[2 * compno] = (int32_t)width;
    dims[2 * compno + 1] = (int32_t)height;
    int32_t lo, hi;
    if (tc.sgnd) {
      lo = -(1 << (tc.prec - 1));
      hi = (1 << (tc.prec - 1)) - 1;
    } else {
      lo = 0;
      hi = (int32_t)((1u << tc.prec) - 1);
    }
    int32_t* dst = out[compno];
    for (uint32_t j = 0; j < height; ++j)
      for (uint32_t i = 0; i < width; ++i) {
        int32_t* p = &tc.data[(size_t)j * stride + i];
        int32_t v;
        if (tc.qmfbid == 1) {
          const int32_t s = (int32_t)((uint32_t)*p + (uint32_t)tc.dcshift);
          v = s < lo ? lo : (s > hi ? hi : s);
        } else {
          float f;
          std::memcpy(&f, p, 4);
          if (f > 2147483648.0f) {
            v = hi;
          } else if (f < -2147483648.0f) {
            v = lo;
          } else {
            const int64_t s = lrintf_x86(f) + tc.dcshift;
            v = (int32_t)(s < lo ? lo : (s > hi ? hi : s));
          }
        }
        dst[(size_t)j * width + i] = v;
      }
  }
  return 0;
}

// The native transforms alone, for the tests against jpeg2000.py's NumPy
// twins: the inverse wavelet of a tile-component (data [h, w] with its
// `numres` resolution rectangles rx, x0 y0 x1 y1 each; int32 codes for the
// 5/3, float32 for the 9/7) and the inverse RCT / ICT over n samples.
void gatling_j2k_idwt(void* data, const int32_t* rx, int32_t numres, int32_t w, int32_t reversible) {
  if (reversible)
    idwt_tile<int32_t, idwt53_line_cb>((int32_t*)data, rx, (uint32_t)numres, (uint32_t)w);
  else
    idwt_tile<float, idwt97_line_cb>((float*)data, rx, (uint32_t)numres, (uint32_t)w);
}

void gatling_j2k_mct(void* c0, void* c1, void* c2, int64_t n, int32_t reversible) {
  if (reversible) mct_rev((int32_t*)c0, (int32_t*)c1, (int32_t*)c2, n);
  else mct_real((float*)c0, (float*)c1, (float*)c2, n);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The lossless encoder behind imgio/jpeg2000.py encode_jpeg2000 (Pillow's
// JPEG 2000 defaults: the reversible 5/3 wavelet, 64x64 code-blocks, one
// precinct a resolution, one layer in LRCP order, no MCT, no code-block
// style): the forward 5/3 (dwt.c's opj_dwt_encode_1, columns then rows at
// each level, so that the inverse above undoes it exactly), tier 1 (the MQ
// coder of mqc.c and the three passes of t1.c, each context the decoder's
// above) and tier 2 (tgt.c's tag trees and t2.c's packet headers, bio.c's
// bit stuffing). The codestream's markers and the JP2 boxes are Python's.
// ---------------------------------------------------------------------------
namespace {

// opj_dwt_encode_1 (cas 0) over an interleaved line a of sn low and dn high
// samples, then deinterleaved into tmp: the low ones first
void fdwt53_line(int32_t* a, int32_t dn, int32_t sn, int32_t* tmp) {
  auto S = [&](int32_t i) -> int32_t& { return a[2 * i]; };
  auto D = [&](int32_t i) -> int32_t& { return a[2 * i + 1]; };
  auto S_ = [&](int32_t i) { return S(i < 0 ? 0 : (i >= sn ? sn - 1 : i)); };
  auto D_ = [&](int32_t i) { return D(i < 0 ? 0 : (i >= dn ? dn - 1 : i)); };
  if (dn > 0 || sn > 1) {
    for (int32_t i = 0; i < dn; i++) D(i) -= (S_(i) + S_(i + 1)) >> 1;
    for (int32_t i = 0; i < sn; i++) S(i) += (D_(i - 1) + D_(i) + 2) >> 2;
  }
  for (int32_t i = 0; i < sn; i++) tmp[i] = a[2 * i];
  for (int32_t i = 0; i < dn; i++) tmp[sn + i] = a[2 * i + 1];
  std::memcpy(a, tmp, sizeof(int32_t) * (size_t)(sn + dn));
}

struct Mqe {
  std::vector<uint8_t> buf;
  size_t bp = 0;  // index of the last byte written (buf[0] is the dummy byte)
  uint32_t a = 0x8000, c = 0, ct = 12;
  uint8_t state[kNumCtx], mps[kNumCtx];
  Mqe() {
    buf.assign(1, 0);
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  uint8_t& at(size_t i) {
    if (i >= buf.size()) buf.resize(i + 1, 0);
    return buf[i];
  }
  void byteout() {
    if (at(bp) == 0xff) {
      at(++bp) = (uint8_t)(c >> 20);
      c &= 0xfffff;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      at(++bp) = (uint8_t)(c >> 19);
      c &= 0x7ffff;
      ct = 8;
    } else {
      at(bp)++;
      if (at(bp) == 0xff) {
        c &= 0x7ffffff;
        at(++bp) = (uint8_t)(c >> 20);
        c &= 0xfffff;
        ct = 7;
      } else {
        at(++bp) = (uint8_t)(c >> 19);
        c &= 0x7ffff;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int cx, uint32_t d) {
    const uint32_t s = state[cx], qe = kQe[s];
    if (mps[cx] == d) {
      a -= qe;
      if ((a & 0x8000) == 0) {
        if (a < qe) a = qe;
        else c += qe;
        state[cx] = kNmps[s];
        renorm();
      } else {
        c += qe;
      }
    } else {
      a -= qe;
      if (a < qe) c += qe;
      else a = qe;
      if (kSwitch[s]) mps[cx] ^= 1;
      state[cx] = kNlps[s];
      renorm();
    }
  }
  // opj_mqc_flush; the segment's bytes are buf[1, bp] (bp past a final 0xff
  // is not counted)
  size_t flush() {
    const uint32_t tempc = c + a;
    c |= 0xffff;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (at(bp) != 0xff) ++bp;
    return bp - 1;
  }
};

// one code-block's passes over coefficients w x h (row stride `stride`)
struct T1Enc {
  T1 t;  // the decoder's flags and contexts
  Mqe mq;
  std::vector<uint32_t> mag;
  std::vector<uint8_t> neg;
  int passes = 0;
  uint32_t numbps = 0;

  bool bit(int x, int y, int32_t bp) const { return (mag[(size_t)y * t.w + x] >> bp) & 1; }
  void sign(int x, int y) {
    int ctx;
    uint32_t spb;
    t.sign_ctx(x, y, &ctx, &spb);
    const uint32_t n = neg[(size_t)y * t.w + x];
    mq.encode(ctx, n ^ spb);
    *t.f(x, y) |= (uint8_t)(kSig | (n ? kNeg : 0));
  }
  void sigpass(int32_t bp) {
    for (int k = 0; k < t.h; k += 4)
      for (int x = 0; x < t.w; ++x)
        for (int y = k; y < k + 4 && y < t.h; ++y) {
          uint8_t* p = t.f(x, y);
          if ((*p & (kSig | kVisit)) || !t.neighbours(x, y)) continue;
          const uint32_t b = bit(x, y, bp);
          mq.encode(g_zc[t.orient][t.neighbours(x, y)], b);
          if (b) sign(x, y);
          *p |= kVisit;
        }
  }
  void refpass(int32_t bp) {
    for (int k = 0; k < t.h; k += 4)
      for (int x = 0; x < t.w; ++x)
        for (int y = k; y < k + 4 && y < t.h; ++y) {
          uint8_t* p = t.f(x, y);
          if ((*p & (kSig | kVisit)) != kSig) continue;
          const int ctx = (*p & kRefined) ? kCtxMag + 2 : (t.neighbours(x, y) ? kCtxMag + 1 : kCtxMag);
          mq.encode(ctx, bit(x, y, bp));
          *p |= kRefined;
        }
  }
  void cln_sample(int x, int y, int32_t bp) {
    const uint32_t b = bit(x, y, bp);
    mq.encode(g_zc[t.orient][t.neighbours(x, y)], b);
    if (b) sign(x, y);
  }
  void clnpass(int32_t bp) {
    int k = 0;
    for (; k + 4 <= t.h; k += 4)
      for (int x = 0; x < t.w; ++x) {
        if (t.run_mode(x, k)) {
          int first = -1;
          for (int y = k; y < k + 4; ++y)
            if (bit(x, y, bp)) {
              first = y - k;
              break;
            }
          mq.encode(kCtxAgg, first >= 0);
          if (first >= 0) {
            mq.encode(kCtxUni, (uint32_t)first >> 1);
            mq.encode(kCtxUni, (uint32_t)first & 1);
            sign(x, k + first);
            for (int y = k + first + 1; y < k + 4; ++y) cln_sample(x, y, bp);
          }
        } else {
          for (int y = k; y < k + 4; ++y)
            if (!(*t.f(x, y) & (kSig | kVisit))) cln_sample(x, y, bp);
        }
        for (int y = k; y < k + 4; ++y) *t.f(x, y) &= (uint8_t)~kVisit;
      }
    if (k < t.h)
      for (int x = 0; x < t.w; ++x) {
        for (int y = k; y < t.h; ++y)
          if (!(*t.f(x, y) & (kSig | kVisit))) cln_sample(x, y, bp);
        for (int y = k; y < t.h; ++y) *t.f(x, y) &= (uint8_t)~kVisit;
      }
  }
  // the segment's length (0 with no passes)
  size_t encode(const int32_t* coef, int64_t stride, int w, int h, int orient) {
    t.allocate(w, h);
    t.orient = orient;
    mag.assign((size_t)w * h, 0);
    neg.assign((size_t)w * h, 0);
    uint32_t mx = 0;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int32_t v = coef[y * stride + x];
        const uint32_t m = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
        mag[(size_t)y * w + x] = m;
        neg[(size_t)y * w + x] = v < 0;
        mx = m > mx ? m : mx;
      }
    numbps = 0;
    while (numbps < 32 && (mx >> numbps)) ++numbps;
    passes = numbps ? (int)(3 * numbps - 2) : 0;
    if (!numbps) return 0;
    for (int32_t bp = (int32_t)numbps - 1; bp >= 0; --bp) {
      if (bp != (int32_t)numbps - 1) {
        sigpass(bp);
        refpass(bp);
      }
      clnpass(bp);
    }
    return mq.flush();
  }
};

// bio.c's writer: a byte after 0xff carries 7 bits
struct BioW {
  std::vector<uint8_t>& out;
  uint32_t buf = 0, ct = 8;
  bool started = false;
  explicit BioW(std::vector<uint8_t>& o) : out(o) {}
  void byteout() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    out.push_back((uint8_t)(buf >> 8));
  }
  void putbit(uint32_t b) {
    if (ct == 0) byteout();
    --ct;
    buf |= b << ct;
  }
  void write(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) putbit((v >> i) & 1);
  }
  void flush() {
    byteout();
    if (ct == 7) byteout();
  }
};

// tgt.c's encoder over the decoder's tree shape
struct TagTreeW {
  TagTree shape;
  std::vector<int32_t> value, low;
  std::vector<uint8_t> known;
  void create(uint32_t nh, uint32_t nv) {
    shape.create(nh, nv);
    value.assign(shape.parent.size(), 999);
    low.assign(shape.parent.size(), 0);
    known.assign(shape.parent.size(), 0);
  }
  void setvalue(uint32_t leaf, int32_t v) {
    int32_t node = (int32_t)leaf;
    while (node >= 0 && value[node] > v) {
      value[node] = v;
      node = shape.parent[node];
    }
  }
  void encode(BioW& bio, uint32_t leaf, int32_t threshold) {
    int32_t stk[64];
    int sp = 0;
    int32_t node = (int32_t)leaf;
    while (shape.parent[node] >= 0) {
      stk[sp++] = node;
      node = shape.parent[node];
    }
    int32_t lo = 0;
    for (;;) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold) {
        if (lo >= value[node]) {
          if (!known[node]) {
            bio.write(1, 1);
            known[node] = 1;
          }
          break;
        }
        bio.write(0, 1);
        ++lo;
      }
      low[node] = lo;
      if (sp == 0) break;
      node = stk[--sp];
    }
  }
};

struct CblkEnc {
  std::vector<uint8_t> data;
  uint32_t numbps = 0;
  int passes = 0;
};

void put_numpasses(BioW& bio, int n) {
  if (n == 1) bio.write(0, 1);
  else if (n == 2) bio.write(2, 2);
  else if (n <= 5) bio.write(0xc | (n - 3), 4);
  else if (n <= 36) bio.write(0x1e0 | (n - 6), 9);
  else bio.write(0xff80 | (n - 37), 16);
}

}  // namespace

extern "C" {

// The forward 5/3 of data [h, w] in place over `levels` levels (columns
// then rows at each), the subbands where the inverse reads them.
void gatling_j2k_fdwt53(int32_t* data, int32_t w, int32_t h, int32_t levels) {
  std::vector<int32_t> line((size_t)(w > h ? w : h) + 2), tmp(line.size());
  int32_t rw = w, rh = h;
  for (int32_t l = 0; l < levels; ++l) {
    const int32_t sn_v = (rh + 1) / 2, dn_v = rh / 2, sn_h = (rw + 1) / 2, dn_h = rw / 2;
    for (int32_t x = 0; x < rw; ++x) {
      for (int32_t y = 0; y < rh; ++y) line[y] = data[(size_t)y * w + x];
      fdwt53_line(line.data(), dn_v, sn_v, tmp.data());
      for (int32_t y = 0; y < rh; ++y) data[(size_t)y * w + x] = line[y];
    }
    for (int32_t y = 0; y < rh; ++y) fdwt53_line(data + (size_t)y * w, dn_h, sn_h, tmp.data());
    rw = sn_h;
    rh = sn_v;
  }
}

// Tier 1 of one code-block (orient 0 LL, 1 HL, 2 LH, 3 HH): its segment
// into out (cap bytes); info[0] its bit-planes, info[1] its passes.
// Returns the length, or -1 if cap is too small.
int64_t gatling_j2k_encode_cblk(const int32_t* coef, int64_t stride, int32_t w, int32_t h,
                                int32_t orient, uint8_t* out, int64_t cap, int32_t* info) {
  T1Enc enc;
  const size_t n = enc.encode(coef, stride, w, h, orient);
  info[0] = (int32_t)enc.numbps;
  info[1] = enc.passes;
  if ((int64_t)n > cap) return -1;
  if (n) std::memcpy(out, enc.mq.buf.data() + 1, n);
  return (int64_t)n;
}

// The packets of one tile: comps [nc][h, w] after the forward 5/3 over
// `levels` levels; 64x64 code-blocks, one precinct a resolution, one layer,
// LRCP. bandbps[r][band] (3 a resolution, LL at [0][0]) are the bands'
// bit-plane counts (expn + guard bits - 1, the decoder's band numbps).
// Returns the length written to out, -1 if cap is too small, -2 if a
// code-block needs more bit-planes than its band allows.
int64_t gatling_j2k_encode_tile(const int32_t* const* comps, int32_t nc, int32_t w, int32_t h,
                                int32_t levels, const int32_t* bandbps, uint8_t* out,
                                int64_t cap) {
  const int32_t numres = levels + 1;
  // every band of every resolution and component, in packet order
  struct BandJob {
    int32_t r, c, b, x0, y0, bw, bh, orient;
    uint32_t cw, ch;
    size_t first;  // index of its first code-block in `blocks`
  };
  std::vector<BandJob> bands;
  size_t nblocks = 0;
  for (int32_t r = 0; r < numres; ++r) {
    int32_t rw = w, rh = h;
    for (int32_t i = 0; i < numres - 1 - r; ++i) {
      rw = (rw + 1) / 2;
      rh = (rh + 1) / 2;
    }
    const int32_t lw = (rw + 1) / 2, lh = (rh + 1) / 2;  // the next lower resolution
    for (int32_t c = 0; c < nc; ++c) {
      const int32_t spec[4][5] = {{0, 0, rw, rh, 0}, {lw, 0, rw - lw, lh, 1},
                                  {0, lh, lw, rh - lh, 2}, {lw, lh, rw - lw, rh - lh, 3}};
      for (int b = r == 0 ? 0 : 1; b < (r == 0 ? 1 : 4); ++b) {
        BandJob j{r, c, r == 0 ? 0 : b - 1, spec[b][0], spec[b][1], spec[b][2], spec[b][3],
                  spec[b][4], 0, 0, nblocks};
        if (j.bw > 0 && j.bh > 0) {
          j.cw = (uint32_t)((j.bw + 63) / 64);
          j.ch = (uint32_t)((j.bh + 63) / 64);
        }
        nblocks += (size_t)j.cw * j.ch;
        bands.push_back(j);
      }
    }
  }
  // tier 1 of every code-block, on the host's cores
  std::vector<CblkEnc> blocks(nblocks);
  std::vector<const BandJob*> owner(nblocks);
  for (const BandJob& j : bands)
    for (size_t k = 0; k < (size_t)j.cw * j.ch; ++k) owner[j.first + k] = &j;
  std::atomic<size_t> next{0};
  std::atomic<bool> too_deep{false};
  auto work = [&]() {
    for (size_t i = next++; i < nblocks; i = next++) {
      const BandJob& j = *owner[i];
      const uint32_t k = (uint32_t)(i - j.first), bx = k % j.cw, by = k / j.cw;
      const int32_t x0 = (int32_t)bx * 64, y0 = (int32_t)by * 64;
      T1Enc enc;
      const int32_t* base = comps[j.c] + (size_t)(j.y0 + y0) * w + (j.x0 + x0);
      const size_t n = enc.encode(base, w, std::min(64, j.bw - x0), std::min(64, j.bh - y0),
                                  j.orient);
      CblkEnc& ce = blocks[i];
      ce.numbps = enc.numbps;
      ce.passes = enc.passes;
      if ((int32_t)enc.numbps > bandbps[j.r * 3 + j.b]) too_deep = true;
      if (n) ce.data.assign(enc.mq.buf.begin() + 1, enc.mq.buf.begin() + 1 + (long)n);
    }
  };
  const unsigned nthreads = std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  std::vector<std::thread> pool;
  for (unsigned t = 1; t < nthreads && t < nblocks; ++t) pool.emplace_back(work);
  work();
  for (std::thread& t : pool) t.join();
  if (too_deep) return -2;
  // tier 2: one packet a resolution and component (one precinct, one layer)
  std::vector<uint8_t> all;
  for (size_t first = 0; first < bands.size();) {
    size_t last = first + 1;
    while (last < bands.size() && bands[last].r == bands[first].r &&
           bands[last].c == bands[first].c)
      ++last;
    std::vector<uint8_t> header, body;
    BioW bio(header);
    std::vector<TagTreeW> incl(last - first), imsb(last - first);
    bool any = false;
    for (size_t q = first; q < last; ++q) {
      const BandJob& j = bands[q];
      if (!j.cw) continue;
      incl[q - first].create(j.cw, j.ch);
      imsb[q - first].create(j.cw, j.ch);
      for (uint32_t k = 0; k < j.cw * j.ch; ++k) {
        const CblkEnc& ce = blocks[j.first + k];
        imsb[q - first].setvalue(k, bandbps[j.r * 3 + j.b] - (int32_t)ce.numbps);
        if (ce.passes) {
          incl[q - first].setvalue(k, 0);
          any = true;
        }
      }
    }
    bio.write(any ? 1 : 0, 1);
    for (size_t q = first; any && q < last; ++q) {
      const BandJob& j = bands[q];
      for (uint32_t k = 0; k < j.cw * j.ch; ++k) {
        const CblkEnc& ce = blocks[j.first + k];
        incl[q - first].encode(bio, k, 1);
        if (!ce.passes) continue;
        imsb[q - first].encode(bio, k, 999);
        put_numpasses(bio, ce.passes);
        const uint32_t len = (uint32_t)ce.data.size();
        const int32_t lenbits = 3 + (int32_t)floorlog2((uint32_t)ce.passes);
        const int32_t need = (int32_t)floorlog2(len) + 1 - lenbits;
        const int32_t increment = need > 0 ? need : 0;
        for (int32_t i = 0; i < increment; ++i) bio.write(1, 1);
        bio.write(0, 1);
        bio.write(len, lenbits + increment);
        body.insert(body.end(), ce.data.begin(), ce.data.end());
      }
    }
    bio.flush();
    all.insert(all.end(), header.begin(), header.end());
    all.insert(all.end(), body.begin(), body.end());
    first = last;
  }
  if ((int64_t)all.size() > cap) return -1;
  std::memcpy(out, all.data(), all.size());
  return (int64_t)all.size();
}

}  // extern "C"
