// JPEG 2000 (ITU-T T.800) tile decoding as OpenJPEG 2.5 decodes it: the
// packet headers and bodies of tier 2 (t2.c, pi.c, tgt.c, bio.c), the MQ
// and raw decoders and the three coding passes of tier 1 (mqc.c, t1.c), the
// high-throughput block decoder of Part 15 (ht_dec.c, ITU-T T.814),
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
constexpr uint32_t kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32, kHt = 64;
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
  uint32_t Mb = 0;  // the band's bit-planes, set where the block is first included
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
// ht_dec.c: the high-throughput block decoder of JPEG 2000 Part 15 (ITU-T
// T.814), as OpenJPEG 2.5 decodes a block: the cleanup pass's MEL, VLC and
// MagSgn streams, then SigProp and MagRef when the block has 2 or 3 passes.
// A sample is written as sign (bit 31) and magnitude with the half-bin
// centre, so that the dequantisation and wavelets above serve both coders.
// ---------------------------------------------------------------------------

// the CxtVLC tables of T.814 in OpenJPEG's packed form, indexed by the
// context (3 bits) and the next 7 bits of the VLC stream: bits 0-2 the
// codeword's length, 3 u_off, 4-7 rho, 8-11 e_1, 12-15 e_k; table 0 for
// the first row of quads, table 1 for the others
const uint16_t kVlcTbl0[1024] = {
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0xd8df, 0x0023, 0x10be, 0x0043, 0xf5ff,
    0x0083, 0x207e, 0x0055, 0x515f, 0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0xcccf,
    0x0023, 0xe2fe, 0x0043, 0x99ff, 0x0083, 0x0096, 0x00c5, 0x313f, 0x0023, 0x00a5, 0x0043, 0x445e,
    0x0083, 0xc8ce, 0x0014, 0x11df, 0x0023, 0xf4fe, 0x0043, 0xfcff, 0x0083, 0x009e, 0x0055, 0x0077,
    0x0023, 0x0035, 0x0043, 0xf1ff, 0x0083, 0x88ae, 0x0014, 0x00b7, 0x0023, 0xf8fe, 0x0043, 0xe4ef,
    0x0083, 0x888e, 0x00c5, 0x111f, 0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0x54df,
    0x0023, 0x10be, 0x0043, 0x22ef, 0x0083, 0x207e, 0x0055, 0x227f, 0x0023, 0x0035, 0x0043, 0x444e,
    0x0083, 0xc4ce, 0x0014, 0x11bf, 0x0023, 0xe2fe, 0x0043, 0x00f7, 0x0083, 0x0096, 0x00c5, 0x223f,
    0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x00d7, 0x0023, 0xf4fe, 0x0043, 0xbaff,
    0x0083, 0x009e, 0x0055, 0x006f, 0x0023, 0x0035, 0x0043, 0xe6ff, 0x0083, 0x88ae, 0x0014, 0xa2af,
    0x0023, 0xf8fe, 0x0043, 0x00e7, 0x0083, 0x888e, 0x00c5, 0x222f, 0x0002, 0x00c5, 0x0084, 0x207e,
    0x0002, 0xc4ce, 0x0024, 0x00f7, 0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x00d7,
    0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x11df, 0x0002, 0xa8ee, 0x0044, 0x0036,
    0x0002, 0x888e, 0x0014, 0x111f, 0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x88ff,
    0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0x00b7, 0x0002, 0xe4fe, 0x0084, 0x445e,
    0x0002, 0x00a6, 0x0024, 0x00e7, 0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x0077,
    0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0xf1ff, 0x0002, 0xa2fe, 0x0044, 0x0056,
    0x0002, 0x009e, 0x0014, 0x11bf, 0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x22ef,
    0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x227f, 0x0002, 0x00c5, 0x0084, 0x006e,
    0x0002, 0x88ce, 0x0024, 0xe4ef, 0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0xa2af,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0xd8df, 0x0002, 0x54de, 0x0044, 0x222e,
    0x0002, 0x003e, 0x0014, 0x515f, 0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x32ff,
    0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x00b7, 0x0002, 0x317e, 0x0084, 0x515e,
    0x0002, 0x00c6, 0x0024, 0x00d7, 0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x0077,
    0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0x00e7, 0x0002, 0xf1fe, 0x0044, 0x0036,
    0x0002, 0x00a6, 0x0014, 0x555f, 0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x747f,
    0x0002, 0xc4de, 0x0044, 0xf8ff, 0x0002, 0x0096, 0x0014, 0x222f, 0x0002, 0x0055, 0x0084, 0x0066,
    0x0002, 0x88de, 0x0024, 0x00f7, 0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x888f,
    0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0xc8cf, 0x0002, 0x20ee, 0x0044, 0x111e,
    0x0002, 0x009e, 0x0014, 0x006f, 0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0xd1df,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x227f, 0x0002, 0x74fe, 0x0084, 0x113e,
    0x0002, 0x20be, 0x0024, 0x22bf, 0x0002, 0xc4de, 0x0044, 0x22ef, 0x0002, 0x0096, 0x0014, 0x323f,
    0x0003, 0xd4de, 0xf4fd, 0xfcff, 0x0014, 0x113e, 0x0055, 0x888f, 0x0003, 0x32be, 0x0085, 0x00e7,
    0x0025, 0x515e, 0xaafe, 0x727f, 0x0003, 0x44ce, 0xf8fd, 0x44ef, 0x0014, 0x647e, 0x0045, 0xa2af,
    0x0003, 0x00a6, 0x555d, 0x99df, 0xf1fd, 0x0036, 0xf5fe, 0x626f, 0x0003, 0xd1de, 0xf4fd, 0xe6ff,
    0x0014, 0x717e, 0x0055, 0xb1bf, 0x0003, 0x88ae, 0x0085, 0xd5df, 0x0025, 0x444e, 0xf2fe, 0x667f,
    0x0003, 0x00c6, 0xf8fd, 0xe2ef, 0x0014, 0x545e, 0x0045, 0x119f, 0x0003, 0x0096, 0x555d, 0xc8cf,
    0xf1fd, 0x111e, 0xc8ee, 0x0067, 0x0003, 0xd4de, 0xf4fd, 0xf3ff, 0x0014, 0x113e, 0x0055, 0x11bf,
    0x0003, 0x32be, 0x0085, 0xd8df, 0x0025, 0x515e, 0xaafe, 0x222f, 0x0003, 0x44ce, 0xf8fd, 0x00f7,
    0x0014, 0x647e, 0x0045, 0x989f, 0x0003, 0x00a6, 0x555d, 0x00d7, 0xf1fd, 0x0036, 0xf5fe, 0x446f,
    0x0003, 0xd1de, 0xf4fd, 0xb9ff, 0x0014, 0x717e, 0x0055, 0x00b7, 0x0003, 0x88ae, 0x0085, 0xdcdf,
    0x0025, 0x444e, 0xf2fe, 0x0077, 0x0003, 0x00c6, 0xf8fd, 0xe4ef, 0x0014, 0x545e, 0x0045, 0x737f,
    0x0003, 0x0096, 0x555d, 0xb8bf, 0xf1fd, 0x111e, 0xc8ee, 0x323f, 0x0002, 0x00a5, 0x0084, 0x407e,
    0x0002, 0x10de, 0x0024, 0x11df, 0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0xb2bf,
    0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00e7, 0x0002, 0xc8ee, 0x0044, 0x222e,
    0x0002, 0x888e, 0x0014, 0x0077, 0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x00f7,
    0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0xaaaf, 0x0002, 0xb8fe, 0x0084, 0x005e,
    0x0002, 0x00be, 0x0024, 0xc4cf, 0x0002, 0x44ee, 0x0044, 0xf4ff, 0x0002, 0x223e, 0x0014, 0x111f,
    0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x99ff, 0x0002, 0x72fe, 0x0044, 0x0056,
    0x0002, 0xa8ae, 0x0014, 0x00b7, 0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x444f, 0x0002, 0x00a5, 0x0084, 0x006e,
    0x0002, 0x88ce, 0x0024, 0xe2ef, 0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0x447f,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0x009f, 0x0002, 0x44ee, 0x0044, 0x76ff,
    0x0002, 0x223e, 0x0014, 0x313f, 0x0003, 0x00c6, 0x0085, 0xd9ff, 0xf2fd, 0x647e, 0xf1fe, 0x99bf,
    0x0003, 0xa2ae, 0x0025, 0x66ef, 0xf4fd, 0x0056, 0xe2ee, 0x737f, 0x0003, 0x98be, 0x0045, 0x00f7,
    0xf8fd, 0x0066, 0x76fe, 0x889f, 0x0003, 0x888e, 0x0015, 0xd5df, 0x00a5, 0x222e, 0x98de, 0x444f,
    0x0003, 0xb2be, 0x0085, 0xfcff, 0xf2fd, 0x226e, 0x0096, 0x00b7, 0x0003, 0xaaae, 0x0025, 0xd1df,
    0xf4fd, 0x0036, 0xd4de, 0x646f, 0x0003, 0xa8ae, 0x0045, 0xeaef, 0xf8fd, 0x445e, 0xe8ee, 0x717f,
    0x0003, 0x323e, 0x0015, 0xc4cf, 0x00a5, 0xfaff, 0x88ce, 0x313f, 0x0003, 0x00c6, 0x0085, 0x77ff,
    0xf2fd, 0x647e, 0xf1fe, 0xb3bf, 0x0003, 0xa2ae, 0x0025, 0x00e7, 0xf4fd, 0x0056, 0xe2ee, 0x0077,
    0x0003, 0x98be, 0x0045, 0xe4ef, 0xf8fd, 0x0066, 0x76fe, 0x667f, 0x0003, 0x888e, 0x0015, 0x00d7,
    0x00a5, 0x222e, 0x98de, 0x333f, 0x0003, 0xb2be, 0x0085, 0x75ff, 0xf2fd, 0x226e, 0x0096, 0x919f,
    0x0003, 0xaaae, 0x0025, 0x99df, 0xf4fd, 0x0036, 0xd4de, 0x515f, 0x0003, 0xa8ae, 0x0045, 0xecef,
    0xf8fd, 0x445e, 0xe8ee, 0x727f, 0x0003, 0x323e, 0x0015, 0xb1bf, 0x00a5, 0xf3ff, 0x88ce, 0x111f,
    0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0xcccf, 0x0003, 0x91be, 0x0045, 0x22ef,
    0x0025, 0x222e, 0xf3fe, 0x888f, 0x0003, 0x00c6, 0x0085, 0x00f7, 0x0014, 0x115e, 0xfcfe, 0xa8af,
    0x0003, 0x00a6, 0x0035, 0xc8df, 0xf1fd, 0x313e, 0x66fe, 0x646f, 0x0003, 0xc8ce, 0xf2fd, 0xf5ff,
    0x0014, 0x0066, 0xf4fe, 0xbabf, 0x0003, 0x22ae, 0x0045, 0x00e7, 0x0025, 0x323e, 0xeafe, 0x737f,
    0x0003, 0xb2be, 0x0085, 0x55df, 0x0014, 0x0056, 0x717e, 0x119f, 0x0003, 0x0096, 0x0035, 0xc4cf,
    0xf1fd, 0x333e, 0xe8ee, 0x444f, 0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0x99bf,
    0x0003, 0x91be, 0x0045, 0xe2ef, 0x0025, 0x222e, 0xf3fe, 0x667f, 0x0003, 0x00c6, 0x0085, 0xe4ef,
    0x0014, 0x115e, 0xfcfe, 0x989f, 0x0003, 0x00a6, 0x0035, 0x00d7, 0xf1fd, 0x313e, 0x66fe, 0x226f,
    0x0003, 0xc8ce, 0xf2fd, 0xb9ff, 0x0014, 0x0066, 0xf4fe, 0x00b7, 0x0003, 0x22ae, 0x0045, 0xd1df,
    0x0025, 0x323e, 0xeafe, 0x0077, 0x0003, 0xb2be, 0x0085, 0xecef, 0x0014, 0x0056, 0x717e, 0x727f,
    0x0003, 0x0096, 0x0035, 0xb8bf, 0xf1fd, 0x333e, 0xe8ee, 0x545f, 0xf1fc, 0xd1de, 0xfafd, 0x00d7,
    0xf8fc, 0x0016, 0xfffd, 0x747f, 0xf4fc, 0x717e, 0xf3fd, 0xb3bf, 0xf2fc, 0xeaef, 0xe8ee, 0x444f,
    0xf1fc, 0x22ae, 0x0005, 0xb8bf, 0xf8fc, 0x00f7, 0xfcfe, 0x0077, 0xf4fc, 0x115e, 0xf5fd, 0x757f,
    0xf2fc, 0xd8df, 0xe2ee, 0x333f, 0xf1fc, 0xb2be, 0xfafd, 0x88cf, 0xf8fc, 0xfbff, 0xfffd, 0x737f,
    0xf4fc, 0x006e, 0xf3fd, 0x00b7, 0xf2fc, 0x66ef, 0xf9fe, 0x313f, 0xf1fc, 0x009e, 0x0005, 0xbabf,
    0xf8fc, 0xfdff, 0xf6fe, 0x0067, 0xf4fc, 0x0026, 0xf5fd, 0x888f, 0xf2fc, 0xdcdf, 0xd4de, 0x222f,
    0xf1fc, 0xd1de, 0xfafd, 0xc4cf, 0xf8fc, 0x0016, 0xfffd, 0x727f, 0xf4fc, 0x717e, 0xf3fd, 0x99bf,
    0xf2fc, 0xecef, 0xe8ee, 0x0047, 0xf1fc, 0x22ae, 0x0005, 0x00a7, 0xf8fc, 0xf7ff, 0xfcfe, 0x0057,
    0xf4fc, 0x115e, 0xf5fd, 0x0097, 0xf2fc, 0xd5df, 0xe2ee, 0x0037, 0xf1fc, 0xb2be, 0xfafd, 0x00c7,
    0xf8fc, 0xfeff, 0xfffd, 0x667f, 0xf4fc, 0x006e, 0xf3fd, 0xa8af, 0xf2fc, 0x00e7, 0xf9fe, 0x323f,
    0xf1fc, 0x009e, 0x0005, 0xb1bf, 0xf8fc, 0xe4ef, 0xf6fe, 0x545f, 0xf4fc, 0x0026, 0xf5fd, 0x0087,
    0xf2fc, 0x99df, 0xd4de, 0x111f,
};
const uint16_t kVlcTbl1[1024] = {
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e, 0x0013, 0x00a5, 0x0043, 0x88ae,
    0x0083, 0x0035, 0x0023, 0x00d7, 0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e,
    0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x0077, 0x0013, 0x0065, 0x0043, 0x88ce,
    0x0083, 0x888d, 0x0023, 0x111e, 0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0x00e7,
    0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x11ff, 0x0013, 0x0095, 0x0043, 0x003e,
    0x0083, 0x40ee, 0x0023, 0xa2af, 0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e,
    0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x44ef, 0x0013, 0x00c5, 0x0043, 0x009e,
    0x0083, 0x0055, 0x0023, 0x222e, 0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x00b7,
    0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e, 0x0013, 0x00a5, 0x0043, 0x005e,
    0x0083, 0x0035, 0x0023, 0xc4cf, 0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x00f7,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0x006f, 0x0001, 0x0084, 0x0001, 0x0056,
    0x0001, 0x0014, 0x0001, 0x00d7, 0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x0077,
    0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x888f, 0x0001, 0x0024, 0x0001, 0x00f7,
    0x0001, 0x0035, 0x0001, 0x222f, 0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00b7,
    0x0001, 0x0024, 0x0001, 0x00bf, 0x0001, 0x0045, 0x0001, 0x0067, 0x0001, 0x0084, 0x0001, 0x00a6,
    0x0001, 0x0014, 0x0001, 0x444f, 0x0001, 0x0024, 0x0001, 0x00e7, 0x0001, 0x0035, 0x0001, 0x113f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00cf, 0x0001, 0x0024, 0x0001, 0x0096,
    0x0001, 0x0045, 0x0001, 0x006f, 0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x009f,
    0x0001, 0x0024, 0x0001, 0x00ef, 0x0001, 0x0035, 0x0001, 0x323f, 0x0001, 0x0084, 0x0001, 0x40fe,
    0x0001, 0x0014, 0x0001, 0x00af, 0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x007f, 0x0001, 0x0024, 0x0001, 0x00df,
    0x0001, 0x0035, 0x0001, 0x111f, 0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0x00bf,
    0x0001, 0x0014, 0x0001, 0x00f7, 0x0001, 0x00c6, 0x0001, 0x0077, 0x0001, 0x0024, 0x0001, 0xf8ff,
    0x0001, 0x0045, 0x0001, 0x007f, 0x0001, 0x0014, 0x0001, 0x00df, 0x0001, 0x00a6, 0x0001, 0x313f,
    0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0x00b7, 0x0001, 0x0014, 0x0001, 0x44ef,
    0x0001, 0xa2ae, 0x0001, 0x0067, 0x0001, 0x0024, 0x0001, 0x51ff, 0x0001, 0x0045, 0x0001, 0x0097,
    0x0001, 0x0014, 0x0001, 0x00cf, 0x0001, 0x0036, 0x0001, 0x223f, 0x0001, 0x0024, 0x0001, 0x0056,
    0x0001, 0x0085, 0x0001, 0xb2bf, 0x0001, 0x0014, 0x0001, 0x40ef, 0x0001, 0x00c6, 0x0001, 0x006f,
    0x0001, 0x0024, 0x0001, 0x72ff, 0x0001, 0x0045, 0x0001, 0x009f, 0x0001, 0x0014, 0x0001, 0x00d7,
    0x0001, 0x00a6, 0x0001, 0x444f, 0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0xa8af,
    0x0001, 0x0014, 0x0001, 0x00e7, 0x0001, 0xa2ae, 0x0001, 0x005f, 0x0001, 0x0024, 0x0001, 0x44ff,
    0x0001, 0x0045, 0x0001, 0x888f, 0x0001, 0x0014, 0x0001, 0xaaaf, 0x0001, 0x0036, 0x0001, 0x111f,
    0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0x66ff, 0x0002, 0x00ce, 0x0014, 0x111e,
    0x0002, 0x0096, 0x0035, 0xa8af, 0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0xb3bf,
    0x0002, 0xb2be, 0x0014, 0xf5ff, 0x0002, 0x0066, 0x517e, 0x545f, 0x0002, 0xf2fe, 0x0024, 0x222e,
    0x0002, 0x22ae, 0x0085, 0x44ef, 0x0002, 0x00c6, 0x0014, 0xf4ff, 0x0002, 0x0076, 0x0035, 0x447f,
    0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0x00d7, 0x0002, 0x88be, 0x0014, 0xfaff,
    0x0002, 0x115e, 0xf1fe, 0x444f, 0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0xc8ef,
    0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0x888f, 0x0002, 0x00f6, 0x0024, 0x313e,
    0x0002, 0x00a6, 0x0045, 0x44df, 0x0002, 0xb2be, 0x0014, 0xa8ff, 0x0002, 0x0066, 0x517e, 0x006f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x00e7, 0x0002, 0x00c6, 0x0014, 0xe2ef,
    0x0002, 0x0076, 0x0035, 0x727f, 0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0xb1bf,
    0x0002, 0x88be, 0x0014, 0x73ff, 0x0002, 0x115e, 0xf1fe, 0x333f, 0x0001, 0x0084, 0x0001, 0x20ee,
    0x0001, 0x00c5, 0x0001, 0xc4cf, 0x0001, 0x0044, 0x0001, 0x32ff, 0x0001, 0x0015, 0x0001, 0x888f,
    0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x00af, 0x0001, 0x0044, 0x0001, 0x22ef,
    0x0001, 0x00a6, 0x0001, 0x005f, 0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0xcccf,
    0x0001, 0x0044, 0x0001, 0x00f7, 0x0001, 0x0015, 0x0001, 0x006f, 0x0001, 0x0084, 0x0001, 0x0056,
    0x0001, 0x0025, 0x0001, 0x009f, 0x0001, 0x0044, 0x0001, 0x00df, 0x0001, 0x30fe, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc8cf, 0x0001, 0x0044, 0x0001, 0x11ff,
    0x0001, 0x0015, 0x0001, 0x0077, 0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x007f,
    0x0001, 0x0044, 0x0001, 0x00e7, 0x0001, 0x00a6, 0x0001, 0x0037, 0x0001, 0x0084, 0x0001, 0x444e,
    0x0001, 0x00c5, 0x0001, 0x00b7, 0x0001, 0x0044, 0x0001, 0x00bf, 0x0001, 0x0015, 0x0001, 0x003f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x0097, 0x0001, 0x0044, 0x0001, 0x00d7,
    0x0001, 0x30fe, 0x0001, 0x111f, 0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xf3ff,
    0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0xd8df, 0x0002, 0xf8fe, 0x0044, 0x0066,
    0x0002, 0x207e, 0x0085, 0x99ff, 0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x009f,
    0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0x76ff, 0x0002, 0xf1fe, 0x0025, 0x444e,
    0x0002, 0x00ae, 0x0055, 0xc8cf, 0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0xe4ef,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x222f, 0x0002, 0xa8ee, 0x0044, 0x888e,
    0x0002, 0x00d6, 0x00c5, 0xfaff, 0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0x11bf,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x22ef, 0x0002, 0x00e6, 0x00f5, 0x0036,
    0x0002, 0x00a6, 0x0015, 0x227f, 0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0xd5ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0x006f, 0x0002, 0xf4fe, 0x0044, 0x445e,
    0x0002, 0x10be, 0x0085, 0x11df, 0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x515f,
    0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xd4df, 0x0003, 0xa2ae, 0x0055, 0x76ff,
    0x0024, 0x223e, 0x00b6, 0xaaaf, 0x0003, 0x00e6, 0x0014, 0xf5ff, 0x0044, 0x0066, 0x0085, 0xcccf,
    0x0003, 0x009e, 0x00c5, 0x44ef, 0x0024, 0x0036, 0xf8fe, 0x317f, 0x0003, 0xe8ee, 0x0014, 0xf1ff,
    0x0044, 0x0076, 0x00a5, 0xc4cf, 0x0003, 0x227e, 0x0055, 0xd1df, 0x0024, 0x444e, 0xf4fe, 0x515f,
    0x0003, 0x00d6, 0x0014, 0xe2ef, 0x0044, 0x445e, 0x0085, 0x22bf, 0x0003, 0x0096, 0x00c5, 0xc8df,
    0x0024, 0x222e, 0xf2fe, 0x226f, 0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xb1bf,
    0x0003, 0xa2ae, 0x0055, 0x33ff, 0x0024, 0x223e, 0x00b6, 0xa8af, 0x0003, 0x00e6, 0x0014, 0xb9ff,
    0x0044, 0x0066, 0x0085, 0xa8bf, 0x0003, 0x009e, 0x00c5, 0xe4ef, 0x0024, 0x0036, 0xf8fe, 0x646f,
    0x0003, 0xe8ee, 0x0014, 0xfcff, 0x0044, 0x0076, 0x00a5, 0xc8cf, 0x0003, 0x227e, 0x0055, 0xeaef,
    0x0024, 0x444e, 0xf4fe, 0x747f, 0x0003, 0x00d6, 0x0014, 0xfaff, 0x0044, 0x445e, 0x0085, 0xb2bf,
    0x0003, 0x0096, 0x00c5, 0x44df, 0x0024, 0x222e, 0xf2fe, 0x313f, 0x00f3, 0xfafe, 0xf1fd, 0x0036,
    0x0004, 0x32be, 0x0075, 0x11df, 0x00f3, 0x54de, 0xf2fd, 0xe4ef, 0x00d5, 0x717e, 0xfcfe, 0x737f,
    0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0xb1bf, 0x00f3, 0x00ce, 0x00b5, 0xd8df,
    0xf4fd, 0x0066, 0xb9fe, 0x545f, 0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x009f,
    0x00f3, 0x00ae, 0xf2fd, 0xf7ff, 0x00d5, 0x0046, 0xf5fe, 0x747f, 0x00f3, 0x00e6, 0xf8fd, 0x0016,
    0x0004, 0x0086, 0x0055, 0x888f, 0x00f3, 0x00c6, 0x00b5, 0xe2ef, 0xf4fd, 0x115e, 0xa8ee, 0x113f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0xd1df, 0x00f3, 0x54de, 0xf2fd, 0xfbff,
    0x00d5, 0x717e, 0xfcfe, 0x447f, 0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0x727f,
    0x00f3, 0x00ce, 0x00b5, 0x22ef, 0xf4fd, 0x0066, 0xb9fe, 0x444f, 0x00f3, 0x76fe, 0xf1fd, 0x0026,
    0x0004, 0x00a6, 0x0075, 0x11bf, 0x00f3, 0x00ae, 0xf2fd, 0xffff, 0x00d5, 0x0046, 0xf5fe, 0x323f,
    0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x006f, 0x00f3, 0x00c6, 0x00b5, 0xb8bf,
    0xf4fd, 0x115e, 0xa8ee, 0x222f,
};
inline uint32_t read_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline uint32_t popcount32(uint32_t v) { return (uint32_t)__builtin_popcount(v); }
inline uint32_t bitlen32(uint32_t v) { return v ? 32u - (uint32_t)__builtin_clz(v) : 0u; }

// The MEL stream, read forwards from the start of the MEL+VLC region, 0xFF
// past its end. `align` is the block's address modulo 4: OpenJPEG reads the
// MEL's bytes up to the next multiple of 4 one at a time, and only those
// are checked for a stuffed byte above 0x8F.
struct HtMel {
  const uint8_t* data;
  uint64_t tmp;
  int bits, size, k, num_runs;
  bool unstuff;
  uint64_t runs;

  bool init(const uint8_t* bbuf, int lcup, int scup, uint32_t align) {
    data = bbuf + lcup - scup;
    bits = 0;
    tmp = 0;
    unstuff = false;
    size = scup - 1;
    k = 0;
    num_runs = 0;
    runs = 0;
    const int num = 4 - (int)((align + (uint32_t)(lcup - scup)) & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && data[0] > 0x8F) return false;
      uint64_t d = size > 0 ? *data : 0xFF;
      if (size == 1) d |= 0xF;
      data += size-- > 0;
      const int d_bits = 8 - unstuff;
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xFF) == 0xFF;
    }
    tmp <<= 64 - bits;
    return true;
  }
  void read() {
    if (bits > 32) return;
    uint32_t val = 0xFFFFFFFFu;
    if (size > 4) {
      val = read_le32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        const uint32_t v = *data++;
        const uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      uint32_t v = *data++;
      v |= 0xF;
      const uint32_t m = ~(0xFFu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nbits = 32 - unstuff;
    uint32_t t = val & 0xFF;
    bool u = (val & 0xFF) == 0xFF;
    nbits -= u;
    t <<= 8 - u;
    t |= (val >> 8) & 0xFF;
    u = ((val >> 8) & 0xFF) == 0xFF;
    nbits -= u;
    t <<= 8 - u;
    t |= (val >> 16) & 0xFF;
    u = ((val >> 16) & 0xFF) == 0xFF;
    nbits -= u;
    t <<= 8 - u;
    t |= (val >> 24) & 0xFF;
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= (uint64_t)t << (64 - nbits - bits);
    bits += nbits;
  }
  void decode() {
    static const int mel_exp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      const int eval = mel_exp[k];
      int run;
      if (tmp & (1ull << 63)) {
        run = ((1 << eval) - 1) << 1;  // 2^eval zero events, no one
        k = k + 1 < 12 ? k + 1 : 12;
        tmp <<= 1;
        bits -= 1;
      } else {
        run = (int)(tmp >> (63 - eval)) & ((1 << eval) - 1);
        k = k - 1 > 0 ? k - 1 : 0;
        tmp <<= eval + 1;
        bits -= eval + 1;
        run = (run << 1) + 1;  // zero events ended by a one
      }
      const int at = num_runs * 7;
      runs &= ~((uint64_t)0x3F << at);
      runs |= (uint64_t)run << at;
      ++num_runs;
    }
  }
  int get_run() {
    if (num_runs == 0) decode();
    const int t = (int)(runs & 0x7F);
    runs >>= 7;
    --num_runs;
    return t;
  }
};

// A stream read backwards with the unstuffing of a byte 0x7F after one above
// 0x8F: the VLC stream from the byte before Scup (its upper four bits), and
// the MagRef stream from the end of the refinement segment; zeros past the
// start.
struct HtRev {
  const uint8_t* data;
  uint64_t tmp;
  uint32_t bits;
  int size;
  bool unstuff;

  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = read_le32(data - 3);
      data -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        const uint32_t v = *data--;
        val |= v << i;
        --size;
        i -= 8;
      }
    }
    uint32_t t = val >> 24;
    uint32_t nbits = 8u - ((unstuff && ((val >> 24) & 0x7F) == 0x7F) ? 1u : 0u);
    bool u = (val >> 24) > 0x8F;
    t |= ((val >> 16) & 0xFF) << nbits;
    nbits += 8u - ((u && ((val >> 16) & 0x7F) == 0x7F) ? 1u : 0u);
    u = ((val >> 16) & 0xFF) > 0x8F;
    t |= ((val >> 8) & 0xFF) << nbits;
    nbits += 8u - ((u && ((val >> 8) & 0x7F) == 0x7F) ? 1u : 0u);
    u = ((val >> 8) & 0xFF) > 0x8F;
    t |= (val & 0xFF) << nbits;
    nbits += 8u - ((u && (val & 0x7F) == 0x7F) ? 1u : 0u);
    u = (val & 0xFF) > 0x8F;
    tmp |= (uint64_t)t << bits;
    bits += nbits;
    unstuff = u;
  }
  // OpenJPEG reads the bytes up to an aligned address one at a time first;
  // the bits come out the same
  void init_vlc(const uint8_t* d, int lcup, int scup) {
    data = d + lcup - 2;
    size = scup - 2;
    const uint32_t first = *data--;
    tmp = first >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (first | 0xF) > 0x8F;
    read();
  }
  void init_mrp(const uint8_t* d, int lcup, int len2) {
    data = d + lcup + len2 - 1;
    size = len2;
    unstuff = true;
    bits = 0;
    tmp = 0;
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return (uint32_t)tmp;
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return (uint32_t)tmp;
  }
};

// A stream read forwards with the unstuffing of the bit after a 0xFF byte:
// MagSgn (0xFF past its end) and SigProp (zeros past its end).
struct HtFrwd {
  const uint8_t* data;
  uint64_t tmp;
  uint32_t bits, X;
  bool unstuff;
  int size;

  void read() {
    uint32_t val;
    if (size > 3) {
      val = read_le32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = X != 0 ? 0xFFFFFFFFu : 0;
      while (size > 0) {
        const uint32_t v = *data++;
        const uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = X != 0 ? 0xFFFFFFFFu : 0;
    }
    uint32_t nbits = 8u - (unstuff ? 1u : 0u);
    uint32_t t = val & 0xFF;
    bool u = (val & 0xFF) == 0xFF;
    t |= ((val >> 8) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 8) & 0xFF) == 0xFF;
    t |= ((val >> 16) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 16) & 0xFF) == 0xFF;
    t |= ((val >> 24) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= (uint64_t)t << bits;
    bits += nbits;
  }
  void init(const uint8_t* d, int n, uint32_t x) {
    data = d;
    tmp = 0;
    bits = 0;
    unstuff = false;
    size = n;
    X = x;
    read();
  }
  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return (uint32_t)tmp;
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// the u prefix (1, 01, 001, 000 read from the LSB) with its suffix length and
// prefix value: bits 0-1 the prefix length, 2-4 the suffix length, 5-7 u_pfx
const uint8_t kUvlcDec[8] = {3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
                             1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
                             2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};

// decode_init_uvlc and decode_noninit_uvlc: u + kappa of a quad pair. mode
// holds the two u_off bits; on the first row, 4 when both are set and the
// MEL event is 1 (both u past 2: kappa 1 and 2 more), and after a first
// prefix of 3 bits at mode 3 the second u is one bit
uint32_t decode_uvlc(uint32_t vlc, uint32_t mode, bool initial, uint32_t* u) {
  u[0] = u[1] = 1;
  if (mode == 0) return 0;
  uint32_t consumed = 0;
  auto prefix = [&]() {
    const uint32_t d = kUvlcDec[vlc & 0x7];
    vlc >>= d & 0x3;
    consumed += d & 0x3;
    return d;
  };
  auto suffix = [&](uint32_t d) {
    const uint32_t sl = (d >> 2) & 0x7;
    const uint32_t v = (d >> 5) + (vlc & ((1u << sl) - 1));
    vlc >>= sl;
    consumed += sl;
    return v;
  };
  if (mode <= 2) {
    u[mode - 1] = suffix(prefix()) + 1;
    return consumed;
  }
  const uint32_t d1 = prefix();
  if (initial && mode == 3 && (d1 & 0x3) > 2) {
    u[1] = (vlc & 1) + 2;
    vlc >>= 1;
    ++consumed;
    u[0] = suffix(d1) + 1;
    return consumed;
  }
  const uint32_t d2 = prefix();
  const uint32_t add = mode == 4 ? 3 : 1;
  u[0] = suffix(d1) + add;
  u[1] = suffix(d2) + add;
  return consumed;
}

// the SigProp and MagRef passes over one stripe of 4 rows (y0 its first row;
// `pattern` limits a last, shorter stripe) of a block w wide. sig, mbr: the
// stripe's significance and its membership (the samples SigProp visits), 8
// columns of 4 rows a word; nsig, nmbr: those of the next stripe.
void ht_sigprop_stripe(uint32_t* dec, int w, int stride, int y0, uint32_t p, uint32_t pattern,
                       uint32_t* cur_sig, uint32_t* cur_mbr, uint32_t* nxt_sig, uint32_t* nxt_mbr,
                       HtFrwd& sigprop) {
  const uint32_t val = 3u << (p - 2);  // the newly significant samples with the bin centre
  for (int i = 0; i < w; i += 8, ++cur_sig, ++cur_mbr, ++nxt_sig, ++nxt_mbr) {
    uint32_t mbr = *cur_mbr & pattern;
    uint32_t new_sig = 0;
    if (mbr) {
      for (int n = 0; n < 8; n += 4) {
        uint32_t cwd = sigprop.fetch();
        uint32_t cnt = 0;
        uint32_t* dp = dec + (size_t)y0 * stride + i + n;
        uint32_t col_mask = 0xFu << (4 * n);
        const uint32_t inv_sig = ~cur_sig[0] & pattern;
        const int end = n + 4 + i < w ? n + 4 : w - i;
        for (int j = n; j < end; ++j, ++dp, col_mask <<= 4) {
          if ((col_mask & mbr) == 0) continue;
          static const uint32_t spread[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
          uint32_t sample_mask = 0x11111111u & col_mask;
          for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
            if (!(mbr & sample_mask)) continue;
            if (cwd & 1) {
              new_sig |= sample_mask;
              mbr |= (spread[r] << (j * 4)) & inv_sig;
            }
            cwd >>= 1;
            ++cnt;
          }
        }
        if (new_sig & (0xFFFFu << (4 * n))) {
          uint32_t* dq = dec + (size_t)y0 * stride + i + n;
          uint32_t cm = 0xFu << (4 * n);
          for (int j = n; j < end; ++j, ++dq, cm <<= 4) {
            if ((cm & new_sig) == 0) continue;
            uint32_t sample_mask = 0x11111111u & cm;
            for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
              if (!(new_sig & sample_mask)) continue;
              dq[(size_t)r * stride] |= ((cwd & 1) << 31) | val;
              cwd >>= 1;
              ++cnt;
            }
          }
        }
        sigprop.advance(cnt);
        if (n == 4) {  // the next 8 columns' first one
          uint32_t t = new_sig >> 28;
          t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
          cur_mbr[1] |= t & ~cur_sig[1];
        }
      }
    }
    // the next stripe's first row
    new_sig |= cur_sig[0];
    const uint32_t ux = (new_sig & 0x88888888u) >> 3;
    const uint32_t tx = ux | (ux << 4) | (ux >> 4);
    if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
    nxt_mbr[0] |= tx & ~nxt_sig[0];
    nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
  }
}

// MagRef over the samples of one stripe that the cleanup made significant
void ht_magref_stripe(uint32_t* dpp, int w, int stride, uint32_t p, uint32_t* sig_row, HtRev& magref) {
  const uint32_t half = 1u << (p - 2);
  for (int i = 0; i < w; i += 8) {
    uint32_t cwd = magref.fetch();
    const uint32_t sig = *sig_row++;
    uint32_t col_mask = 0xFu;
    uint32_t* dp = dpp + i;
    if (sig) {
      for (int j = 0; j < 8; ++j, ++dp, col_mask <<= 4) {
        if (!(sig & col_mask)) continue;
        uint32_t sample_mask = 0x11111111u & col_mask;
        for (int r = 0; r < 4; ++r, sample_mask += sample_mask) {
          if (!(sig & sample_mask)) continue;
          const uint32_t sym = cwd & 1;
          dp[(size_t)r * stride] ^= (1 - sym) << (p - 1);
          dp[(size_t)r * stride] |= half;
          cwd >>= 1;
        }
      }
    }
    magref.advance(popcount32(sig));
  }
}

// the membership of a stripe from its own significance: its neighbours
// left, right, above and below, less the significant samples
void ht_stripe_mbr(const uint32_t* sig, uint32_t* mbr, int w) {
  uint32_t prev = 0;
  for (int i = 0; i < w; i += 8, ++mbr, ++sig) {
    mbr[0] = sig[0];
    mbr[0] |= prev >> 28;
    mbr[0] |= sig[0] << 4;
    mbr[0] |= sig[0] >> 4;
    mbr[0] |= sig[1] << 28;
    prev = sig[0];
    const uint32_t t = mbr[0];
    uint32_t z = mbr[0];
    z |= (t & 0x77777777u) << 1;
    z |= (t & 0xEEEEEEEEu) >> 1;
    mbr[0] = z & ~sig[0];
  }
}

// the next stripe's first row adds to this stripe's last row's membership
// (not when vertically causal)
void ht_stripe_mbr_below(const uint32_t* cur_sig, uint32_t* cur_mbr, const uint32_t* nxt_sig, int w,
                         bool stripe_causal) {
  uint32_t prev = 0;
  for (int i = 0; i < w; i += 8, ++cur_mbr, ++cur_sig, ++nxt_sig) {
    uint32_t t = nxt_sig[0];
    t |= prev >> 28;
    t |= nxt_sig[0] << 4;
    t |= nxt_sig[0] >> 4;
    t |= nxt_sig[1] << 28;
    prev = nxt_sig[0];
    if (!stripe_causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
    cur_mbr[0] &= ~cur_sig[0];
  }
}

// one significant sample of the cleanup pass: m_n bits of MagSgn (the sign
// first) under the implicit MSB e_1, the bin centre, shifted to bit-plane p;
// returns v_n for the exponent
inline uint32_t ht_sample(HtFrwd& magsgn, uint32_t U, uint32_t ek, uint32_t e1, uint32_t p, uint32_t* out) {
  const uint32_t ms_val = magsgn.fetch();
  const uint32_t m_n = U - ek;
  magsgn.advance(m_n);
  const uint32_t val = ms_val << 31;
  uint32_t v_n = ms_val & ((1u << m_n) - 1);
  v_n |= e1 << m_n;
  v_n |= 1;
  *out = val | ((v_n + 2) << (p - 1));
  return v_n;
}

// opj_t1_ht_decode_cblk: false where OpenJPEG gives up on the block
bool ht_decode_cblk(T1& t1, Cblk& cb, const uint8_t* tiledata, uint32_t roishift, uint32_t cblksty) {
  if (roishift != 0) return false;  // "We do not support ROI in decoding HT codeblocks"
  const int width = cb.x1 - cb.x0, height = cb.y1 - cb.y0;
  t1.allocate(width, height);
  const uint32_t zero_bplanes = (cb.Mb + 1) - cb.numbps;
  uint32_t cblk_len = 0;
  for (const Chunk& c : cb.chunks) cblk_len += c.len;
  if (cb.chunks.empty()) return true;
  // OpenJPEG reads one chunk where it lies in the tile's data (a malloc'd,
  // so 16-byte aligned, buffer: `align` is the block's address modulo 4,
  // which the MEL's check depends on), several from an aligned buffer
  std::vector<uint8_t> joined;
  const uint8_t* coded;
  uint32_t align = 0;
  if (cb.chunks.size() > 1) {
    joined.resize(cblk_len);
    uint32_t at = 0;
    for (const Chunk& c : cb.chunks) {
      if (c.len) std::memcpy(joined.data() + at, tiledata + c.off, c.len);
      at += c.len;
    }
    coded = joined.data();
  } else {
    coded = tiledata + cb.chunks[0].off;
    align = cb.chunks[0].off & 3;
  }
  // a segment no packet header began reads as zeros (OpenJPEG clears every
  // segment when it sets a tile up): a later layer's lone pass joins the
  // cleanup's segment and leaves the second one empty
  const Seg none;
  const Seg& seg0 = cb.segs.size() > 0 ? cb.segs[0] : none;
  const Seg& seg1 = cb.segs.size() > 1 ? cb.segs[1] : none;
  uint32_t num_passes = cb.numsegs > 0 ? seg0.real_num_passes : 0;
  num_passes += cb.numsegs > 1 ? seg1.real_num_passes : 0;
  const uint32_t lengths1 = num_passes > 0 ? seg0.len : 0;
  const uint32_t lengths2 = num_passes > 1 ? seg1.len : 0;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;  // a warning
  if (num_passes > 3) return false;
  if (cb.Mb > 30) return false;
  if (zero_bplanes > cb.Mb) return false;
  if (zero_bplanes == cb.Mb && num_passes > 1) num_passes = 1;  // a warning
  const uint32_t p = cb.numbps;
  if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len) return false;
  const int lcup = (int)lengths1;
  const int scup = ((int)coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079) return false;
  const int stride = width;
  uint32_t* dec = reinterpret_cast<uint32_t*>(t1.data.data());
  std::vector<uint32_t> flags(132 * 4 + 132, 0);
  uint32_t* sigma1 = flags.data();
  uint32_t* sigma2 = sigma1 + 132;
  uint32_t* mbr1 = sigma2 + 132;
  uint32_t* mbr2 = mbr1 + 132;
  uint8_t* line_state = reinterpret_cast<uint8_t*>(mbr2 + 132);
  const bool stripe_causal = (cblksty & kVsc) != 0;

  HtMel mel;
  if (!mel.init(coded, lcup, scup, align)) return false;  // "Incorrect MEL segment sequence"
  HtRev vlc, magref;
  vlc.init_vlc(coded, lcup, scup);
  HtFrwd magsgn, sigprop;
  magsgn.init(coded, lcup - scup, 0xFF);
  if (num_passes > 1) sigprop.init(coded + lengths1, (int)lengths2, 0);
  if (num_passes > 2) magref.init_mrp(coded, (int)lengths1, (int)lengths2);

  // the rows of quads, two rows of samples each; SigProp and MagRef follow
  // a stripe behind. The first row takes table 0, the initial u code and
  // no line state above it (all zeros, so the context and kappa come out
  // as the first row's).
  uint32_t sip_shift = 2;
  const uint32_t zero_bplanes_p1 = zero_bplanes + 1;
  int run = mel.get_run();
  for (int y = 0; y < height;) {
    const bool initial = y == 0;
    const uint16_t* table = initial ? kVlcTbl0 : kVlcTbl1;
    sip_shift ^= 0x2;
    sip_shift &= 0xFFFFFFEFu;
    uint32_t* sip = y & 0x4 ? sigma2 : sigma1;
    uint8_t* lsp = line_state;
    uint8_t ls0 = lsp[0];
    lsp[0] = 0;
    uint32_t* sp = dec + (size_t)y * stride;
    uint32_t c_q = 0;
    for (int x = 0; x < width; x += 4) {
      uint32_t qinf[2], U_q[2];
      c_q |= ls0 >> 7;
      c_q |= (lsp[1] >> 5) & 0x4;
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = table[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {  // a MEL event says whether the quad is significant
        run -= 2;
        qinf[0] = run == -1 ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = initial ? ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5)
                    : ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(qinf[0] & 0x7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
      qinf[1] = 0;
      if (x + 2 < width) {
        c_q |= lsp[1] >> 7;
        c_q |= (lsp[2] >> 5) & 0x4;
        qinf[1] = table[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = run == -1 ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = initial ? ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5)
                      : ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[1] & 0x7);
      }
      *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
      sip += x & 0x7 ? 1 : 0;
      sip_shift ^= 0x10;
      uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      if (initial && uvlc_mode == 3) {
        run -= 2;
        uvlc_mode += run == -1 ? 1 : 0;
        if (run < 0) run = mel.get_run();
      }
      vlc.advance(decode_uvlc(vlc_val, uvlc_mode, initial, U_q));
      // kappa from the row above (E^max less 1) where more than one sample
      // of the quad is significant
      if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
        uint32_t E = ls0 & 0x7Fu;
        E = E > (lsp[1] & 0x7Fu) ? E : (lsp[1] & 0x7Fu);
        U_q[0] += E > 2 ? E - 2 : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        uint32_t E = lsp[1] & 0x7Fu;
        E = E > (lsp[2] & 0x7Fu) ? E : (lsp[2] & 0x7Fu);
        U_q[1] += E > 2 ? E - 2 : 0;
      }
      if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1) return false;  // "U_q is larger ..."
      ls0 = lsp[2];
      lsp[1] = lsp[2] = 0;
      uint32_t locs = 0xFF;
      if (x + 4 > width) locs >>= (x + 4 - width) << 1;
      locs = y + 2 <= height ? locs : (locs & 0x55);
      if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs) return false;  // outside the block
      for (int q = 0; q < 2; ++q) {  // the samples, MagSgn in their order; the line state
        const uint32_t qi = qinf[q], U = U_q[q], lb = q * 4;
        if (qi & 0x10) ht_sample(magsgn, U, (qi >> 12) & 1, (qi >> 8) & 1, p, &sp[0]);
        else if (locs & (1u << lb)) sp[0] = 0;
        if (qi & 0x20) {
          const uint32_t v_n = ht_sample(magsgn, U, (qi >> 13) & 1, (qi >> 9) & 1, p, &sp[stride]);
          const uint32_t t = lsp[0] & 0x7F, e = bitlen32(v_n);
          lsp[0] = (uint8_t)(0x80 | (t > e ? t : e));
        } else if (locs & (2u << lb)) {
          sp[stride] = 0;
        }
        ++lsp;
        ++sp;
        if (qi & 0x40) ht_sample(magsgn, U, (qi >> 14) & 1, (qi >> 10) & 1, p, &sp[0]);
        else if (locs & (4u << lb)) sp[0] = 0;
        lsp[0] = 0;
        if (qi & 0x80) {
          const uint32_t v_n = ht_sample(magsgn, U, (qi >> 15) & 1, (qi >> 11) & 1, p, &sp[stride]);
          lsp[0] = (uint8_t)(0x80 | bitlen32(v_n));
        } else if (locs & (8u << lb)) {
          sp[stride] = 0;
        }
        ++sp;
      }
    }
    y += 2;
    if (num_passes > 1 && (y & 3) == 0) {
      if (num_passes > 2) ht_magref_stripe(dec + (size_t)(y - 4) * stride, width, stride, p,
                                           y & 0x4 ? sigma1 : sigma2, magref);
      if (y >= 4) ht_stripe_mbr(y & 0x4 ? sigma1 : sigma2, y & 0x4 ? mbr1 : mbr2, width);
      if (y >= 8) {
        uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
        uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
        uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
        uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
        ht_stripe_mbr_below(cur_sig, cur_mbr, nxt_sig, width, stripe_causal);
        ht_sigprop_stripe(dec, width, stride, y - 8, p, 0xFFFFFFFFu, cur_sig, cur_mbr, nxt_sig,
                          nxt_mbr, sigprop);
        std::memset(cur_sig, 0, ((((uint32_t)width + 7u) >> 3) + 1u) << 2);
      }
    }
  }

  // the last stripes' refinement
  if (num_passes > 1) {
    if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2))
      ht_magref_stripe(dec + (size_t)(height & 0xFFFFFC) * stride, width, stride, p,
                       height & 0x4 ? sigma2 : sigma1, magref);
    if ((height & 3) == 1 || (height & 3) == 2)
      ht_stripe_mbr(height & 0x4 ? sigma2 : sigma1, height & 0x4 ? mbr2 : mbr1, width);
    int st = height;
    st -= height > 6 ? (((height + 1) & 3) + 3) : height;
    for (int y = st; y < height; y += 4) {
      uint32_t pattern = 0xFFFFFFFFu;
      if (height - y == 3) pattern = 0x77777777u;
      else if (height - y == 2) pattern = 0x33333333u;
      else if (height - y == 1) pattern = 0x11111111u;
      uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
      uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
      uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
      uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
      if (height - y > 4) ht_stripe_mbr_below(cur_sig, cur_mbr, nxt_sig, width, stripe_causal);
      ht_sigprop_stripe(dec, width, stride, y, p, pattern, cur_sig, cur_mbr, nxt_sig, nxt_mbr, sigprop);
    }
  }

  // sign and magnitude to two's complement
  for (int i = 0; i < width * height; ++i) {
    const int32_t v = (int32_t)(dec[i] & 0x7FFFFFFFu);
    dec[i] = (dec[i] & 0x80000000u) ? (uint32_t)-v : (uint32_t)v;
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
          c.Mb = (uint32_t)b.numbps;
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
          if (tc.cblksty & kHt)  // the cleanup pass alone, then the rest in one segment
            s.numnewpasses = segno == 0 ? 1u : (uint32_t)n;
          else
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
// samples packed, and dims its width and height. Returns 0, or -1 where
// OpenJPEG fails ("broken data stream" in Pillow).
int64_t gatling_j2k_decode_tile(const int32_t* hdr, uint8_t* data, int64_t n, const uint8_t* ext,
                                int64_t ext_n, int64_t* ext_pos, int32_t* resno_decoded,
                                int32_t* const* out, int32_t* dims) {
  Tile t;
  t.hdr = hdr;
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
            const bool ok = (tc.cblksty & kHt) ? ht_decode_cblk(t1, cb, data, tc.roishift, tc.cblksty)
                                               : decode_cblk(t1, cb, data, b.bandno, tc.roishift, tc.cblksty);
            if (!ok) return -1;
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
