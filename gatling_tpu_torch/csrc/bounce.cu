// Fused path-tracing bounce for NVIDIA Hopper (sm_90a): two kernels.
//
// K1 `bounce_kernel` replaces the JAX package's TPU kernel
// ops/pallas_bounce.py `bounce_step` -> `_bounce_kernel` / `_bounce_body` /
// `_shade_core` / `_sample_lights_fused`, resident branch (the whole
// triangle table of a scene of at most 4096 triangles). K2 `walk_kernel`
// replaces its clustered and instanced branch: the closest-hit walk
// `_trace_clustered_matrix` and the any-hit shadow walk
// `_trace_clustered_occluded`, with their XLA walk plan
// `_cluster_walk_plan`. Both run with cutout, volumes, scattering, advanced
// lobes and tangent rows off, and share the shading code. Their plain
// PyTorch twin is ops/bounce_ref.py; all compute the same float operations
// in the same order, so with -fmad=false they agree to the last bit except
// where the math library's cos/sin/log differ.
//
// K1. One thread per ray; ray state row k of ray i lives at
// state[k*R + i], so every row access coalesces. The TPU kernel tested a
// 2048-ray block against one triangle at a time out of SMEM; here every
// thread walks the whole triangle table, which is staged through shared
// memory in 128-triangle tiles (16 KB) with coalesced float4 loads
// (a 4096-triangle table is 512 KB: more than shared memory or the 64 KB
// constant bank, so it stays in global memory behind L2). Materials, lights
// and the light-type list are staged in shared memory once per block.
// A block whose rays are all dead returns at once; a dead ray inside a live
// block only helps load tiles (the TPU kernel's per-block early-out, at ray
// granularity). The NEE shadow loop stops as soon as no ray of the block
// still needs an answer. At the Cornell box's ~30 triangles it is bound by
// the state traffic (16 floats read and written per ray) and the shading
// math.
//
// K2. The TPU walked level-1 entries near to far per 1024-ray block, in an
// order an XLA prelude sorted, and intersected whole clusters with bf16
// hi/lo matrix products. Here each thread walks its own ray down a binary
// BVH over the entry boxes (the TLAS, ops/bounce.py build_tlas), nearer
// child first, pruning boxes beyond its best hit; at an entry it tests the
// fan's cluster boxes and then a surviving cluster's 128 triangles, read
// as float4 quads from the triangle-major [C * 128, 40] table in global
// memory (L1 and L2 cache it: the instanced sphere_field's unique clusters
// are a few hundred KB, its flattened table 47 MB). Instanced entries carry
// the world->local transform: the ray enters the entry's frame, where t
// is the same parameter. The winner is selected in f32 with the TPU's
// pass-1 formulas and recomputed with its pass-2 division form; ties on t
// go to the lower global triangle index, so the result does not depend on
// the traversal order. What bounds it: the per-ray serial triangle tests
// (about 30 flops each, a few hundred to a few thousand a ray) and the
// divergence of rays of one warp that walk different clusters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TRI_ROWS = 32;
constexpr int MAT_COLS = 30;
constexpr int LIGHT_COLS = 20;
constexpr int TILE = 128;     // triangles per shared-memory tile
constexpr int THREADS = 128;  // rays per block

// Constants rounded from double as the JAX kernel rounds its Python floats.
#define C(x) static_cast<float>(x)
constexpr double PI_D = 3.14159265358979;
constexpr float FMAX = 3.402823466e38f;
constexpr float BARY_LO = -1e-6f;
constexpr float BARY_HI = 1.0f + 1e-6f;  // f32(1) + f32(1e-6), in f32

// state rows
enum { S_OX = 0, S_DX = 3, S_TP = 6, S_RAD = 9, S_RNG = 12, S_ALIVE = 13,
       S_MISS = 14, S_SEG = 15 };
// triangle columns
enum { TR_N = 0, TR_D0 = 3, TR_R1 = 4, TR_R2 = 8, TR_GN = 12, TR_N0 = 15,
       TR_N1 = 18, TR_N2 = 21, TR_MAT = 24, TR_DS = 25 };
// params
enum { P_BG_R = 0, P_RR_INV_MIN = 3, P_RR_OFFSET = 4, P_BOUNCE = 5,
       P_EXP2_EXPOSURE = 6, P_TMIN = 7, P_LIGHT_MULT = 8, PARAMS_LEN = 11 };
enum { LT_SPHERE = 0, LT_DISTANT = 1, LT_RECT = 2, LT_DISK = 3 };
constexpr double SHADOW_TMIN = 0.01;  // reference: rgen:397-438 shadow ray tMin

// clustered tables (ops/bounce_ref.py CLU_*, INST_*)
constexpr int CLUSTER_SIZE = 128;  // triangles per cluster
constexpr int L1_FAN = 16;         // clusters per level-1 entry
constexpr int CLU_ROWS = 40;
enum { CLU_N = 0, CLU_GN = 4, CLU_MAT = 7, CLU_R1 = 8, CLU_N0 = 12, CLU_DS = 15,
       CLU_R2 = 16, CLU_N1 = 20, CLU_N2 = 24 };
enum { INST_AT = 9, INST_MAT = 12, INST_DS = 15, INST_COLS = 16 };
constexpr int STACK = 64;  // TLAS traversal stack (ops/bounce.py TLAS_MAX_DEPTH)

__device__ __forceinline__ float pcg_next(uint32_t& s) {
  const uint32_t ns = s * 747796405u + 2891336453u;
  const uint32_t shift = (ns >> 28) + 4u;
  uint32_t word = ((ns >> shift) ^ ns) * 277803737u;
  word = (word >> 22) ^ word;
  s = ns;
  return __uint_as_float(0x3F800000u | (word >> 9)) - 1.0f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Baldwin-Weber plane + barycentric test of one triangle (row pointer tr).
__device__ __forceinline__ bool tri_hit(const float* tr, float ox, float oy,
                                        float oz, float dx, float dy, float dz,
                                        float tmin, float& tt, float& u,
                                        float& v) {
  const float nx = tr[TR_N], ny = tr[TR_N + 1], nz = tr[TR_N + 2];
  const float ndotd = nx * dx + ny * dy + nz * dz;
  bool ok = fabsf(ndotd) > C(1e-12);
  const float inv = ok ? 1.0f / ndotd : 0.0f;
  tt = -(nx * ox + ny * oy + nz * oz + tr[TR_D0]) * inv;
  const float px = ox + tt * dx;
  const float py = oy + tt * dy;
  const float pz = oz + tt * dz;
  u = tr[TR_R1] * px + tr[TR_R1 + 1] * py + tr[TR_R1 + 2] * pz + tr[TR_R1 + 3];
  v = tr[TR_R2] * px + tr[TR_R2 + 1] * py + tr[TR_R2 + 2] * pz + tr[TR_R2 + 3];
  return ok && (u >= BARY_LO) && (v >= BARY_LO) && (u + v <= BARY_HI) &&
         (tt > tmin);
}

// Copy triangles [base, base+cnt) of the table into the shared tile.
__device__ __forceinline__ void load_tile(float* s_tri, const float* tris,
                                          int base, int cnt) {
  const float4* src = reinterpret_cast<const float4*>(tris + (size_t)base * TRI_ROWS);
  float4* dst = reinterpret_cast<float4*>(s_tri);
  for (int k = threadIdx.x; k < cnt * (TRI_ROWS / 4); k += blockDim.x)
    dst[k] = src[k];
}

// Diffuse + glossy reflection lobes at local wi (render/bsdf.py _eval_lobes).
struct Lobes {
  float fd[3], fg[3], pdf;
};

struct Surface {
  float wox, woy, woz;
  float base[3], f0[3];
  float metallic, transm, alpha2, p_d, p_g;
};

__device__ __forceinline__ Lobes eval_lobes(const Surface& s, float wix,
                                            float wiy, float wiz) {
  Lobes l;
  const bool refl = (s.woz > 0.0f) && (wiz > 0.0f);
  const float cos_i_c = fmaxf(wiz, 0.0f);
  float hxs = s.wox + wix;
  float hys = s.woy + wiy;
  float hzs = s.woz + wiz;
  const float hinv = 1.0f / sqrtf(fmaxf(hxs * hxs + hys * hys + hzs * hzs, C(1e-24)));
  hxs = hxs * hinv;
  hys = hys * hinv;
  hzs = hzs * hinv;
  const float nh = fabsf(hzs);
  const float oh = fmaxf(s.wox * hxs + s.woy * hys + s.woz * hzs, C(1e-6));
  const float nvo = fmaxf(s.woz, C(1e-6));
  const float nvi = fmaxf(cos_i_c, C(1e-6));
  const float a2 = s.alpha2;
  const float dd = nh * nh * (a2 - 1.0f) + 1.0f;
  const float ggx_d = a2 / fmaxf(C(PI_D) * dd * dd, C(1e-12));
  const float g1o = 2.0f * nvo / (nvo + sqrtf(a2 + (1.0f - a2) * nvo * nvo));
  const float g1i = 2.0f * nvi / (nvi + sqrtf(a2 + (1.0f - a2) * nvi * nvi));
  const float gg = g1o * g1i;
  const float mfres = clampf(1.0f - oh, 0.0f, 1.0f);
  const float fres5 = (mfres * mfres) * (mfres * mfres) * mfres;
  const float spec_core = ggx_d * gg / fmaxf(4.0f * s.woz * cos_i_c, C(1e-9)) * cos_i_c;
  const float diff_core = (1.0f - s.metallic) * (1.0f - s.transm) * cos_i_c / C(PI_D);
  for (int c = 0; c < 3; ++c) {
    l.fd[c] = refl ? s.base[c] * diff_core : 0.0f;
    l.fg[c] = refl ? (s.f0[c] + (1.0f - s.f0[c]) * fres5) * spec_core : 0.0f;
  }
  const float pdf = s.p_d * cos_i_c / C(PI_D) +
                    s.p_g * ggx_d * nh / fmaxf(4.0f * oh, C(1e-9));
  l.pdf = refl ? pdf : 0.0f;
  return l;
}

struct LightSample {
  float dx, dy, dz, dist, pw[3], ipdf, ds0, ds1;
};

// Light sampling (rp_main.chit sampleLight:30-129): type chosen by k0
// against the cumulative type counts, slot within the type by k1; slots are
// type-major. A type with no slot (k0 == 0 with no spheres) samples nothing.
__device__ LightSample sample_light(const float* s_light, const int* s_ltype,
                                    int n_lights, float k0, float k1, float k2,
                                    float k3, float posx, float posy,
                                    float posz) {
  LightSample ls = {0.f, 0.f, 0.f, 0.f, {0.f, 0.f, 0.f}, 0.f, 0.f, 0.f};
  int counts[4] = {0, 0, 0, 0};
  for (int l = 0; l < n_lights; ++l) counts[s_ltype[l]]++;
  const float total = (float)n_lights;
  const float cs = (float)counts[0], cd = (float)counts[1], cr = (float)counts[2];
  const float pick = k0 * total;
  int t;
  if (pick <= cs) t = LT_SPHERE;
  else if (pick <= cs + cd) t = LT_DISTANT;
  else if (pick <= cs + cd + cr) t = LT_RECT;
  else t = LT_DISK;
  const int c = counts[t];
  if (c == 0) return ls;
  int start = 0;
  for (int k = 0; k < t; ++k) start += counts[k];
  const int j = c > 1 ? min((int)(k1 * (float)c), c - 1) : 0;
  const float* g = s_light + (start + j) * LIGHT_COLS;

  float sdx, sdy, sdz, dist, s_ipdf;
  if (t == LT_SPHERE) {
    const float a_s = 1.0f - 2.0f * k2;
    const float b_s = sqrtf(fmaxf(0.0f, 1.0f - a_s * a_s));
    const float phi = C(2.0 * PI_D) * k3;
    const float lx = b_s * cosf(phi) * g[3];
    const float ly = b_s * sinf(phi) * g[4];
    const float lz = a_s * g[5];
    const float vx = g[0] + lx - posx;
    const float vy = g[1] + ly - posy;
    const float vz = g[2] + lz - posz;
    dist = sqrtf(vx * vx + vy * vy + vz * vz);
    const float inv_d = dist > 0.0f ? 1.0f / fmaxf(dist, C(1e-30)) : 0.0f;
    sdx = vx * inv_d;
    sdy = vy * inv_d;
    sdz = vz * inv_d;
    const float nl = sqrtf(lx * lx + ly * ly + lz * lz);
    const float inv_nl = nl > 0.0f ? 1.0f / fmaxf(nl, C(1e-30)) : 0.0f;
    const float cosl = fmaxf(0.0f, -(sdx * lx + sdy * ly + sdz * lz) * inv_nl);
    const float area = g[9];
    const float num = area > 0.0f ? area * cosl : 1.0f;
    const float d2 = dist * dist;
    s_ipdf = d2 > 0.0f ? num / fmaxf(d2, C(1e-30)) : 0.0f;
  } else if (t == LT_DISTANT) {
    const float phi = k2 * 2.0f * C(PI_D) - C(PI_D);
    const float theta = k3 * g[9];
    const float st = sinf(theta), ct = cosf(theta);
    const float cp = cosf(phi), sp = sinf(phi);
    const float px = st * (cp * g[3] + sp * g[6]) + ct * g[0];
    const float py = st * (cp * g[4] + sp * g[7]) + ct * g[1];
    const float pz = st * (cp * g[5] + sp * g[8]) + ct * g[2];
    const float pinv = 1.0f / sqrtf(fmaxf(px * px + py * py + pz * pz, C(1e-40)));
    if (g[9] > 0.0f) {
      sdx = px * pinv;
      sdy = py * pinv;
      sdz = pz * pinv;
    } else {
      sdx = g[0];
      sdy = g[1];
      sdz = g[2];
    }
    dist = 100000.0f;
    s_ipdf = g[10];
  } else {
    float on0, on1, area;
    if (t == LT_RECT) {
      on0 = (k2 - 0.5f) * g[9];
      on1 = (k3 - 0.5f) * g[10];
      area = g[9] * g[10];
    } else {
      const float a = 2.0f * k2 - 1.0f;
      const float b = 2.0f * k3 - 1.0f;
      const bool use_a = (a * a) > (b * b);
      const float r0 = use_a ? g[9] * a : g[9] * b;
      const float r1 = use_a ? g[10] * a : g[10] * b;
      const float ba = a == 0.0f ? 0.0f : b / a;
      const float ab = b == 0.0f ? 0.0f : a / b;
      const float phi = use_a ? C(PI_D / 4.0) * ba : C(PI_D / 2.0) - C(PI_D / 4.0) * ab;
      on0 = r0 * cosf(phi);
      on1 = r1 * sinf(phi);
      area = g[9] * g[10] * C(PI_D);
    }
    const float sx = g[0] + on0 * g[3] + on1 * g[6];
    const float sy = g[1] + on0 * g[4] + on1 * g[7];
    const float sz = g[2] + on0 * g[5] + on1 * g[8];
    const float vx = sx - posx, vy = sy - posy, vz = sz - posz;
    dist = sqrtf(vx * vx + vy * vy + vz * vz);
    const float inv_d = dist > 0.0f ? 1.0f / fmaxf(dist, C(1e-30)) : 0.0f;
    sdx = vx * inv_d;
    sdy = vy * inv_d;
    sdz = vz * inv_d;
    const float cosl = fmaxf(0.0f, -(sdx * g[11] + sdy * g[12] + sdz * g[13]));
    const float num = area > 0.0f ? area * cosl : 1.0f;
    const float d2 = dist * dist;
    s_ipdf = d2 > 0.0f ? num / fmaxf(d2, C(1e-30)) : 0.0f;
  }
  ls.dx = sdx;
  ls.dy = sdy;
  ls.dz = sdz;
  ls.dist = dist;
  ls.pw[0] = g[14];
  ls.pw[1] = g[15];
  ls.pw[2] = g[16];
  ls.ipdf = s_ipdf;
  ls.ds0 = g[17];
  ls.ds1 = g[18];
  return ls;
}

// ---------------------------------------------------------------------------
// shading, shared by K1 and K2
// ---------------------------------------------------------------------------

// One ray's path state through a bounce.
struct Ray {
  float o[3], d[3], tp[3], rad[3], miss_rec;
  uint32_t rng;
  bool hit, miss, valid, do_trace;
  float ld[3], ldist, cnee[3];  // NEE: light direction, distance, contribution
};

// The closest hit: its t, barycentrics, geometric normal, interpolated
// (unnormalised) shading normal, material row and double-sided flag.
struct Surf {
  float t, u, v, gn[3], nrm[3], mat_f, dsided;
};

__device__ __forceinline__ void load_path(Ray& r, const float* state, long long R,
                                          long long i) {
  for (int c = 0; c < 3; ++c) {
    r.tp[c] = state[(S_TP + c) * R + i];
    r.rad[c] = state[(S_RAD + c) * R + i];
  }
  r.rng = __float_as_uint(state[S_RNG * R + i]);
  r.miss_rec = state[S_MISS * R + i];
}

// Miss background, emission, BSDF sampling, the new ray and the NEE light
// sample of an alive ray whose closest hit (r.hit, sf) is known.
template <bool NEE>
__device__ __forceinline__ void shade(const float* p, const float* s_mat, int n_mats,
                                      const float* s_light, const int* s_ltype,
                                      int n_lights, const Surf& sf, Ray& r) {
  const float bounce = p[P_BOUNCE];
  r.miss = !r.hit;

  // ---- miss: constant background; no dome (not ported) ----
  if (r.miss) {
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.tp[c] * p[P_BG_R + c];
    r.miss_rec = bounce + 1.0f;
  }
  if (!r.hit) return;

  // ---- shading state ----
  const float posx = r.o[0] + sf.t * r.d[0];
  const float posy = r.o[1] + sf.t * r.d[1];
  const float posz = r.o[2] + sf.t * r.d[2];
  const float* nrm = sf.nrm;
  const float* gn = sf.gn;
  const float nlen = 1.0f / sqrtf(fmaxf(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2], C(1e-20)));
  float nx = nrm[0] * nlen, ny = nrm[1] * nlen, nz = nrm[2] * nlen;
  const bool front = (gn[0] * -r.d[0] + gn[1] * -r.d[1] + gn[2] * -r.d[2]) >= 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  const float gnx = gn[0] * fsign, gny = gn[1] * fsign, gnz = gn[2] * fsign;
  nx = nx * fsign;
  ny = ny * fsign;
  nz = nz * fsign;

  // ---- material row (ids outside the table resolve to zeros) ----
  const int m_id = (int)rintf(sf.mat_f);
  const bool m_ok = m_id >= 0 && m_id < n_mats;
  const float* m = s_mat + (m_ok ? m_id : 0) * MAT_COLS;
#define MAT(col) (m_ok ? m[col] : 0.0f)
  Surface s;
  s.base[0] = MAT(0);
  s.base[1] = MAT(1);
  s.base[2] = MAT(2);
  s.metallic = MAT(3);
  const float roughness = MAT(4), ior = MAT(5);
  const float em[3] = {MAT(7), MAT(8), MAT(9)};
  s.transm = MAT(14);
  const float thinw = MAT(15), bf_edf = MAT(24);
#undef MAT

  // ---- emission (rp_main.chit:304-315) ----
  if (front || sf.dsided <= 0.5f || (thinw > 0.5f && bf_edf > 0.5f)) {
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.tp[c] * em[c] * p[P_EXP2_EXPOSURE];
  }

  // ---- BSDF sample draws ----
  const float xi0 = pcg_next(r.rng);
  const float xi1 = pcg_next(r.rng);
  const float xi2 = pcg_next(r.rng);
  pcg_next(r.rng);  // xi3: drawn for the reference's order, unused here

  // ---- Duff ONB around the shading normal ----
  const float nsign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a_onb = -1.0f / (nsign + nz);
  const float b_onb = nx * ny * a_onb;
  const float t1x = 1.0f + nsign * nx * nx * a_onb;
  const float t1y = nsign * b_onb;
  const float t1z = -nsign * nx;
  const float t2x = b_onb;
  const float t2y = nsign + ny * ny * a_onb;
  const float t2z = -ny;
  const float* d = r.d;
  s.wox = -(d[0] * t1x + d[1] * t1y + d[2] * t1z);
  s.woy = -(d[0] * t2x + d[1] * t2y + d[2] * t2z);
  s.woz = -(d[0] * nx + d[1] * ny + d[2] * nz);

  // ---- lobe weights (render/bsdf.py _lobe_weights) ----
  const float f0q = (ior - 1.0f) / (ior + 1.0f);
  const float f0d = f0q * f0q;
  for (int c = 0; c < 3; ++c)
    s.f0[c] = f0d * (1.0f - s.metallic) + s.base[c] * s.metallic;
  const float lum_base = C(0.2126) * s.base[0] + C(0.7152) * s.base[1] + C(0.0722) * s.base[2];
  const float lum_f0 = C(0.2126) * s.f0[0] + C(0.7152) * s.f0[1] + C(0.0722) * s.f0[2];
  const float w_d = lum_base * (1.0f - s.metallic) * (1.0f - s.transm);
  const float w_g = lum_f0 > 0.0f ? fmaxf(lum_f0, C(0.04)) : 0.0f;
  const float w_t = s.transm;
  const float w_sum = fmaxf(w_d + w_g + w_t, C(1e-20));
  s.p_d = w_d / w_sum;
  s.p_g = w_g / w_sum;
  const float p_t = w_t / w_sum;
  const bool pick_d = xi0 < s.p_d;
  const bool pick_g = !pick_d && (xi0 < s.p_d + s.p_g);
  const bool pick_t = !pick_d && !pick_g;

  const float alpha = fmaxf(roughness * roughness, C(1e-3));
  s.alpha2 = alpha * alpha;

  float wix, wiy, wiz;
  if (pick_t) {
    wix = -s.wox;
    wiy = -s.woy;
    wiz = -s.woz;
  } else {
    const float phi_d = C(2.0 * PI_D) * xi2;
    const float cphi = cosf(phi_d), sphi = sinf(phi_d);
    if (pick_d) {  // diffuse: cosine hemisphere
      const float ra = sqrtf(clampf(xi1, 0.0f, 1.0f));
      wix = ra * cphi;
      wiy = ra * sphi;
      wiz = sqrtf(fmaxf(0.0f, 1.0f - xi1));
    } else {  // glossy: GGX NDF half-vector sample + reflect
      const float c2h = (1.0f - xi1) / fmaxf(1.0f + (s.alpha2 - 1.0f) * xi1, C(1e-12));
      const float ch = sqrtf(clampf(c2h, 0.0f, 1.0f));
      const float sh = sqrtf(fmaxf(0.0f, 1.0f - c2h));
      const float hx = sh * cphi, hy = sh * sphi, hz = ch;
      const float odoth = s.wox * hx + s.woy * hy + s.woz * hz;
      wix = 2.0f * odoth * hx - s.wox;
      wiy = 2.0f * odoth * hy - s.woy;
      wiz = 2.0f * odoth * hz - s.woz;
    }
  }

  const Lobes lb = eval_lobes(s, wix, wiy, wiz);
  const float inv_pdf = lb.pdf > C(1e-12) ? 1.0f / fmaxf(lb.pdf, C(1e-12)) : 0.0f;
  float bop[3];
  if (pick_t) {  // thin transmission, Fresnel-weighted (render/bsdf.py)
    const float mtr = clampf(1.0f - fmaxf(s.woz, 0.0f), 0.0f, 1.0f);
    const float tr5 = (mtr * mtr) * (mtr * mtr) * mtr;
    const float inv_pt = p_t > C(1e-12) ? 1.0f / fmaxf(p_t, C(1e-12)) : 0.0f;
    for (int c = 0; c < 3; ++c)
      bop[c] = s.transm * (1.0f - (s.f0[c] + (1.0f - s.f0[c]) * tr5)) * inv_pt;
    r.valid = p_t > 0.0f;
  } else {
    for (int c = 0; c < 3; ++c) bop[c] = (lb.fd[c] + lb.fg[c]) * inv_pdf;
    r.valid = lb.pdf > C(1e-12) && wiz > 0.0f && s.woz > 0.0f;
  }
  for (int c = 0; c < 3; ++c) r.tp[c] = r.tp[c] * (r.valid ? bop[c] : 0.0f);

  // new origin, offset along the signed geometric normal; world wi
  const float osign = pick_t ? -1.0f : 1.0f;
  const float pos[3] = {posx, posy, posz};
  const float gns[3] = {gnx, gny, gnz};
  for (int c = 0; c < 3; ++c)
    r.o[c] = pos[c] + gns[c] * osign * fmaxf(fabsf(pos[c]) * C(1.0 / 65536.0), C(1.0 / 65536.0));
  r.d[0] = wix * t1x + wiy * t2x + wiz * nx;
  r.d[1] = wix * t1y + wiy * t2y + wiz * ny;
  r.d[2] = wix * t1z + wiy * t2z + wiz * nz;

  // ---- NEE (rp_main.chit sampleLight:30-129 + rgen:397-438) ----
  if (NEE && r.valid && !pick_t) {
    uint32_t r2 = r.rng;
    const float k0 = pcg_next(r2);
    const float k1 = pcg_next(r2);
    const float k2 = pcg_next(r2);
    const float k3 = pcg_next(r2);
    r.rng = r2;
    if (n_lights > 0) {
      const LightSample ls = sample_light(s_light, s_ltype, n_lights, k0, k1, k2, k3, posx,
                                          posy, posz);
      const float pw_scale = p[P_LIGHT_MULT] * p[P_EXP2_EXPOSURE];
      const float ipdf_l = ls.ipdf * (float)n_lights;
      const float lwx = ls.dx * t1x + ls.dy * t1y + ls.dz * t1z;
      const float lwy = ls.dx * t2x + ls.dy * t2y + ls.dz * t2z;
      const float lwz = ls.dx * nx + ls.dy * ny + ls.dz * nz;
      const Lobes el = eval_lobes(s, lwx, lwy, lwz);
      const float gdot = ls.dx * gnx + ls.dy * gny + ls.dz * gnz;
      const bool nee_valid = ls.dist > 0.0f && gdot > 0.0f && el.pdf > 0.0f;
      // reference quirk: the throughput already includes this bounce's
      // bsdf_over_pdf (rp_main.chit:360-389 then :393-444)
      for (int c = 0; c < 3; ++c)
        r.cnee[c] = nee_valid ? r.tp[c] * (ls.pw[c] * pw_scale) * ipdf_l *
                                    (el.fd[c] * ls.ds0 + el.fg[c] * ls.ds1)
                              : 0.0f;
      const float lum_c = C(0.2126) * r.cnee[0] + C(0.7152) * r.cnee[1] + C(0.0722) * r.cnee[2];
      r.do_trace = lum_c > C(1e-6) && ls.dist > C(1e-9);
      r.ld[0] = ls.dx;
      r.ld[1] = ls.dy;
      r.ld[2] = ls.dz;
      r.ldist = ls.dist;
    }
  }
}

// NEE contribution, termination (miss, absorb, throughput cutoff, russian
// roulette) and the write-back of an alive ray.
__device__ __forceinline__ void finish(const float* p, Ray& r, bool occ, float* state,
                                       long long R, long long i) {
  if (r.do_trace && !occ)
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.cnee[c];

  bool terminate = r.miss || (r.hit && !r.valid);
  terminate = terminate || (r.tp[0] * r.tp[0] + r.tp[1] * r.tp[1] + r.tp[2] * r.tp[2] < C(1e-18));
  if (p[P_BOUNCE] > p[P_RR_OFFSET]) {
    const float krr = pcg_next(r.rng);
    const float p_rr = fminf(fmaxf(r.tp[0], fmaxf(r.tp[1], r.tp[2])), p[P_RR_INV_MIN]);
    const bool rr_kill = krr > p_rr;
    // the !miss guard keeps the throughput rows at their at-miss value
    if (!rr_kill && !r.miss) {
      const float sc = 1.0f / fmaxf(p_rr, C(1e-20));
      for (int c = 0; c < 3; ++c) r.tp[c] = r.tp[c] * sc;
    }
    terminate = terminate || rr_kill;
  }

  for (int c = 0; c < 3; ++c) {
    state[(S_OX + c) * R + i] = r.o[c];
    state[(S_DX + c) * R + i] = r.d[c];
    state[(S_TP + c) * R + i] = r.tp[c];
    state[(S_RAD + c) * R + i] = r.rad[c];
  }
  state[S_RNG * R + i] = __uint_as_float(r.rng);
  state[S_ALIVE * R + i] = terminate ? 0.0f : 1.0f;
  state[S_MISS * R + i] = r.miss_rec;
  state[S_SEG * R + i] = state[S_SEG * R + i] + 1.0f + (r.do_trace ? 1.0f : 0.0f);
}

__device__ __forceinline__ void stage_tables(float* s_mat, const float* mats, int n_mats,
                                             float* s_light, const float* lights,
                                             int* s_ltype, const int8_t* ltypes,
                                             int n_lights) {
  for (int k = threadIdx.x; k < n_mats * MAT_COLS; k += blockDim.x) s_mat[k] = mats[k];
  for (int k = threadIdx.x; k < n_lights * LIGHT_COLS; k += blockDim.x) s_light[k] = lights[k];
  for (int k = threadIdx.x; k < n_lights; k += blockDim.x) s_ltype[k] = ltypes[k];
}

// ---------------------------------------------------------------------------
// K1: the resident table
// ---------------------------------------------------------------------------

template <bool NEE>
__global__ void __launch_bounds__(THREADS)
bounce_kernel(const float* __restrict__ params, const float* __restrict__ tris,
              int n_tris, const float* __restrict__ mats, int n_mats,
              const float* __restrict__ lights, const int8_t* __restrict__ ltypes,
              int n_lights, float* __restrict__ state, long long R) {
  extern __shared__ float4 smem4[];
  float* s_tri = reinterpret_cast<float*>(smem4);
  float* s_mat = s_tri + TILE * TRI_ROWS;
  float* s_light = s_mat + n_mats * MAT_COLS;
  int* s_ltype = reinterpret_cast<int*>(s_light + n_lights * LIGHT_COLS);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  // dead block: every ray passes through unchanged
  if (!__syncthreads_or(alive)) return;

  stage_tables(s_mat, mats, n_mats, s_light, lights, s_ltype, ltypes, n_lights);

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);

  Ray r = {};
  if (alive) {
    for (int c = 0; c < 3; ++c) {
      r.o[c] = state[(S_OX + c) * R + i];
      r.d[c] = state[(S_DX + c) * R + i];
    }
  }

  // ---- closest hit: serial table order, strict '<' (ties keep the first) ----
  float best_t = FMAX, bu = 0.0f, bv = 0.0f;
  int win = -1;
  for (int base = 0; base < n_tris; base += TILE) {
    const int cnt = min(TILE, n_tris - base);
    __syncthreads();
    load_tile(s_tri, tris, base, cnt);
    __syncthreads();
    if (alive) {
      for (int t = 0; t < cnt; ++t) {
        float tt, u, v;
        const bool ok = tri_hit(s_tri + t * TRI_ROWS, r.o[0], r.o[1], r.o[2], r.d[0],
                                r.d[1], r.d[2], p[P_TMIN], tt, u, v);
        if (ok && tt < best_t) {
          best_t = tt;
          bu = u;
          bv = v;
          win = base + t;
        }
      }
    }
  }

  if (alive) {
    load_path(r, state, R, i);
    r.hit = best_t < FMAX;
    Surf sf = {};
    sf.t = best_t;
    sf.u = bu;
    sf.v = bv;
    if (r.hit) {
      const float* tr = tris + (size_t)win * TRI_ROWS;
      const float w = 1.0f - bu - bv;
      for (int c = 0; c < 3; ++c) {
        sf.gn[c] = __ldg(tr + TR_GN + c);
        sf.nrm[c] = w * __ldg(tr + TR_N0 + c) + bu * __ldg(tr + TR_N1 + c) +
                    bv * __ldg(tr + TR_N2 + c);
      }
      sf.mat_f = __ldg(tr + TR_MAT);
      sf.dsided = __ldg(tr + TR_DS);
    }
    shade<NEE>(p, s_mat, n_mats, s_light, s_ltype, n_lights, sf, r);
  }

  // ---- NEE shadow rays: any hit in (SHADOW_TMIN, ldist); all threads
  // help load tiles until no ray of the block needs an answer ----
  bool occ = false;
  if (NEE) {
    for (int base = 0; base < n_tris; base += TILE) {
      if (!__syncthreads_or(r.do_trace && !occ)) break;
      const int cnt = min(TILE, n_tris - base);
      load_tile(s_tri, tris, base, cnt);
      __syncthreads();
      if (r.do_trace && !occ) {
        for (int t = 0; t < cnt; ++t) {
          float tt, u, v;
          if (tri_hit(s_tri + t * TRI_ROWS, r.o[0], r.o[1], r.o[2], r.ld[0], r.ld[1],
                      r.ld[2], C(SHADOW_TMIN), tt, u, v) && tt < r.ldist) {
            occ = true;
            break;
          }
        }
      }
    }
  }

  if (!alive) return;
  finish(p, r, occ, state, R, i);
}

// ---------------------------------------------------------------------------
// K2: the two-level walk (clustered and instanced tables)
// ---------------------------------------------------------------------------

struct Walk {
  const float* tris;   // [C * 128, 40] CLU_* rows, triangle-major
  const float* l1;     // [n_l1, 8] entry world boxes (lo xyz, hi xyz, -, -)
  const float* l2;     // [n_l1 * 16, 8] fan-slot cluster world boxes
  const int* cmap;     // [n_l1 * 16] fan slot -> cluster of tris
  const float* inst;   // [n_l1, 16] world->local rows (instanced)
  const float* nodes;  // [N, 8] TLAS node boxes
  const int* kids;     // [N, 2] children, or (-1 - first, count) for a leaf
  const int* leaf;     // [n_l1] entries in leaf order
  const float* gbox;   // [8] scene box
};

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < C(1e-20) ? (d >= 0.0f ? C(1e-20) : -C(1e-20)) : d);
}

// Ray/box slab test (pallas_bounce.py _slab_test) over [tmin, tcap];
// tenter is the clipped entry distance.
__device__ __forceinline__ bool slab(const float* __restrict__ b, const float o[3],
                                     const float iv[3], float tmin, float tcap,
                                     float& tenter) {
  // box row (lo xyz, hi xyz, 0, 0): q0 = lo xyz + hi.x, q1 = hi.yz
  const float4 q0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 q1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float tx0 = (q0.x - o[0]) * iv[0], tx1 = (q0.w - o[0]) * iv[0];
  const float ty0 = (q0.y - o[1]) * iv[1], ty1 = (q1.x - o[1]) * iv[1];
  const float tz0 = (q0.z - o[2]) * iv[2], tz1 = (q1.y - o[2]) * iv[2];
  tenter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fmaxf(fminf(tz0, tz1), tmin));
  const float texit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fminf(fmaxf(tz0, tz1), tcap));
  return tenter <= texit;
}

// World ray into an instance frame: o_l = o A3 + a_t, d_l = d A3
// (A3[j, i] at a[3j + i]; pass 2's expression order).
__device__ __forceinline__ void to_local(const float* __restrict__ a, const float o[3],
                                         const float d[3], float ol[3], float dl[3]) {
  for (int c = 0; c < 3; ++c) {
    ol[c] = o[0] * __ldg(a + c) + o[1] * __ldg(a + 3 + c) + o[2] * __ldg(a + 6 + c) +
            __ldg(a + INST_AT + c);
    dl[c] = d[0] * __ldg(a + c) + d[1] * __ldg(a + 3 + c) + d[2] * __ldg(a + 6 + c);
  }
}

// Pass-1 test of one clustered triangle (pallas_bounce.py :1649-1656, in
// f32): t from the plane quad, u and v as (r.o + c) + t (r.d).
__device__ __forceinline__ bool clu_test(const float* __restrict__ tr, const float o[3],
                                         const float d[3], float tmin, float tcap,
                                         float& tt) {
  const float4 q0 = __ldg(reinterpret_cast<const float4*>(tr + CLU_N));
  const float4 q1 = __ldg(reinterpret_cast<const float4*>(tr + CLU_R1));
  const float4 q2 = __ldg(reinterpret_cast<const float4*>(tr + CLU_R2));
  const float nd = q0.x * d[0] + q0.y * d[1] + q0.z * d[2];
  const bool ok = fabsf(nd) > C(1e-12);
  const float inv = ok ? 1.0f / nd : 0.0f;
  tt = -(q0.x * o[0] + q0.y * o[1] + q0.z * o[2] + q0.w) * inv;
  const float u = (q1.x * o[0] + q1.y * o[1] + q1.z * o[2] + q1.w) +
                  tt * (q1.x * d[0] + q1.y * d[1] + q1.z * d[2]);
  const float v = (q2.x * o[0] + q2.y * o[1] + q2.z * o[2] + q2.w) +
                  tt * (q2.x * d[0] + q2.y * d[1] + q2.z * d[2]);
  return ok && (u >= BARY_LO) && (v >= BARY_LO) && (u + v <= BARY_HI) && (tt > tmin) &&
         (tt < tcap);
}

// The walk: a stack traversal of the TLAS, nearer child first; at a leaf,
// each entry's box, then its fan's non-empty cluster boxes, then the
// cluster's 128 triangles (in the entry's frame when instanced). Boxes are
// tested in world space over [tmin, run], run being tcap, or the best hit
// so far for a closest-hit walk. ANY: return true at the first valid
// triangle. Else: keep the smallest t, ties to the lower global triangle
// index (fan slot * 128 + lane), in (best, win).
template <bool INST, bool ANY>
__device__ bool walk(const Walk& w, const float o[3], const float d[3], float tmin,
                     float tcap, float& best, int& win) {
  float iv[3];
  for (int c = 0; c < 3; ++c) iv[c] = safe_inv(d[c]);
  float run = tcap;
  int stack[STACK];
  float enter[STACK];
  int sp = 0;
  stack[sp] = 0;
  enter[sp++] = tmin;
  while (sp > 0) {
    --sp;
    if (enter[sp] > run) continue;  // behind the best hit found since the push
    const int node = stack[sp];
    const int k0 = __ldg(w.kids + 2 * node), k1 = __ldg(w.kids + 2 * node + 1);
    if (k0 >= 0) {
      float ta, tb;
      const bool ha = slab(w.nodes + 8 * k0, o, iv, tmin, run, ta);
      const bool hb = slab(w.nodes + 8 * k1, o, iv, tmin, run, tb);
      if (ha && hb) {
        const bool a_first = ta <= tb;
        stack[sp] = a_first ? k1 : k0;
        enter[sp++] = a_first ? tb : ta;
        stack[sp] = a_first ? k0 : k1;
        enter[sp++] = a_first ? ta : tb;
      } else if (ha || hb) {
        stack[sp] = ha ? k0 : k1;
        enter[sp++] = ha ? ta : tb;
      }
      continue;
    }
    for (int j = 0; j < k1; ++j) {
      const int e = __ldg(w.leaf - 1 - k0 + j);
      float te;
      if (!slab(w.l1 + 8 * e, o, iv, tmin, run, te)) continue;
      float ol[3], dl[3];
      if (INST) {
        to_local(w.inst + INST_COLS * e, o, d, ol, dl);
      } else {
        for (int c = 0; c < 3; ++c) {
          ol[c] = o[c];
          dl[c] = d[c];
        }
      }
      for (int b = 0; b < L1_FAN; ++b) {
        const int slot = e * L1_FAN + b;
        const float* box = w.l2 + 8 * slot;
        if (__ldg(box) > __ldg(box + 3)) continue;  // empty: pad slot
        if (!slab(box, o, iv, tmin, run, te)) continue;
        const float* tr = w.tris + (size_t)__ldg(w.cmap + slot) * (CLUSTER_SIZE * CLU_ROWS);
        for (int lane = 0; lane < CLUSTER_SIZE; ++lane) {
          float tt;
          if (!clu_test(tr + lane * CLU_ROWS, ol, dl, tmin, tcap, tt)) continue;
          if (ANY) return true;
          const int gid = slot * CLUSTER_SIZE + lane;
          if (tt < best || (tt == best && gid < win)) {
            best = tt;
            win = gid;
          }
        }
        if (!ANY) run = fminf(tcap, best);
      }
    }
  }
  return false;
}

// Pass 2 (pallas_bounce.py :1882-1982): the winner's t, u, v recomputed in
// f32 with the division form, and its attributes; an instanced winner
// transforms its normals as covectors through A3 and takes its material
// and flag from the instance row.
template <bool INST>
__device__ __forceinline__ void pass2(const Walk& w, const float o[3], const float d[3],
                                      int win, Surf& sf) {
  const int slot = win / CLUSTER_SIZE;
  const float* tr = w.tris + ((size_t)__ldg(w.cmap + slot) * CLUSTER_SIZE +
                              win % CLUSTER_SIZE) * CLU_ROWS;
  const float* a = INST ? w.inst + INST_COLS * (slot / L1_FAN) : nullptr;
  float ol[3], dl[3];
  if (INST) {
    to_local(a, o, d, ol, dl);
  } else {
    for (int c = 0; c < 3; ++c) {
      ol[c] = o[c];
      dl[c] = d[c];
    }
  }
  const float ndw = tr[CLU_N] * dl[0] + tr[CLU_N + 1] * dl[1] + tr[CLU_N + 2] * dl[2];
  const float pw = tr[CLU_N] * ol[0] + tr[CLU_N + 1] * ol[1] + tr[CLU_N + 2] * ol[2] +
                   tr[CLU_N + 3];
  const float nd_safe = fabsf(ndw) > C(1e-20) ? ndw : (ndw >= 0.0f ? C(1e-20) : -C(1e-20));
  sf.t = -pw / nd_safe;
  const float px = ol[0] + sf.t * dl[0];
  const float py = ol[1] + sf.t * dl[1];
  const float pz = ol[2] + sf.t * dl[2];
  sf.u = tr[CLU_R1] * px + tr[CLU_R1 + 1] * py + tr[CLU_R1 + 2] * pz + tr[CLU_R1 + 3];
  sf.v = tr[CLU_R2] * px + tr[CLU_R2 + 1] * py + tr[CLU_R2 + 2] * pz + tr[CLU_R2 + 3];
  float n[3][3];
  const int rows[3] = {CLU_N0, CLU_N1, CLU_N2};
  if (INST) {
    // normals are covectors: n_w = n_l A3^T
    float g[3];
    for (int c = 0; c < 3; ++c)
      g[c] = tr[CLU_GN] * a[3 * c] + tr[CLU_GN + 1] * a[3 * c + 1] + tr[CLU_GN + 2] * a[3 * c + 2];
    const float glen = 1.0f / sqrtf(fmaxf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2], C(1e-20)));
    for (int c = 0; c < 3; ++c) sf.gn[c] = g[c] * glen;
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c)
        n[k][c] = tr[rows[k]] * a[3 * c] + tr[rows[k] + 1] * a[3 * c + 1] +
                  tr[rows[k] + 2] * a[3 * c + 2];
    sf.mat_f = a[INST_MAT];
    sf.dsided = a[INST_DS];
  } else {
    for (int c = 0; c < 3; ++c) {
      sf.gn[c] = tr[CLU_GN + c];
      for (int k = 0; k < 3; ++k) n[k][c] = tr[rows[k] + c];
    }
    sf.mat_f = tr[CLU_MAT];
    sf.dsided = tr[CLU_DS];
  }
  const float wb = 1.0f - sf.u - sf.v;
  for (int c = 0; c < 3; ++c) sf.nrm[c] = wb * n[0][c] + sf.u * n[1][c] + sf.v * n[2][c];
}

template <bool NEE, bool INST>
__global__ void __launch_bounds__(THREADS)
walk_kernel(const float* __restrict__ params, Walk w, const float* __restrict__ mats,
            int n_mats, const float* __restrict__ lights, const int8_t* __restrict__ ltypes,
            int n_lights, float* __restrict__ state, long long R) {
  extern __shared__ float4 smem4[];
  float* s_mat = reinterpret_cast<float*>(smem4);
  float* s_light = s_mat + n_mats * MAT_COLS;
  int* s_ltype = reinterpret_cast<int*>(s_light + n_lights * LIGHT_COLS);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  if (!__syncthreads_or(alive)) return;
  stage_tables(s_mat, mats, n_mats, s_light, lights, s_ltype, ltypes, n_lights);
  __syncthreads();
  if (!alive) return;  // no block-wide step follows

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);
  Ray r = {};
  for (int c = 0; c < 3; ++c) {
    r.o[c] = state[(S_OX + c) * R + i];
    r.d[c] = state[(S_DX + c) * R + i];
  }

  // closest hit below the scene box's widened slab exit (:1555-1560)
  float cap;
  {
    float ex[3];
    for (int c = 0; c < 3; ++c) {
      const float iv = safe_inv(r.d[c]);
      ex[c] = fmaxf((__ldg(w.gbox + c) - r.o[c]) * iv, (__ldg(w.gbox + 3 + c) - r.o[c]) * iv);
    }
    cap = fmaxf(fminf(fminf(ex[0], ex[1]), ex[2]), 0.0f) * C(1.0001) + C(1e-3);
  }
  float best = FMAX;
  int win = -1;
  walk<INST, false>(w, r.o, r.d, p[P_TMIN], cap, best, win);

  load_path(r, state, R, i);
  r.hit = win >= 0;
  Surf sf = {};
  sf.t = FMAX;
  if (r.hit) pass2<INST>(w, r.o, r.d, win, sf);
  shade<NEE>(p, s_mat, n_mats, s_light, s_ltype, n_lights, sf, r);

  bool occ = false;
  if (NEE && r.do_trace) {
    float unused_t = FMAX;
    int unused_win = -1;
    occ = walk<INST, true>(w, r.o, r.ld, C(SHADOW_TMIN), r.ldist, unused_t, unused_win);
  }
  finish(p, r, occ, state, R, i);
}

// Dynamic shared memory above the default 48 KB needs an opt-in.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

size_t table_smem(int n_mats, int n_lights) {
  return sizeof(float) * ((size_t)n_mats * MAT_COLS + (size_t)n_lights * LIGHT_COLS) +
         sizeof(int) * (size_t)n_lights;
}

}  // namespace

extern "C" {

const char* gatling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: one bounce over state [16, R] in place, on `stream`. Returns a
// cudaError_t code (0 = launched).
int gatling_bounce_step(const float* params, const float* tris, int n_tris,
                        const float* mats, int n_mats, const float* lights,
                        const int8_t* light_types, int n_lights, float* state,
                        long long n_rays, int nee, void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)TILE * TRI_ROWS + table_smem(n_mats, n_lights);
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (nee) {
    if ((err = allow_smem(bounce_kernel<true>, smem))) return err;
    bounce_kernel<true><<<blocks, THREADS, smem, s>>>(params, tris, n_tris, mats, n_mats,
                                                      lights, light_types, n_lights, state,
                                                      n_rays);
  } else {
    if ((err = allow_smem(bounce_kernel<false>, smem))) return err;
    bounce_kernel<false><<<blocks, THREADS, smem, s>>>(params, tris, n_tris, mats, n_mats,
                                                       lights, light_types, n_lights, state,
                                                       n_rays);
  }
  return (int)cudaGetLastError();
}

// K2: one bounce over state [16, R] in place through the two-level walk.
int gatling_bounce_walk(const float* params, const float* tris, const float* l1,
                        const float* l2, const int* cmap, const float* inst,
                        const float* nodes, const int* kids, const int* leaf_entries,
                        const float* gbox, int instanced, const float* mats, int n_mats,
                        const float* lights, const int8_t* light_types, int n_lights,
                        float* state, long long n_rays, int nee, void* stream) {
  if (n_rays <= 0) return 0;
  const Walk w = {tris, l1, l2, cmap, inst, nodes, kids, leaf_entries, gbox};
  const size_t smem = table_smem(n_mats, n_lights);
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define WALK_LAUNCH(NEE_, INST_)                                                          \
  if ((err = allow_smem(walk_kernel<NEE_, INST_>, smem))) return err;              \
  walk_kernel<NEE_, INST_><<<blocks, THREADS, smem, s>>>(params, w, mats, n_mats, lights, \
                                                         light_types, n_lights, state,    \
                                                         n_rays)
  if (nee && instanced) {
    WALK_LAUNCH(true, true);
  } else if (nee) {
    WALK_LAUNCH(true, false);
  } else if (instanced) {
    WALK_LAUNCH(false, true);
  } else {
    WALK_LAUNCH(false, false);
  }
#undef WALK_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
