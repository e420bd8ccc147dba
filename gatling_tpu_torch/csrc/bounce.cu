// Fused path-tracing bounce for NVIDIA Hopper (sm_90a): four kernels.
//
// K1 `bounce_kernel` replaces the JAX package's TPU kernel
// ops/pallas_bounce.py `bounce_step` -> `_bounce_kernel` / `_bounce_body` /
// `_shade_core` / `_sample_lights_fused`, resident branch (the whole
// triangle table of a scene of at most 4096 triangles). K2 `walk_kernel`
// replaces its clustered and instanced branch: the closest-hit walk
// `_trace_clustered_matrix` and the any-hit shadow walk
// `_trace_clustered_occluded`, with their XLA walk plan
// `_cluster_walk_plan`. Both share the shading code. Their plain PyTorch
// twin is ops/bounce_ref.py; all compute the same float operations in the
// same order, so with -fmad=false they agree to the last bit except where
// the math library's cos/sin/log differ. Volumes and scattering are not
// ported (gi raises for them).
//
// Two branches of the JAX FusedStatic are template flags here:
// * ADV (`advanced`), the full lobe set in the shading core: clearcoat,
//   anisotropic GGX (in the mesh-tangent frame where K4 reads the hit
//   buffer's tangent rows) and thick refraction with the exact dielectric
//   Fresnel and TIR (pallas_bounce.py :2453-2762). It adds per-ray math
//   (a few sqrt, cos/sin and divisions more a sample and a light
//   evaluation), no memory traffic; plain scenes take the ADV = false
//   instances, whose code is the plain path's.
// * CUT (`cutout`), stochastic cutout inside every search (:1445-1466,
//   :1657-1668, :2127-2138, :2874-2900, :3276-3311): a candidate hit
//   draws `cutout_xi`, an integer hash of the ray's PCG word and the
//   global triangle id, against its pass probability (resident: two
//   table columns staged in shared memory beside the tile; flattened walk:
//   the CLU_OPAC / CLU_OPAC_SH row; instanced: the placement's INST_PASS /
//   INST_PASS_SH). A rejected candidate is not a hit; nothing is re-traced
//   and the path's PCG stream gives no draw. It adds a hash (about 10
//   integer operations) to each candidate that would win, bound like the
//   search itself by the per-ray triangle tests.
// The source compiles in parts (GATLING_PART, ops/cuda_lib.py), each
// defining some of the entry points below, so that nvcc runs in parallel.
//
// Textured scenes split the bounce (the JAX package's split-bounce mode):
// K3 `trace_kernel` / `trace_walk_kernel` replaces `trace_step` ->
// `_trace_kernel` (with `_finalize_hits` on walk tables) and writes each
// ray's closest hit and shading state into a hit buffer; plain torch ops
// then sample the textures (render/fused.py material_rows); K4
// `shade_kernel` / `shade_walk_kernel` replaces `shade_step` ->
// `_shade_kernel` and shades from the hit buffer and the per-ray
// parameter rows. K3 reuses K1's tiled closest-hit search and K2's walk
// and pass 2; K4 runs the shading core and the NEE shadow walks that K1
// and K2 run (one copy of each in this file). Their twins are in
// ops/split_ref.py. What bounds them: K3 the same triangle tests as K1
// and K2 without the shading; K4 the state, hit-buffer and parameter
// traffic (16 + 16 + up to 8 floats a ray) and, with NEE, the shadow walk.
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

#include <type_traits>

// without GATLING_PART the file defines every entry point
#ifndef GATLING_PART
#define PART(k) 1
#else
#define PART(k) (GATLING_PART == (k))
#endif

namespace {

constexpr int TRI_ROWS = 32;      // the resident row; the tile holds its first 32 floats
constexpr int TRI_ROWS_TAN = 48;  // with the tangent rows TR_T0..TR_BS
// a cutout table appends the camera and the shadow pass probability after
// those rows and pads them to 36 or 52 floats
constexpr uint32_t SHADOW_SALT = 0x5BD1E995u;  // the shadow walk's cutout key salt
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
       TR_N1 = 18, TR_N2 = 21, TR_MAT = 24, TR_DS = 25, TR_UV = 26, TR_T0 = 32,
       TR_T1 = 35, TR_T2 = 38, TR_BS = 41 };
// hit buffer rows (ops/split_ref.py H_*)
enum { H_HIT = 0, H_T = 1, H_UV = 2, H_MAT = 4, H_GN = 5, H_N = 8, H_FRONT = 11, H_DS = 12,
       H_POS = 13, HIT_ROWS = 16, H_TAN = 16, H_BS = 19, HIT_ROWS_TAN = 24 };
// params
enum { P_BG_R = 0, P_RR_INV_MIN = 3, P_RR_OFFSET = 4, P_BOUNCE = 5,
       P_EXP2_EXPOSURE = 6, P_TMIN = 7, P_LIGHT_MULT = 8, PARAMS_LEN = 11 };
enum { LT_SPHERE = 0, LT_DISTANT = 1, LT_RECT = 2, LT_DISK = 3 };
constexpr double SHADOW_TMIN = 0.01;  // reference: rgen:397-438 shadow ray tMin

// clustered tables (ops/bounce_ref.py CLU_*, INST_*)
constexpr int CLUSTER_SIZE = 128;  // triangles per cluster
constexpr int L1_FAN = 16;         // clusters per level-1 entry
constexpr int CLU_ROWS_TAN = 56;  // a clustered row with the tangent rows (else 40)
enum { CLU_N = 0, CLU_GN = 4, CLU_MAT = 7, CLU_R1 = 8, CLU_N0 = 12, CLU_DS = 15,
       CLU_R2 = 16, CLU_N1 = 20, CLU_N2 = 24, CLU_UV = 28, CLU_OPAC = 34, CLU_OPAC_SH = 35,
       CLU_T0 = 40, CLU_T1 = 43, CLU_T2 = 46, CLU_BS = 49 };
enum { INST_AT = 9, INST_MAT = 12, INST_DS = 15, INST_PASS = 16, INST_PASS_SH = 17,
       INST_COLS = 20 };
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

// Per-(ray, triangle) uniform in [0, 1) (pallas_bounce.py _cutout_xi): a
// murmur-style mix of the ray's PCG word and the global triangle id.
__device__ __forceinline__ float cutout_xi(uint32_t key, uint32_t tid) {
  uint32_t h = key ^ (tid * 2654435761u);
  h = (h ^ (h >> 16)) * 0x21F0AAADu;
  h = (h ^ (h >> 15)) * 0x735A2D97u;
  h = h ^ (h >> 15);
  return (float)(h >> 8) * C(1.0 / (1 << 24));
}

// The camera pass-probability column of a resident cutout table of rows
// of ld floats (the shadow one follows it).
__device__ __forceinline__ int opac_col(int ld) { return ld >= TRI_ROWS_TAN ? TRI_ROWS_TAN : TRI_ROWS; }

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

// Copy the first 32 floats of triangles [base, base+cnt) of a table with
// rows of ld floats into the shared tile; with CUT also their column
// `col` (a pass probability) into s_opac.
template <bool CUT>
__device__ __forceinline__ void load_tile(float* s_tri, float* s_opac, const float* tris,
                                          int base, int cnt, int ld, int col) {
  float4* dst = reinterpret_cast<float4*>(s_tri);
  for (int k = threadIdx.x; k < cnt * (TRI_ROWS / 4); k += blockDim.x) {
    const int t = k / (TRI_ROWS / 4), q = k % (TRI_ROWS / 4);
    dst[k] = reinterpret_cast<const float4*>(tris + (size_t)(base + t) * ld)[q];
  }
  if (CUT)
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) s_opac[k] = tris[(size_t)(base + k) * ld + col];
}

// Diffuse + glossy reflection lobes at local wi (render/bsdf.py _eval_lobes).
struct Lobes {
  float fd[3], fg[3], pdf;
};

struct Surface {
  float wox, woy, woz;
  float base[3], f0[3];
  float metallic, transm, alpha2, p_d, p_g;
  // the advanced lobe set: anisotropic roughnesses and their rotation,
  // the coat's weight, roughness^4 and pick probability, the thick-glass
  // fraction
  float ax, ay, cos_r, sin_r, coat, ac2, p_c, thick;
};

__device__ __forceinline__ float ggx_g1(float a2, float nv) {
  return 2.0f * nv / (nv + sqrtf(a2 + (1.0f - a2) * nv * nv));
}

// Smith G1 of anisotropic GGX in the rotated frame (pallas_bounce.py :2651).
__device__ __forceinline__ float aniso_g1(float ax, float ay, float vx, float vy, float vz) {
  const float vza = fmaxf(fabsf(vz), C(1e-6));
  const float sx = ax * vx, sy = ay * vy;
  const float lam = 0.5f * (-1.0f + sqrtf(1.0f + (sx * sx + sy * sy) / (vza * vza)));
  return 1.0f / (1.0f + lam);
}

template <bool ADV>
__device__ __forceinline__ Lobes eval_lobes(const Surface& s, float wix, float wiy, float wiz) {
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
  float ggx_d, gg;
  if (ADV) {  // anisotropic D and G in the rotated tangent frame
    const float qa = (hxs * s.cos_r + hys * s.sin_r) / s.ax;
    const float qb = (-hxs * s.sin_r + hys * s.cos_r) / s.ay;
    const float q = qa * qa + qb * qb + hzs * hzs;
    ggx_d = 1.0f / fmaxf(C(PI_D) * s.ax * s.ay * q * q, C(1e-12));
    gg = aniso_g1(s.ax, s.ay, s.wox * s.cos_r + s.woy * s.sin_r,
                  -s.wox * s.sin_r + s.woy * s.cos_r, s.woz) *
         aniso_g1(s.ax, s.ay, wix * s.cos_r + wiy * s.sin_r, -wix * s.sin_r + wiy * s.cos_r, wiz);
  } else {
    const float dd = nh * nh * (a2 - 1.0f) + 1.0f;
    ggx_d = a2 / fmaxf(C(PI_D) * dd * dd, C(1e-12));
    gg = ggx_g1(a2, nvo) * ggx_g1(a2, nvi);
  }
  const float mfres = clampf(1.0f - oh, 0.0f, 1.0f);
  const float fres5 = (mfres * mfres) * (mfres * mfres) * mfres;
  float spec_core = ggx_d * gg / fmaxf(4.0f * s.woz * cos_i_c, C(1e-9)) * cos_i_c;
  float diff_core = (1.0f - s.metallic) * (1.0f - s.transm) * cos_i_c / C(PI_D);
  float coat_core = 0.0f, dc = 0.0f;
  if (ADV) {
    // the clearcoat lobe, and the base attenuated under the coat in both
    // directions; the thick-glass fraction leaves the base glossy lobe
    const float dcd = nh * nh * (s.ac2 - 1.0f) + 1.0f;
    dc = s.ac2 / fmaxf(C(PI_D) * (dcd * dcd), C(1e-12));
    const float fc = C(0.04) + C(0.96) * fres5;
    coat_core = s.coat * fc * dc * ggx_g1(s.ac2, nvo) * ggx_g1(s.ac2, nvi) /
                fmaxf(4.0f * s.woz * cos_i_c, C(1e-9)) * cos_i_c;
    const float m_o = clampf(1.0f - nvo, 0.0f, 1.0f);
    const float m_i = clampf(1.0f - nvi, 0.0f, 1.0f);
    const float att = (1.0f - s.coat * (C(0.04) + C(0.96) * ((m_o * m_o) * (m_o * m_o)) * m_o)) *
                      (1.0f - s.coat * (C(0.04) + C(0.96) * ((m_i * m_i) * (m_i * m_i)) * m_i));
    spec_core = spec_core * ((1.0f - s.thick) * att);
    diff_core = diff_core * att;
  }
  for (int c = 0; c < 3; ++c) {
    l.fd[c] = refl ? s.base[c] * diff_core : 0.0f;
    float g = (s.f0[c] + (1.0f - s.f0[c]) * fres5) * spec_core;
    if (ADV) g = g + coat_core;
    l.fg[c] = refl ? g : 0.0f;
  }
  float pdf = s.p_d * cos_i_c / C(PI_D) + s.p_g * ggx_d * nh / fmaxf(4.0f * oh, C(1e-9));
  if (ADV) pdf = pdf + s.p_c * dc * nh / fmaxf(4.0f * oh, C(1e-9));
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
// shading, shared by K1, K2 and K4
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

// The shading state of a hit: position, geometric and (normalised)
// shading normal turned to face the ray, facing flag, double-sided flag;
// in K4 with tangent rows the mesh tangent and bitangent sign, which frame
// the advanced lobes.
struct Hit {
  float pos[3], gn[3], n[3], dsided;
  bool front, has_tan;
  float tan[3], tbs;
};

// The shading parameters of a hit's material (the last four: the advanced
// lobe set's clearcoat, its roughness, anisotropy and its rotation).
struct Mat {
  float base[3], metallic, roughness, ior, em[3], transm, thinw, bf_edf;
  float coat, coat_rough, aniso, aniso_rot;
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

__device__ __forceinline__ Hit surface_hit(const float o[3], const float d[3], const Surf& sf) {
  Hit h;
  for (int c = 0; c < 3; ++c) h.pos[c] = o[c] + sf.t * d[c];
  const float* nrm = sf.nrm;
  const float* gn = sf.gn;
  const float nlen = 1.0f / sqrtf(fmaxf(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2], C(1e-20)));
  h.front = (gn[0] * -d[0] + gn[1] * -d[1] + gn[2] * -d[2]) >= 0.0f;
  const float fsign = h.front ? 1.0f : -1.0f;
  for (int c = 0; c < 3; ++c) {
    h.gn[c] = gn[c] * fsign;
    h.n[c] = nrm[c] * nlen * fsign;
  }
  h.dsided = sf.dsided;
  h.has_tan = false;
  return h;
}

// Material row of a hit from the shared-memory table (ids outside the
// table resolve to zeros); ADV also reads the advanced columns
// (pallas_bounce.py _resolve_material_rows).
template <bool ADV>
__device__ __forceinline__ Mat table_mat(const float* s_mat, int n_mats, float mat_f) {
  const int m_id = (int)rintf(mat_f);
  const bool m_ok = m_id >= 0 && m_id < n_mats;
  const float* m = s_mat + (m_ok ? m_id : 0) * MAT_COLS;
#define MAT(col) (m_ok ? m[col] : 0.0f)
  Mat t;
  for (int c = 0; c < 3; ++c) {
    t.base[c] = MAT(c);
    t.em[c] = MAT(7 + c);
  }
  t.metallic = MAT(3);
  t.roughness = MAT(4);
  t.ior = MAT(5);
  t.transm = MAT(14);
  t.thinw = MAT(15);
  t.bf_edf = MAT(24);
  if (ADV) {
    t.coat = MAT(26);
    t.coat_rough = MAT(27);
    t.aniso = MAT(28);
    t.aniso_rot = MAT(29);
  }
#undef MAT
  return t;
}

// Miss: constant background (no dome: not ported).
__device__ __forceinline__ void shade_miss(const float* p, Ray& r) {
  r.miss = !r.hit;
  if (r.miss) {
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.tp[c] * p[P_BG_R + c];
    r.miss_rec = p[P_BOUNCE] + 1.0f;
  }
}

// Emission, BSDF sampling, the new ray and the NEE light sample of an
// alive ray that hit (pallas_bounce.py _shade_core). ADV: the full lobe
// set (:2453-2762).
template <bool NEE, bool ADV>
__device__ __forceinline__ void shade_core(const float* p, const Mat& m, const Hit& h,
                                           const float* s_light, const int* s_ltype,
                                           int n_lights, Ray& r) {
  const float posx = h.pos[0], posy = h.pos[1], posz = h.pos[2];
  const float gnx = h.gn[0], gny = h.gn[1], gnz = h.gn[2];
  const float nx = h.n[0], ny = h.n[1], nz = h.n[2];
  Surface s;
  for (int c = 0; c < 3; ++c) s.base[c] = m.base[c];
  s.metallic = m.metallic;
  s.transm = m.transm;

  // ---- emission (rp_main.chit:304-315) ----
  if (h.front || h.dsided <= 0.5f || (m.thinw > 0.5f && m.bf_edf > 0.5f)) {
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.tp[c] * m.em[c] * p[P_EXP2_EXPOSURE];
  }

  // ---- BSDF sample draws (xi3 picks reflection or refraction at a thick
  // interface) ----
  const float xi0 = pcg_next(r.rng);
  const float xi1 = pcg_next(r.rng);
  const float xi2 = pcg_next(r.rng);
  const float xi3 = pcg_next(r.rng);

  // ---- Duff ONB around the shading normal ----
  const float nsign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a_onb = -1.0f / (nsign + nz);
  const float b_onb = nx * ny * a_onb;
  float t1x = 1.0f + nsign * nx * nx * a_onb;
  float t1y = nsign * b_onb;
  float t1z = -nsign * nx;
  float t2x = b_onb;
  float t2y = nsign + ny * ny * a_onb;
  float t2z = -ny;
  if (ADV && h.has_tan) {
    // the mesh tangent re-orthonormalised against the (possibly
    // normal-mapped) shading normal, bitangent cross(n, t) * sign; a
    // degenerate tangent keeps the Duff frame
    const float tdn = h.tan[0] * nx + h.tan[1] * ny + h.tan[2] * nz;
    float mtx = h.tan[0] - nx * tdn;
    float mty = h.tan[1] - ny * tdn;
    float mtz = h.tan[2] - nz * tdn;
    const float tlen2 = mtx * mtx + mty * mty + mtz * mtz;
    if (tlen2 > C(1e-12)) {
      const float tl = 1.0f / sqrtf(fmaxf(tlen2, C(1e-20)));
      mtx = mtx * tl;
      mty = mty * tl;
      mtz = mtz * tl;
      const float bsgn = h.tbs >= 0.0f ? 1.0f : -1.0f;
      t1x = mtx;
      t1y = mty;
      t1z = mtz;
      t2x = (ny * mtz - nz * mty) * bsgn;
      t2y = (nz * mtx - nx * mtz) * bsgn;
      t2z = (nx * mty - ny * mtx) * bsgn;
    }
  }
  const float* d = r.d;
  s.wox = -(d[0] * t1x + d[1] * t1y + d[2] * t1z);
  s.woy = -(d[0] * t2x + d[1] * t2y + d[2] * t2z);
  s.woz = -(d[0] * nx + d[1] * ny + d[2] * nz);

  // ---- lobe weights (render/bsdf.py _lobe_weights) ----
  const float f0q = (m.ior - 1.0f) / (m.ior + 1.0f);
  const float f0d = f0q * f0q;
  for (int c = 0; c < 3; ++c)
    s.f0[c] = f0d * (1.0f - s.metallic) + s.base[c] * s.metallic;
  const float lum_base = C(0.2126) * s.base[0] + C(0.7152) * s.base[1] + C(0.0722) * s.base[2];
  const float lum_f0 = C(0.2126) * s.f0[0] + C(0.7152) * s.f0[1] + C(0.0722) * s.f0[2];
  const float w_d = lum_base * (1.0f - s.metallic) * (1.0f - s.transm);
  float w_g = lum_f0 > 0.0f ? fmaxf(lum_f0, C(0.04)) : 0.0f;
  const float w_t = s.transm;
  const bool thin = m.thinw > 0.5f;
  float w_sum, w_c = 0.0f;
  if (ADV) {
    // the thick-glass fraction is the interface lobe's: the base glossy
    // lobe does not model that reflection again
    s.thick = s.transm * (1.0f - (thin ? 1.0f : 0.0f));
    w_g = w_g * (1.0f - s.thick);
    w_c = C(0.25) * m.coat;
    w_sum = fmaxf(w_d + w_g + w_t + w_c, C(1e-20));
  } else {
    w_sum = fmaxf(w_d + w_g + w_t, C(1e-20));
  }
  s.p_d = w_d / w_sum;
  s.p_g = w_g / w_sum;
  const float p_t = w_t / w_sum;
  const bool pick_d = xi0 < s.p_d;
  const bool pick_g = !pick_d && (xi0 < s.p_d + s.p_g);
  bool pick_t, pick_c = false;
  if (ADV) {
    s.p_c = w_c / w_sum;
    pick_t = !pick_d && !pick_g && (xi0 < s.p_d + s.p_g + p_t);
    pick_c = !pick_d && !pick_g && !pick_t;
  } else {
    pick_t = !pick_d && !pick_g;
  }

  const float alpha = fmaxf(m.roughness * m.roughness, C(1e-3));
  s.alpha2 = alpha * alpha;
  if (ADV) {  // anisotropic GGX roughnesses (Disney aspect), their rotation; the coat
    const float aspect = sqrtf(1.0f - C(0.9) * clampf(m.aniso, 0.0f, 1.0f));
    s.ax = fmaxf(alpha / aspect, C(1e-3));
    s.ay = fmaxf(alpha * aspect, C(1e-3));
    const float rtheta = C(2.0 * PI_D) * m.aniso_rot;
    s.cos_r = cosf(rtheta);
    s.sin_r = sinf(rtheta);
    s.coat = m.coat;
    const float ac = fmaxf(m.coat_rough * m.coat_rough, C(1e-3));
    s.ac2 = ac * ac;
  }

  // ---- the sampled direction ----
  float wix, wiy, wiz;
  bool refl_pick = false;  // thick interface: Fresnel reflection picked
  float k_t = 0.0f;        // thick interface: 1 - sin^2 of the refracted angle
  if (pick_t && (!ADV || thin)) {  // thin transmission: straight through
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
    } else {
      // the half vector, then a reflection about it (or a refraction)
      float hx, hy, hz;
      const float u_c = clampf(xi1, 0.0f, C(1.0 - 1e-7));
      if (ADV && pick_g) {  // anisotropic GGX, in slope space, rotated back
        const float r_slope = sqrtf(u_c / (1.0f - u_c));
        float hxr = s.ax * r_slope * cphi;
        float hyr = s.ay * r_slope * sphi;
        const float hinv_s = 1.0f / sqrtf(fmaxf(hxr * hxr + hyr * hyr + 1.0f, C(1e-24)));
        hxr = hxr * hinv_s;
        hyr = hyr * hinv_s;
        hx = hxr * s.cos_r - hyr * s.sin_r;
        hy = hxr * s.sin_r + hyr * s.cos_r;
        hz = hinv_s;
      } else {
        // GGX NDF: the glossy lobe (plain), the coat or the thick interface
        const float a2 = ADV ? (pick_c ? s.ac2 : s.alpha2) : s.alpha2;
        const float x = ADV ? u_c : xi1;
        const float c2h = (1.0f - x) / fmaxf(1.0f + (a2 - 1.0f) * x, C(1e-12));
        const float ch = sqrtf(clampf(c2h, 0.0f, 1.0f));
        const float sh = sqrtf(fmaxf(0.0f, 1.0f - c2h));
        hx = sh * cphi;
        hy = sh * sphi;
        hz = ch;
      }
      if (ADV && pick_t) {
        // thick transmission: a microfacet dielectric interface; the exact
        // Fresnel picks reflection or refraction, TIR is F = 1
        const float eta_rel = h.front ? m.ior : 1.0f / fmaxf(m.ior, C(1e-6));
        const float c_oh = fmaxf(s.wox * hx + s.woy * hy + s.woz * hz, 0.0f);
        const float sin2_t = (1.0f - c_oh * c_oh) / fmaxf(eta_rel * eta_rel, C(1e-12));
        const float cos_tf = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
        const float rs_f = (c_oh - eta_rel * cos_tf) / fmaxf(c_oh + eta_rel * cos_tf, C(1e-12));
        const float rp_f = (eta_rel * c_oh - cos_tf) / fmaxf(eta_rel * c_oh + cos_tf, C(1e-12));
        const float f_t = sin2_t >= 1.0f ? 1.0f
                                         : clampf(0.5f * (rs_f * rs_f + rp_f * rp_f), 0.0f, 1.0f);
        const float eta_inv = 1.0f / fmaxf(eta_rel, C(1e-6));
        k_t = 1.0f - eta_inv * eta_inv * (1.0f - c_oh * c_oh);
        const float cos_t = sqrtf(fmaxf(k_t, 0.0f));
        const float scale_h = eta_inv * c_oh - cos_t;
        refl_pick = xi3 < f_t;
        if (refl_pick) {
          wix = 2.0f * c_oh * hx - s.wox;
          wiy = 2.0f * c_oh * hy - s.woy;
          wiz = 2.0f * c_oh * hz - s.woz;
        } else {
          wix = -eta_inv * s.wox + scale_h * hx;
          wiy = -eta_inv * s.woy + scale_h * hy;
          wiz = -eta_inv * s.woz + scale_h * hz;
        }
      } else {
        const float odoth = s.wox * hx + s.woy * hy + s.woz * hz;
        wix = 2.0f * odoth * hx - s.wox;
        wiy = 2.0f * odoth * hy - s.woy;
        wiz = 2.0f * odoth * hz - s.woz;
      }
    }
  }

  float bop[3];
  if (pick_t) {  // thin transmission Fresnel-weighted (render/bsdf.py); thick: G1 at wi
    const float mtr = clampf(1.0f - fmaxf(s.woz, 0.0f), 0.0f, 1.0f);
    const float tr5 = (mtr * mtr) * (mtr * mtr) * mtr;
    const float inv_pt = p_t > C(1e-12) ? 1.0f / fmaxf(p_t, C(1e-12)) : 0.0f;
    if (ADV && !thin) {
      const float thick_w = s.transm * ggx_g1(s.alpha2, fmaxf(fabsf(wiz), C(1e-6))) * inv_pt;
      for (int c = 0; c < 3; ++c) bop[c] = thick_w;
      r.valid = p_t > 0.0f && (refl_pick || k_t > 0.0f);
    } else {
      for (int c = 0; c < 3; ++c)
        bop[c] = s.transm * (1.0f - (s.f0[c] + (1.0f - s.f0[c]) * tr5)) * inv_pt;
      r.valid = p_t > 0.0f;
    }
  } else {
    const Lobes lb = eval_lobes<ADV>(s, wix, wiy, wiz);
    const float inv_pdf = lb.pdf > C(1e-12) ? 1.0f / fmaxf(lb.pdf, C(1e-12)) : 0.0f;
    for (int c = 0; c < 3; ++c) bop[c] = (lb.fd[c] + lb.fg[c]) * inv_pdf;
    r.valid = lb.pdf > C(1e-12) && wiz > 0.0f && s.woz > 0.0f;
  }
  for (int c = 0; c < 3; ++c) r.tp[c] = r.tp[c] * (r.valid ? bop[c] : 0.0f);

  // new origin, offset along the signed geometric normal (a Fresnel-
  // reflected thick-glass sample stays on the front side); world wi
  const bool crossing = pick_t && (!ADV || thin || !refl_pick);
  const float osign = crossing ? -1.0f : 1.0f;
  for (int c = 0; c < 3; ++c)
    r.o[c] = h.pos[c] + h.gn[c] * osign * fmaxf(fabsf(h.pos[c]) * C(1.0 / 65536.0), C(1.0 / 65536.0));
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
      const Lobes el = eval_lobes<ADV>(s, lwx, lwy, lwz);
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

// The whole shading of a bounce for an alive ray whose closest hit (r.hit,
// sf) is known: K1 and K2 read the material row from the table.
template <bool NEE, bool ADV>
__device__ __forceinline__ void shade(const float* p, const float* s_mat, int n_mats,
                                      const float* s_light, const int* s_ltype,
                                      int n_lights, const Surf& sf, Ray& r) {
  shade_miss(p, r);
  if (!r.hit) return;
  shade_core<NEE, ADV>(p, table_mat<ADV>(s_mat, n_mats, sf.mat_f), surface_hit(r.o, r.d, sf),
                       s_light, s_ltype, n_lights, r);
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
// the split bounce's buffers (K3 writes the hit buffer, K4 reads it)
// ---------------------------------------------------------------------------

// K3's output for one ray: the H_* rows (ops/split_ref.py), the shading
// state of its hit; with tangents the tangent orthonormalised against the
// facing shading normal and the interpolated bitangent sign.
template <bool TAN>
__device__ __forceinline__ void write_hit(float* hit, long long R, long long i, bool is_hit,
                                          const float o[3], const float d[3], const Surf& sf,
                                          const float uv[2], const float tan[3], float tbs) {
  const Hit h = surface_hit(o, d, sf);
  hit[H_HIT * R + i] = is_hit ? 1.0f : 0.0f;
  hit[H_T * R + i] = sf.t;
  hit[H_UV * R + i] = uv[0];
  hit[(H_UV + 1) * R + i] = uv[1];
  hit[H_MAT * R + i] = sf.mat_f;
  for (int c = 0; c < 3; ++c) {
    hit[(H_GN + c) * R + i] = h.gn[c];
    hit[(H_N + c) * R + i] = h.n[c];
    hit[(H_POS + c) * R + i] = h.pos[c];
  }
  hit[H_FRONT * R + i] = h.front ? 1.0f : 0.0f;
  hit[H_DS * R + i] = sf.dsided;
  if (TAN) {
    const float tdn = tan[0] * h.n[0] + tan[1] * h.n[1] + tan[2] * h.n[2];
    float t[3];
    for (int c = 0; c < 3; ++c) t[c] = tan[c] - h.n[c] * tdn;
    const float tlen = 1.0f / sqrtf(fmaxf(t[0] * t[0] + t[1] * t[1] + t[2] * t[2], C(1e-20)));
    for (int c = 0; c < 3; ++c) hit[(H_TAN + c) * R + i] = t[c] * tlen;
    hit[H_BS * R + i] = tbs;
    for (int k = H_BS + 1; k < HIT_ROWS_TAN; ++k) hit[k * R + i] = 0.0f;
  }
}

// A dead ray's hit buffer: every row 0.
__device__ __forceinline__ void write_dead(float* hit, int rows, long long R, long long i) {
  for (int k = 0; k < rows; ++k) hit[k * R + i] = 0.0f;
}

// K4's view of one alive ray: the hit flag, its shading state (with the
// tangent rows when the buffer has them), and its material, the textured
// parameters (row >= 0) from the parameter buffer.
template <bool ADV>
__device__ __forceinline__ void read_hit(const float* hit, const float* par, const int prow[4],
                                         bool hit_tan, const float* s_mat, int n_mats,
                                         long long R, long long i, Ray& r, Hit& h, Mat& m) {
  r.hit = hit[H_HIT * R + i] > 0.5f;
  for (int c = 0; c < 3; ++c) {
    h.pos[c] = hit[(H_POS + c) * R + i];
    h.gn[c] = hit[(H_GN + c) * R + i];
    h.n[c] = hit[(H_N + c) * R + i];
  }
  h.front = hit[H_FRONT * R + i] > 0.5f;
  h.dsided = hit[H_DS * R + i];
  h.has_tan = ADV && hit_tan;
  if (h.has_tan) {
    for (int c = 0; c < 3; ++c) h.tan[c] = hit[(H_TAN + c) * R + i];
    h.tbs = hit[H_BS * R + i];
  }
  m = table_mat<ADV>(s_mat, n_mats, hit[H_MAT * R + i]);
  for (int c = 0; c < 3; ++c) {
    if (prow[0] >= 0) m.base[c] = par[(prow[0] + c) * R + i];
    if (prow[1] >= 0) m.em[c] = par[(prow[1] + c) * R + i];
  }
  if (prow[2] >= 0) m.metallic = par[prow[2] * R + i];
  if (prow[3] >= 0) m.roughness = par[prow[3] * R + i];
}

// ---------------------------------------------------------------------------
// K1 (bounce), K3 (trace) and K4 (shade) over the resident table
// ---------------------------------------------------------------------------

// Shared memory of the resident kernels: the 128-triangle tile, with CUT
// its pass probabilities, then the material and light tables.
struct Smem {
  float *tri, *opac, *mat, *light;
  int* ltype;
};

template <bool CUT>
__device__ __forceinline__ Smem resident_smem(float* base, int n_mats, int n_lights) {
  Smem m;
  m.tri = base;
  m.opac = m.tri + TILE * TRI_ROWS;
  m.mat = m.opac + (CUT ? TILE : 0);
  m.light = m.mat + n_mats * MAT_COLS;
  m.ltype = reinterpret_cast<int*>(m.light + n_lights * LIGHT_COLS);
  return m;
}

// The closest hit of each alive ray of the block over the resident table,
// through shared-memory tiles: serial table order, strict '<' (ties keep
// the first). CUT: a candidate that would win is a hit only if its cutout
// draw with `key` passes the camera column. Every thread of the block must
// call it.
template <bool CUT>
__device__ __forceinline__ void resident_closest(const Smem& sm, const float* tris, int n_tris,
                                                 int ld, bool alive, const Ray& r, float tmin,
                                                 uint32_t key, float& best_t, float& bu,
                                                 float& bv, int& win) {
  best_t = FMAX;
  bu = bv = 0.0f;
  win = -1;
  for (int base = 0; base < n_tris; base += TILE) {
    const int cnt = min(TILE, n_tris - base);
    __syncthreads();
    load_tile<CUT>(sm.tri, sm.opac, tris, base, cnt, ld, opac_col(ld));
    __syncthreads();
    if (alive) {
      for (int t = 0; t < cnt; ++t) {
        float tt, u, v;
        const bool ok = tri_hit(sm.tri + t * TRI_ROWS, r.o[0], r.o[1], r.o[2], r.d[0],
                                r.d[1], r.d[2], tmin, tt, u, v);
        if (ok && tt < best_t &&
            (!CUT || cutout_xi(key, (uint32_t)(base + t)) < sm.opac[t])) {
          best_t = tt;
          bu = u;
          bv = v;
          win = base + t;
        }
      }
    }
  }
}

// The winner's attributes from its resident table row (zeros on a miss).
__device__ __forceinline__ Surf resident_surf(const float* tris, int ld, float best_t, float bu,
                                              float bv, int win) {
  Surf sf = {};
  sf.t = best_t;
  sf.u = bu;
  sf.v = bv;
  if (win >= 0) {
    const float* tr = tris + (size_t)win * ld;
    const float w = 1.0f - bu - bv;
    for (int c = 0; c < 3; ++c) {
      sf.gn[c] = __ldg(tr + TR_GN + c);
      sf.nrm[c] = w * __ldg(tr + TR_N0 + c) + bu * __ldg(tr + TR_N1 + c) +
                  bv * __ldg(tr + TR_N2 + c);
    }
    sf.mat_f = __ldg(tr + TR_MAT);
    sf.dsided = __ldg(tr + TR_DS);
  }
  return sf;
}

// NEE shadow rays over the resident table: any hit in (SHADOW_TMIN,
// ldist), with CUT only those whose draw (the salted PCG word) passes the
// shadow column; all threads help load tiles until no ray of the block
// needs an answer. Every thread of the block must call it.
template <bool CUT>
__device__ __forceinline__ bool resident_occluded(const Smem& sm, const float* tris, int n_tris,
                                                  int ld, const Ray& r) {
  bool occ = false;
  const uint32_t key = CUT ? r.rng ^ SHADOW_SALT : 0u;
  for (int base = 0; base < n_tris; base += TILE) {
    if (!__syncthreads_or(r.do_trace && !occ)) break;
    const int cnt = min(TILE, n_tris - base);
    load_tile<CUT>(sm.tri, sm.opac, tris, base, cnt, ld, opac_col(ld) + 1);
    __syncthreads();
    if (r.do_trace && !occ) {
      for (int t = 0; t < cnt; ++t) {
        float tt, u, v;
        if (tri_hit(sm.tri + t * TRI_ROWS, r.o[0], r.o[1], r.o[2], r.ld[0], r.ld[1],
                    r.ld[2], C(SHADOW_TMIN), tt, u, v) && tt < r.ldist &&
            (!CUT || cutout_xi(key, (uint32_t)(base + t)) < sm.opac[t])) {
          occ = true;
          break;
        }
      }
    }
  }
  return occ;
}

template <bool NEE, bool ADV, bool CUT>
__global__ void __launch_bounds__(THREADS)
bounce_kernel(const float* __restrict__ params, const float* __restrict__ tris,
              int n_tris, int ld, const float* __restrict__ mats, int n_mats,
              const float* __restrict__ lights, const int8_t* __restrict__ ltypes,
              int n_lights, float* __restrict__ state, long long R) {
  extern __shared__ float4 smem4[];
  const Smem sm = resident_smem<CUT>(reinterpret_cast<float*>(smem4), n_mats, n_lights);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  // dead block: every ray passes through unchanged
  if (!__syncthreads_or(alive)) return;

  stage_tables(sm.mat, mats, n_mats, sm.light, lights, sm.ltype, ltypes, n_lights);

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);

  Ray r = {};
  uint32_t key = 0;
  if (alive) {
    for (int c = 0; c < 3; ++c) {
      r.o[c] = state[(S_OX + c) * R + i];
      r.d[c] = state[(S_DX + c) * R + i];
    }
    if (CUT) key = __float_as_uint(state[S_RNG * R + i]);
  }

  float best_t, bu, bv;
  int win;
  resident_closest<CUT>(sm, tris, n_tris, ld, alive, r, p[P_TMIN], key, best_t, bu, bv, win);
  if (alive) {
    load_path(r, state, R, i);
    r.hit = best_t < FMAX;
    shade<NEE, ADV>(p, sm.mat, n_mats, sm.light, sm.ltype, n_lights,
                    resident_surf(tris, ld, best_t, bu, bv, win), r);
  }
  const bool occ = NEE && resident_occluded<CUT>(sm, tris, n_tris, ld, r);
  if (!alive) return;
  finish(p, r, occ, state, R, i);
}

// K3, resident: closest hit and shading state into the hit buffer.
template <bool TAN, bool CUT>
__global__ void __launch_bounds__(THREADS)
trace_kernel(const float* __restrict__ params, const float* __restrict__ tris, int n_tris,
             int ld, const float* __restrict__ state, long long R, float* __restrict__ hit) {
  extern __shared__ float4 smem4[];
  const Smem sm = resident_smem<CUT>(reinterpret_cast<float*>(smem4), 0, 0);
  const int rows = TAN ? HIT_ROWS_TAN : HIT_ROWS;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  if (!__syncthreads_or(alive)) {
    if (i < R) write_dead(hit, rows, R, i);
    return;
  }
  Ray r = {};
  uint32_t key = 0;
  if (alive) {
    for (int c = 0; c < 3; ++c) {
      r.o[c] = state[(S_OX + c) * R + i];
      r.d[c] = state[(S_DX + c) * R + i];
    }
    if (CUT) key = __float_as_uint(state[S_RNG * R + i]);
  }
  float best_t, bu, bv;
  int win;
  resident_closest<CUT>(sm, tris, n_tris, ld, alive, r, __ldg(params + P_TMIN), key, best_t,
                        bu, bv, win);
  if (i >= R) return;
  if (!alive) {
    write_dead(hit, rows, R, i);
    return;
  }
  const Surf sf = resident_surf(tris, ld, best_t, bu, bv, win);
  float uv[2] = {0.0f, 0.0f}, tan[3] = {0.0f, 0.0f, 0.0f}, tbs = 0.0f;
  if (win >= 0) {
    const float* tr = tris + (size_t)win * ld;
    const float w = 1.0f - bu - bv;
    for (int k = 0; k < 2; ++k)
      uv[k] = w * __ldg(tr + TR_UV + k) + bu * __ldg(tr + TR_UV + 2 + k) +
              bv * __ldg(tr + TR_UV + 4 + k);
    if (TAN) {
      for (int c = 0; c < 3; ++c)
        tan[c] = w * __ldg(tr + TR_T0 + c) + bu * __ldg(tr + TR_T1 + c) +
                 bv * __ldg(tr + TR_T2 + c);
      tbs = w * __ldg(tr + TR_BS) + bu * __ldg(tr + TR_BS + 1) + bv * __ldg(tr + TR_BS + 2);
    }
  }
  write_hit<TAN>(hit, R, i, best_t < FMAX, r.o, r.d, sf, uv, tan, tbs);
}

// K4, resident: shading from the hit and parameter buffers; the NEE shadow
// rays walk the resident table as in K1.
template <bool NEE, bool ADV, bool CUT>
__global__ void __launch_bounds__(THREADS)
shade_kernel(const float* __restrict__ params, const float* __restrict__ tris, int n_tris,
             int ld, const float* __restrict__ mats, int n_mats,
             const float* __restrict__ lights, const int8_t* __restrict__ ltypes,
             int n_lights, float* __restrict__ state, long long R,
             const float* __restrict__ hit, const float* __restrict__ par, int pb, int pe,
             int pm, int pr, int hit_tan) {
  extern __shared__ float4 smem4[];
  const Smem sm = resident_smem<CUT>(reinterpret_cast<float*>(smem4), n_mats, n_lights);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  if (!__syncthreads_or(alive)) return;
  stage_tables(sm.mat, mats, n_mats, sm.light, lights, sm.ltype, ltypes, n_lights);
  __syncthreads();

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);
  const int prow[4] = {pb, pe, pm, pr};
  Ray r = {};
  if (alive) {
    for (int c = 0; c < 3; ++c) {
      r.o[c] = state[(S_OX + c) * R + i];
      r.d[c] = state[(S_DX + c) * R + i];
    }
    load_path(r, state, R, i);
    Hit h;
    Mat m;
    read_hit<ADV>(hit, par, prow, hit_tan != 0, sm.mat, n_mats, R, i, r, h, m);
    shade_miss(p, r);
    if (r.hit) shade_core<NEE, ADV>(p, m, h, sm.light, sm.ltype, n_lights, r);
  }
  const bool occ = NEE && resident_occluded<CUT>(sm, tris, n_tris, ld, r);
  if (!alive) return;
  finish(p, r, occ, state, R, i);
}

// ---------------------------------------------------------------------------
// K2 (bounce), K3 (trace) and K4 (shade) over the two-level walk
// (clustered and instanced tables)
// ---------------------------------------------------------------------------

struct Walk {
  const float* tris;   // [C * 128, rows] CLU_* rows, triangle-major
  const float* l1;     // [n_l1, 8] entry world boxes (lo xyz, hi xyz, -, -)
  const float* l2;     // [n_l1 * 16, 8] fan-slot cluster world boxes
  const int* cmap;     // [n_l1 * 16] fan slot -> cluster of tris
  const float* inst;   // [n_l1, 20] world->local and pass-probability rows (instanced)
  const float* nodes;  // [N, 8] TLAS node boxes
  const int* kids;     // [N, 2] children, or (-1 - first, count) for a leaf
  const int* leaf;     // [n_l1] entries in leaf order
  const float* gbox;   // [8] scene box
};

// floats per clustered triangle row: 40, or 56 with the tangent rows
template <bool TAN>
__host__ __device__ constexpr int clu_rows() { return TAN ? CLU_ROWS_TAN : 40; }

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
// index (fan slot * 128 + lane), in (best, win). CUT: a candidate is valid
// only if cutout_xi(key, global index) falls below its pass probability:
// the placement's (instanced) or the triangle row's, the shadow column for
// ANY.
template <bool INST, bool ANY, bool TAN, bool CUT>
__device__ bool walk(const Walk& w, const float o[3], const float d[3], float tmin,
                     float tcap, uint32_t key, float& best, int& win) {
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
      float pass = 1.0f;
      if (INST) {
        to_local(w.inst + INST_COLS * e, o, d, ol, dl);
        if (CUT) pass = __ldg(w.inst + INST_COLS * e + (ANY ? INST_PASS_SH : INST_PASS));
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
        const float* tr = w.tris + (size_t)__ldg(w.cmap + slot) * CLUSTER_SIZE * clu_rows<TAN>();
        for (int lane = 0; lane < CLUSTER_SIZE; ++lane) {
          float tt;
          const float* row = tr + lane * clu_rows<TAN>();
          if (!clu_test(row, ol, dl, tmin, tcap, tt)) continue;
          const int gid = slot * CLUSTER_SIZE + lane;
          if (!ANY && !(tt < best || (tt == best && gid < win))) continue;
          if (CUT) {
            const float prob = INST ? pass : __ldg(row + (ANY ? CLU_OPAC_SH : CLU_OPAC));
            if (!(cutout_xi(key, (uint32_t)gid) < prob)) continue;
          }
          if (ANY) return true;
          best = tt;
          win = gid;
        }
        if (!ANY) run = fminf(tcap, best);
      }
    }
  }
  return false;
}

// The closest-hit walk of one ray below the scene box's widened slab exit
// (pallas_bounce.py :1555-1560); returns the winner's global index or -1.
template <bool INST, bool TAN, bool CUT>
__device__ __forceinline__ int walk_closest(const Walk& w, const float o[3], const float d[3],
                                            float tmin, uint32_t key) {
  float ex[3];
  for (int c = 0; c < 3; ++c) {
    const float iv = safe_inv(d[c]);
    ex[c] = fmaxf((__ldg(w.gbox + c) - o[c]) * iv, (__ldg(w.gbox + 3 + c) - o[c]) * iv);
  }
  const float cap = fmaxf(fminf(fminf(ex[0], ex[1]), ex[2]), 0.0f) * C(1.0001) + C(1e-3);
  float best = FMAX;
  int win = -1;
  walk<INST, false, TAN, CUT>(w, o, d, tmin, cap, key, best, win);
  return win;
}

// The NEE shadow ray of a ray that traces one: the any-hit walk, its
// cutout key the salted PCG word.
template <bool INST, bool TAN, bool CUT>
__device__ __forceinline__ bool walk_occluded(const Walk& w, const Ray& r) {
  float unused_t = FMAX;
  int unused_win = -1;
  return walk<INST, true, TAN, CUT>(w, r.o, r.ld, C(SHADOW_TMIN), r.ldist,
                                    CUT ? r.rng ^ SHADOW_SALT : 0u,
                                    unused_t, unused_win);
}

template <bool TAN>
__device__ __forceinline__ const float* winner_row(const Walk& w, int win) {
  return w.tris + ((size_t)__ldg(w.cmap + win / CLUSTER_SIZE) * CLUSTER_SIZE +
                   win % CLUSTER_SIZE) * clu_rows<TAN>();
}

// Pass 2 (pallas_bounce.py :1882-1982): the winner's t, u, v recomputed in
// f32 with the division form, and its attributes; an instanced winner
// transforms its normals as covectors through A3 and takes its material
// and flag from the instance row.
template <bool INST, bool TAN>
__device__ __forceinline__ void pass2(const Walk& w, const float o[3], const float d[3],
                                      int win, Surf& sf) {
  const float* tr = winner_row<TAN>(w, win);
  const float* a = INST ? w.inst + INST_COLS * (win / CLUSTER_SIZE / L1_FAN) : nullptr;
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

// The trace finalize's extra attributes of a walk winner (pallas_bounce.py
// _finalize_hits :3504): the interpolated uv and, with tangent rows, the
// interpolated tangent (an instanced one to world space as a vector,
// through the exact adjugate inverse of A3) and bitangent sign.
template <bool INST, bool TAN>
__device__ __forceinline__ void pass2_surface(const Walk& w, int win, float u, float v,
                                              float uv[2], float tan[3], float& tbs) {
  const float* tr = winner_row<TAN>(w, win);
  const float wb = 1.0f - u - v;
  for (int k = 0; k < 2; ++k)
    uv[k] = wb * tr[CLU_UV + k] + u * tr[CLU_UV + 2 + k] + v * tr[CLU_UV + 4 + k];
  if constexpr (TAN) {
    float t[3];
    for (int c = 0; c < 3; ++c)
      t[c] = wb * tr[CLU_T0 + c] + u * tr[CLU_T1 + c] + v * tr[CLU_T2 + c];
    tbs = wb * tr[CLU_BS] + u * tr[CLU_BS + 1] + v * tr[CLU_BS + 2];
    if constexpr (INST) {
      const float* a = w.inst + INST_COLS * (win / CLUSTER_SIZE / L1_FAN);
      const float a00 = a[0], a01 = a[1], a02 = a[2], a10 = a[3], a11 = a[4], a12 = a[5];
      const float a20 = a[6], a21 = a[7], a22 = a[8];
      const float det = (a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
                         a02 * (a10 * a21 - a11 * a20));
      const float idet = 1.0f / (fabsf(det) > C(1e-30) ? det : 1.0f);
      const float i00 = (a11 * a22 - a12 * a21) * idet, i01 = (a02 * a21 - a01 * a22) * idet;
      const float i02 = (a01 * a12 - a02 * a11) * idet, i10 = (a12 * a20 - a10 * a22) * idet;
      const float i11 = (a00 * a22 - a02 * a20) * idet, i12 = (a02 * a10 - a00 * a12) * idet;
      const float i20 = (a10 * a21 - a11 * a20) * idet, i21 = (a01 * a20 - a00 * a21) * idet;
      const float i22 = (a00 * a11 - a01 * a10) * idet;
      tan[0] = t[0] * i00 + t[1] * i10 + t[2] * i20;
      tan[1] = t[0] * i01 + t[1] * i11 + t[2] * i21;
      tan[2] = t[0] * i02 + t[1] * i12 + t[2] * i22;
    } else {
      for (int c = 0; c < 3; ++c) tan[c] = t[c];
    }
  }
}

template <bool NEE, bool INST, bool TAN, bool ADV, bool CUT>
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
  const int win = walk_closest<INST, TAN, CUT>(w, r.o, r.d, p[P_TMIN],
                                               CUT ? __float_as_uint(state[S_RNG * R + i]) : 0u);
  load_path(r, state, R, i);
  r.hit = win >= 0;
  Surf sf = {};
  sf.t = FMAX;
  if (r.hit) pass2<INST, TAN>(w, r.o, r.d, win, sf);
  shade<NEE, ADV>(p, s_mat, n_mats, s_light, s_ltype, n_lights, sf, r);
  const bool occ = NEE && r.do_trace && walk_occluded<INST, TAN, CUT>(w, r);
  finish(p, r, occ, state, R, i);
}

// K3 over the walk: the closest hit, pass 2 and the finalize's extra
// attributes into the hit buffer.
template <bool INST, bool TAN, bool CUT>
__global__ void __launch_bounds__(THREADS)
trace_walk_kernel(const float* __restrict__ params, Walk w, const float* __restrict__ state,
                  long long R, float* __restrict__ hit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  if (!(state[S_ALIVE * R + i] > 0.5f)) {
    write_dead(hit, TAN ? HIT_ROWS_TAN : HIT_ROWS, R, i);
    return;
  }
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = state[(S_OX + c) * R + i];
    d[c] = state[(S_DX + c) * R + i];
  }
  const int win = walk_closest<INST, TAN, CUT>(w, o, d, __ldg(params + P_TMIN),
                                               CUT ? __float_as_uint(state[S_RNG * R + i]) : 0u);
  Surf sf = {};
  sf.t = FMAX;
  float uv[2] = {0.0f, 0.0f}, tan[3] = {0.0f, 0.0f, 0.0f}, tbs = 0.0f;
  if (win >= 0) {
    pass2<INST, TAN>(w, o, d, win, sf);
    pass2_surface<INST, TAN>(w, win, sf.u, sf.v, uv, tan, tbs);
  }
  write_hit<TAN>(hit, R, i, win >= 0, o, d, sf, uv, tan, tbs);
}

// K4 over the walk: shading from the hit and parameter buffers, the NEE
// shadow ray through the any-hit walk.
template <bool NEE, bool INST, bool TAN, bool ADV, bool CUT>
__global__ void __launch_bounds__(THREADS)
shade_walk_kernel(const float* __restrict__ params, Walk w, const float* __restrict__ mats,
                  int n_mats, const float* __restrict__ lights,
                  const int8_t* __restrict__ ltypes, int n_lights, float* __restrict__ state,
                  long long R, const float* __restrict__ hit, const float* __restrict__ par,
                  int pb, int pe, int pm, int pr, int hit_tan) {
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
  const int prow[4] = {pb, pe, pm, pr};
  Ray r = {};
  for (int c = 0; c < 3; ++c) {
    r.o[c] = state[(S_OX + c) * R + i];
    r.d[c] = state[(S_DX + c) * R + i];
  }
  load_path(r, state, R, i);
  Hit h;
  Mat m;
  read_hit<ADV>(hit, par, prow, hit_tan != 0, s_mat, n_mats, R, i, r, h, m);
  shade_miss(p, r);
  if (r.hit) shade_core<NEE, ADV>(p, m, h, s_light, s_ltype, n_lights, r);
  const bool occ = NEE && r.do_trace && walk_occluded<INST, TAN, CUT>(w, r);
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

__global__ void __launch_bounds__(THREADS)
cutout_draws_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ ids,
                    float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = cutout_xi(keys[i], ids[i]);
}

// the tile and, with cutout, its pass probabilities
size_t tile_smem(bool cut) { return sizeof(float) * TILE * (TRI_ROWS + (cut ? 1 : 0)); }

unsigned grid(long long n_rays) { return (unsigned)((n_rays + THREADS - 1) / THREADS); }

// f(std::true_type{}) or f(std::false_type{}): a runtime flag to a
// template argument (decltype(flag)::value inside f)
template <typename F>
int with_flag(bool v, F&& f) {
  return v ? f(std::true_type{}) : f(std::false_type{});
}

}  // namespace

// the launch configuration of an entry point below: one thread per ray
#define CONFIG(SMEM) <<<grid(n_rays), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>
// the compile-time value of a flag passed through with_flag
#define V(flag) decltype(flag)::value

extern "C" {

// Every entry point launches on `stream` and returns a cudaError_t code
// (0 = launched). Resident tables are [n_tris, ld] (ld 32, or 48 with
// tangent rows; 36 or 52 with the cutout columns); walk tables carry their
// row length (40, or 56). `adv` and `cut` pick the branches.

#if PART(0)
const char* gatling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The traversals' cutout draws for n (key, triangle id) pairs, as the
// searches compute them (ops/bounce.py cutout_draws checks them against
// the twin's cutout_xi).
int gatling_cutout_draws(const uint32_t* keys, const uint32_t* ids, float* out,
                         long long n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  cutout_draws_kernel CONFIG(0)(keys, ids, out, n_rays);
  return (int)cudaGetLastError();
}

// K1: one bounce over state [16, n_rays] in place.
int gatling_bounce_step(const float* params, const float* tris, int n_tris, int ld,
                        const float* mats, int n_mats, const float* lights,
                        const int8_t* light_types, int n_lights, float* state,
                        long long n_rays, int nee, int adv, int cut, void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = tile_smem(cut) + table_smem(n_mats, n_lights);
  return with_flag(nee, [&](auto nee_) {
    return with_flag(adv, [&](auto adv_) {
      return with_flag(cut, [&](auto cut_) {
        auto kern = bounce_kernel<V(nee_), V(adv_), V(cut_)>;
        if (int err = allow_smem(kern, smem)) return err;
        kern CONFIG(smem)(params, tris, n_tris, ld, mats, n_mats, lights, light_types, n_lights,
                          state, n_rays);
        return (int)cudaGetLastError();
      });
    });
  });
}

// K3, resident: the hit buffer [16 or 24, n_rays] of state [16, n_rays].
int gatling_trace_resident(const float* params, const float* tris, int n_tris, int ld,
                           const float* state, long long n_rays, float* hit, int cut,
                           void* stream) {
  if (n_rays <= 0) return 0;
  const bool tan = ld >= TRI_ROWS_TAN;
  return with_flag(tan, [&](auto tan_) {
    return with_flag(cut, [&](auto cut_) {
      trace_kernel<V(tan_), V(cut_)> CONFIG(tile_smem(cut))(params, tris, n_tris, ld, state,
                                                            n_rays, hit);
      return (int)cudaGetLastError();
    });
  });
}

// K4, resident: shade state [16, n_rays] in place from the hit buffer and
// the parameter buffer, whose rows pb/pe/pm/pr hold base colour, emission,
// metallic and roughness (-1: from the material table); hit_tan: the hit
// buffer has the tangent rows.
int gatling_shade_resident(const float* params, const float* tris, int n_tris, int ld,
                           const float* mats, int n_mats, const float* lights,
                           const int8_t* light_types, int n_lights, float* state,
                           long long n_rays, const float* hit, const float* par, int pb,
                           int pe, int pm, int pr, int hit_tan, int nee, int adv, int cut,
                           void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = tile_smem(cut) + table_smem(n_mats, n_lights);
  return with_flag(nee, [&](auto nee_) {
    return with_flag(adv, [&](auto adv_) {
      return with_flag(cut, [&](auto cut_) {
        auto kern = shade_kernel<V(nee_), V(adv_), V(cut_)>;
        if (int err = allow_smem(kern, smem)) return err;
        kern CONFIG(smem)(params, tris, n_tris, ld, mats, n_mats, lights, light_types, n_lights,
                          state, n_rays, hit, par, pb, pe, pm, pr, hit_tan);
        return (int)cudaGetLastError();
      });
    });
  });
}
#endif

#define WALK_TABLES                                                                     \
  const float *tris, const float *l1, const float *l2, const int *cmap, const float *inst, \
      const float *nodes, const int *kids, const int *leaf_entries, const float *gbox,     \
      int instanced, int rows
#define WALK_STRUCT {tris, l1, l2, cmap, inst, nodes, kids, leaf_entries, gbox}

#if PART(0)
// K3 over the walk.
int gatling_trace_walk(const float* params, WALK_TABLES, const float* state, long long n_rays,
                       float* hit, int cut, void* stream) {
  if (n_rays <= 0) return 0;
  const Walk w = WALK_STRUCT;
  return with_flag(instanced, [&](auto inst_) {
    return with_flag(rows == CLU_ROWS_TAN, [&](auto tan_) {
      return with_flag(cut, [&](auto cut_) {
        trace_walk_kernel<V(inst_), V(tan_), V(cut_)> CONFIG(0)(params, w, state, n_rays, hit);
        return (int)cudaGetLastError();
      });
    });
  });
}
#endif

// K2: one bounce over state [16, n_rays] in place through the two-level
// walk, NEE off (gatling_bounce_walk) or on (gatling_bounce_walk_nee).
#define BOUNCE_WALK(NAME, NEE_)                                                               \
  int NAME(const float* params, WALK_TABLES, const float* mats, int n_mats,                   \
           const float* lights, const int8_t* light_types, int n_lights, float* state,        \
           long long n_rays, int adv, int cut, void* stream) {                                \
    if (n_rays <= 0) return 0;                                                                \
    const Walk w = WALK_STRUCT;                                                               \
    const size_t smem = table_smem(n_mats, n_lights);                                         \
    return with_flag(instanced, [&](auto inst_) {                                             \
      return with_flag(rows == CLU_ROWS_TAN, [&](auto tan_) {                                 \
        return with_flag(adv, [&](auto adv_) {                                                \
          return with_flag(cut, [&](auto cut_) {                                              \
            auto kern = walk_kernel<NEE_, V(inst_), V(tan_), V(adv_), V(cut_)>;               \
            if (int err = allow_smem(kern, smem)) return err;                                 \
            kern CONFIG(smem)(params, w, mats, n_mats, lights, light_types, n_lights, state,  \
                              n_rays);                                                        \
            return (int)cudaGetLastError();                                                   \
          });                                                                                 \
        });                                                                                   \
      });                                                                                     \
    });                                                                                       \
  }

// K4 over the walk, NEE off (gatling_shade_walk) or on (gatling_shade_walk_nee).
#define SHADE_WALK(NAME, NEE_)                                                                \
  int NAME(const float* params, WALK_TABLES, const float* mats, int n_mats,                   \
           const float* lights, const int8_t* light_types, int n_lights, float* state,        \
           long long n_rays, const float* hit, const float* par, int pb, int pe, int pm,      \
           int pr, int hit_tan, int adv, int cut, void* stream) {                             \
    if (n_rays <= 0) return 0;                                                                \
    const Walk w = WALK_STRUCT;                                                               \
    const size_t smem = table_smem(n_mats, n_lights);                                         \
    return with_flag(instanced, [&](auto inst_) {                                             \
      return with_flag(rows == CLU_ROWS_TAN, [&](auto tan_) {                                 \
        return with_flag(adv, [&](auto adv_) {                                                \
          return with_flag(cut, [&](auto cut_) {                                              \
            auto kern = shade_walk_kernel<NEE_, V(inst_), V(tan_), V(adv_), V(cut_)>;         \
            if (int err = allow_smem(kern, smem)) return err;                                 \
            kern CONFIG(smem)(params, w, mats, n_mats, lights, light_types, n_lights, state,  \
                              n_rays, hit, par, pb, pe, pm, pr, hit_tan);                     \
            return (int)cudaGetLastError();                                                   \
          });                                                                                 \
        });                                                                                   \
      });                                                                                     \
    });                                                                                       \
  }

#if PART(1)
BOUNCE_WALK(gatling_bounce_walk, false)
#endif
#if PART(2)
BOUNCE_WALK(gatling_bounce_walk_nee, true)
#endif
#if PART(3)
SHADE_WALK(gatling_shade_walk, false)
#endif
#if PART(4)
SHADE_WALK(gatling_shade_walk_nee, true)
#endif

}  // extern "C"
