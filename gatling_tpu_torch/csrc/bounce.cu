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
// the math library's cos/sin/log/exp differ.
//
// Three branches of the JAX FusedStatic are template flags here:
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
//   global triangle id, against its pass probability (resident: the two
//   table columns, copied into the tree's leaf rows; flattened walk:
//   the CLU_OPAC / CLU_OPAC_SH row; instanced: the placement's INST_PASS /
//   INST_PASS_SH). A rejected candidate is not a hit; nothing is re-traced
//   and the path's PCG stream gives no draw. It adds a hash (about 10
//   integer operations) to each candidate that would win, bound like the
//   search itself by the per-ray triangle tests.
// * VOL (`volumes` and `scatter`, one mode: 0 off, 1 absorption only, 2
//   scatter; K4 takes 0 and 1). Absorption (:2414-2430, :2930-2940):
//   the alive row holds 2.0 inside a medium; the segment into a hit,
//   measured from the hit position, attenuates by exp(-sigma_a d) with
//   the HIT material's sigma_a, and a refracted crossing of a
//   non-thin-walled surface toggles the flag. Scatter, a depth-1 medium
//   stack (:2223, :2255-2290, :2321-2330, :2404-2413, :2779-2831,
//   :2941-2954): the alive row encodes 2 + medium material id + 64 x walk
//   count; inside a scattering medium a ray draws a free-flight distance
//   (one colour channel by spectral MIS, two PCG words), and a hit beyond
//   it, or none, becomes a Henyey-Greenstein walk step (two more words)
//   instead of a surface hit or a miss; a surface hit inside attenuates
//   by the current medium's sigma_t over the hit's t. The TPU kernel
//   resolved the medium's row with a select loop over every material and
//   kept the flags as f32 0/1; here both are one indexed read of the
//   shared-memory table and a bool. Every reader takes a ray as alive iff
//   its row 13 exceeds 0.5; ids are rounded half to even (rintf, as
//   jnp.round). It adds a log and an exp or two a ray, no memory traffic
//   beyond the table columns 16-22.
// The source compiles in parts (GATLING_PART, ops/cuda_lib.py), each
// defining some of the entry points below, so that nvcc runs in parallel.
//
// Textured scenes split the bounce (the JAX package's split-bounce mode):
// K3 `trace_kernel` / `trace_walk_kernel` replaces `trace_step` ->
// `_trace_kernel` (with `_finalize_hits` on walk tables) and writes each
// ray's closest hit and shading state into a hit buffer; K4
// `shade_kernel` / `shade_walk_kernel` replaces the XLA texture stage
// `_material_rows` and `shade_step` -> `_shade_kernel`: it samples the
// textured parameters and the normal map itself and shades. The TPU
// kernel could not gather per lane, so an XLA stage between the two
// kernels sampled every ray's textures into a parameter buffer and a
// normal-mapped copy of the hit buffer; here each thread gathers its own
// texels: a tap is one 16-byte read of the texel's baked 2x2 row (a pool
// whose slots all wrap `repeat`) or four 4-byte reads through the wrap
// modes, through the read-only cache, with the slot records, the
// materials' slot columns and a 256-entry sRGB decode table in shared
// memory. A float pool (an EXR or Radiance HDR slot makes the whole pool
// float, render/texture.py build_pool) holds linear [4] f32 texels: the
// FLT instances of K4 and of its taps alone read four 16-byte texels a tap
// through the wrap modes, with no sRGB table and no 2x2 rows; the 8-bit
// instances are compiled without that code. K4 writes every row of the path state before its NEE shadow
// walk, and after it only the radiance of an unoccluded shadow ray, so
// that little of the shaded ray stays live across the walk. K3 reuses K1's closest-hit walk and K2's walk
// and pass 2; K4 runs the shading core and the NEE shadow walks that K1
// and K2 run (one copy of each in this file). Their twins are in
// ops/split_ref.py (K4's after material_rows there, the texture stage in
// plain torch). What bounds them: K3 the same triangle tests as
// K1 and K2 without the shading; K4 the state and hit-buffer traffic (16
// + 16 + up to 21 floats a ray), the texels its taps touch and, with NEE,
// the shadow walk's box and triangle tests. Two more serve the fused
// sample loop: K4t `tap_kernel`, K4's taps alone at the bounce-0 peel, and
// K4r `retrace_kernel`, one round of the textured-cutout re-trace (notes
// at their definitions).
//
// K1. One thread per ray; ray state row k of ray i lives at
// state[k*R + i], so every row access coalesces. The TPU kernel tested a
// 2048-ray block against every triangle, one at a time out of SMEM: its
// matrix unit makes the dense product cheap. Here each ray walks a binary
// BVH over the table, built once per scene on the host (ops/bvh.py
// TriBvh: median split, 4 triangles a leaf, boxes padded for rounding; a
// table of at most 64 triangles is one leaf, which a warp runs in step),
// nearer child first with a local stack (tree_walk.cuh); a leaf's
// triangles are read as three float4 quads of test data and a fourth with
// the table index and the cutout probabilities, through the read-only
// cache (a 4096-triangle table's tree and rows are about 300 KB: L1 and
// L2 hold them). Each candidate runs the brute-force loop's tri_hit, and
// the smallest t wins with ties to the lower table index, which is the
// serial loop's "first wins" made independent of the order: the walk
// finds the winner the twin's serial loop finds, bit for bit. The NEE
// shadow ray is an any-hit walk that ends at its first occluder. The
// winner's attributes are read from its table row. Materials, lights and
// the light-type list are staged in shared memory once per block; a block
// whose rays are all dead returns at once. What bounds it: per ray, the
// slab tests of the nodes it opens (24 operations each) and the triangle
// tests of the leaves it reaches (30 each), a few tens a ray on a closed
// mesh of hundreds of triangles, and the divergence of a warp's rays down
// different paths; on the Cornell box's 32 triangles, the state traffic
// (16 floats read and written a ray) and the shading math.
//
// K2. The TPU walked level-1 entries near to far per 1024-ray block, in an
// order an XLA prelude sorted, and intersected whole clusters with bf16
// hi/lo matrix products. Here each thread walks its own ray down a binary
// BVH over the entry boxes (the TLAS, ops/bounce.py build_tlas), nearer
// child first, pruning boxes beyond its best hit; at an entry it tests the
// fan's cluster boxes and visits the survivors nearest entry first, and in
// a cluster it walks the cluster's own BVH (ops/bvh.py ClusterBvh: median
// split, 4 triangles a leaf, at most 6 levels, a stack of 8 nested in the
// TLAS's), reading each candidate's 64-byte leaf row (its three test quads,
// lane and pass probabilities) through the read-only cache: the instanced
// sphere_field's trees are a few hundred KB, the flattened one's about
// 19 MB beside its 47 MB table, which pass 2 alone reads. Instanced
// entries carry the world->local transform: the ray enters the entry's
// frame, where t is the same parameter, and the cluster's tree lives in
// that frame. The trees' boxes are padded for their own coordinates and
// grown at run time by 1e-4 of the ray origin's largest coordinate in the
// frame (tree_walk.cuh padded_origin), which covers the rounding of the
// tests however far or however scaled the placement. The winner is
// selected in f32 with the TPU's pass-1 formulas and recomputed with its
// pass-2 division form; ties on t go to the lower global triangle index,
// so the result does not depend on the traversal order, and a node is
// skipped only when no triangle under it can still win: the winner is
// the brute-force twin's. What bounds it: per ray, the slab tests of the
// TLAS nodes, entry boxes, cluster boxes and tree nodes it opens (24
// operations each) and the triangle tests of the leaves it reaches (30
// each), and the divergence of rays of one warp that walk different
// clusters.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tree_walk.cuh"

// without GATLING_PART the file defines every entry point
#ifndef GATLING_PART
#define PART(k) 1
#else
#define PART(k) (GATLING_PART == (k))
#endif

namespace {

constexpr int TRI_ROWS_TAN = 48;  // with the tangent rows TR_T0..TR_BS
// a cutout table appends the camera and the shadow pass probability after
// those rows and pads them to 36 or 52 floats
constexpr uint32_t SHADOW_SALT = 0x5BD1E995u;  // the shadow walk's cutout key salt
constexpr int MAT_COLS = 30;
constexpr int LIGHT_COLS = 20;
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
       P_EXP2_EXPOSURE = 6, P_TMIN = 7, P_LIGHT_MULT = 8, P_METERS = 9, P_MAX_WALK = 10,
       PARAMS_LEN = 11 };
// material columns of the volume modes: sigma_a, sigma_s, the HG bias
enum { MF_VOL_A = 16, MF_VOL_S = 19, MF_VOL_BIAS = 22 };
enum { VOL_OFF = 0, VOL_ABSORB = 1, VOL_SCATTER = 2 };
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
constexpr int STACK = 64;  // TLAS traversal stack (ops/bvh.py TLAS_MAX_DEPTH)

__device__ __forceinline__ float pcg_next(uint32_t& s) {
  const uint32_t ns = s * 747796405u + 2891336453u;
  const uint32_t shift = (ns >> 28) + 4u;
  uint32_t word = ((ns >> shift) ^ ns) * 277803737u;
  word = (word >> 22) ^ word;
  s = ns;
  return __uint_as_float(0x3F800000u | (word >> 9)) - 1.0f;
}

// torch.maximum, torch.minimum and torch.clamp as the twins (and the JAX
// package's jnp.maximum) compute them: a NaN operand gives NaN (PTX's
// max.NaN / min.NaN), where fmaxf and fminf return the other operand. A NaN
// or infinite texel (a float pool) then shades as the twin shades it.
__device__ __forceinline__ float maxn(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float minn(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return minn(maxn(x, lo), hi);
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

// Baldwin-Weber plane + barycentric test of one triangle: its quads
// (TR_N xyz, TR_D0), (TR_R1 xyz, c1), (TR_R2 xyz, c2).
__device__ __forceinline__ bool tri_hit(const float4 n, const float4 r1, const float4 r2,
                                        const float o[3], const float d[3], float tmin,
                                        float& tt, float& u, float& v) {
  const float ndotd = n.x * d[0] + n.y * d[1] + n.z * d[2];
  bool ok = fabsf(ndotd) > C(1e-12);
  const float inv = ok ? 1.0f / ndotd : 0.0f;
  tt = -(n.x * o[0] + n.y * o[1] + n.z * o[2] + n.w) * inv;
  const float px = o[0] + tt * d[0];
  const float py = o[1] + tt * d[1];
  const float pz = o[2] + tt * d[2];
  u = r1.x * px + r1.y * py + r1.z * pz + r1.w;
  v = r2.x * px + r2.y * py + r2.z * pz + r2.w;
  return ok && (u >= BARY_LO) && (v >= BARY_LO) && (u + v <= BARY_HI) &&
         (tt > tmin);
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
  const float vza = maxn(fabsf(vz), C(1e-6));
  const float sx = ax * vx, sy = ay * vy;
  const float lam = 0.5f * (-1.0f + sqrtf(1.0f + (sx * sx + sy * sy) / (vza * vza)));
  return 1.0f / (1.0f + lam);
}

template <bool ADV>
__device__ __forceinline__ Lobes eval_lobes(const Surface& s, float wix, float wiy, float wiz) {
  Lobes l;
  const bool refl = (s.woz > 0.0f) && (wiz > 0.0f);
  const float cos_i_c = maxn(wiz, 0.0f);
  float hxs = s.wox + wix;
  float hys = s.woy + wiy;
  float hzs = s.woz + wiz;
  const float hinv = 1.0f / sqrtf(maxn(hxs * hxs + hys * hys + hzs * hzs, C(1e-24)));
  hxs = hxs * hinv;
  hys = hys * hinv;
  hzs = hzs * hinv;
  const float nh = fabsf(hzs);
  const float oh = maxn(s.wox * hxs + s.woy * hys + s.woz * hzs, C(1e-6));
  const float nvo = maxn(s.woz, C(1e-6));
  const float nvi = maxn(cos_i_c, C(1e-6));
  const float a2 = s.alpha2;
  float ggx_d, gg;
  if (ADV) {  // anisotropic D and G in the rotated tangent frame
    const float qa = (hxs * s.cos_r + hys * s.sin_r) / s.ax;
    const float qb = (-hxs * s.sin_r + hys * s.cos_r) / s.ay;
    const float q = qa * qa + qb * qb + hzs * hzs;
    ggx_d = 1.0f / maxn(C(PI_D) * s.ax * s.ay * q * q, C(1e-12));
    gg = aniso_g1(s.ax, s.ay, s.wox * s.cos_r + s.woy * s.sin_r,
                  -s.wox * s.sin_r + s.woy * s.cos_r, s.woz) *
         aniso_g1(s.ax, s.ay, wix * s.cos_r + wiy * s.sin_r, -wix * s.sin_r + wiy * s.cos_r, wiz);
  } else {
    const float dd = nh * nh * (a2 - 1.0f) + 1.0f;
    ggx_d = a2 / maxn(C(PI_D) * dd * dd, C(1e-12));
    gg = ggx_g1(a2, nvo) * ggx_g1(a2, nvi);
  }
  const float mfres = clampf(1.0f - oh, 0.0f, 1.0f);
  const float fres5 = (mfres * mfres) * (mfres * mfres) * mfres;
  float spec_core = ggx_d * gg / maxn(4.0f * s.woz * cos_i_c, C(1e-9)) * cos_i_c;
  float diff_core = (1.0f - s.metallic) * (1.0f - s.transm) * cos_i_c / C(PI_D);
  float coat_core = 0.0f, dc = 0.0f;
  if (ADV) {
    // the clearcoat lobe, and the base attenuated under the coat in both
    // directions; the thick-glass fraction leaves the base glossy lobe
    const float dcd = nh * nh * (s.ac2 - 1.0f) + 1.0f;
    dc = s.ac2 / maxn(C(PI_D) * (dcd * dcd), C(1e-12));
    const float fc = C(0.04) + C(0.96) * fres5;
    coat_core = s.coat * fc * dc * ggx_g1(s.ac2, nvo) * ggx_g1(s.ac2, nvi) /
                maxn(4.0f * s.woz * cos_i_c, C(1e-9)) * cos_i_c;
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
  float pdf = s.p_d * cos_i_c / C(PI_D) + s.p_g * ggx_d * nh / maxn(4.0f * oh, C(1e-9));
  if (ADV) pdf = pdf + s.p_c * dc * nh / maxn(4.0f * oh, C(1e-9));
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
    const float b_s = sqrtf(maxn(0.0f, 1.0f - a_s * a_s));
    const float phi = C(2.0 * PI_D) * k3;
    const float lx = b_s * cosf(phi) * g[3];
    const float ly = b_s * sinf(phi) * g[4];
    const float lz = a_s * g[5];
    const float vx = g[0] + lx - posx;
    const float vy = g[1] + ly - posy;
    const float vz = g[2] + lz - posz;
    dist = sqrtf(vx * vx + vy * vy + vz * vz);
    const float inv_d = dist > 0.0f ? 1.0f / maxn(dist, C(1e-30)) : 0.0f;
    sdx = vx * inv_d;
    sdy = vy * inv_d;
    sdz = vz * inv_d;
    const float nl = sqrtf(lx * lx + ly * ly + lz * lz);
    const float inv_nl = nl > 0.0f ? 1.0f / maxn(nl, C(1e-30)) : 0.0f;
    const float cosl = maxn(0.0f, -(sdx * lx + sdy * ly + sdz * lz) * inv_nl);
    const float area = g[9];
    const float num = area > 0.0f ? area * cosl : 1.0f;
    const float d2 = dist * dist;
    s_ipdf = d2 > 0.0f ? num / maxn(d2, C(1e-30)) : 0.0f;
  } else if (t == LT_DISTANT) {
    const float phi = k2 * 2.0f * C(PI_D) - C(PI_D);
    const float theta = k3 * g[9];
    const float st = sinf(theta), ct = cosf(theta);
    const float cp = cosf(phi), sp = sinf(phi);
    const float px = st * (cp * g[3] + sp * g[6]) + ct * g[0];
    const float py = st * (cp * g[4] + sp * g[7]) + ct * g[1];
    const float pz = st * (cp * g[5] + sp * g[8]) + ct * g[2];
    const float pinv = 1.0f / sqrtf(maxn(px * px + py * py + pz * pz, C(1e-40)));
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
    const float inv_d = dist > 0.0f ? 1.0f / maxn(dist, C(1e-30)) : 0.0f;
    sdx = vx * inv_d;
    sdy = vy * inv_d;
    sdz = vz * inv_d;
    const float cosl = maxn(0.0f, -(sdx * g[11] + sdy * g[12] + sdz * g[13]));
    const float num = area > 0.0f ? area * cosl : 1.0f;
    const float d2 = dist * dist;
    s_ipdf = d2 > 0.0f ? num / maxn(d2, C(1e-30)) : 0.0f;
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
  // volume modes: a refracted crossing of a non-thin-walled surface, and
  // the alive row the ray keeps if it survives the bounce
  bool toggled;
  float alive_out;
};

// The scatter mode's record of one ray's bounce: the decoded alive row,
// the current medium's coefficients and the free-flight sample; `step`: a
// walk step instead of a surface hit or a miss.
struct Medium {
  bool inside, do_dist, step;
  float mid_f, walk_f, t_sample, gbias, ms[3], mt[3], p3[3];
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
  float va[3];  // the absorption mode's sigma_a
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
  const float nlen = 1.0f / sqrtf(maxn(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2], C(1e-20)));
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
// table resolve to zeros); ADV also reads the advanced columns, the
// absorption mode sigma_a (pallas_bounce.py _resolve_material_rows).
template <bool ADV, int VOL = VOL_OFF>
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
  if (VOL == VOL_ABSORB)
    for (int c = 0; c < 3; ++c) t.va[c] = MAT(MF_VOL_A + c);
#undef MAT
  return t;
}

// The scatter mode's free-flight distance sampling of an alive ray
// (pallas_bounce.py :2255-2290): decode the alive row, resolve the current
// medium from the table, draw two PCG words where the ray is inside a
// scattering medium with walk steps left, pick a colour channel by
// spectral MIS and sample a distance against its sigma_t.
__device__ __forceinline__ void free_flight(const float* p, const float* s_mat, int n_mats,
                                            float alive_f, Ray& r, Medium& md) {
  md.inside = alive_f >= 1.5f;
  const float enc = maxn(alive_f - 2.0f, 0.0f);
  md.walk_f = floorf(enc * C(1.0 / 64.0));
  md.mid_f = enc - md.walk_f * 64.0f;
  const int m_id = (int)rintf(md.mid_f);
  const bool m_ok = m_id >= 0 && m_id < n_mats;
  const float* m = s_mat + (m_ok ? m_id : 0) * MAT_COLS;
  for (int c = 0; c < 3; ++c) {
    md.ms[c] = m_ok ? m[MF_VOL_S + c] : 0.0f;
    md.mt[c] = (m_ok ? m[MF_VOL_A + c] : 0.0f) + md.ms[c];
  }
  md.gbias = m_ok ? m[MF_VOL_BIAS] : 0.0f;
  const bool has_scat = (md.ms[0] + md.ms[1] + md.ms[2]) > 0.0f;
  md.do_dist = md.inside && has_scat && (md.walk_f <= p[P_MAX_WALK]);
  uint32_t s2 = r.rng;
  const float xv0 = pcg_next(s2);
  const float xv1 = pcg_next(s2);
  if (md.do_dist) r.rng = s2;
  // spectral single-channel MIS select (rgen sampleDistance:49-69)
  float w[3];
  for (int c = 0; c < 3; ++c)
    w[c] = r.tp[c] * (md.mt[c] > 0.0f ? md.ms[c] / maxn(md.mt[c], C(1e-20)) : 0.0f);
  const float wsum = w[0] + w[1] + w[2];
  for (int c = 0; c < 3; ++c)
    md.p3[c] = wsum > C(1e-9) ? w[c] / maxn(wsum, C(1e-9)) : C(1.0 / 3.0);
  const bool pick1 = xv0 < md.p3[0];
  const bool pick2 = !pick1 && (xv0 < md.p3[0] + md.p3[1]);
  const float sel_sigma = pick1 ? md.mt[0] : (pick2 ? md.mt[1] : md.mt[2]);
  const float s_coef = maxn(sel_sigma * p[P_METERS], C(1e-20));
  md.t_sample = -logf(maxn(1.0f - xv1, C(1e-20))) / s_coef;
}

// A walk step of a ray whose free-flight sample fell short of its hit
// (:2779-2831): throughput sigma_s T / pdf, the origin t_sample along, and
// a Henyey-Greenstein direction in the Duff frame of the current one.
__device__ __forceinline__ void walk_step(const float* p, Ray& r, const Medium& md) {
  const float ts = md.t_sample;
  const float dm_s = ts * p[P_METERS];
  float trv[3];
  for (int c = 0; c < 3; ++c) trv[c] = expf(-md.mt[c] * dm_s);
  const float pdf_w = maxn(md.p3[0] * md.mt[0] * trv[0] + md.p3[1] * md.mt[1] * trv[1] +
                                md.p3[2] * md.mt[2] * trv[2], C(1e-20));
  for (int c = 0; c < 3; ++c) {
    r.tp[c] = r.tp[c] * md.ms[c] * trv[c] / pdf_w;
    r.o[c] = r.o[c] + r.d[c] * ts;
  }
  const float xh0 = pcg_next(r.rng);
  const float xh1 = pcg_next(r.rng);
  const float g = md.gbias;
  const float sq = (1.0f - g * g) / maxn(1.0f - g + 2.0f * g * xh0, C(1e-9));
  const float g_safe = fabsf(g) < C(1e-9) ? 1.0f : g;
  const float cos_hg = clampf(fabsf(g) < C(1e-3) ? 1.0f - 2.0f * xh0
                                                 : (1.0f + g * g - sq * sq) / (2.0f * g_safe),
                              -1.0f, 1.0f);
  const float sin_hg = sqrtf(maxn(0.0f, 1.0f - cos_hg * cos_hg));
  const float phi = C(2.0 * PI_D) * xh1;
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  const float vsign = dz >= 0.0f ? 1.0f : -1.0f;
  const float va_o = -1.0f / (vsign + dz);
  const float vb_o = dx * dy * va_o;
  const float v1x = 1.0f + vsign * dx * dx * va_o, v1y = vsign * vb_o, v1z = -vsign * dx;
  const float v2x = vb_o, v2y = vsign + dy * dy * va_o, v2z = -dy;
  const float shx = sin_hg * cosf(phi);
  const float shy = sin_hg * sinf(phi);
  r.d[0] = v1x * shx + v2x * shy + dx * cos_hg;
  r.d[1] = v1y * shx + v2y * shy + dy * cos_hg;
  r.d[2] = v1z * shx + v2z * shy + dz * cos_hg;
}

// The alive row of a volume mode for a ray that survives the bounce
// (:2930-2954): inside a medium after the toggle, 2.0 (absorption) or
// 2 + medium id + 64 x walk count (scatter: a medium entered through a
// front face is the hit material, the id clipped to [0, 63]; a crossing
// resets the walk, a walk step counts); outside, 1.0.
template <int VOL>
__device__ __forceinline__ float medium_row(bool inside, const Ray& r, bool entering,
                                            float mat_f, const Medium& md) {
  if (r.toggled == inside) return 1.0f;  // outside after the bounce
  if (VOL == VOL_ABSORB) return 2.0f;
  const float mid_new = entering ? clampf(rintf(mat_f), 0.0f, 63.0f) : md.mid_f;
  const float walk_new = r.toggled ? 0.0f : (md.step ? md.walk_f + 1.0f : md.walk_f);
  return 2.0f + mid_new + 64.0f * walk_new;
}

// Miss: constant background, the miss recorded (row 14: the bounce + 1),
// from which the sample loop adds a dome light's radiance after the last
// bounce (render/fused.py dome_pass); a walk step is no miss.
__device__ __forceinline__ void shade_miss(const float* p, Ray& r, bool step = false) {
  r.miss = !r.hit && !step;
  if (r.miss) {
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.tp[c] * p[P_BG_R + c];
    r.miss_rec = p[P_BOUNCE] + 1.0f;
  }
}

// Emission, BSDF sampling, the new ray and the NEE light sample of an
// alive ray that hit (pallas_bounce.py _shade_core). ADV: the full lobe
// set (:2453-2762). VOL: first the transmittance of the segment into the
// hit for a ray `inside` a medium (absorption: the hit material's sigma_a
// over the distance from the origin to the hit position; scatter: the
// current medium's sigma_t over the hit's t, `hit_t`), and last whether
// the sample crosses into or out of a medium (r.toggled).
template <bool NEE, bool ADV, int VOL = VOL_OFF>
__device__ __forceinline__ void shade_core(const float* p, const Mat& m, const Hit& h,
                                           const float* s_light, const int* s_ltype,
                                           int n_lights, Ray& r, bool inside = false,
                                           const Medium* md = nullptr, float hit_t = 0.0f) {
  const float posx = h.pos[0], posy = h.pos[1], posz = h.pos[2];
  const float gnx = h.gn[0], gny = h.gn[1], gnz = h.gn[2];
  const float nx = h.n[0], ny = h.n[1], nz = h.n[2];
  Surface s;
  for (int c = 0; c < 3; ++c) s.base[c] = m.base[c];
  s.metallic = m.metallic;
  s.transm = m.transm;

  if (VOL == VOL_SCATTER && inside) {  // (:2404-2413, integrator chit:160-186)
    const float dist_m = hit_t * p[P_METERS];
    for (int c = 0; c < 3; ++c) r.tp[c] = r.tp[c] * expf(-md->mt[c] * dist_m);
  } else if (VOL == VOL_ABSORB && inside) {  // (:2414-2430, integrator:427-431)
    const float ex = posx - r.o[0], ey = posy - r.o[1], ez = posz - r.o[2];
    const float dist_m = minn(sqrtf(ex * ex + ey * ey + ez * ez), C(1e30)) * p[P_METERS];
    for (int c = 0; c < 3; ++c) r.tp[c] = r.tp[c] * expf(-m.va[c] * dist_m);
  }

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
      const float tl = 1.0f / sqrtf(maxn(tlen2, C(1e-20)));
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
  float w_g = lum_f0 > 0.0f ? maxn(lum_f0, C(0.04)) : 0.0f;
  const float w_t = s.transm;
  const bool thin = m.thinw > 0.5f;
  float w_sum, w_c = 0.0f;
  if (ADV) {
    // the thick-glass fraction is the interface lobe's: the base glossy
    // lobe does not model that reflection again
    s.thick = s.transm * (1.0f - (thin ? 1.0f : 0.0f));
    w_g = w_g * (1.0f - s.thick);
    w_c = C(0.25) * m.coat;
    w_sum = maxn(w_d + w_g + w_t + w_c, C(1e-20));
  } else {
    w_sum = maxn(w_d + w_g + w_t, C(1e-20));
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

  const float alpha = maxn(m.roughness * m.roughness, C(1e-3));
  s.alpha2 = alpha * alpha;
  if (ADV) {  // anisotropic GGX roughnesses (Disney aspect), their rotation; the coat
    const float aspect = sqrtf(1.0f - C(0.9) * clampf(m.aniso, 0.0f, 1.0f));
    s.ax = maxn(alpha / aspect, C(1e-3));
    s.ay = maxn(alpha * aspect, C(1e-3));
    const float rtheta = C(2.0 * PI_D) * m.aniso_rot;
    s.cos_r = cosf(rtheta);
    s.sin_r = sinf(rtheta);
    s.coat = m.coat;
    const float ac = maxn(m.coat_rough * m.coat_rough, C(1e-3));
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
      wiz = sqrtf(maxn(0.0f, 1.0f - xi1));
    } else {
      // the half vector, then a reflection about it (or a refraction)
      float hx, hy, hz;
      const float u_c = clampf(xi1, 0.0f, C(1.0 - 1e-7));
      if (ADV && pick_g) {  // anisotropic GGX, in slope space, rotated back
        const float r_slope = sqrtf(u_c / (1.0f - u_c));
        float hxr = s.ax * r_slope * cphi;
        float hyr = s.ay * r_slope * sphi;
        const float hinv_s = 1.0f / sqrtf(maxn(hxr * hxr + hyr * hyr + 1.0f, C(1e-24)));
        hxr = hxr * hinv_s;
        hyr = hyr * hinv_s;
        hx = hxr * s.cos_r - hyr * s.sin_r;
        hy = hxr * s.sin_r + hyr * s.cos_r;
        hz = hinv_s;
      } else {
        // GGX NDF: the glossy lobe (plain), the coat or the thick interface
        const float a2 = ADV ? (pick_c ? s.ac2 : s.alpha2) : s.alpha2;
        const float x = ADV ? u_c : xi1;
        const float c2h = (1.0f - x) / maxn(1.0f + (a2 - 1.0f) * x, C(1e-12));
        const float ch = sqrtf(clampf(c2h, 0.0f, 1.0f));
        const float sh = sqrtf(maxn(0.0f, 1.0f - c2h));
        hx = sh * cphi;
        hy = sh * sphi;
        hz = ch;
      }
      if (ADV && pick_t) {
        // thick transmission: a microfacet dielectric interface; the exact
        // Fresnel picks reflection or refraction, TIR is F = 1
        const float eta_rel = h.front ? m.ior : 1.0f / maxn(m.ior, C(1e-6));
        const float c_oh = maxn(s.wox * hx + s.woy * hy + s.woz * hz, 0.0f);
        const float sin2_t = (1.0f - c_oh * c_oh) / maxn(eta_rel * eta_rel, C(1e-12));
        const float cos_tf = sqrtf(maxn(1.0f - sin2_t, 0.0f));
        const float rs_f = (c_oh - eta_rel * cos_tf) / maxn(c_oh + eta_rel * cos_tf, C(1e-12));
        const float rp_f = (eta_rel * c_oh - cos_tf) / maxn(eta_rel * c_oh + cos_tf, C(1e-12));
        const float f_t = sin2_t >= 1.0f ? 1.0f
                                         : clampf(0.5f * (rs_f * rs_f + rp_f * rp_f), 0.0f, 1.0f);
        const float eta_inv = 1.0f / maxn(eta_rel, C(1e-6));
        k_t = 1.0f - eta_inv * eta_inv * (1.0f - c_oh * c_oh);
        const float cos_t = sqrtf(maxn(k_t, 0.0f));
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
    const float mtr = clampf(1.0f - maxn(s.woz, 0.0f), 0.0f, 1.0f);
    const float tr5 = (mtr * mtr) * (mtr * mtr) * mtr;
    const float inv_pt = p_t > C(1e-12) ? 1.0f / maxn(p_t, C(1e-12)) : 0.0f;
    if (ADV && !thin) {
      const float thick_w = s.transm * ggx_g1(s.alpha2, maxn(fabsf(wiz), C(1e-6))) * inv_pt;
      for (int c = 0; c < 3; ++c) bop[c] = thick_w;
      r.valid = p_t > 0.0f && (refl_pick || k_t > 0.0f);
    } else {
      for (int c = 0; c < 3; ++c)
        bop[c] = s.transm * (1.0f - (s.f0[c] + (1.0f - s.f0[c]) * tr5)) * inv_pt;
      r.valid = p_t > 0.0f;
    }
  } else {
    const Lobes lb = eval_lobes<ADV>(s, wix, wiy, wiz);
    const float inv_pdf = lb.pdf > C(1e-12) ? 1.0f / maxn(lb.pdf, C(1e-12)) : 0.0f;
    for (int c = 0; c < 3; ++c) bop[c] = (lb.fd[c] + lb.fg[c]) * inv_pdf;
    r.valid = lb.pdf > C(1e-12) && wiz > 0.0f && s.woz > 0.0f;
  }
  for (int c = 0; c < 3; ++c) r.tp[c] = r.tp[c] * (r.valid ? bop[c] : 0.0f);

  // new origin, offset along the signed geometric normal (a Fresnel-
  // reflected thick-glass sample stays on the front side); world wi
  const bool crossing = pick_t && (!ADV || thin || !refl_pick);
  if (VOL != VOL_OFF) r.toggled = r.valid && pick_t && m.thinw <= 0.5f && (!ADV || !refl_pick);
  const float osign = crossing ? -1.0f : 1.0f;
  for (int c = 0; c < 3; ++c)
    r.o[c] = h.pos[c] + h.gn[c] * osign * maxn(fabsf(h.pos[c]) * C(1.0 / 65536.0), C(1.0 / 65536.0));
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
// sf) is known: K1 and K2 read the material row from the table. VOL: the
// alive row `alive_f` the ray came in with; scatter: `md` from
// free_flight, whose sample caps the segment (:2321-2330).
template <bool NEE, bool ADV, int VOL = VOL_OFF>
__device__ __forceinline__ void shade(const float* p, const float* s_mat, int n_mats,
                                      const float* s_light, const int* s_ltype,
                                      int n_lights, const Surf& sf, Ray& r,
                                      float alive_f = 1.0f, Medium* md = nullptr) {
  if constexpr (VOL == VOL_OFF) {
    shade_miss(p, r);
    if (!r.hit) return;
    shade_core<NEE, ADV>(p, table_mat<ADV>(s_mat, n_mats, sf.mat_f), surface_hit(r.o, r.d, sf),
                         s_light, s_ltype, n_lights, r);
  } else {
    const bool inside = VOL == VOL_SCATTER ? md->inside : alive_f > 1.5f;
    if (VOL == VOL_SCATTER) {
      md->step = md->do_dist && (!r.hit || sf.t > md->t_sample);
      r.hit = r.hit && !md->step;
    }
    shade_miss(p, r, VOL == VOL_SCATTER && md->step);
    bool front = false;
    if (r.hit) {
      const Hit h = surface_hit(r.o, r.d, sf);
      front = h.front;
      shade_core<NEE, ADV, VOL>(p, table_mat<ADV, VOL>(s_mat, n_mats, sf.mat_f), h, s_light,
                                s_ltype, n_lights, r, inside, md, sf.t);
    } else if (VOL == VOL_SCATTER && md->step) {
      walk_step(p, r, *md);
    }
    r.alive_out = medium_row<VOL>(inside, r, r.toggled && front, sf.mat_f, *md);
  }
}

// Termination (miss, absorb, throughput cutoff, russian roulette) and the
// write-back of an alive ray (VOL: its alive row r.alive_out).
template <int VOL = VOL_OFF>
__device__ __forceinline__ void write_path(const float* p, Ray& r, float* state, long long R,
                                           long long i) {
  bool terminate = r.miss || (r.hit && !r.valid);
  terminate = terminate || (r.tp[0] * r.tp[0] + r.tp[1] * r.tp[1] + r.tp[2] * r.tp[2] < C(1e-18));
  if (p[P_BOUNCE] > p[P_RR_OFFSET]) {
    const float krr = pcg_next(r.rng);
    const float p_rr = minn(maxn(r.tp[0], maxn(r.tp[1], r.tp[2])), p[P_RR_INV_MIN]);
    const bool rr_kill = krr > p_rr;
    // the !miss guard keeps the throughput rows at their at-miss value
    if (!rr_kill && !r.miss) {
      const float sc = 1.0f / maxn(p_rr, C(1e-20));
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
  state[S_ALIVE * R + i] = terminate ? 0.0f : (VOL != VOL_OFF ? r.alive_out : 1.0f);
  state[S_MISS * R + i] = r.miss_rec;
  state[S_SEG * R + i] = state[S_SEG * R + i] + 1.0f + (r.do_trace ? 1.0f : 0.0f);
}

// The NEE contribution of an unoccluded shadow ray, then write_path.
template <int VOL = VOL_OFF>
__device__ __forceinline__ void finish(const float* p, Ray& r, bool occ, float* state,
                                       long long R, long long i) {
  if (r.do_trace && !occ)
    for (int c = 0; c < 3; ++c) r.rad[c] = r.rad[c] + r.cnee[c];
  write_path<VOL>(p, r, state, R, i);
}

// What K4 keeps of a ray across its shadow walk, once write_path has
// written the rest: the shadow ray, its cutout key (the salted PCG word
// after the shading, before the russian-roulette draw) and the radiance
// with the NEE contribution, written if the walk finds no occluder.
struct Shadow {
  float o[3], ld[3], ldist, rad[3];
  uint32_t key;
};

__device__ __forceinline__ Shadow shadow_of(const Ray& r) {
  Shadow sh;
  for (int c = 0; c < 3; ++c) {
    sh.o[c] = r.o[c];
    sh.ld[c] = r.ld[c];
    sh.rad[c] = r.rad[c] + r.cnee[c];
  }
  sh.ldist = r.ldist;
  sh.key = r.rng ^ SHADOW_SALT;
  return sh;
}

__device__ __forceinline__ void write_rad(const float rad[3], float* state, long long R,
                                          long long i) {
  for (int c = 0; c < 3; ++c) state[(S_RAD + c) * R + i] = rad[c];
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
    const float tlen = 1.0f / sqrtf(maxn(t[0] * t[0] + t[1] * t[1] + t[2] * t[2], C(1e-20)));
    for (int c = 0; c < 3; ++c) hit[(H_TAN + c) * R + i] = t[c] * tlen;
    hit[H_BS * R + i] = tbs;
    for (int k = H_BS + 1; k < HIT_ROWS_TAN; ++k) hit[k * R + i] = 0.0f;
  }
}

// A dead ray's hit buffer: every row 0.
__device__ __forceinline__ void write_dead(float* hit, int rows, long long R, long long i) {
  for (int k = 0; k < rows; ++k) hit[k * R + i] = 0.0f;
}

// ---------------------------------------------------------------------------
// K4's texture taps (render/texture.py sample_pool, render/material.py
// apply_textures and perturb_normal, as ops/split_ref.py material_rows
// runs them)
// ---------------------------------------------------------------------------

enum { WRAP_BLACK = 0, WRAP_CLAMP = 1, WRAP_REPEAT = 2, WRAP_MIRROR = 3 };
// which taps a launch makes: the textured parameters, and the normal map
// when the hit buffer carries the tangent rows; TAP_OPACITY only in
// retrace_kernel (K4 and tap_kernel never read opacity).
enum { TAP_BASE = 1, TAP_EMISSIVE = 2, TAP_METAL = 4, TAP_ROUGH = 8, TAP_NORMAL = 16,
       TAP_OPACITY = 32, TAP_SAMPLES = 63 };
// the material table's integer columns K4 stages, per material: the slots
// of base colour, emission, metallic, roughness and the normal map, then
// the channels of metallic and roughness (render/material.py MI_*)
constexpr int MI_COLS = 10;
constexpr int TAP_MI = 7;  // MI_* columns 0-3 and 5-7 (4, the opacity slot, is not read)
// the MI_* columns as tap_kernel and retrace_kernel read them, from global
// memory; the float table's opacity and opacity-threshold columns
enum { MI_BASE_TEX = 0, MI_METAL_TEX = 2, MI_OPACITY_TEX = 4, MI_NORMAL_TEX = 5,
       MI_METAL_CH = 6, MI_OPACITY_CH = 8 };
constexpr int MF_OPACITY = 6, MF_OPACITY_THRESH = 23;
constexpr int SLOT_I = 6;  // offset, width, height, wrap s, wrap t, sRGB
constexpr int SLOT_F = 8;  // scale, bias

// The texture pool (render/texture.py TexturePool) and the material
// table's integer columns, as K4 reads them.
struct Taps {
  const int* mat_i;     // [n_mats, 10] the MI_* columns
  const uint32_t* u32;  // [N + 1] each texel's rgba8 codes (an 8-bit pool)
  const int4* q22;      // [N + 1] each texel's 2x2 row (repeat baked in), or null
  const float4* f32;    // [N] each texel's linear RGBA (a float pool)
  const int *offset, *width, *height, *wrap_s, *wrap_t, *is_srgb;  // [T] a slot each
  const float *scale, *bias;  // [T, 4]
  const float* lut;           // [256] the sRGB decode of each 8-bit code
  int n_slots, mask;
};

// Shared-memory copies of what the taps read of the tables (stage_taps).
struct TapTables {
  const int* mi;      // [n_mats, TAP_MI]
  const int* slot_i;  // [T, SLOT_I]
  const float* slot_f;  // [T, SLOT_F]
  const float* lut;   // [256]
};

__host__ __device__ constexpr size_t tap_smem_words(int n_mats, int n_slots) {
  return (size_t)n_mats * TAP_MI + (size_t)n_slots * (SLOT_I + SLOT_F) + 256;
}

// The slot records, then the sRGB table (when `lut`), staged at smem.
__device__ __forceinline__ void stage_slots(const Taps& tx, int* smem, bool lut, TapTables& tt) {
  int* si = smem;
  float* sf = reinterpret_cast<float*>(si + tx.n_slots * SLOT_I);
  float* sl = sf + tx.n_slots * SLOT_F;
  for (int k = threadIdx.x; k < tx.n_slots; k += blockDim.x) {
    int* o = si + k * SLOT_I;
    o[0] = tx.offset[k];
    o[1] = tx.width[k];
    o[2] = tx.height[k];
    o[3] = tx.wrap_s[k];
    o[4] = tx.wrap_t[k];
    o[5] = tx.is_srgb[k];
  }
  for (int k = threadIdx.x; k < tx.n_slots * 4; k += blockDim.x) {
    sf[(k / 4) * SLOT_F + k % 4] = tx.scale[k];
    sf[(k / 4) * SLOT_F + 4 + k % 4] = tx.bias[k];
  }
  if (lut)
    for (int k = threadIdx.x; k < 256; k += blockDim.x) sl[k] = tx.lut[k];
  tt.slot_i = si;
  tt.slot_f = sf;
  tt.lut = sl;
}

// the words stage_slots stages
__host__ __device__ constexpr size_t slot_smem_words(int n_slots, bool lut) {
  return (size_t)n_slots * (SLOT_I + SLOT_F) + (lut ? 256 : 0);
}

// K4's tables: its materials' slot columns, then the slot records and the
// sRGB table
__device__ __forceinline__ TapTables stage_taps(const Taps& tx, int n_mats, int* smem) {
  TapTables tt;
  int* mi = smem;
  for (int k = threadIdx.x; k < n_mats * TAP_MI; k += blockDim.x)
    mi[k] = tx.mat_i[(k / TAP_MI) * MI_COLS + k % TAP_MI + (k % TAP_MI >= 4 ? 1 : 0)];
  tt.mi = mi;
  stage_slots(tx, mi + n_mats * TAP_MI, true, tt);
  return tt;
}

// torch.remainder of int32: the floor modulo (a negative a wraps to b - 1)
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// texture.py _wrap_coord: the wrapped index of texel coordinate x, and
// whether a `black` wrap keeps it
__device__ __forceinline__ int wrap_coord(int x, int size, int mode, bool& valid) {
  const int s = max(size, 1);
  const int rep = floor_mod(x, s);
  const int clamped = min(max(x, 0), s - 1);
  const int period = floor_mod(x, 2 * s);
  const int mirrored = period < s ? period : 2 * s - 1 - period;
  valid = mode != WRAP_BLACK || (x >= 0 && x < s);
  return mode == WRAP_REPEAT ? rep
                             : (mode == WRAP_CLAMP ? clamped : (mode == WRAP_MIRROR ? mirrored
                                                                                    : clamped));
}

// One texel's rgba8 codes as floats, code / 255 (in f32), the colour
// channels of an sRGB slot through the decode table (built by the twin's
// own expression, so equal to it on every code); zeros when not `valid`.
__device__ __forceinline__ float4 unpack_texel(uint32_t code, bool srgb, const float* lut,
                                               bool valid = true) {
  float c[4];
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (code >> (8 * k)) & 0xFFu;
    c[k] = (k < 3 && srgb) ? lut[b] : (float)b * C(1.0 / 255.0);
  }
  return valid ? make_float4(c[0], c[1], c[2], c[3]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One texel of a float pool, zeros when not `valid` (sample_pool's float
// branch: the gathered row, then the black-wrap select).
__device__ __forceinline__ float4 float_texel(const Taps& tx, int k, bool valid) {
  const float4 c = __ldg(tx.f32 + k);
  return valid ? c : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The bilinear tap of slot `slot` at (u, v) (sample_pool: v up, texel
// centres at half integers), its scale and bias applied: RGBA. FLT: the
// float pool's texels, through the wrap modes.
template <bool FLT>
__device__ __forceinline__ float4 tap(const Taps& tx, const TapTables& tt, int slot, float u,
                                      float v) {
  const int* si = tt.slot_i + slot * SLOT_I;
  const int off = si[0], w = si[1], h = si[2];
  const bool srgb = si[5] > 0;
  const float x = u * (float)w - 0.5f;
  const float y = (1.0f - v) * (float)h - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  float4 c00, c10, c01, c11;
  if constexpr (FLT) {
    bool vx0, vx1, vy0, vy1;
    const int xa = wrap_coord(x0, w, si[3], vx0), xb = wrap_coord(x0 + 1, w, si[3], vx1);
    const int ya = wrap_coord(y0, h, si[4], vy0), yb = wrap_coord(y0 + 1, h, si[4], vy1);
    c00 = float_texel(tx, off + ya * w + xa, vx0 && vy0);
    c10 = float_texel(tx, off + ya * w + xb, vx1 && vy0);
    c01 = float_texel(tx, off + yb * w + xa, vx0 && vy1);
    c11 = float_texel(tx, off + yb * w + xb, vx1 && vy1);
  } else if (tx.q22 != nullptr) {
    const int4 q = __ldg(tx.q22 + off + floor_mod(y0, h) * w + floor_mod(x0, w));
    c00 = unpack_texel((uint32_t)q.x, srgb, tt.lut);
    c10 = unpack_texel((uint32_t)q.y, srgb, tt.lut);
    c01 = unpack_texel((uint32_t)q.z, srgb, tt.lut);
    c11 = unpack_texel((uint32_t)q.w, srgb, tt.lut);
  } else {
    bool vx0, vx1, vy0, vy1;
    const int xa = wrap_coord(x0, w, si[3], vx0), xb = wrap_coord(x0 + 1, w, si[3], vx1);
    const int ya = wrap_coord(y0, h, si[4], vy0), yb = wrap_coord(y0 + 1, h, si[4], vy1);
    c00 = unpack_texel(__ldg(tx.u32 + off + ya * w + xa), srgb, tt.lut, vx0 && vy0);
    c10 = unpack_texel(__ldg(tx.u32 + off + ya * w + xb), srgb, tt.lut, vx1 && vy0);
    c01 = unpack_texel(__ldg(tx.u32 + off + yb * w + xa), srgb, tt.lut, vx0 && vy1);
    c11 = unpack_texel(__ldg(tx.u32 + off + yb * w + xb), srgb, tt.lut, vx1 && vy1);
  }
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const float* sf = tt.slot_f + slot * SLOT_F;
  auto mix = [&](float a, float b, float c, float d, int k) {
    return ((a * gx + b * fx) * gy + (c * gx + d * fx) * fy) * sf[k] + sf[4 + k];
  };
  return make_float4(mix(c00.x, c10.x, c01.x, c11.x, 0), mix(c00.y, c10.y, c01.y, c11.y, 1),
                     mix(c00.z, c10.z, c01.z, c11.z, 2), mix(c00.w, c10.w, c01.w, c11.w, 3));
}

// channel k of a tap (torch.gather of MI_*_CH), a select, not an indexed
// register
__device__ __forceinline__ float channel(const float4 t, int k) {
  return k == 0 ? t.x : (k == 1 ? t.y : (k == 2 ? t.z : t.w));
}

// One component of torch.linalg.cross on the card, a * b - c * d, rounded
// as PyTorch's CUDA kernel rounds it: nvcc contracts the first product
// into a fused multiply-add. This form and norm_sq's order are the ones
// that make the normal map bit-equal to the twin's (tests/test_torch_cuda.py
// test_taps_match_texture_stage, 1,048,576 random rows).
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// The squared length torch.linalg.vector_norm sums over a row of three on
// the card: each square rounded, summed left to right.
__device__ __forceinline__ float norm_sq(const float m[3]) {
  return (m[0] * m[0] + m[1] * m[1]) + m[2] * m[2];
}

// perturb_normal of one ray: the normal map's tap nm in the frame of the
// shading normal n, the tangent t and the bitangent cross(n, t) * sign,
// normalised; n in place.
__device__ __forceinline__ void perturb(const float4 nm, const float t[3], float tbs, float n[3]) {
  float b[3], m[3];
  b[0] = cross_term(n[1], t[2], n[2], t[1]) * tbs;
  b[1] = cross_term(n[2], t[0], n[0], t[2]) * tbs;
  b[2] = cross_term(n[0], t[1], n[1], t[0]) * tbs;
  const float nz = maxn(nm.z, C(1e-3));
  for (int c = 0; c < 3; ++c) m[c] = (nm.x * t[c] + nm.y * b[c]) + nz * n[c];
  const float len = maxn(sqrtf(norm_sq(m)), C(1e-20));
  for (int c = 0; c < 3; ++c) n[c] = m[c] / len;
}

// K4's view of one alive ray: the hit flag, its shading state (with the
// tangent rows when the buffer has them), and its material: the table's
// row, the textured parameters of `tx.mask` tapped where the material
// binds a slot, and the shading normal normal-mapped (TAP_NORMAL).
template <bool ADV, int VOL = VOL_OFF, bool FLT = false>
__device__ __forceinline__ void read_hit(const float* hit, bool hit_tan, const float* s_mat,
                                         int n_mats, const Taps& tx, const TapTables& tt,
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
  const bool nmap = (tx.mask & TAP_NORMAL) != 0;
  if (h.has_tan || nmap) {
    for (int c = 0; c < 3; ++c) h.tan[c] = hit[(H_TAN + c) * R + i];
    h.tbs = hit[H_BS * R + i];
  }
  const float mat_f = hit[H_MAT * R + i];
  m = table_mat<ADV, VOL>(s_mat, n_mats, mat_f);
  if (tx.mask == 0 || !r.hit) return;
  const float u = hit[H_UV * R + i], v = hit[(H_UV + 1) * R + i];
  const int* mi = tt.mi + TAP_MI * min(max((int)rintf(mat_f), 0), n_mats - 1);
  if ((tx.mask & TAP_BASE) && mi[0] >= 0) {
    const float4 t = tap<FLT>(tx, tt, mi[0], u, v);
    m.base[0] = t.x;
    m.base[1] = t.y;
    m.base[2] = t.z;
  }
  if ((tx.mask & TAP_EMISSIVE) && mi[1] >= 0) {
    const float4 t = tap<FLT>(tx, tt, mi[1], u, v);
    m.em[0] = t.x;
    m.em[1] = t.y;
    m.em[2] = t.z;
  }
  if ((tx.mask & TAP_METAL) && mi[2] >= 0)
    m.metallic = channel(tap<FLT>(tx, tt, mi[2], u, v), mi[5]);
  if ((tx.mask & TAP_ROUGH) && mi[3] >= 0)
    m.roughness = channel(tap<FLT>(tx, tt, mi[3], u, v), mi[6]);
  if (nmap && mi[4] >= 0) perturb(tap<FLT>(tx, tt, mi[4], u, v), h.tan, h.tbs, h.n);
}

// ---------------------------------------------------------------------------
// K1 (bounce), K3 (trace) and K4 (shade) over the resident table
// ---------------------------------------------------------------------------

// A resident table's TriBvh (ops/bvh.py): nodes, kids and the leaf rows,
// four quads a triangle: (TR_N xyz, TR_D0), (TR_R1, c1), (TR_R2, c2) and
// (table index, camera pass probability, shadow pass probability, 0).
struct TriTree {
  const float* nodes;
  const int* kids;
  const float* rows;
};

// The closest hit of one ray over a resident table, walking its tree:
// the smallest t of a candidate that passes tri_hit, ties to the lower
// table index, so the winner is the serial loop's (strict '<', the first
// of equal t). CUT: a candidate that would win is a hit only if its
// cutout draw with `key` passes the camera probability (a draw depends on
// the ray and the triangle alone, so the same candidates pass in any
// order).
template <bool CUT>
__device__ __forceinline__ void tree_closest(const TriTree& tr, const float o[3],
                                             const float d[3], float tmin, uint32_t key,
                                             float& best_t, float& bu, float& bv, int& win) {
  best_t = FMAX;
  bu = bv = 0.0f;
  win = -1;
  gatling::tree_walk(tr.nodes, tr.kids, o, d, tmin, FMAX, [&](int first, int count, float& run) {
    const float4* q = reinterpret_cast<const float4*>(tr.rows) + 4 * (size_t)first;
    for (int j = 0; j < count; ++j, q += 4) {
      float tt, u, v;
      if (!tri_hit(__ldg(q), __ldg(q + 1), __ldg(q + 2), o, d, tmin, tt, u, v)) continue;
      const float4 q3 = __ldg(q + 3);
      const int idx = (int)q3.x;
      if (!(tt < best_t || (tt == best_t && idx < win))) continue;
      if (CUT && !(cutout_xi(key, (uint32_t)idx) < q3.y)) continue;
      best_t = tt;
      bu = u;
      bv = v;
      win = idx;
    }
    run = best_t;
    return false;
  });
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

// The NEE shadow ray of a ray that traces one: any candidate in
// (SHADOW_TMIN, ldist), with CUT only one whose draw (the salted PCG word)
// passes the shadow probability; the walk ends at the first.
template <bool CUT>
__device__ __forceinline__ bool tree_occluded(const TriTree& tr, const float o[3],
                                              const float ld[3], float ldist, uint32_t key) {
  bool occ = false;
  gatling::tree_walk(tr.nodes, tr.kids, o, ld, C(SHADOW_TMIN), ldist,
                     [&](int first, int count, float&) {
    const float4* q = reinterpret_cast<const float4*>(tr.rows) + 4 * (size_t)first;
    for (int j = 0; j < count; ++j, q += 4) {
      float tt, u, v;
      if (!tri_hit(__ldg(q), __ldg(q + 1), __ldg(q + 2), o, ld, C(SHADOW_TMIN), tt, u, v) ||
          !(tt < ldist))
        continue;
      if (CUT && !(cutout_xi(key, (uint32_t)__ldg(q + 3).x) < __ldg(q + 3).z)) continue;
      occ = true;
      return true;
    }
    return false;
  });
  return occ;
}

template <bool NEE, bool ADV, bool CUT, int VOL>
__global__ void __launch_bounds__(THREADS)
bounce_kernel(const float* __restrict__ params, const float* __restrict__ tris, int ld,
              TriTree tree, const float* __restrict__ mats, int n_mats,
              const float* __restrict__ lights, const int8_t* __restrict__ ltypes,
              int n_lights, float* __restrict__ state, long long R) {
  extern __shared__ float4 smem4[];
  float* s_mat = reinterpret_cast<float*>(smem4);
  float* s_light = s_mat + n_mats * MAT_COLS;
  int* s_ltype = reinterpret_cast<int*>(s_light + n_lights * LIGHT_COLS);

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  // dead block: every ray passes through unchanged
  if (!__syncthreads_or(alive)) return;
  stage_tables(s_mat, mats, n_mats, s_light, lights, s_ltype, ltypes, n_lights);
  __syncthreads();
  if (!alive) return;  // no block-wide step follows

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);

  Ray r = {};
  Medium md = {};
  for (int c = 0; c < 3; ++c) {
    r.o[c] = state[(S_OX + c) * R + i];
    r.d[c] = state[(S_DX + c) * R + i];
  }
  const float alive_f = VOL != VOL_OFF ? state[S_ALIVE * R + i] : 0.0f;
  if (VOL == VOL_SCATTER) {
    load_path(r, state, R, i);
    free_flight(p, s_mat, n_mats, alive_f, r, md);
  }
  // the resident search keys its cutout draws off the PCG word after the
  // free-flight draws (:2311)
  const uint32_t key =
      CUT ? (VOL == VOL_SCATTER ? r.rng : __float_as_uint(state[S_RNG * R + i])) : 0u;

  float best_t, bu, bv;
  int win;
  tree_closest<CUT>(tree, r.o, r.d, p[P_TMIN], key, best_t, bu, bv, win);
  if (VOL != VOL_SCATTER) load_path(r, state, R, i);
  r.hit = best_t < FMAX;
  shade<NEE, ADV, VOL>(p, s_mat, n_mats, s_light, s_ltype, n_lights,
                       resident_surf(tris, ld, best_t, bu, bv, win), r, alive_f, &md);
  const bool occ = NEE && r.do_trace &&
                   tree_occluded<CUT>(tree, r.o, r.ld, r.ldist, CUT ? r.rng ^ SHADOW_SALT : 0u);
  finish<VOL>(p, r, occ, state, R, i);
}

// K3, resident: closest hit and shading state into the hit buffer.
template <bool TAN, bool CUT>
__global__ void __launch_bounds__(THREADS)
trace_kernel(const float* __restrict__ params, const float* __restrict__ tris, int ld,
             TriTree tree, const float* __restrict__ state, long long R,
             float* __restrict__ hit) {
  const int rows = TAN ? HIT_ROWS_TAN : HIT_ROWS;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  if (!(state[S_ALIVE * R + i] > 0.5f)) {
    write_dead(hit, rows, R, i);
    return;
  }
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = state[(S_OX + c) * R + i];
    d[c] = state[(S_DX + c) * R + i];
  }
  const uint32_t key = CUT ? __float_as_uint(state[S_RNG * R + i]) : 0u;
  float best_t, bu, bv;
  int win;
  tree_closest<CUT>(tree, o, d, __ldg(params + P_TMIN), key, best_t, bu, bv, win);
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
  write_hit<TAN>(hit, R, i, best_t < FMAX, o, d, sf, uv, tan, tbs);
}

// K4's shared memory: the material and light tables (stage_tables), then
// the taps' tables (stage_taps) when the launch taps. Returns false for a
// block whose rays are all dead (nothing to do); every thread reaches the
// barriers.
__device__ __forceinline__ bool stage_k4(bool alive, const float* mats, int n_mats,
                                         const float* lights, const int8_t* ltypes,
                                         int n_lights, const Taps& tx, float*& s_mat,
                                         float*& s_light, int*& s_ltype, TapTables& tt) {
  extern __shared__ float4 smem4[];
  s_mat = reinterpret_cast<float*>(smem4);
  s_light = s_mat + n_mats * MAT_COLS;
  s_ltype = reinterpret_cast<int*>(s_light + n_lights * LIGHT_COLS);
  if (!__syncthreads_or(alive)) return false;
  stage_tables(s_mat, mats, n_mats, s_light, lights, s_ltype, ltypes, n_lights);
  tt = {};
  if (tx.mask != 0) tt = stage_taps(tx, n_mats, s_ltype + n_lights);
  __syncthreads();
  return true;
}

// K4's shading of one alive ray up to its shadow walk: the hit buffer and
// the taps (read_hit), the shading core, and every row of the path state
// written (write_path, the radiance without the NEE contribution).
// Returns whether the ray traces a shadow ray, which `sh` then holds.
template <bool NEE, bool ADV, int VOL, bool FLT>
__device__ __forceinline__ bool shade_split(const float* p, const float* s_mat, int n_mats,
                                            const float* s_light, const int* s_ltype,
                                            int n_lights, const float* hit, bool hit_tan,
                                            const Taps& tx, const TapTables& tt, float* state,
                                            long long R, long long i, Shadow& sh) {
  Ray r = {};
  for (int c = 0; c < 3; ++c) {
    r.o[c] = state[(S_OX + c) * R + i];
    r.d[c] = state[(S_DX + c) * R + i];
  }
  load_path(r, state, R, i);
  Hit h;
  Mat m;
  read_hit<ADV, VOL, FLT>(hit, hit_tan, s_mat, n_mats, tx, tt, R, i, r, h, m);
  shade_miss(p, r);
  const bool inside = VOL != VOL_OFF && state[S_ALIVE * R + i] > 1.5f;
  if (r.hit) shade_core<NEE, ADV, VOL>(p, m, h, s_light, s_ltype, n_lights, r, inside);
  if (VOL != VOL_OFF) r.alive_out = medium_row<VOL_ABSORB>(inside, r, false, 0.0f, Medium{});
  const bool trace = NEE && r.do_trace;
  if (trace) sh = shadow_of(r);  // before write_path's russian-roulette draw
  write_path<VOL>(p, r, state, R, i);
  return trace;
}

// K4, resident: shading from the hit buffer with its own texture taps, the
// path state written; then the NEE shadow ray walks the resident table's
// tree as in K1 and writes the radiance if unoccluded.
template <bool NEE, bool ADV, bool CUT, int VOL, bool FLT>
__global__ void __launch_bounds__(THREADS)
shade_kernel(const float* __restrict__ params, TriTree tree, const float* __restrict__ mats,
             int n_mats, const float* __restrict__ lights, const int8_t* __restrict__ ltypes,
             int n_lights, float* __restrict__ state, long long R,
             const float* __restrict__ hit, int hit_tan, Taps tx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  float *s_mat, *s_light;
  int* s_ltype;
  TapTables tt;
  if (!stage_k4(alive, mats, n_mats, lights, ltypes, n_lights, tx, s_mat, s_light, s_ltype, tt))
    return;
  if (!alive) return;  // no block-wide step follows

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);
  Shadow sh;
  if (shade_split<NEE, ADV, VOL, FLT>(p, s_mat, n_mats, s_light, s_ltype, n_lights, hit,
                                      hit_tan != 0, tx, tt, state, R, i, sh) &&
      !tree_occluded<CUT>(tree, sh.o, sh.ld, sh.ldist, sh.key))
    write_rad(sh.rad, state, R, i);
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
  // one tree per cluster of tris, in the cluster's frame (ops/bvh.py ClusterBvh)
  const float* cnodes;  // [M, 8] padded node boxes
  const int* ckids;     // [M, 2] children, or (-1 - first row, count) for a leaf
  const float* crows;   // [m, 16] leaf rows: the CLU_N, CLU_R1, CLU_R2 quads, lane,
                        // CLU_OPAC, CLU_OPAC_SH, 0
  const int* croot;     // [C] each cluster's root node
};

// floats per clustered triangle row: 40, or 56 with the tangent rows
template <bool TAN>
__host__ __device__ constexpr int clu_rows() { return TAN ? CLU_ROWS_TAN : 40; }

// safe_inv and the slab tests (tree_walk.cuh) serve the TLAS walk too
using gatling::padded_origin;
using gatling::safe_inv;
using gatling::slab;

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
// f32) from its plane and barycentric quads: t from the plane quad, u and
// v as (r.o + c) + t (r.d).
__device__ __forceinline__ bool clu_test(const float4 q0, const float4 q1, const float4 q2,
                                         const float o[3], const float d[3], float tmin,
                                         float tcap, float& tt) {
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

constexpr int CLU_STACK = 8;  // a cluster tree's traversal stack (ops/bvh.py CLUSTER_STACK)

// The walk: a stack traversal of the TLAS, nearer child first; at a leaf,
// each entry's box, then its fan's non-empty cluster boxes: a closest-hit
// walk visits the survivors nearest entry first (ties to the lower slot),
// each while its entry t is not above `run`, an any-hit walk each as it
// tests it, in stored order (measured faster there: PERF.md); in a
// cluster, a walk of its tree (in the entry's frame when instanced, the
// boxes grown at run time by padded_origin) and the cluster test of each
// row of the leaves it reaches. Boxes are tested over [tmin, run] (the
// trees' over [tmin less 2^-10 of |tmin|, run]), run being tcap, or the
// best hit so far for a closest-hit walk. ANY: return true at the first
// valid triangle. Else: keep the smallest t, ties to the lower global
// triangle index (fan slot * 128 + lane), in (best, win): the order of
// the visits does not change the winner, and a node is skipped only when
// no triangle under it can pass with a t that could still win. CUT: a
// candidate is valid only if cutout_xi(key, global index) falls below its
// pass probability: the placement's (instanced) or the triangle row's,
// the shadow column for ANY.
template <bool INST, bool ANY, bool TAN, bool CUT>
__device__ bool walk(const Walk& w, const float o[3], const float d[3], float tmin,
                     float tcap, uint32_t key, float& best, int& win) {
  float iv[3];
  for (int c = 0; c < 3; ++c) iv[c] = safe_inv(d[c]);
  const float tlo = tmin - fabsf(tmin) * (1.0f / 1024.0f);
  // the cluster trees' frame: the world's when flattened, else the entry's
  float ol[3], dl[3], ivl[3], olo[3], ohi[3];
  for (int c = 0; c < 3; ++c) {
    ol[c] = o[c];
    dl[c] = d[c];
    ivl[c] = iv[c];
  }
  if (!INST) padded_origin(o, olo, ohi);
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
      float pass = 1.0f;
      if (INST) {
        to_local(w.inst + INST_COLS * e, o, d, ol, dl);
        for (int c = 0; c < 3; ++c) ivl[c] = safe_inv(dl[c]);
        padded_origin(ol, olo, ohi);
        if (CUT) pass = __ldg(w.inst + INST_COLS * e + (ANY ? INST_PASS_SH : INST_PASS));
      }
      // a fan slot's cluster: its tree, the cluster test in its leaves
      auto cluster = [&](int slot) {
        return gatling::tree_walk_from<CLU_STACK>(
            w.cnodes, w.ckids, __ldg(w.croot + __ldg(w.cmap + slot)), olo, ohi, ivl, tlo, run,
            [&](int first, int count, float& run_) {
              const float4* q = reinterpret_cast<const float4*>(w.crows) + 4 * (size_t)first;
              for (int r = 0; r < count; ++r, q += 4) {
                float tt;
                if (!clu_test(__ldg(q), __ldg(q + 1), __ldg(q + 2), ol, dl, tmin, tcap, tt))
                  continue;
                const float4 q3 = __ldg(q + 3);
                const int gid = slot * CLUSTER_SIZE + (int)q3.x;
                if (!ANY && !(tt < best || (tt == best && gid < win))) continue;
                if (CUT) {
                  const float prob = INST ? pass : (ANY ? q3.z : q3.y);
                  if (!(cutout_xi(key, (uint32_t)gid) < prob)) continue;
                }
                if (ANY) return true;
                best = tt;
                win = gid;
              }
              if (!ANY) run_ = fminf(tcap, best);
              return false;
            });
      };
      if constexpr (ANY) {
        // any hit: the fan in stored order, each box tested as it comes,
        // since the first occluder ends the walk and `run` never falls
        for (int b = 0; b < L1_FAN; ++b) {
          const float* box = w.l2 + 8 * (e * L1_FAN + b);
          if (__ldg(box) > __ldg(box + 3)) continue;  // empty: pad slot
          if (slab(box, o, iv, tmin, run, te) && cluster(e * L1_FAN + b)) return true;
        }
      } else {
        // closest hit: the fan's cluster boxes, then the survivors nearest
        // entry first (ties to the lower slot), while not behind the best
        float tf[L1_FAN];  // the survivors' entry t, +inf for the rest
        unsigned mask = 0u;
#pragma unroll
        for (int b = 0; b < L1_FAN; ++b) {
          const float* box = w.l2 + 8 * (e * L1_FAN + b);
          tf[b] = INFINITY;
          if (__ldg(box) > __ldg(box + 3)) continue;  // empty: pad slot
          if (slab(box, o, iv, tmin, run, te)) {
            mask |= 1u << b;
            tf[b] = te;
          }
        }
        while (mask) {
          int b_min = 0;
          float t_min = INFINITY;
#pragma unroll
          for (int b = 0; b < L1_FAN; ++b) {
            if (tf[b] < t_min) {
              t_min = tf[b];
              b_min = b;
            }
          }
          if (t_min > run) break;  // the nearest survivor lies behind the best hit
#pragma unroll
          for (int b = 0; b < L1_FAN; ++b)
            if (b == b_min) tf[b] = INFINITY;
          mask &= ~(1u << b_min);
          cluster(e * L1_FAN + b_min);
        }
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
__device__ __forceinline__ bool walk_occluded(const Walk& w, const float o[3], const float ld[3],
                                              float ldist, uint32_t key) {
  float unused_t = FMAX;
  int unused_win = -1;
  return walk<INST, true, TAN, CUT>(w, o, ld, C(SHADOW_TMIN), ldist, CUT ? key : 0u, unused_t,
                                    unused_win);
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
    const float glen = 1.0f / sqrtf(maxn(g[0] * g[0] + g[1] * g[1] + g[2] * g[2], C(1e-20)));
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

template <bool NEE, bool INST, bool TAN, bool ADV, bool CUT, int VOL>
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
  // the walk keys its cutout draws off the PCG word at the start of the
  // bounce (:1345), before the free-flight draws
  const uint32_t key = CUT ? __float_as_uint(state[S_RNG * R + i]) : 0u;
  Medium md = {};
  const float alive_f = VOL != VOL_OFF ? state[S_ALIVE * R + i] : 1.0f;
  if (VOL == VOL_SCATTER) {
    load_path(r, state, R, i);
    free_flight(p, s_mat, n_mats, alive_f, r, md);
  }
  const int win = walk_closest<INST, TAN, CUT>(w, r.o, r.d, p[P_TMIN], key);
  if (VOL != VOL_SCATTER) load_path(r, state, R, i);
  r.hit = win >= 0;
  Surf sf = {};
  sf.t = FMAX;
  if (r.hit) pass2<INST, TAN>(w, r.o, r.d, win, sf);
  shade<NEE, ADV, VOL>(p, s_mat, n_mats, s_light, s_ltype, n_lights, sf, r, alive_f, &md);
  const bool occ = NEE && r.do_trace &&
                   walk_occluded<INST, TAN, CUT>(w, r.o, r.ld, r.ldist, r.rng ^ SHADOW_SALT);
  finish<VOL>(p, r, occ, state, R, i);
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

// K4 over the walk: shading from the hit buffer with its own texture taps,
// the path state written; then the NEE shadow ray's any-hit walk.
template <bool NEE, bool INST, bool TAN, bool ADV, bool CUT, int VOL, bool FLT>
__global__ void __launch_bounds__(THREADS)
shade_walk_kernel(const float* __restrict__ params, Walk w, const float* __restrict__ mats,
                  int n_mats, const float* __restrict__ lights,
                  const int8_t* __restrict__ ltypes, int n_lights, float* __restrict__ state,
                  long long R, const float* __restrict__ hit, int hit_tan, Taps tx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool alive = i < R && state[S_ALIVE * R + i] > 0.5f;
  float *s_mat, *s_light;
  int* s_ltype;
  TapTables tt;
  if (!stage_k4(alive, mats, n_mats, lights, ltypes, n_lights, tx, s_mat, s_light, s_ltype, tt))
    return;
  if (!alive) return;  // no block-wide step follows

  float p[PARAMS_LEN];
  for (int k = 0; k < PARAMS_LEN; ++k) p[k] = __ldg(params + k);
  Shadow sh;
  if (shade_split<NEE, ADV, VOL, FLT>(p, s_mat, n_mats, s_light, s_ltype, n_lights, hit,
                                      hit_tan != 0, tx, tt, state, R, i, sh) &&
      !walk_occluded<INST, TAN, CUT>(w, sh.o, sh.ld, sh.ldist, sh.key))
    write_rad(sh.rad, state, R, i);
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

// K4's: the tables, and the taps' when it taps
size_t shade_smem(int n_mats, int n_lights, const Taps& tx) {
  return table_smem(n_mats, n_lights) +
         (tx.mask != 0 ? sizeof(int) * tap_smem_words(n_mats, tx.n_slots) : 0);
}

__global__ void __launch_bounds__(THREADS)
cutout_draws_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ ids,
                    float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = cutout_xi(keys[i], ids[i]);
}

// K4t, K4's taps alone (ops/bounce.py tap_rows; replaces the texture stage
// gatling_tpu/render/fused.py:241 _material_rows where the fused sample
// loop's bounce-0 peel reads it): out [7, R] holds the rows the peel's
// first-hit AOVs read, each hit ray's base colour (3), metallic and
// shading normal (3), written only for hit rays: the material table's
// columns with the base colour and metallic tapped (tx.mask) where the
// material binds a slot, the normal normal-mapped (TAP_NORMAL). FLT: over
// a float pool. What bounds it: bytes, H_HIT of every ray; of the hit
// rays H_MAT, the normal rows, the uv rows when it taps and the tangent
// rows when it normal-maps; the 7 rows written; the texels its taps touch.
// Its design for that: one thread a ray, which reads H_HIT first and
// stops a missed ray there; the materials' columns read through the
// read-only cache, the slot records and the sRGB table staged in shared
// memory only when it taps, so that an untextured launch stages nothing
// and never syncs. Four rays a thread with float4 rows, and two with
// float2, ran slower on the peel waves (PERF.md, section 6): fewer
// threads hid less of the two dependent reads, and the four-ray instance
// kept its arrays on the stack.
enum { O_BASE = 0, O_METAL = 3, O_N = 4 };  // the first of out's rows of each

template <bool FLT>
__global__ void __launch_bounds__(THREADS)
tap_kernel(const float* __restrict__ mats, int n_mats, const float* __restrict__ hit,
           long long R, Taps tx, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  TapTables tt = {};
  if (tx.mask & TAP_SAMPLES) {
    stage_slots(tx, reinterpret_cast<int*>(smem4), !FLT, tt);
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R || !(__ldg(hit + H_HIT * R + i) > 0.5f)) return;
  const int mat = min(max((int)rintf(__ldg(hit + H_MAT * R + i)), 0), n_mats - 1);
  const float* m = mats + (long long)mat * MAT_COLS;
  const int* mi = tx.mat_i + mat * MI_COLS;
  float u = 0.0f, v = 0.0f;
  if (tx.mask & TAP_SAMPLES) {
    u = __ldg(hit + H_UV * R + i);
    v = __ldg(hit + (H_UV + 1) * R + i);
  }
  float base[3];
  for (int c = 0; c < 3; ++c) base[c] = __ldg(m + c);
  const int base_slot = (tx.mask & TAP_BASE) ? __ldg(mi + MI_BASE_TEX) : -1;
  if (base_slot >= 0) {
    const float4 t = tap<FLT>(tx, tt, base_slot, u, v);
    base[0] = t.x;
    base[1] = t.y;
    base[2] = t.z;
  }
  for (int c = 0; c < 3; ++c) out[(O_BASE + c) * R + i] = base[c];
  float metal = __ldg(m + 3);
  const int metal_slot = (tx.mask & TAP_METAL) ? __ldg(mi + MI_METAL_TEX) : -1;
  if (metal_slot >= 0) metal = channel(tap<FLT>(tx, tt, metal_slot, u, v), __ldg(mi + MI_METAL_CH));
  out[O_METAL * R + i] = metal;
  float n[3];
  for (int c = 0; c < 3; ++c) n[c] = __ldg(hit + (H_N + c) * R + i);
  const int normal_slot = (tx.mask & TAP_NORMAL) ? __ldg(mi + MI_NORMAL_TEX) : -1;
  if (normal_slot >= 0) {
    float t[3];
    for (int c = 0; c < 3; ++c) t[c] = __ldg(hit + (H_TAN + c) * R + i);
    perturb(tap<FLT>(tx, tt, normal_slot, u, v), t, __ldg(hit + H_BS * R + i), n);
  }
  for (int c = 0; c < 3; ++c) out[(O_N + c) * R + i] = n[c];
}

// The textured-cutout re-trace's draw of round `rnd` (ops/bounce.py
// retrace_draws, gatling_tpu/render/fused.py:342-346): a hash of the ray's
// PCG word, salted by the round, in [0, 1).
__device__ __forceinline__ float retrace_xi(uint32_t salt, int rnd) {
  uint32_t h = salt ^ (0x9E3779B9u + 0x85EBu * (uint32_t)rnd);
  h = (h ^ (h >> 16)) * 0x21F0AAADu;
  h = (h ^ (h >> 15)) * 0x735A2D97u;
  return (float)((h ^ (h >> 15)) >> 8) * C(1.0 / (1 << 24));
}

// K4r, one round of the textured-cutout re-trace (ops/bounce.py
// retrace_round; replaces the XLA round gatling_tpu/render/fused.py:337-358,
// whose twin ops/bounce.py retrace_round_ref runs it in PyTorch): an alive
// ray whose hit's material binds an opacity slot draws against
// cutout_opacity of the opacity tapped at its uv (the table's without
// TAP_OPACITY) and the table's threshold; a rejected ray's origin moves
// past the surface (offset_ray_origin of H_POS along -H_GN) in state rows
// 0-2 and masked rows 0-2, in place; masked row 13, the alive row K3
// re-traces, becomes state row 13 where rejected, else 0. `masked` is a
// copy of the state made once a bounce: its rows 3-12 are the state's, and
// its rows 0-2 are the state's wherever K3 reads them. What bounds it:
// bytes, the alive row read and masked row 13 written on every ray, H_HIT
// of the alive, H_MAT of the alive hits, the PCG row and uv of the
// candidates (and their texels), six hit rows read and six rows written
// of the rejected. Its design: one thread a ray, each row read only while
// the ray is still a candidate; the slot records and the sRGB table
// staged only when it taps. With -fmad=false the origin's multiply, then
// add, rounds as the twin's, and the draw is integer arithmetic: the
// kernel is bit-equal to the twin.
template <bool FLT>
__global__ void __launch_bounds__(THREADS)
retrace_kernel(const float* __restrict__ mats, int n_mats, const float* __restrict__ hit,
               long long R, Taps tx, int rnd, float* __restrict__ state,
               float* __restrict__ masked) {
  extern __shared__ float4 smem4[];
  TapTables tt = {};
  if (tx.mask & TAP_OPACITY) {
    stage_slots(tx, reinterpret_cast<int*>(smem4), !FLT, tt);
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const float alive = state[S_ALIVE * R + i];
  bool reject = false;
  if (alive > 0.5f && __ldg(hit + H_HIT * R + i) > 0.5f) {
    const int mat = min(max((int)rintf(__ldg(hit + H_MAT * R + i)), 0), n_mats - 1);
    const int* mi = tx.mat_i + mat * MI_COLS;
    const int slot = __ldg(mi + MI_OPACITY_TEX);
    if (slot >= 0) {
      const float* m = mats + (long long)mat * MAT_COLS;
      float opacity = __ldg(m + MF_OPACITY);
      if (tx.mask & TAP_OPACITY)
        opacity = channel(tap<FLT>(tx, tt, slot, __ldg(hit + H_UV * R + i),
                                   __ldg(hit + (H_UV + 1) * R + i)),
                          __ldg(mi + MI_OPACITY_CH));
      const float thresh = __ldg(m + MF_OPACITY_THRESH);
      const float pass = thresh > 0.0f ? (opacity >= thresh ? 1.0f : 0.0f) : opacity;
      reject = retrace_xi(__float_as_uint(state[S_RNG * R + i]), rnd) >= pass;
    }
  }
  if (reject) {
    for (int c = 0; c < 3; ++c) {
      const float p = __ldg(hit + (H_POS + c) * R + i);
      const float g = -__ldg(hit + (H_GN + c) * R + i);
      const float o = p + g * maxn(fabsf(p) * C(1.0 / 65536.0), C(1.0 / 65536.0));
      state[(S_OX + c) * R + i] = o;
      masked[(S_OX + c) * R + i] = o;
    }
  }
  masked[S_ALIVE * R + i] = reject ? alive : 0.0f;
}

unsigned grid(long long n_rays) { return (unsigned)((n_rays + THREADS - 1) / THREADS); }

// f(std::true_type{}) or f(std::false_type{}): a runtime flag to a
// template argument (decltype(flag)::value inside f)
template <typename F>
int with_flag(bool v, F&& f) {
  return v ? f(std::true_type{}) : f(std::false_type{});
}

// a volume mode to a template argument: LO..HI, or cudaErrorInvalidValue
// for a mode that has no instance in this entry point
template <int LO, int HI, typename F>
int with_vol(int v, F&& f) {
  if (v < LO || v > HI) return (int)cudaErrorInvalidValue;
  if constexpr (LO < HI) {
    if (v > LO) return with_vol<LO + 1, HI>(v, f);
  }
  return f(std::integral_constant<int, LO>{});
}

}  // namespace

// the launch configuration of an entry point below: one thread per ray
#define CONFIG(SMEM) <<<grid(n_rays), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>
// the compile-time value of a flag passed through with_flag
#define V(flag) decltype(flag)::value

extern "C" {

// Every entry point launches on `stream` and returns a cudaError_t code
// (0 = launched). Resident tables are [n_tris, ld] (ld 32, or 48 with
// tangent rows; 36 or 52 with the cutout columns) with their TriBvh
// (nodes, kids, leaf rows); walk tables carry their row length (40, or
// 56). `adv`, `cut` and `vol` pick the branches.
#define RESIDENT_TABLES \
  const float *tris, int ld, const float *nodes, const int *kids, const float *trows
#define TREE_STRUCT {nodes, kids, trows}

// K4's texture pool and material slot columns (ops/bounce.py
// BounceKernel.launch_shade): the MI_* table, the 8-bit texels and their
// 2x2 rows (q22 null unless every slot wraps repeat), the float texels
// (read by the FLT instances alone), the per-slot offset,
// width, height, wrap modes, sRGB flag, scale and bias, the sRGB decode
// table, the slot count and the TAP_* mask (0: no taps).
#define TAP_ARGS                                                                           \
  const int *mat_i, const uint32_t *u32, const int *q22, const float *f32, const int *t_off, \
      const int *t_w, const int *t_h, const int *t_ws, const int *t_wt, const int *t_srgb,   \
      const float *t_scale, const float *t_bias, const float *lut, int n_slots, int taps
#define TAP_STRUCT                                                                           \
  {mat_i, u32, reinterpret_cast<const int4*>(q22), reinterpret_cast<const float4*>(f32),      \
   t_off, t_w, t_h, t_ws, t_wt, t_srgb, t_scale, t_bias, lut, n_slots, taps}

// K4's taps alone on hit buffer `hit` into out [7, n_rays] (tap_kernel):
// gatling_tap_rows over an 8-bit pool, gatling_tap_rows_flt over a float one.
#define TAP_ROWS(NAME, FLT_)                                                               \
  int NAME(const float* mats, int n_mats, const float* hit, long long n_rays, TAP_ARGS,   \
           float* out, void* stream) {                                                    \
    if (n_rays <= 0) return 0;                                                             \
    const Taps tx = TAP_STRUCT;                                                            \
    const size_t smem =                                                                    \
        (taps & TAP_SAMPLES) ? sizeof(int) * slot_smem_words(n_slots, !FLT_) : 0;          \
    if (int err = allow_smem(tap_kernel<FLT_>, smem)) return err;                          \
    tap_kernel<FLT_> CONFIG(smem)(mats, n_mats, hit, n_rays, tx, out);                     \
    return (int)cudaGetLastError();                                                        \
  }

// K4r, a textured-cutout re-trace round `rnd` on hit buffer `hit`, state
// [16, n_rays] and its masked copy, in place (retrace_kernel):
// gatling_retrace_round over an 8-bit pool, gatling_retrace_round_flt over
// a float one.
#define RETRACE_ROUND(NAME, FLT_)                                                         \
  int NAME(const float* mats, int n_mats, const float* hit, long long n_rays, TAP_ARGS,   \
           int rnd, float* state, float* masked, void* stream) {                          \
    if (n_rays <= 0) return 0;                                                             \
    const Taps tx = TAP_STRUCT;                                                            \
    const size_t smem =                                                                    \
        (taps & TAP_OPACITY) ? sizeof(int) * slot_smem_words(n_slots, !FLT_) : 0;          \
    if (int err = allow_smem(retrace_kernel<FLT_>, smem)) return err;                      \
    retrace_kernel<FLT_> CONFIG(smem)(mats, n_mats, hit, n_rays, tx, rnd, state, masked);  \
    return (int)cudaGetLastError();                                                        \
  }

// K4, resident: shade state [16, n_rays] in place from the hit buffer
// (hit_tan: with the tangent rows), tapping the textures itself: an 8-bit
// pool (gatling_shade_resident) or a float one (gatling_shade_resident_flt).
#define SHADE_RESIDENT(NAME, FLT_)                                                            \
  int NAME(const float* params, RESIDENT_TABLES, const float* mats, int n_mats,               \
           const float* lights, const int8_t* light_types, int n_lights, float* state,        \
           long long n_rays, const float* hit, int hit_tan, TAP_ARGS, int nee, int adv,       \
           int cut, int vol, void* stream) {                                                  \
    if (n_rays <= 0) return 0;                                                                \
    const Taps tx = TAP_STRUCT;                                                               \
    const size_t smem = shade_smem(n_mats, n_lights, tx);                                     \
    const TriTree tree = TREE_STRUCT;                                                         \
    return with_flag(nee, [&](auto nee_) {                                                    \
      return with_flag(adv, [&](auto adv_) {                                                  \
        return with_flag(cut, [&](auto cut_) {                                                \
          return with_vol<VOL_OFF, VOL_ABSORB>(vol, [&](auto vol_) {                          \
            auto kern = shade_kernel<V(nee_), V(adv_), V(cut_), V(vol_), FLT_>;               \
            if (int err = allow_smem(kern, smem)) return err;                                 \
            kern CONFIG(smem)(params, tree, mats, n_mats, lights, light_types, n_lights,      \
                              state, n_rays, hit, hit_tan, tx);                               \
            return (int)cudaGetLastError();                                                   \
          });                                                                                 \
        });                                                                                   \
      });                                                                                     \
    });                                                                                       \
  }

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

TAP_ROWS(gatling_tap_rows, false)
RETRACE_ROUND(gatling_retrace_round, false)

// K3, resident: the hit buffer [16 or 24, n_rays] of state [16, n_rays].
int gatling_trace_resident(const float* params, RESIDENT_TABLES, const float* state,
                           long long n_rays, float* hit, int cut, void* stream) {
  if (n_rays <= 0) return 0;
  const bool tan = ld >= TRI_ROWS_TAN;
  const TriTree tree = TREE_STRUCT;
  return with_flag(tan, [&](auto tan_) {
    return with_flag(cut, [&](auto cut_) {
      trace_kernel<V(tan_), V(cut_)> CONFIG(0)(params, tris, ld, tree, state, n_rays, hit);
      return (int)cudaGetLastError();
    });
  });
}

SHADE_RESIDENT(gatling_shade_resident, false)
#endif

#if PART(5)
// K1: one bounce over state [16, n_rays] in place.
int gatling_bounce_step(const float* params, RESIDENT_TABLES, const float* mats, int n_mats,
                        const float* lights, const int8_t* light_types, int n_lights,
                        float* state, long long n_rays, int nee, int adv, int cut, int vol,
                        void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = table_smem(n_mats, n_lights);
  const TriTree tree = TREE_STRUCT;
  return with_flag(nee, [&](auto nee_) {
    return with_flag(adv, [&](auto adv_) {
      return with_flag(cut, [&](auto cut_) {
        return with_vol<VOL_OFF, VOL_SCATTER>(vol, [&](auto vol_) {
          auto kern = bounce_kernel<V(nee_), V(adv_), V(cut_), V(vol_)>;
          if (int err = allow_smem(kern, smem)) return err;
          kern CONFIG(smem)(params, tris, ld, tree, mats, n_mats, lights, light_types,
                            n_lights, state, n_rays);
          return (int)cudaGetLastError();
        });
      });
    });
  });
}
#endif

#define WALK_TABLES                                                                     \
  const float *tris, const float *l1, const float *l2, const int *cmap, const float *inst, \
      const float *nodes, const int *kids, const int *leaf_entries, const float *gbox,     \
      const float *cnodes, const int *ckids, const float *crows, const int *croot,         \
      int instanced, int rows
#define WALK_STRUCT \
  {tris, l1, l2, cmap, inst, nodes, kids, leaf_entries, gbox, cnodes, ckids, crows, croot}

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
// walk, NEE off (gatling_bounce_walk) or on (gatling_bounce_walk_nee);
// the volume modes VLO..VHI (the plain entry points take VOL_OFF, the
// ..._vol ones the absorption and scatter modes, in parts of their own).
// The scatter mode has no tangent-row instance: only the split bounce's
// tables carry tangents, and gi sends no scattering there.
#define BOUNCE_WALK(NAME, NEE_, VLO, VHI)                                                     \
  int NAME(const float* params, WALK_TABLES, const float* mats, int n_mats,                   \
           const float* lights, const int8_t* light_types, int n_lights, float* state,        \
           long long n_rays, int adv, int cut, int vol, void* stream) {                       \
    if (n_rays <= 0) return 0;                                                                \
    const Walk w = WALK_STRUCT;                                                               \
    const size_t smem = table_smem(n_mats, n_lights);                                         \
    return with_vol<VLO, VHI>(vol, [&](auto vol_) {                                           \
      return with_flag(instanced, [&](auto inst_) {                                           \
        return with_flag(rows == CLU_ROWS_TAN, [&](auto tan_) {                               \
          if constexpr (V(tan_) && V(vol_) == VOL_SCATTER) {                                  \
            return (int)cudaErrorInvalidValue;                                                \
          } else {                                                                            \
            return with_flag(adv, [&](auto adv_) {                                            \
              return with_flag(cut, [&](auto cut_) {                                          \
                auto kern = walk_kernel<NEE_, V(inst_), V(tan_), V(adv_), V(cut_), V(vol_)>;  \
                if (int err = allow_smem(kern, smem)) return err;                             \
                kern CONFIG(smem)(params, w, mats, n_mats, lights, light_types, n_lights,     \
                                  state, n_rays);                                             \
                return (int)cudaGetLastError();                                               \
              });                                                                             \
            });                                                                               \
          }                                                                                   \
        });                                                                                   \
      });                                                                                     \
    });                                                                                       \
  }

#if PART(1)
BOUNCE_WALK(gatling_bounce_walk, false, VOL_OFF, VOL_OFF)
#endif
#if PART(2)
BOUNCE_WALK(gatling_bounce_walk_nee, true, VOL_OFF, VOL_OFF)
#endif
// K4 over the walk, NEE off (gatling_shade_walk) or on (gatling_shade_walk_nee),
// the volume modes VLO..VHI, over an 8-bit pool or (..._flt) a float one.
#define SHADE_WALK(NAME, NEE_, VLO, VHI, FLT_)                                                \
  int NAME(const float* params, WALK_TABLES, const float* mats, int n_mats,                   \
           const float* lights, const int8_t* light_types, int n_lights, float* state,        \
           long long n_rays, const float* hit, int hit_tan, TAP_ARGS, int adv, int cut,       \
           int vol, void* stream) {                                                           \
    if (n_rays <= 0) return 0;                                                                \
    const Walk w = WALK_STRUCT;                                                               \
    const Taps tx = TAP_STRUCT;                                                               \
    const size_t smem = shade_smem(n_mats, n_lights, tx);                                     \
    return with_vol<VLO, VHI>(vol, [&](auto vol_) {                                           \
      return with_flag(instanced, [&](auto inst_) {                                           \
        return with_flag(rows == CLU_ROWS_TAN, [&](auto tan_) {                               \
          return with_flag(adv, [&](auto adv_) {                                              \
            return with_flag(cut, [&](auto cut_) {                                            \
              auto kern =                                                                     \
                  shade_walk_kernel<NEE_, V(inst_), V(tan_), V(adv_), V(cut_), V(vol_), FLT_>; \
              if (int err = allow_smem(kern, smem)) return err;                               \
              kern CONFIG(smem)(params, w, mats, n_mats, lights, light_types, n_lights,       \
                                state, n_rays, hit, hit_tan, tx);                             \
              return (int)cudaGetLastError();                                                 \
            });                                                                               \
          });                                                                                 \
        });                                                                                   \
      });                                                                                     \
    });                                                                                       \
  }

#if PART(3)
SHADE_WALK(gatling_shade_walk, false, VOL_OFF, VOL_OFF, false)
#endif
#if PART(4)
SHADE_WALK(gatling_shade_walk_nee, true, VOL_OFF, VOL_OFF, false)
#endif
#if PART(6)
BOUNCE_WALK(gatling_bounce_walk_vol, false, VOL_ABSORB, VOL_SCATTER)
#endif
#if PART(7)
BOUNCE_WALK(gatling_bounce_walk_vol_nee, true, VOL_ABSORB, VOL_SCATTER)
#endif

#if PART(8)
SHADE_WALK(gatling_shade_walk_vol, false, VOL_ABSORB, VOL_ABSORB, false)
#endif
#if PART(9)
SHADE_WALK(gatling_shade_walk_vol_nee, true, VOL_ABSORB, VOL_ABSORB, false)
#endif

// the float pool's instances of K4, of its taps alone and of the re-trace
// round, in parts of their own
#if PART(10)
TAP_ROWS(gatling_tap_rows_flt, true)
RETRACE_ROUND(gatling_retrace_round_flt, true)
SHADE_RESIDENT(gatling_shade_resident_flt, true)
#endif
#if PART(11)
SHADE_WALK(gatling_shade_walk_flt, false, VOL_OFF, VOL_OFF, true)
#endif
#if PART(12)
SHADE_WALK(gatling_shade_walk_nee_flt, true, VOL_OFF, VOL_OFF, true)
#endif
#if PART(13)
SHADE_WALK(gatling_shade_walk_vol_flt, false, VOL_ABSORB, VOL_ABSORB, true)
#endif
#if PART(14)
SHADE_WALK(gatling_shade_walk_vol_nee_flt, true, VOL_ABSORB, VOL_ABSORB, true)
#endif

}  // extern "C"
