// The per-ray BVH walk of the triangle searches (K1, K3 and K4 over a
// resident table in bounce.cu, K5 and K6 over the wavefront's soup in
// trace.cu, and K2-K4 in each cluster of a clustered table) and the slab
// test they share with K2's TLAS walk.
//
// The tree is a TriBvh (ops/bvh.py): nodes [N, 8] (lo xyz, hi xyz, 0, 0),
// kids [N, 2] (children, or (-1 - first, count) for a leaf over the leaf
// rows first..first + count - 1), node 0 the root. One thread walks one
// ray with a stack in local memory, nearer child first, reading nodes and
// kids through the read-only cache; a leaf's rows are the caller's.
//
// Bit-equal to the brute-force loops: the caller runs the loops' own test
// on every candidate and keeps the smallest t, ties to the lower table
// index, so the visiting order does not change the winner. The walk skips
// a node only when the ray's segment misses its box or enters it strictly
// after the best t so far (`run`): an equal t in another leaf is visited.
// The boxes are padded (ops/bvh.py tri_boxes), which covers the rounding
// of the triangle test and of the slab test; the segment starts at tmin
// less 2^-10 of |tmin|, so a box is culled by tmin only with a margin.

#pragma once

#include <cuda_runtime.h>

namespace gatling {

constexpr int TREE_STACK = 64;  // traversal stack (ops/bvh.py TLAS_MAX_DEPTH 48)

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = static_cast<float>(1e-20);
  return 1.0f / (fabsf(d) < tiny ? (d >= 0.0f ? tiny : -tiny) : d);
}

// Ray/box slab test (pallas_bounce.py _slab_test) over [tmin, tcap] of
// the box grown by the padding p of padded_origin below: the low faces
// against olo = o + p, the high ones against ohi = o - p (with p = 0, the
// plain slab test of o). tenter is the clipped entry distance.
__device__ __forceinline__ bool slab_padded(const float* __restrict__ b, const float olo[3],
                                            const float ohi[3], const float iv[3], float tmin,
                                            float tcap, float& tenter) {
  // box row (lo xyz, hi xyz, 0, 0): q0 = lo xyz + hi.x, q1 = hi.yz
  const float4 q0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 q1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float tx0 = (q0.x - olo[0]) * iv[0], tx1 = (q0.w - ohi[0]) * iv[0];
  const float ty0 = (q0.y - olo[1]) * iv[1], ty1 = (q1.x - ohi[1]) * iv[1];
  const float tz0 = (q0.z - olo[2]) * iv[2], tz1 = (q1.y - ohi[2]) * iv[2];
  tenter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fmaxf(fminf(tz0, tz1), tmin));
  const float texit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fminf(fmaxf(tz0, tz1), tcap));
  return tenter <= texit;
}

__device__ __forceinline__ bool slab(const float* __restrict__ b, const float o[3],
                                     const float iv[3], float tmin, float tcap,
                                     float& tenter) {
  return slab_padded(b, o, o, iv, tmin, tcap, tenter);
}

// The origins of the cluster trees' slab tests (bounce.cu walk): o + p and
// o - p with p = BOX_PAD (ops/bvh.py) times the largest |coordinate| of o.
// The trees' boxes are padded for their own coordinates; p adds the
// rounding that grows with the ray's origin in the tree's frame.
__device__ __forceinline__ void padded_origin(const float o[3], float olo[3], float ohi[3]) {
  const float p =
      fmaxf(fmaxf(fabsf(o[0]), fabsf(o[1])), fabsf(o[2])) * static_cast<float>(1e-4);
  for (int c = 0; c < 3; ++c) {
    olo[c] = o[c] + p;
    ohi[c] = o[c] - p;
  }
}

// Walk the tree from node `root` for the ray with inverse direction iv
// over [tlo, run], the boxes grown as slab_padded grows them, with a
// stack of STACK_N nodes (the tree's depth at most). At each leaf it calls
// leaf(first, count, run): the caller tests the leaf's rows, may lower
// `run` to its best t, and returns true to end the walk (an any-hit
// search at its first occluder); the walk then returns true. The root's
// own box is not tested.
template <int STACK_N, typename Leaf>
__device__ __forceinline__ bool tree_walk_from(const float* __restrict__ nodes,
                                               const int* __restrict__ kids, int root,
                                               const float olo[3], const float ohi[3],
                                               const float iv[3], float tlo, float& run,
                                               Leaf&& leaf) {
  int stack[STACK_N];
  float enter[STACK_N];
  int sp = 0;
  stack[sp] = root;
  enter[sp++] = tlo;
  while (sp > 0) {
    --sp;
    if (enter[sp] > run) continue;  // behind the best hit found since the push
    const int node = stack[sp];
    const int k0 = __ldg(kids + 2 * node), k1 = __ldg(kids + 2 * node + 1);
    if (k0 >= 0) {
      float ta, tb;
      const bool ha = slab_padded(nodes + 8 * k0, olo, ohi, iv, tlo, run, ta);
      const bool hb = slab_padded(nodes + 8 * k1, olo, ohi, iv, tlo, run, tb);
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
    if (leaf(-1 - k0, k1, run)) return true;
  }
  return false;
}

// Walk the tree for the ray o + t d, t in [tmin, tcap], from node 0 with
// the plain slab test (the boxes' padding is the table's).
template <typename Leaf>
__device__ __forceinline__ void tree_walk(const float* __restrict__ nodes,
                                          const int* __restrict__ kids, const float o[3],
                                          const float d[3], float tmin, float tcap,
                                          Leaf&& leaf) {
  float iv[3];
  for (int c = 0; c < 3; ++c) iv[c] = safe_inv(d[c]);
  const float tlo = tmin - fabsf(tmin) * (1.0f / 1024.0f);
  float run = tcap;
  tree_walk_from<TREE_STACK>(nodes, kids, 0, o, o, iv, tlo, run, leaf);
}

}  // namespace gatling
