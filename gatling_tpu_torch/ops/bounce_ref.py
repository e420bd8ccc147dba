"""Plain PyTorch twin of the fused bounce kernels (csrc/bounce.cu).

One path-tracing bounce over the whole ray state, written with ordinary
tensor operations, vectorized over rays. It computes what the JAX
package's `bounce_step` (ops/pallas_bounce.py `_bounce_body` +
`_shade_core`, volumes and scatter off) computes, in the same order of float
operations, so the two agree to rounding. Two flags select branches as the
JAX FusedStatic does: `advanced` (the full lobe set: thick refraction with
the exact dielectric Fresnel and TIR, clearcoat, anisotropic GGX) and
`cutout` (a hash Bernoulli per candidate hit against its pass
probability, `cutout_xi`). Two closest-hit searches feed the same shading:

* resident (K1): every ray against the whole triangle table, in chunks;
* clustered and instanced (K2, `walk` given): the two-level walk of
  `_trace_clustered_matrix` / `_trace_clustered_occluded`. Rays are
  slab-tested against the level-1 entry boxes, then the entry's cluster
  boxes, then the cluster's 128 triangles. Winners are selected in f32
  with the pass-1 formulas, ties on equal t going to the lower global
  triangle index (cluster * 128 + lane), and the winner's t, u, v are
  recomputed with pass 2's division form.

Its searches and its shading core (`shade_core`) also serve the split
bounce's twins (ops/split_ref.py). The tests hold it against the JAX
kernel; chip_smoke.py holds the CUDA kernels against it on the card; the
CLI's `--device cpu` renders with it.

Layouts shared with the kernels:
* state [16, R] f32: rows 0-2 origin, 3-5 dir, 6-8 throughput,
  9-11 radiance, 12 rng (uint32 bits), 13 alive, 14 miss record
  (1 + bounce at which the ray missed), 15 traced-segment count;
* resident tris [T, 32] f32, triangle-major: Baldwin-Weber plane and
  barycentric rows plus shading attributes (TR_* columns); [T, 48] with
  the tangent rows of normal-mapped and anisotropic scenes, which only the
  split trace reads; a cutout table appends the camera and shadow pass
  probabilities (TR_OPAC, then TR_OPAC + 1) and pads its rows to a
  multiple of 4 floats: [T, 36] or [T, 52];
* clustered tris [C * 128, 40] f32: 128-triangle clusters, triangle-major
  rows in the CLU_* layout (the JAX package's [C, 40, 128] transposed);
  [C * 128, 56] with tangent rows;
* mats [M, 30] f32 packed material rows; lights [max(L,1), 20] f32 with
  a type-major slot order (LT_* per slot);
* params [11] f32 (P_* entries);
* WalkTables for the clustered and instanced walks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.interface import BARY_EPS, FLOAT_MAX, f32
from gatling_tpu_torch.ops.sampling import (
    _M32,
    _mul32,
    f32_bits_to_u32,
    pcg32_step,
    u32_to_f32_bits,
    uint_as_float,
)

STATE_ROWS = 16
PI = 3.14159265358979  # the kernel's constant (the JAX kernel's PI)
MIN_ALPHA = 1e-3
SHADOW_TMIN = 0.01  # reference: rgen:397-438 shadow ray tMin

# triangle table columns
TR_N = 0      # 0-2: plane normal = cross(e1,e2), unnormalized
TR_D0 = 3     # plane offset: -dot(n, v0)
TR_R1 = 4     # 4-7: barycentric u row: r1.xyz, c1  (u = dot(r1,p)+c1)
TR_R2 = 8     # 8-11: barycentric v row
TR_GN = 12    # 12-14: geometric normal (normalized, flip-facing applied)
TR_N0 = 15    # 15-17, 18-20, 21-23: shading normals per corner
TR_N1 = 18
TR_N2 = 21
TR_MAT = 24
TR_DS = 25
TR_UV = 26    # 26-31: uv0.xy uv1.xy uv2.xy
TRI_ROWS = 32
# tangent extension of normal-mapped scenes: per-corner tangents and
# bitangent signs, read by the trace kernel K3 only
TR_T0 = 32    # 32-34, 35-37, 38-40: tangents per corner
TR_T1 = 35
TR_T2 = 38
TR_BS = 41    # 41-43: bitangent signs per corner
TRI_ROWS_TAN = 48
# cutout tables: the camera and the shadow walk's pass probability after the
# rows above (pallas_bounce.py tr_opac_row), padded to a float4 multiple
CUTOUT_PAD = 4

# clustered layout (pallas_bounce.py CLU_*): a permutation of the TR_*
# columns in which each Baldwin-Weber quad (n d0 | r1 c1 | r2 c2) starts at
# a multiple of 8, the attributes filling the gaps
CLUSTER_SIZE = 128
L1_FAN = 16  # clusters per level-1 entry
CLU_N = 0     # 0-2 n, 3 d0 | 4-6 gn, 7 mat
CLU_GN = 4
CLU_MAT = 7
CLU_R1 = 8    # 8-10 r1, 11 c1 | 12-14 n0, 15 dsided
CLU_N0 = 12
CLU_DS = 15
CLU_R2 = 16   # 16-18 r2, 19 c2 | 20-22 n1
CLU_N1 = 20
CLU_N2 = 24   # 24-26 n2
CLU_UV = 28   # 28-33 uv0.xy uv1.xy uv2.xy
CLU_OPAC = 34     # cutout pass probability, camera walk (1 = opaque)
CLU_OPAC_SH = 35  # cutout pass probability, shadow walk
CLU_TRI_ROWS = 40
CLU_T0 = 40   # tangent extension: 40-42, 43-45, 46-48 tangents per corner
CLU_T1 = 43
CLU_T2 = 46
CLU_BS = 49   # 49-51: bitangent signs per corner
CLU_TRI_ROWS_TAN = 56
CLU_ROW_MAP = (  # (TR_* column, CLU_* column)
    (TR_N, CLU_N), (TR_N + 1, CLU_N + 1), (TR_N + 2, CLU_N + 2), (TR_D0, CLU_N + 3),
    (TR_R1, CLU_R1), (TR_R1 + 1, CLU_R1 + 1), (TR_R1 + 2, CLU_R1 + 2), (TR_R1 + 3, CLU_R1 + 3),
    (TR_R2, CLU_R2), (TR_R2 + 1, CLU_R2 + 1), (TR_R2 + 2, CLU_R2 + 2), (TR_R2 + 3, CLU_R2 + 3),
    (TR_GN, CLU_GN), (TR_GN + 1, CLU_GN + 1), (TR_GN + 2, CLU_GN + 2), (TR_MAT, CLU_MAT),
    (TR_N0, CLU_N0), (TR_N0 + 1, CLU_N0 + 1), (TR_N0 + 2, CLU_N0 + 2), (TR_DS, CLU_DS),
    (TR_N1, CLU_N1), (TR_N1 + 1, CLU_N1 + 1), (TR_N1 + 2, CLU_N1 + 2),
    (TR_N2, CLU_N2), (TR_N2 + 1, CLU_N2 + 1), (TR_N2 + 2, CLU_N2 + 2),
    (TR_UV, CLU_UV), (TR_UV + 1, CLU_UV + 1), (TR_UV + 2, CLU_UV + 2),
    (TR_UV + 3, CLU_UV + 3), (TR_UV + 4, CLU_UV + 4), (TR_UV + 5, CLU_UV + 5),
)
CLU_ROW_MAP_TAN = CLU_ROW_MAP + tuple((TR_T0 + i, CLU_T0 + i) for i in range(12))
# the pass-1 test columns: the three quads
_CLU_TEST_COLS = (CLU_N, CLU_N + 1, CLU_N + 2, CLU_N + 3, CLU_R1, CLU_R1 + 1, CLU_R1 + 2,
                  CLU_R1 + 3, CLU_R2, CLU_R2 + 1, CLU_R2 + 2, CLU_R2 + 3)

# per-entry instance rows (the first 16 columns of the JAX inst_attr)
INST_A3 = 0    # 0-8: world->local A3[j, i] at 3j+i
INST_AT = 9    # 9-11: world->local translation a_t
INST_MAT = 12
INST_OBJ = 13
INST_ENTRY = 14
INST_DS = 15
INST_PASS = 16     # cutout pass probability of the placement, camera walk
INST_PASS_SH = 17  # and shadow walk (the JAX inst_smem columns 12 and 14)
INST_COLS = 20     # padded to a float4 multiple


class WalkTables(NamedTuple):
    """Tables of the two-level walk (K2). Boxes are rows (lo xyz, hi xyz,
    0, 0); an empty box has lo > hi and holds no triangle.

    The TLAS is a binary BVH over the level-1 entry boxes: node k is
    internal when kids[k, 0] >= 0 (children kids[k]) and a leaf otherwise,
    holding entries leaf_entries[-1 - kids[k, 0]:][:kids[k, 1]]."""

    l1: torch.Tensor            # [n_l1, 8] f32 entry world boxes
    l2: torch.Tensor            # [n_l1 * 16, 8] f32 fan-slot cluster world boxes
    cmap: torch.Tensor          # [n_l1 * 16] int32 fan slot -> cluster of tris
    inst: torch.Tensor          # [n_l1, 16] f32 INST_* rows; [0, 16] when flattened
    nodes: torch.Tensor         # [N, 8] f32 TLAS node boxes
    kids: torch.Tensor          # [N, 2] int32
    leaf_entries: torch.Tensor  # [n_l1] int32
    gbox: torch.Tensor          # [8] f32 scene box

    @property
    def instanced(self) -> bool:
        return self.inst.shape[0] > 0


LIGHT_COLS = 20
LT_SPHERE, LT_DISTANT, LT_RECT, LT_DISK = 0, 1, 2, 3

P_BG_R, P_BG_G, P_BG_B = 0, 1, 2
P_RR_INV_MIN = 3
P_RR_OFFSET = 4
P_BOUNCE = 5
P_EXP2_EXPOSURE = 6
P_TMIN = 7
P_LIGHT_MULT = 8
P_METERS = 9
P_MAX_WALK = 10
PARAMS_LEN = 11

# material columns the kernel reads (MaterialTable packed_f); the advanced
# lobe set adds clearcoat, its roughness, anisotropy and its rotation
_MAT_COLS = (0, 1, 2, 3, 4, 5, 7, 8, 9, 14, 15, 24)
_ADV_COLS = (26, 27, 28, 29)
# the shadow walk's cutout key is the ray's PCG word salted with this
# (pallas_bounce.py :2052), so its draws decorrelate from the camera walk's
SHADOW_SALT = 0x5BD1E995

_EPS_LO = float(-BARY_EPS)
_EPS_HI = float(np.float32(1.0) + BARY_EPS)
_FMAX = float(FLOAT_MAX)
TRI_CHUNK = 64


def _pcg_next(rng: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ns, word = pcg32_step(rng)
    return ns, uint_as_float(word)


def _where(c, a, b):
    return torch.where(c, a, b)


def tr_opac_col(tris: torch.Tensor) -> int:
    """The camera pass-probability column of a resident cutout table (the
    shadow one follows it)."""
    return TRI_ROWS_TAN if tris.shape[1] >= TRI_ROWS_TAN else TRI_ROWS


def cutout_xi(key: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """Per-(ray, triangle) uniform in [0, 1) (pallas_bounce.py _cutout_xi):
    a murmur-style mix of the ray's PCG word `key` with the global triangle
    id `tid`, uint32 values in int64 carriers, broadcast. Independent of the
    path's PCG stream: it takes no draw from it."""
    h = key ^ _mul32(tid & _M32, 2654435761)
    h = ((h ^ (h >> 16)) * 0x21F0AAAD) & _M32
    h = ((h ^ (h >> 15)) * 0x735A2D97) & _M32
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _tri_test(tris: torch.Tensor, o, d, tmin: float):
    """Baldwin-Weber test of rays [R] against triangles tris [C, 32];
    returns tt, u, v, ok, each [R, C]."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    col = tris.T  # [32, C]
    nx, ny, nz, d0 = col[TR_N], col[TR_N + 1], col[TR_N + 2], col[TR_D0]
    ndotd = nx * dx + ny * dy + nz * dz
    ok = torch.abs(ndotd) > 1e-12
    inv = _where(ok, 1.0 / _where(ok, ndotd, 1.0), 0.0)
    tt = -(nx * ox + ny * oy + nz * oz + d0) * inv
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz
    u = col[TR_R1] * px + col[TR_R1 + 1] * py + col[TR_R1 + 2] * pz + col[TR_R1 + 3]
    v = col[TR_R2] * px + col[TR_R2 + 1] * py + col[TR_R2 + 2] * pz + col[TR_R2 + 3]
    ok = ok & (u >= _EPS_LO) & (v >= _EPS_LO) & (u + v <= _EPS_HI) & (tt > tmin)
    return tt, u, v, ok


def closest_hit(tris: torch.Tensor, o, d, tmin: float, key: torch.Tensor | None = None):
    """Serial-order closest hit: the first triangle (in table order) with
    the smallest valid t wins, exactly as a loop with a strict `<` test.
    With a cutout `key` ([R] uint32 words) a candidate is a hit only where
    its draw falls below the table's camera pass probability. Returns
    best_t (FLOAT_MAX on a miss), u, v and the winner index (-1)."""
    r = o[0].shape[0]
    best_t = torch.full((r,), _FMAX, dtype=torch.float32, device=o[0].device)
    bu = torch.zeros_like(best_t)
    bv = torch.zeros_like(best_t)
    win = torch.full((r,), -1, dtype=torch.int64, device=o[0].device)
    for c0 in range(0, tris.shape[0], TRI_CHUNK):
        chunk = tris[c0:c0 + TRI_CHUNK]
        tt, u, v, ok = _tri_test(chunk, o, d, tmin)
        if key is not None:
            ok = ok & _passes(key, c0, chunk, tr_opac_col(tris))
        tt = _where(ok, tt, float("inf"))
        cmin, carg = torch.min(tt, dim=1)  # first index of the minimum
        better = cmin < best_t
        best_t = _where(better, cmin, best_t)
        bu = _where(better, u.gather(1, carg[:, None])[:, 0], bu)
        bv = _where(better, v.gather(1, carg[:, None])[:, 0], bv)
        win = _where(better, carg + c0, win)
    return best_t, bu, bv, win


def _passes(key: torch.Tensor, c0: int, chunk: torch.Tensor, col: int) -> torch.Tensor:
    """[R, C] cutout draws of rays `key` against triangles c0.. of a
    resident chunk, below their pass probability in column `col`."""
    tid = torch.arange(c0, c0 + chunk.shape[0], device=key.device)
    return cutout_xi(key[:, None], tid[None, :]) < chunk[:, col][None, :]


def occluded(tris: torch.Tensor, o, d, dist: torch.Tensor,
             key: torch.Tensor | None = None) -> torch.Tensor:
    """Any triangle hit at SHADOW_TMIN < t < dist; with a cutout `key` (the
    salted words) only candidates whose draw passes the shadow column."""
    occ = torch.zeros(o[0].shape, dtype=torch.bool, device=o[0].device)
    for c0 in range(0, tris.shape[0], TRI_CHUNK):
        chunk = tris[c0:c0 + TRI_CHUNK]
        tt, _u, _v, ok = _tri_test(chunk, o, d, SHADOW_TMIN)
        if key is not None:
            ok = ok & _passes(key, c0, chunk, tr_opac_col(tris) + 1)
        occ = occ | (ok & (tt < dist[:, None])).any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# the two-level walk (K2)
# ---------------------------------------------------------------------------

WALK_ENTRIES = 16   # level-1 entries slab-tested in one pass
WALK_PAIRS = 65536  # (ray, cluster) pairs triangle-tested in one pass
_NO_HIT = torch.iinfo(torch.int64).max


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| clamped to 1e-20 (pallas_bounce.py _safe_inv)."""
    tiny = torch.abs(d) < 1e-20
    return 1.0 / _where(tiny, _where(d >= 0.0, 1e-20, -1e-20), d)


def _slab(box: torch.Tensor, o, iv, tmin, tcap) -> torch.Tensor:
    """Slab test (pallas_bounce.py _slab_test) of boxes [..., 8] against
    rays o, iv [..., 3] over [tmin, tcap], broadcast."""
    t0 = (box[..., 0:3] - o) * iv
    t1 = (box[..., 3:6] - o) * iv
    tn = torch.minimum(t0, t1)
    tx = torch.maximum(t0, t1)
    tenter = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), torch.maximum(tn[..., 2], tmin))
    texit = torch.minimum(torch.minimum(tx[..., 0], tx[..., 1]), torch.minimum(tx[..., 2], tcap))
    return tenter <= texit


def _to_local(a: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """World rays [P, 3] into the frames of instance rows a [P, 16]:
    o_l = o A3 + a_t, d_l = d A3, in pass 2's expression order."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ol = torch.stack([ox * a[:, 0] + oy * a[:, 3] + oz * a[:, 6] + a[:, 9],
                      ox * a[:, 1] + oy * a[:, 4] + oz * a[:, 7] + a[:, 10],
                      ox * a[:, 2] + oy * a[:, 5] + oz * a[:, 8] + a[:, 11]], -1)
    dl = torch.stack([dx * a[:, 0] + dy * a[:, 3] + dz * a[:, 6],
                      dx * a[:, 1] + dy * a[:, 4] + dz * a[:, 7],
                      dx * a[:, 2] + dy * a[:, 5] + dz * a[:, 8]], -1)
    return ol, dl


def _test_rows(tris: torch.Tensor) -> torch.Tensor:
    """[C * 128, 40 or 56] clustered tris -> [C, 128, 12] pass-1 quads."""
    cols = torch.tensor(_CLU_TEST_COLS, device=tris.device)
    return tris.reshape(-1, CLUSTER_SIZE, tris.shape[1]).index_select(2, cols)


def _candidates(walk: WalkTables, o, iv, rays, e0: int, e1: int, tmin, tcap):
    """(ray, fan slot, entry) triples of entries [e0, e1) whose entry box
    and non-empty cluster box the segment [tmin, tcap] of ray `rays` crosses."""
    l1 = walk.l1[e0:e1]
    m1 = _slab(l1, o[rays][:, None], iv[rays][:, None], tmin[rays][:, None], tcap[rays][:, None])
    pi, pe = m1.nonzero(as_tuple=True)
    ray, ent = rays[pi], pe + e0
    slot = ent[:, None] * L1_FAN + torch.arange(L1_FAN, device=rays.device)
    box = walk.l2[slot]
    m2 = _slab(box, o[ray][:, None], iv[ray][:, None], tmin[ray][:, None], tcap[ray][:, None])
    m2 = m2 & (box[..., 0] <= box[..., 3])
    qi, qb = m2.nonzero(as_tuple=True)
    return ray[qi], slot[qi, qb], ent[qi]


def _pair_test(walk: WalkTables, rows, o, d, ray, slot, ent, tmin, tcap, cut=None):
    """Pass-1 Baldwin-Weber test (pallas_bounce.py :1649-1656, in f32) of
    each (ray, cluster) pair against the cluster's 128 triangles; returns
    tt and the validity mask, both [P, 128]. `cut` = (tris, key, shadow):
    the cutout draws (pallas_bounce.py :1657-1668, :2127-2138) against the
    placement's pass probability (instanced) or the triangles' CLU_OPAC
    (camera) or CLU_OPAC_SH (shadow) rows."""
    clu = walk.cmap[slot].long()
    q = rows[clu].unbind(-1)  # 12 x [P, 128]
    po, pd = o[ray], d[ray]
    if walk.instanced:
        po, pd = _to_local(walk.inst[ent], po, pd)
    ox, oy, oz = (x[:, None] for x in po.unbind(-1))
    dx, dy, dz = (x[:, None] for x in pd.unbind(-1))
    nd = q[0] * dx + q[1] * dy + q[2] * dz
    ok = torch.abs(nd) > 1e-12
    inv = _where(ok, 1.0 / _where(ok, nd, 1.0), 0.0)
    tt = -(q[0] * ox + q[1] * oy + q[2] * oz + q[3]) * inv
    u = (q[4] * ox + q[5] * oy + q[6] * oz + q[7]) + tt * (q[4] * dx + q[5] * dy + q[6] * dz)
    v = (q[8] * ox + q[9] * oy + q[10] * oz + q[11]) + tt * (q[8] * dx + q[9] * dy + q[10] * dz)
    ok = (ok & (u >= _EPS_LO) & (v >= _EPS_LO) & (u + v <= _EPS_HI)
          & (tt > tmin[ray][:, None]) & (tt < tcap[ray][:, None]))
    if cut is not None:
        tris, key, shadow = cut
        gid = slot[:, None] * CLUSTER_SIZE + torch.arange(CLUSTER_SIZE, device=slot.device)
        if walk.instanced:
            prob = walk.inst[ent, INST_PASS_SH if shadow else INST_PASS][:, None]
        else:
            col = CLU_OPAC_SH if shadow else CLU_OPAC
            prob = tris.reshape(-1, CLUSTER_SIZE, tris.shape[1])[clu, :, col]
        ok = ok & (cutout_xi(key[ray][:, None], gid) < prob)
    return tt, ok


def _scene_cap(walk: WalkTables, o: torch.Tensor, iv: torch.Tensor) -> torch.Tensor:
    """Per-ray closest-hit cap: the scene box's slab exit, widened
    (pallas_bounce.py :1555-1560)."""
    gb = walk.gbox
    ex = [torch.maximum((gb[a] - o[:, a]) * iv[:, a], (gb[3 + a] - o[:, a]) * iv[:, a])
          for a in range(3)]
    t_exit = torch.minimum(torch.minimum(ex[0], ex[1]), ex[2])
    return torch.clamp(t_exit, min=0.0) * 1.0001 + 1e-3


def _key_t(key: torch.Tensor) -> torch.Tensor:
    """t of a (t bits << 32 | triangle) key; FLOAT_MAX for no hit."""
    t = (key >> 32).to(torch.int32).view(torch.float32)
    return _where(key != _NO_HIT, t, _FMAX)


def walk_closest(walk: WalkTables, tris: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                 alive: torch.Tensor, tmin: float, key: torch.Tensor | None = None) -> torch.Tensor:
    """Closest hit of the alive rays (o, d [R, 3]) over the two-level walk:
    the global triangle index (fan slot * 128 + lane) of the smallest
    valid t, ties to the lower index, or -1. With a cutout `key` ([R]
    uint32 words) a candidate whose draw fails is not a hit."""
    if tmin < 0.0:
        raise ValueError("the walk's hit keys order t by its bits: tmin must be >= 0")
    r = o.shape[0]
    iv = _safe_inv(d)
    cap = _scene_cap(walk, o, iv)
    tmin_r = torch.full((r,), tmin, dtype=torch.float32, device=o.device)
    best = torch.full((r,), _NO_HIT, dtype=torch.int64, device=o.device)
    rows = _test_rows(tris)
    lanes = torch.arange(CLUSTER_SIZE, device=o.device)
    rays = alive.nonzero()[:, 0]
    cut = None if key is None else (tris, key, False)
    for e0 in range(0, walk.l1.shape[0], WALK_ENTRIES):
        run = torch.minimum(cap, _key_t(best))  # prunes boxes behind the best hit
        ray, slot, ent = _candidates(walk, o, iv, rays, e0, e0 + WALK_ENTRIES, tmin_r, run)
        for p0 in range(0, ray.numel(), WALK_PAIRS):
            sl = slice(p0, p0 + WALK_PAIRS)
            tt, ok = _pair_test(walk, rows, o, d, ray[sl], slot[sl], ent[sl], tmin_r, cap, cut)
            gid = slot[sl, None] * CLUSTER_SIZE + lanes
            hit_key = _where(ok, (tt.view(torch.int32).to(torch.int64) << 32) | gid, _NO_HIT)
            best.scatter_reduce_(0, ray[sl], hit_key.amin(dim=1), "amin")
    return _where(best != _NO_HIT, best & 0xFFFFFFFF, -1)


def walk_occluded(walk: WalkTables, tris: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                  dist: torch.Tensor, key: torch.Tensor | None = None) -> torch.Tensor:
    """Any-hit walk (pallas_bounce.py _trace_clustered_occluded): a valid
    triangle at SHADOW_TMIN < t < dist on each ray (o, d [n, 3]); with a
    cutout `key` (the salted words) only candidates whose draw passes."""
    n = o.shape[0]
    iv = _safe_inv(d)
    tmin = torch.full((n,), SHADOW_TMIN, dtype=torch.float32, device=o.device)
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    rows = _test_rows(tris)
    for e0 in range(0, walk.l1.shape[0], WALK_ENTRIES):
        rays = (~occ).nonzero()[:, 0]
        if not rays.numel():
            break
        ray, slot, ent = _candidates(walk, o, iv, rays, e0, e0 + WALK_ENTRIES, tmin, dist)
        for p0 in range(0, ray.numel(), WALK_PAIRS):
            sl = slice(p0, p0 + WALK_PAIRS)
            cut = None if key is None else (tris, key, True)
            _tt, ok = _pair_test(walk, rows, o, d, ray[sl], slot[sl], ent[sl], tmin, dist, cut)
            occ.index_fill_(0, ray[sl][ok.any(dim=1)], True)
    return occ


def walk_work(walk: WalkTables, o: torch.Tensor, d: torch.Tensor, alive: torch.Tensor,
              tmin: float, t_hit: torch.Tensor) -> tuple[int, int]:
    """(level-1 entry boxes, cluster boxes) that the alive rays enter
    between tmin and their hit t_hit (FLOAT_MAX on a miss: then up to the
    scene cap): the fans a closest-hit walk over these tables must
    slab-test and the clusters whose 128 triangles it must test, whatever
    its order. The work count of K2's bound."""
    iv = _safe_inv(d)
    tcap = torch.minimum(_scene_cap(walk, o, iv), t_hit)
    tmin_r = torch.full_like(tcap, tmin)
    rays = alive.nonzero()[:, 0]
    n_entries = n_clusters = 0
    for e0 in range(0, walk.l1.shape[0], WALK_ENTRIES):
        m1 = _slab(walk.l1[e0:e0 + WALK_ENTRIES], o[rays][:, None], iv[rays][:, None],
                   tmin_r[rays][:, None], tcap[rays][:, None])
        n_entries += int(m1.sum())
        ray, _slot, _ent = _candidates(walk, o, iv, rays, e0, e0 + WALK_ENTRIES, tmin_r, tcap)
        n_clusters += ray.numel()
    return n_entries, n_clusters


def walk_hit_attrs(walk: WalkTables, tris: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                   win: torch.Tensor, surface: bool = False):
    """Pass 2 (pallas_bounce.py :1882-1982): the winner's t, u, v
    recomputed in f32 with the division form, and its attributes. An
    instanced winner takes its normals as covectors through A3 and its
    material and double-sided flag from the instance row. Returns (t, u,
    v, gn, n0, n1, n2, mat_f, dsided), vectors as 3-tuples; t is FLOAT_MAX
    and the rest 0 where win < 0. With `surface` (the trace kernel's
    finalize, pallas_bounce.py _finalize_hits :3504) also the interpolated
    uv (2-tuple) and, on a table with tangent rows, the interpolated
    tangent (3-tuple; an instanced one taken to world space as a vector,
    through the exact inverse of A3) and bitangent sign, else None."""
    hit = win >= 0
    w = win.clamp(min=0)
    slot = w // CLUSTER_SIZE
    row = tris[walk.cmap[slot].long() * CLUSTER_SIZE + w % CLUSTER_SIZE]
    c = row.unbind(-1)
    if walk.instanced:
        a = walk.inst[slot // L1_FAN]
        ol, dl = _to_local(a, o, d)
    else:
        ol, dl = o, d
    ox, oy, oz = ol.unbind(-1)
    dx, dy, dz = dl.unbind(-1)
    ndw = c[CLU_N] * dx + c[CLU_N + 1] * dy + c[CLU_N + 2] * dz
    pw = c[CLU_N] * ox + c[CLU_N + 1] * oy + c[CLU_N + 2] * oz + c[CLU_N + 3]
    nd_safe = _where(torch.abs(ndw) > 1e-20, ndw, _where(ndw >= 0.0, 1e-20, -1e-20))
    t = _where(hit, -pw / nd_safe, _FMAX)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    u = c[CLU_R1] * px + c[CLU_R1 + 1] * py + c[CLU_R1 + 2] * pz + c[CLU_R1 + 3]
    v = c[CLU_R2] * px + c[CLU_R2 + 1] * py + c[CLU_R2 + 2] * pz + c[CLU_R2 + 3]

    def vec(r0):
        return c[r0], c[r0 + 1], c[r0 + 2]

    if walk.instanced:
        def covec(r0):  # n_w = n_l A3^T
            nx, ny, nz = vec(r0)
            return (nx * a[:, 0] + ny * a[:, 1] + nz * a[:, 2],
                    nx * a[:, 3] + ny * a[:, 4] + nz * a[:, 5],
                    nx * a[:, 6] + ny * a[:, 7] + nz * a[:, 8])

        gx, gy, gz = covec(CLU_GN)
        glen = 1.0 / torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-20))
        gn = (gx * glen, gy * glen, gz * glen)
        n0, n1, n2 = covec(CLU_N0), covec(CLU_N1), covec(CLU_N2)
        mat_f, dsided = a[:, INST_MAT], a[:, INST_DS]
    else:
        gn, n0, n1, n2 = vec(CLU_GN), vec(CLU_N0), vec(CLU_N1), vec(CLU_N2)
        mat_f, dsided = c[CLU_MAT], c[CLU_DS]

    def keep(x):
        return _where(hit, x, 0.0)

    gn, n0, n1, n2 = (tuple(keep(x) for x in vv) for vv in (gn, n0, n1, n2))
    u, v = keep(u), keep(v)
    out = (t, u, v, gn, n0, n1, n2, keep(mat_f), keep(dsided))
    if not surface:
        return out
    w = 1.0 - u - v
    uv = tuple(keep(w * c[CLU_UV + k] + u * c[CLU_UV + 2 + k] + v * c[CLU_UV + 4 + k])
               for k in range(2))
    tan = tbs = None
    if tris.shape[1] == CLU_TRI_ROWS_TAN:
        tan = tuple(w * c[CLU_T0 + k] + u * c[CLU_T1 + k] + v * c[CLU_T2 + k] for k in range(3))
        tbs = keep(w * c[CLU_BS] + u * c[CLU_BS + 1] + v * c[CLU_BS + 2])
        if walk.instanced:
            tan = _vec_to_world(a, *tan)
        tan = tuple(keep(x) for x in tan)
    return out + (uv, tan, tbs)


def _vec_to_world(a: torch.Tensor, x, y, z):
    """A local vector to world space through the inverse of A3 (rows a
    [R, 16], A3[j, i] at 3j + i), by the exact adjugate: the transform of a
    tangent, which A3^T (a normal's) would skew under a non-uniform scale
    (pallas_bounce.py :3578-3602)."""
    a00, a01, a02 = a[:, 0], a[:, 1], a[:, 2]
    a10, a11, a12 = a[:, 3], a[:, 4], a[:, 5]
    a20, a21, a22 = a[:, 6], a[:, 7], a[:, 8]
    det = (a00 * (a11 * a22 - a12 * a21)
           - a01 * (a10 * a22 - a12 * a20)
           + a02 * (a10 * a21 - a11 * a20))
    idet = 1.0 / _where(torch.abs(det) > 1e-30, det, 1.0)
    i00 = (a11 * a22 - a12 * a21) * idet
    i01 = (a02 * a21 - a01 * a22) * idet
    i02 = (a01 * a12 - a02 * a11) * idet
    i10 = (a12 * a20 - a10 * a22) * idet
    i11 = (a00 * a22 - a02 * a20) * idet
    i12 = (a02 * a10 - a00 * a12) * idet
    i20 = (a10 * a21 - a11 * a20) * idet
    i21 = (a01 * a20 - a00 * a21) * idet
    i22 = (a00 * a11 - a01 * a10) * idet
    return (x * i00 + y * i10 + z * i20,
            x * i01 + y * i11 + z * i21,
            x * i02 + y * i12 + z * i22)


def sample_lights(lights: torch.Tensor, light_types: tuple[int, ...],
                  k0, k1, k2, k3, posx, posy, posz):
    """Per-slot light sampling in type-major slot order: the type is
    chosen by k0 against the cumulative type counts, the slot within the
    type by k1. Returns (dir xyz, dist, power rgb, inv_pdf, ds0, ds1)."""
    counts = [0, 0, 0, 0]
    for t in light_types:
        counts[t] += 1
    total = float(len(light_types))
    cs, cd, cr = float(counts[0]), float(counts[1]), float(counts[2])
    pick = k0 * total
    is_sph = pick <= cs
    is_dst = ~is_sph & (pick <= cs + cd)
    is_rct = ~is_sph & ~is_dst & (pick <= cs + cd + cr)
    is_dsk = ~is_sph & ~is_dst & ~is_rct
    type_mask = {LT_SPHERE: is_sph, LT_DISTANT: is_dst, LT_RECT: is_rct, LT_DISK: is_dsk}
    within = {t: torch.clamp((k1 * float(c)).to(torch.int32), max=c - 1)
              for t, c in enumerate(counts) if c > 1}

    z = torch.zeros_like(k0)
    ldx, ldy, ldz, ldist = z, z, z, z
    pw_r, pw_g, pw_b = z, z, z
    ipdf, ds0, ds1 = z, z, z
    rows = lights.tolist()
    seen = [0, 0, 0, 0]
    for slot, t in enumerate(light_types):
        j = seen[t]
        seen[t] += 1
        mask = type_mask[t]
        if counts[t] > 1:
            mask = mask & (within[t] == j)
        g = [f32(x) for x in rows[slot]]

        if t == LT_SPHERE:
            a_s = 1.0 - 2.0 * k2
            b_s = torch.sqrt(torch.clamp(1.0 - a_s * a_s, min=0.0))
            phi = 2.0 * PI * k3
            lx = b_s * torch.cos(phi) * g[3]
            ly = b_s * torch.sin(phi) * g[4]
            lz = a_s * g[5]
            vx = g[0] + lx - posx
            vy = g[1] + ly - posy
            vz = g[2] + lz - posz
            dist = torch.sqrt(vx * vx + vy * vy + vz * vz)
            inv_d = _where(dist > 0.0, 1.0 / torch.clamp(dist, min=1e-30), 0.0)
            sdx, sdy, sdz = vx * inv_d, vy * inv_d, vz * inv_d
            nl = torch.sqrt(lx * lx + ly * ly + lz * lz)
            inv_nl = _where(nl > 0.0, 1.0 / torch.clamp(nl, min=1e-30), 0.0)
            cosl = torch.clamp(-(sdx * lx + sdy * ly + sdz * lz) * inv_nl, min=0.0)
            num = area_num(g[9], cosl)
            d2 = dist * dist
            s_ipdf = _where(d2 > 0.0, num / torch.clamp(d2, min=1e-30), 0.0)
        elif t == LT_DISTANT:
            phi = k2 * 2.0 * PI - PI
            theta = k3 * g[9]
            st_, ct_ = torch.sin(theta), torch.cos(theta)
            cp_, sp_ = torch.cos(phi), torch.sin(phi)
            px_ = st_ * (cp_ * g[3] + sp_ * g[6]) + ct_ * g[0]
            py_ = st_ * (cp_ * g[4] + sp_ * g[7]) + ct_ * g[1]
            pz_ = st_ * (cp_ * g[5] + sp_ * g[8]) + ct_ * g[2]
            pinv = 1.0 / torch.sqrt(torch.clamp(px_ * px_ + py_ * py_ + pz_ * pz_, min=1e-40))
            if g[9] > 0.0:
                sdx, sdy, sdz = px_ * pinv, py_ * pinv, pz_ * pinv
            else:
                sdx, sdy, sdz = (torch.full_like(k2, g[c]) for c in (0, 1, 2))
            dist = torch.full_like(k2, 100000.0)
            s_ipdf = torch.full_like(k2, g[10])
        else:
            if t == LT_RECT:
                on0 = (k2 - 0.5) * g[9]
                on1 = (k3 - 0.5) * g[10]
                area = f32(np.float32(g[9]) * np.float32(g[10]))
            else:
                a_ = 2.0 * k2 - 1.0
                b_ = 2.0 * k3 - 1.0
                use_a = (a_ * a_) > (b_ * b_)
                r0 = _where(use_a, g[9] * a_, g[9] * b_)
                r1 = _where(use_a, g[10] * a_, g[10] * b_)
                ba = _where(a_ == 0.0, 0.0, b_ / _where(a_ == 0.0, 1.0, a_))
                ab = _where(b_ == 0.0, 0.0, a_ / _where(b_ == 0.0, 1.0, b_))
                phi = _where(use_a, (PI / 4.0) * ba, (PI / 2.0) - (PI / 4.0) * ab)
                on0 = r0 * torch.cos(phi)
                on1 = r1 * torch.sin(phi)
                area = f32(np.float32(g[9]) * np.float32(g[10]) * np.float32(PI))
            sx_ = g[0] + on0 * g[3] + on1 * g[6]
            sy_ = g[1] + on0 * g[4] + on1 * g[7]
            sz_ = g[2] + on0 * g[5] + on1 * g[8]
            vx = sx_ - posx
            vy = sy_ - posy
            vz = sz_ - posz
            dist = torch.sqrt(vx * vx + vy * vy + vz * vz)
            inv_d = _where(dist > 0.0, 1.0 / torch.clamp(dist, min=1e-30), 0.0)
            sdx, sdy, sdz = vx * inv_d, vy * inv_d, vz * inv_d
            cosl = torch.clamp(-(sdx * g[11] + sdy * g[12] + sdz * g[13]), min=0.0)
            num = area_num(area, cosl)
            d2 = dist * dist
            s_ipdf = _where(d2 > 0.0, num / torch.clamp(d2, min=1e-30), 0.0)

        ldx = _where(mask, sdx, ldx)
        ldy = _where(mask, sdy, ldy)
        ldz = _where(mask, sdz, ldz)
        ldist = _where(mask, dist, ldist)
        pw_r = _where(mask, g[14], pw_r)
        pw_g = _where(mask, g[15], pw_g)
        pw_b = _where(mask, g[16], pw_b)
        ipdf = _where(mask, s_ipdf, ipdf)
        ds0 = _where(mask, g[17], ds0)
        ds1 = _where(mask, g[18], ds1)
    return ldx, ldy, ldz, ldist, pw_r, pw_g, pw_b, ipdf, ds0, ds1


def area_num(area: float, cosl: torch.Tensor) -> torch.Tensor:
    """area * cos for an area light, 1 for a point light."""
    return area * cosl if area > 0.0 else torch.ones_like(cosl)


def resident_hits(tris: torch.Tensor, o, d, tmin: float, key: torch.Tensor | None = None):
    """Closest hits over a resident table: (t, u, v, winner rows [R, rows],
    zero where nothing is hit); t is FLOAT_MAX on a miss. `key`: the
    cutout words, as closest_hit takes them."""
    best_t, u, v, win = closest_hit(tris, o, d, tmin, key)
    if tris.shape[0]:
        attrs = _where((win >= 0)[:, None], tris[win.clamp(min=0)], 0.0)
    else:
        attrs = torch.zeros((win.shape[0], tris.shape[1]), dtype=torch.float32,
                            device=win.device)
    return best_t, u, v, attrs


def surface_state(o, d, t, u, v, gn, n0, n1, n2):
    """The shading state of a hit (the trace epilogue of the kernels):
    position, the geometric normal and the interpolated, normalised
    shading normal, both turned to face the ray, and the facing flag.
    Vectors are 3-tuples of [R] tensors."""
    pos = tuple(o[c] + t * d[c] for c in range(3))
    w = 1.0 - u - v
    nx, ny, nz = (w * n0[c] + u * n1[c] + v * n2[c] for c in range(3))
    nlen = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    nx, ny, nz = nx * nlen, ny * nlen, nz * nlen
    front = (gn[0] * -d[0] + gn[1] * -d[1] + gn[2] * -d[2]) >= 0.0
    fsign = _where(front, 1.0, -1.0)
    return (pos, tuple(x * fsign for x in gn), (nx * fsign, ny * fsign, nz * fsign), front)


def material_rows(mats: torch.Tensor, mat_f: torch.Tensor,
                  advanced: bool = False) -> list[torch.Tensor]:
    """The 12 shading parameters (_MAT_COLS) of each ray's material row,
    16 with the advanced columns (_ADV_COLS); ids outside the table resolve
    to zeros."""
    m_id = torch.round(mat_f).to(torch.int64)
    m_ok = (m_id >= 0) & (m_id < mats.shape[0])
    mrow = _where(m_ok[:, None], mats[m_id.clamp(0, mats.shape[0] - 1)], 0.0)
    return [mrow[:, c] for c in _MAT_COLS + (_ADV_COLS if advanced else ())]


def cutout_key(state: torch.Tensor) -> torch.Tensor:
    """The camera walk's cutout words: each ray's PCG state at the start of
    the bounce (pallas_bounce.py :1345, :2312)."""
    return f32_bits_to_u32(state[12])


def bounce_ref(params: torch.Tensor, tris: torch.Tensor, mats: torch.Tensor,
               lights: torch.Tensor, light_types: tuple[int, ...],
               state: torch.Tensor, nee: bool, walk: WalkTables | None = None,
               advanced: bool = False, cutout: bool = False) -> None:
    """One bounce over state [16, R], updated in place: resident tris
    [T, 32 or 48; 36 or 52 with cutout rows] without `walk`, clustered tris
    [C * 128, 40 or 56] with it."""
    p = [f32(x) for x in params.tolist()]
    o, d = (state[0], state[1], state[2]), (state[3], state[4], state[5])
    alive = state[13] > 0.5
    key = cutout_key(state) if cutout else None
    if walk is None:
        best_t, u, v, attrs = resident_hits(tris, o, d, p[P_TMIN], key)
        hit = alive & (best_t < _FMAX)
        gn, n0, n1, n2 = ((attrs[:, c], attrs[:, c + 1], attrs[:, c + 2])
                          for c in (TR_GN, TR_N0, TR_N1, TR_N2))
        mat_f, dsided = attrs[:, TR_MAT], attrs[:, TR_DS]
    else:
        o3, d3 = torch.stack(o, 1), torch.stack(d, 1)
        win = walk_closest(walk, tris, o3, d3, alive, p[P_TMIN], key)
        # best_t caps at FLOAT_MAX on a miss; the hit flag is the winner
        hit = alive & (win >= 0)
        best_t, u, v, gn, n0, n1, n2, mat_f, dsided = walk_hit_attrs(walk, tris, o3, d3, win)
    pos, gn, n, front = surface_state(o, d, best_t, u, v, gn, n0, n1, n2)
    shade_core(p, state, hit, pos, gn, n, front, dsided, material_rows(mats, mat_f, advanced),
               lights, light_types, nee, occluder(tris, walk, cutout), advanced)


def occluder(tris: torch.Tensor, walk: WalkTables | None, cutout: bool = False):
    """The any-hit test of NEE shadow rays over a resident table or a walk:
    fn(o, d, dist, key), `key` the salted cutout words of the rays (ignored
    without cutout)."""
    if walk is None:
        return lambda o, d, dist, key: occluded(tris, o, d, dist, key if cutout else None)
    return lambda o, d, dist, key: walk_occluded(walk, tris, torch.stack(o, 1),
                                                 torch.stack(d, 1), dist,
                                                 key if cutout else None)


def _ggx_g1(a2, nv):
    return 2.0 * nv / (nv + torch.sqrt(a2 + (1.0 - a2) * nv * nv))


def _aniso_g1(ax, ay, vx, vy, vz):
    """Smith G1 of anisotropic GGX in the rotated frame (pallas_bounce.py
    :2651-2655)."""
    vza = torch.clamp(torch.abs(vz), min=1e-6)
    sx, sy = ax * vx, ay * vy
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + (sx * sx + sy * sy) / (vza * vza)))
    return 1.0 / (1.0 + lam)


def shade_core(p: list[float], state: torch.Tensor, hit: torch.Tensor, pos, gn, n,
               front: torch.Tensor, dsided: torch.Tensor, mrow: list[torch.Tensor],
               lights: torch.Tensor, light_types: tuple[int, ...], nee: bool,
               occluded_fn, advanced: bool = False, tangent=None) -> None:
    """Miss background, emission, BSDF sampling, the NEE shadow ray,
    russian roulette and the state write-back of one bounce, given each
    ray's hit and shading state (pallas_bounce.py _shade_core, shared by
    the bounce and the split shade step). `state` is updated in place.

    `advanced` adds the JAX kernel's full lobe set (mrow then carries the
    four _ADV_COLS): clearcoat, anisotropic GGX and thick refraction with
    the exact dielectric Fresnel and TIR; `tangent` = (t xyz, bitangent
    sign), the split trace's H_TAN and H_BS rows, anchors its frame to the
    mesh tangent (pallas_bounce.py :2453-2473)."""
    s = state
    ox, oy, oz = s[0], s[1], s[2]
    dx, dy, dz = s[3], s[4], s[5]
    tpx, tpy, tpz = s[6], s[7], s[8]
    radx, rady, radz = s[9], s[10], s[11]
    rng = f32_bits_to_u32(s[12])
    alive = s[13] > 0.5
    bounce = p[P_BOUNCE]
    miss = alive & ~hit
    posx, posy, posz = pos
    gnx, gny, gnz = gn
    nx, ny, nz = n
    (base_r, base_g, base_b, metallic, roughness, ior,
     em_r, em_g, em_b, transm, thinw, bf_edf) = mrow[:12]
    adv = advanced
    if adv:
        coat, coat_rough, aniso, aniso_rot = mrow[12:16]

    # ---- miss: constant background (dome radiance is not ported) ----
    radx = radx + _where(miss, tpx * p[P_BG_R], 0.0)
    rady = rady + _where(miss, tpy * p[P_BG_G], 0.0)
    radz = radz + _where(miss, tpz * p[P_BG_B], 0.0)
    miss_rec = _where(miss, bounce + 1.0, s[14])

    # ---- emission: front face, backface of single-sided geometry, or
    # thin-walled backface EDF (rp_main.chit:304-315) ----
    em_ok = hit & (front | (dsided <= 0.5) | ((thinw > 0.5) & (bf_edf > 0.5)))
    em_scale = p[P_EXP2_EXPOSURE]
    radx = radx + _where(em_ok, tpx * em_r * em_scale, 0.0)
    rady = rady + _where(em_ok, tpy * em_g * em_scale, 0.0)
    radz = radz + _where(em_ok, tpz * em_b * em_scale, 0.0)

    # ---- BSDF sample draws (xi4, the general integrator's order) ----
    rng1, xi0 = _pcg_next(rng)
    rng2, xi1 = _pcg_next(rng1)
    rng3, xi2 = _pcg_next(rng2)
    rng4, xi3 = _pcg_next(rng3)
    rng = _where(hit, rng4, rng)

    # ---- Duff ONB around the shading normal ----
    nsign = _where(nz >= 0.0, 1.0, -1.0)
    a_onb = -1.0 / (nsign + nz)
    b_onb = nx * ny * a_onb
    t1x = 1.0 + nsign * nx * nx * a_onb
    t1y = nsign * b_onb
    t1z = -nsign * nx
    t2x = b_onb
    t2y = nsign + ny * ny * a_onb
    t2z = -ny
    if adv and tangent is not None:
        # the mesh tangent re-orthonormalised against the (possibly
        # normal-mapped) shading normal, bitangent cross(n, t) * sign; a
        # degenerate tangent keeps the Duff frame
        (tanx, tany, tanz), tbs = tangent
        tdn = tanx * nx + tany * ny + tanz * nz
        mtx = tanx - nx * tdn
        mty = tany - ny * tdn
        mtz = tanz - nz * tdn
        tlen2 = mtx * mtx + mty * mty + mtz * mtz
        tok = tlen2 > 1e-12
        tl = 1.0 / torch.sqrt(torch.clamp(tlen2, min=1e-20))
        mtx, mty, mtz = mtx * tl, mty * tl, mtz * tl
        bsgn = _where(tbs >= 0.0, 1.0, -1.0)
        t1x = _where(tok, mtx, t1x)
        t1y = _where(tok, mty, t1y)
        t1z = _where(tok, mtz, t1z)
        t2x = _where(tok, (ny * mtz - nz * mty) * bsgn, t2x)
        t2y = _where(tok, (nz * mtx - nx * mtz) * bsgn, t2y)
        t2z = _where(tok, (nx * mty - ny * mtx) * bsgn, t2z)

    wox = -(dx * t1x + dy * t1y + dz * t1z)
    woy = -(dx * t2x + dy * t2y + dz * t2z)
    woz = -(dx * nx + dy * ny + dz * nz)

    # ---- lobe weights (render/bsdf.py _lobe_weights) ----
    f0q = (ior - 1.0) / (ior + 1.0)
    f0d = f0q * f0q
    f0r = f0d * (1.0 - metallic) + base_r * metallic
    f0g = f0d * (1.0 - metallic) + base_g * metallic
    f0b = f0d * (1.0 - metallic) + base_b * metallic
    lum_base = 0.2126 * base_r + 0.7152 * base_g + 0.0722 * base_b
    lum_f0 = 0.2126 * f0r + 0.7152 * f0g + 0.0722 * f0b
    w_d = lum_base * (1.0 - metallic) * (1.0 - transm)
    w_g = _where(lum_f0 > 0.0, torch.clamp(lum_f0, min=0.04), 0.0)
    w_t = transm
    if adv:
        # the thick-glass fraction is the interface lobe's: the base glossy
        # lobe does not model that reflection again
        thick = transm * (1.0 - _where(thinw > 0.5, 1.0, 0.0))
        w_g = w_g * (1.0 - thick)
        w_c = 0.25 * coat
        w_sum = torch.clamp(w_d + w_g + w_t + w_c, min=1e-20)
    else:
        w_sum = torch.clamp(w_d + w_g + w_t, min=1e-20)
    p_d = w_d / w_sum
    p_g = w_g / w_sum
    p_t = w_t / w_sum
    pick_d = xi0 < p_d
    pick_g = ~pick_d & (xi0 < p_d + p_g)
    if adv:
        p_c = w_c / w_sum
        pick_t = ~pick_d & ~pick_g & (xi0 < p_d + p_g + p_t)
        pick_c = ~pick_d & ~pick_g & ~pick_t
    else:
        pick_t = ~pick_d & ~pick_g

    alpha = torch.clamp(roughness * roughness, min=MIN_ALPHA)
    alpha2 = alpha * alpha
    if adv:
        # anisotropic GGX roughnesses (Disney aspect) and their rotation
        aspect = torch.sqrt(1.0 - 0.9 * torch.clamp(aniso, 0.0, 1.0))
        ax = torch.clamp(alpha / aspect, min=MIN_ALPHA)
        ay = torch.clamp(alpha * aspect, min=MIN_ALPHA)
        rtheta = (2.0 * PI) * aniso_rot
        cos_r, sin_r = torch.cos(rtheta), torch.sin(rtheta)

    # diffuse: cosine hemisphere
    ra = torch.sqrt(torch.clamp(xi1, 0.0, 1.0))
    phi_d = 2.0 * PI * xi2
    cphi, sphi = torch.cos(phi_d), torch.sin(phi_d)
    wdx = ra * cphi
    wdy = ra * sphi
    wdz = torch.sqrt(torch.clamp(1.0 - xi1, min=0.0))
    if adv:
        # glossy: anisotropic GGX half vector in slope space, sampled in the
        # rotated frame and rotated back
        u_c = torch.clamp(xi1, 0.0, 1.0 - 1e-7)
        r_slope = torch.sqrt(u_c / (1.0 - u_c))
        hxr = ax * r_slope * cphi
        hyr = ay * r_slope * sphi
        hinv_s = 1.0 / torch.sqrt(torch.clamp(hxr * hxr + hyr * hyr + 1.0, min=1e-24))
        hxr, hyr, hz = hxr * hinv_s, hyr * hinv_s, hinv_s
        hx = hxr * cos_r - hyr * sin_r
        hy = hxr * sin_r + hyr * cos_r
    else:
        # glossy: GGX NDF half-vector sample + reflect
        c2h = (1.0 - xi1) / torch.clamp(1.0 + (alpha2 - 1.0) * xi1, min=1e-12)
        ch = torch.sqrt(torch.clamp(c2h, 0.0, 1.0))
        sh = torch.sqrt(torch.clamp(1.0 - c2h, min=0.0))
        hx = sh * cphi
        hy = sh * sphi
        hz = ch
    odoth = wox * hx + woy * hy + woz * hz
    wix = _where(pick_d, wdx, 2.0 * odoth * hx - wox)
    wiy = _where(pick_d, wdy, 2.0 * odoth * hy - woy)
    wiz = _where(pick_d, wdz, 2.0 * odoth * hz - woz)
    if adv:
        # clearcoat: isotropic GGX reflection at the coat roughness
        ac = torch.clamp(coat_rough * coat_rough, min=MIN_ALPHA)
        ac2 = ac * ac
        c2hc = (1.0 - u_c) / torch.clamp(1.0 + (ac2 - 1.0) * u_c, min=1e-12)
        chc = torch.sqrt(torch.clamp(c2hc, 0.0, 1.0))
        shc = torch.sqrt(torch.clamp(1.0 - c2hc, min=0.0))
        hcx, hcy, hcz = shc * cphi, shc * sphi, chc
        odothc = wox * hcx + woy * hcy + woz * hcz
        wix = _where(pick_c, 2.0 * odothc * hcx - wox, wix)
        wiy = _where(pick_c, 2.0 * odothc * hcy - woy, wiy)
        wiz = _where(pick_c, 2.0 * odothc * hcz - woz, wiz)

        # thick transmission: a microfacet dielectric interface; the exact
        # Fresnel picks reflection or refraction, TIR is F = 1
        c2ht = (1.0 - u_c) / torch.clamp(1.0 + (alpha2 - 1.0) * u_c, min=1e-12)
        cht = torch.sqrt(torch.clamp(c2ht, 0.0, 1.0))
        sht = torch.sqrt(torch.clamp(1.0 - c2ht, min=0.0))
        htx, hty, htz = sht * cphi, sht * sphi, cht
        eta_rel = _where(front, ior, 1.0 / torch.clamp(ior, min=1e-6))
        c_oh = torch.clamp(wox * htx + woy * hty + woz * htz, min=0.0)
        sin2_t = (1.0 - c_oh * c_oh) / torch.clamp(eta_rel * eta_rel, min=1e-12)
        tir = sin2_t >= 1.0
        cos_tf = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
        rs_f = (c_oh - eta_rel * cos_tf) / torch.clamp(c_oh + eta_rel * cos_tf, min=1e-12)
        rp_f = (eta_rel * c_oh - cos_tf) / torch.clamp(eta_rel * c_oh + cos_tf, min=1e-12)
        f_t = _where(tir, 1.0, torch.clamp(0.5 * (rs_f * rs_f + rp_f * rp_f), 0.0, 1.0))
        eta_inv = 1.0 / torch.clamp(eta_rel, min=1e-6)
        k_t = 1.0 - eta_inv * eta_inv * (1.0 - c_oh * c_oh)
        cos_t = torch.sqrt(torch.clamp(k_t, min=0.0))
        scale_h = eta_inv * c_oh - cos_t
        refl_pick = xi3 < f_t
        thin_b = thinw > 0.5
        wt = [_where(thin_b, -wo_, _where(refl_pick, 2.0 * c_oh * ht_ - wo_,
                                           -eta_inv * wo_ + scale_h * ht_))
              for wo_, ht_ in ((wox, htx), (woy, hty), (woz, htz))]
        wix = _where(pick_t, wt[0], wix)
        wiy = _where(pick_t, wt[1], wiy)
        wiz = _where(pick_t, wt[2], wiz)
    else:
        wix = _where(pick_t, -wox, wix)
        wiy = _where(pick_t, -woy, wiy)
        wiz = _where(pick_t, -woz, wiz)

    def eval_lobes(wix_, wiy_, wiz_):
        """Diffuse + glossy reflection (+ clearcoat, anisotropy when
        advanced) at local wi (render/bsdf.py _eval_lobes): per-channel
        diffuse, glossy, and the pdf."""
        refl = (woz > 0.0) & (wiz_ > 0.0)
        cos_i_c = torch.clamp(wiz_, min=0.0)
        hxs = wox + wix_
        hys = woy + wiy_
        hzs = woz + wiz_
        hinv = 1.0 / torch.sqrt(torch.clamp(hxs * hxs + hys * hys + hzs * hzs, min=1e-24))
        hxs, hys, hzs = hxs * hinv, hys * hinv, hzs * hinv
        nh = torch.abs(hzs)
        oh = torch.clamp(wox * hxs + woy * hys + woz * hzs, min=1e-6)
        nvo = torch.clamp(woz, min=1e-6)
        nvi = torch.clamp(cos_i_c, min=1e-6)
        if adv:
            # anisotropic D and G in the rotated tangent frame
            hxr_ = hxs * cos_r + hys * sin_r
            hyr_ = -hxs * sin_r + hys * cos_r
            qa, qb = hxr_ / ax, hyr_ / ay
            q_ = qa * qa + qb * qb + hzs * hzs
            ggx_d = 1.0 / torch.clamp(PI * ax * ay * q_ * q_, min=1e-12)
            gg = (_aniso_g1(ax, ay, wox * cos_r + woy * sin_r, -wox * sin_r + woy * cos_r, woz)
                  * _aniso_g1(ax, ay, wix_ * cos_r + wiy_ * sin_r,
                              -wix_ * sin_r + wiy_ * cos_r, wiz_))
        else:
            dd = nh * nh * (alpha2 - 1.0) + 1.0
            ggx_d = alpha2 / torch.clamp(PI * dd * dd, min=1e-12)
            gg = _ggx_g1(alpha2, nvo) * _ggx_g1(alpha2, nvi)
        mfres = torch.clamp(1.0 - oh, 0.0, 1.0)
        fres5 = (mfres * mfres) * (mfres * mfres) * mfres
        spec_core = ggx_d * gg / torch.clamp(4.0 * woz * cos_i_c, min=1e-9) * cos_i_c
        diff_core = (1.0 - metallic) * (1.0 - transm) * cos_i_c / PI
        if adv:
            # the clearcoat lobe, and the base attenuated under the coat in
            # both directions; the thick-glass fraction leaves the base
            # glossy lobe
            dcd = nh * nh * (ac2 - 1.0) + 1.0
            dc_ = ac2 / torch.clamp(PI * (dcd * dcd), min=1e-12)
            fc_ = 0.04 + 0.96 * fres5
            coat_core = (coat * fc_ * dc_ * _ggx_g1(ac2, nvo) * _ggx_g1(ac2, nvi)
                         / torch.clamp(4.0 * woz * cos_i_c, min=1e-9) * cos_i_c)
            m_o = torch.clamp(1.0 - nvo, 0.0, 1.0)
            m_i = torch.clamp(1.0 - nvi, 0.0, 1.0)
            att = ((1.0 - coat * (0.04 + 0.96 * ((m_o * m_o) * (m_o * m_o)) * m_o))
                   * (1.0 - coat * (0.04 + 0.96 * ((m_i * m_i) * (m_i * m_i)) * m_i)))
            spec_core = spec_core * ((1.0 - thick) * att)
            diff_core = diff_core * att
        fd = [_where(refl, b * diff_core, 0.0) for b in (base_r, base_g, base_b)]
        fg = [(f0 + (1.0 - f0) * fres5) * spec_core for f0 in (f0r, f0g, f0b)]
        if adv:
            fg = [x + coat_core for x in fg]
        fg = [_where(refl, x, 0.0) for x in fg]
        pdf_ = p_d * cos_i_c / PI + p_g * ggx_d * nh / torch.clamp(4.0 * oh, min=1e-9)
        if adv:
            pdf_ = pdf_ + p_c * dc_ * nh / torch.clamp(4.0 * oh, min=1e-9)
        return fd, fg, _where(refl, pdf_, 0.0)

    fd, fg, pdf = eval_lobes(wix, wiy, wiz)
    inv_pdf = _where(pdf > 1e-12, 1.0 / torch.clamp(pdf, min=1e-12), 0.0)
    bop = [(a + b) * inv_pdf for a, b in zip(fd, fg)]

    # transmission: thin surfaces straight through, Fresnel-weighted
    # (render/bsdf.py); advanced thick ones the interface lobe's white
    # weight (its G1 at wi)
    mtr = torch.clamp(1.0 - torch.clamp(woz, min=0.0), 0.0, 1.0)
    tr5 = (mtr * mtr) * (mtr * mtr) * mtr
    inv_pt = _where(p_t > 1e-12, 1.0 / torch.clamp(p_t, min=1e-12), 0.0)
    trans_w = [transm * (1.0 - (f0 + (1.0 - f0) * tr5)) * inv_pt for f0 in (f0r, f0g, f0b)]
    if adv:
        awz = torch.clamp(torch.abs(wiz), min=1e-6)
        thick_w = transm * _ggx_g1(alpha2, awz) * inv_pt
        trans_w = [_where(thin_b, tw, thick_w) for tw in trans_w]
        valid_t = (p_t > 0.0) & (thin_b | refl_pick | (k_t > 0.0))
    else:
        valid_t = p_t > 0.0
    bop = [_where(pick_t, tw, b) for tw, b in zip(trans_w, bop)]
    valid = (pick_t & valid_t) | (~pick_t & (pdf > 1e-12) & (wiz > 0.0) & (woz > 0.0))
    bop = [_where(valid, b, 0.0) for b in bop]

    # world-space wi
    k2x = wix * t1x + wiy * t2x + wiz * nx
    k2y = wix * t1y + wiy * t2y + wiz * ny
    k2z = wix * t1z + wiy * t2z + wiz * nz
    tpx = _where(hit, tpx * bop[0], tpx)
    tpy = _where(hit, tpy * bop[1], tpy)
    tpz = _where(hit, tpz * bop[2], tpz)

    # new origin, offset along the signed geometric normal (a Fresnel-
    # reflected thick-glass sample stays on the front side)
    crossing = pick_t & (thin_b | ~refl_pick) if adv else pick_t
    osign = _where(crossing, -1.0, 1.0)
    offx = gnx * osign * torch.clamp(torch.abs(posx) * 2.0 ** -16, min=1.0 / 65536.0)
    offy = gny * osign * torch.clamp(torch.abs(posy) * 2.0 ** -16, min=1.0 / 65536.0)
    offz = gnz * osign * torch.clamp(torch.abs(posz) * 2.0 ** -16, min=1.0 / 65536.0)
    ox = _where(hit, posx + offx, ox)
    oy = _where(hit, posy + offy, oy)
    oz = _where(hit, posz + offz, oz)
    dx = _where(hit, k2x, dx)
    dy = _where(hit, k2y, dy)
    dz = _where(hit, k2z, dz)

    # ---- NEE (rp_main.chit sampleLight:30-129 + rgen:397-438) ----
    shadow_count = torch.zeros_like(radx)
    if nee:
        nee_able = hit & valid & ~pick_t
        rng_n1, k0 = _pcg_next(rng)
        rng_n2, k1 = _pcg_next(rng_n1)
        rng_n3, k2l = _pcg_next(rng_n2)
        rng_n4, k3 = _pcg_next(rng_n3)
        rng = _where(nee_able, rng_n4, rng)
        if light_types:
            (ldx, ldy, ldz, ldist, pw_r, pw_g, pw_b, ipdf_l, ds0, ds1) = sample_lights(
                lights, light_types, k0, k1, k2l, k3, posx, posy, posz)
            pw_scale = f32(np.float32(p[P_LIGHT_MULT]) * np.float32(p[P_EXP2_EXPOSURE]))
            pw_r, pw_g, pw_b = pw_r * pw_scale, pw_g * pw_scale, pw_b * pw_scale
            ipdf_l = ipdf_l * float(len(light_types))
            lwx = ldx * t1x + ldy * t1y + ldz * t1z
            lwy = ldx * t2x + ldy * t2y + ldz * t2z
            lwz = ldx * nx + ldy * ny + ldz * nz
            efd, efg, epdf = eval_lobes(lwx, lwy, lwz)
            gdot = ldx * gnx + ldy * gny + ldz * gnz
            nee_valid = nee_able & (ldist > 0.0) & (gdot > 0.0) & (epdf > 0.0)
            # reference quirk: the throughput here already includes this
            # bounce's bsdf_over_pdf (rp_main.chit:360-389 then :393-444)
            c = [_where(nee_valid, tp * pw * ipdf_l * (a * ds0 + b * ds1), 0.0)
                 for tp, pw, a, b in zip((tpx, tpy, tpz), (pw_r, pw_g, pw_b), efd, efg)]
            lum_c = 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]
            do_trace = (lum_c > 1e-6) & (ldist > 1e-9)
            occ = torch.zeros_like(do_trace)
            idx = do_trace.nonzero()[:, 0]
            if idx.numel():
                occ[idx] = occluded_fn((ox[idx], oy[idx], oz[idx]),
                                       (ldx[idx], ldy[idx], ldz[idx]), ldist[idx],
                                       rng[idx] ^ SHADOW_SALT)
            add = do_trace & ~occ
            radx = radx + _where(add, c[0], 0.0)
            rady = rady + _where(add, c[1], 0.0)
            radz = radz + _where(add, c[2], 0.0)
            shadow_count = do_trace.to(torch.float32)

    # ---- termination: miss, absorb, throughput cutoff, russian roulette ----
    terminate = miss | (hit & ~valid)
    tp_len2 = tpx * tpx + tpy * tpy + tpz * tpz
    terminate = terminate | (alive & (tp_len2 < 1e-18))
    do_rr = alive & (bounce > p[P_RR_OFFSET])
    rng_rr, krr = _pcg_next(rng)
    rng = _where(do_rr, rng_rr, rng)
    max_tp = torch.maximum(tpx, torch.maximum(tpy, tpz))
    p_rr = torch.clamp(max_tp, max=p[P_RR_INV_MIN])
    rr_kill = do_rr & (krr > p_rr)
    # the ~miss guard keeps the throughput rows at their at-miss value
    rr_scale = _where(do_rr & ~rr_kill & ~miss, 1.0 / torch.clamp(p_rr, min=1e-20), 1.0)
    tpx, tpy, tpz = tpx * rr_scale, tpy * rr_scale, tpz * rr_scale
    terminate = terminate | rr_kill
    new_alive = alive & ~terminate

    out = torch.stack([
        ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, radx, rady, radz,
        u32_to_f32_bits(rng), new_alive.to(torch.float32), miss_rec,
        s[15] + _where(alive, 1.0, 0.0) + shadow_count,
    ])
    state.copy_(out)
