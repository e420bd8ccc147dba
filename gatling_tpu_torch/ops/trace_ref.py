"""Plain PyTorch twins of the trace kernels: K5-K8, all brute force, and B1/B2.

They compute what csrc/trace.cu computes, with the same f32 operations in
the same order: the coefficient form's dot products as explicit sums over
the structurally non-zero features in ascending order (not `feat @ C`,
whose summation order a BLAS chooses), the elementwise Moller-Trumbore of
`_mt_tile` operation for operation, and the TPU kernels' selection rule
(ops/trace.py). A CPU tensor takes these; the CUDA kernels are held
against them on the card. `matrix_work` and `occluded_work` repeat K5's
and K6's walks of the soup's BVH step for step (their answer and their
work); `tiles_work` counts where K7's and K8's pairs are decided. Rays go
in chunks of RAY_CHUNK, so the [rays, 128] temporaries stay small; a
ray's result does not depend on its chunk.

The twins of B1 and B2, `intersect_threaded_ref` and
`occluded_threaded_ref`, are not brute force: they are the JAX package's
lockstep `traverse` (gatling_tpu/ops/bvh.py:202-263) over the same
threaded BVH (ops/bvh.py ThreadedBvh), step for step, in the arithmetic
XLA compiles it to on the CPU (its leaf test's products and sums
contracted into fused multiply-adds, `fma_f32`; B1 and B2 take
__fmaf_rn); `threaded_work` counts their walks' slab and triangle tests.
The kernels walk the same tree's wide rows (ops/bvh.py wide_rows) with a
stack; `wide_work` is a plain model of that walk, for the tests (its
answer equals the twins' on every ray) and for the work it counts.
"""

from __future__ import annotations

import numpy as np
import torch

from gatling_tpu_torch.interface import BARY_EPS, FLOAT_MAX
from gatling_tpu_torch.ops.bounce_ref import bvh_walk
from gatling_tpu_torch.ops.bvh import (LEAF_BITS, LEAF_SIZE, WIDE, WIDE_ROW, WIDE_STACK,
                                       ThreadedBvh, TriBvh)

TRI_TILE = 128
RAY_CHUNK = 131072
DET_EPS = float(np.float32(1e-12))
NEG_EPS = float(-BARY_EPS)
ONE_PLUS_EPS = float(np.float32(1.0) + BARY_EPS)  # 1 + 2**-20
# (feature, coefficient row) pairs of each numerator with a non-zero
# coefficient, features f = [o, d, vec(o d^T), 1] (f[6 + 3i + j] = o_i d_j)
DET_TERMS = (3, 4, 5)
T_TERMS = (0, 1, 2, 15)
UV_TERMS = (3, 4, 5, 7, 8, 9, 11, 12, 13)


def ray_features(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """[R, 16] feature vector [o, d, vec(o d^T), 1] (pallas_trace.py:97-102)."""
    od = (origins[:, :, None] * dirs[:, None, :]).reshape(-1, 9)
    return torch.cat([origins, dirs, od, torch.ones_like(origins[:, :1])], dim=1)


def _dot(f: torch.Tensor, c: torch.Tensor, terms, group: int) -> torch.Tensor:
    """sum_k f[:, k] * c[k, group lanes] over `terms`, left to right; the
    constant feature 15 contributes its coefficient exactly."""
    lanes = slice(group * TRI_TILE, (group + 1) * TRI_TILE)
    acc = None
    for k in terms:
        term = c[k, lanes][None, :] if k == 15 else f[:, k:k + 1] * c[k, lanes][None, :]
        acc = term if acc is None else acc + term
    return acc


def _valid(det, tn, un, vn, tmin, tmax):
    """(t, u, v, valid) of candidates, tmin and tmax broadcast to them."""
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    t, u, v = tn * inv, un * inv, vn * inv
    valid = (ok & (u >= NEG_EPS) & (v >= NEG_EPS) & (u + v <= ONE_PLUS_EPS)
             & (t > tmin) & (t < tmax))
    return t, u, v, valid


def _matrix_tile(f, c, tmin, tmax):
    det = _dot(f, c, DET_TERMS, 0)
    return _valid(det, _dot(f, c, T_TERMS, 1), _dot(f, c, UV_TERMS, 2),
                  _dot(f, c, UV_TERMS, 3), tmin[:, None], tmax[:, None])


def _mt_det(d, tile):
    """_mt_tile's p = d x e2 and det = e1 . p."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1x, e1y, e1z, e2x, e2y, e2z = (tile[k][None, :] for k in range(3, 9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    return px, py, pz, e1x * px + e1y * py + e1z * pz


def _mt_tile(o, d, tile, tmin, tmax):
    """Elementwise Moller-Trumbore of rays [n] against a [9, 128] tile
    (pallas_trace.py _mt_tile)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tile[k][None, :] for k in range(9))
    px, py, pz, det = _mt_det(d, tile)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = (ok & (u >= NEG_EPS) & (v >= NEG_EPS) & (u + v <= ONE_PLUS_EPS)
             & (t > tmin[:, None]) & (t < tmax[:, None]))
    return t, u, v, valid


def _closest(origins, dirs, tmin, tmax, table, matrix: bool):
    """(t, tri, u, v) of the closest valid hit; the lowest triangle index
    wins a tie (within a tile the lowest lane, across tiles the earlier)."""
    r = origins.shape[0]
    dev = origins.device
    t_out = torch.full((r,), float(FLOAT_MAX), dtype=torch.float32, device=dev)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    for a in range(0, r, RAY_CHUNK):
        o, d = origins[a:a + RAY_CHUNK], dirs[a:a + RAY_CHUNK]
        lo, hi = tmin[a:a + RAY_CHUNK], tmax[a:a + RAY_CHUNK]
        f = ray_features(o, d) if matrix else None
        best_t, best_tri = t_out[a:a + RAY_CHUNK], tri_out[a:a + RAY_CHUNK]
        best_u, best_v = u_out[a:a + RAY_CHUNK], v_out[a:a + RAY_CHUNK]
        for j in range(table.shape[0]):
            if matrix:
                t, u, v, valid = _matrix_tile(f, table[j], lo, hi)
                valid = valid & (t < best_t[:, None])
            else:
                t, u, v, valid = _mt_tile(o, d, table[j], lo, torch.minimum(hi, best_t))
            tm = torch.where(valid, t, float(FLOAT_MAX))
            lane = torch.argmin(tm, dim=1, keepdim=True)  # the first of equal minima
            tile_min = torch.gather(tm, 1, lane)[:, 0]
            better = tile_min < best_t
            best_tri.copy_(torch.where(better, j * TRI_TILE + lane[:, 0].to(torch.int32),
                                       best_tri))
            best_u.copy_(torch.where(better, torch.gather(u, 1, lane)[:, 0], best_u))
            best_v.copy_(torch.where(better, torch.gather(v, 1, lane)[:, 0], best_v))
            best_t.copy_(torch.where(better, tile_min, best_t))
    return t_out, tri_out, u_out, v_out


def _first_occluder(origins, dirs, tmin, tmax, table, matrix: bool) -> torch.Tensor:
    """[R] int32: the lowest index of a triangle with a valid hit in
    (tmin, tmax), -1 for none. Any such triangle occludes; the index is
    where the kernels' lane-order search stops."""
    r = origins.shape[0]
    out = torch.full((r,), -1, dtype=torch.int32, device=origins.device)
    for a in range(0, r, RAY_CHUNK):
        o, d = origins[a:a + RAY_CHUNK], dirs[a:a + RAY_CHUNK]
        lo, hi = tmin[a:a + RAY_CHUNK], tmax[a:a + RAY_CHUNK]
        f = ray_features(o, d) if matrix else None
        first = out[a:a + RAY_CHUNK]
        for j in range(table.shape[0]):
            valid = (_matrix_tile(f, table[j], lo, hi) if matrix
                     else _mt_tile(o, d, table[j], lo, hi))[3]
            lane = torch.argmax(valid.to(torch.uint8), dim=1).to(torch.int32)
            first.copy_(torch.where((first < 0) & valid.any(dim=1), j * TRI_TILE + lane, first))
    return out


def _leaf_test(bvh: TriBvh, origins, dirs, tmin, tmax):
    """bvh_walk's test of K5's and K6's leaves: each leaf triangle's
    numerators summed from its 25 leaf coefficients in _dot's order and
    selected by _valid over the ray's (tmin, tmax)."""
    f = ray_features(origins, dirs)

    def test(slot, ray):
        q, fr = bvh.rows[slot], f[ray]
        sums, off = [], 0
        for terms in (DET_TERMS, T_TERMS, UV_TERMS, UV_TERMS):
            acc = None
            for j, k in enumerate(terms):
                term = q[:, off + j] if k == 15 else fr[:, k] * q[:, off + j]
                acc = term if acc is None else acc + term
            sums.append(acc)
            off += len(terms)
        return _valid(*sums, tmin[ray], tmax[ray])

    return test


def matrix_work(bvh: TriBvh, origins, dirs, tmin, tmax):
    """K5's walk of the soup's TriBvh (ops/trace.py TraceTables.bvh) for
    rays o, d [R, 3] in (tmin, tmax) [R], as bounce_ref.bvh_walk with
    _leaf_test. Returns (t, tri, u, v, boxes, tests), each [R]: the hit
    intersect_matrix_ref finds, and the slab and triangle tests the walk
    made."""
    t, u, v, win, boxes, tests = bvh_walk(bvh, origins, dirs, tmax > tmin, tmin, tmax,
                                          _leaf_test(bvh, origins, dirs, tmin, tmax))
    return t, win.to(torch.int32), u, v, boxes, tests


def occluded_work(bvh: TriBvh, origins, dirs, tmin, tmax):
    """K6's any-hit walk of the same tree, as bvh_walk(..., any_hit=True)
    with _leaf_test: the segment's end never lowered, the walk ended at
    its first valid candidate. Returns (flag, boxes, tests), each [R]: the
    flag occluded_matrix_ref computes, and the slab and triangle tests the
    walk made."""
    _t, _u, _v, win, boxes, tests = bvh_walk(bvh, origins, dirs, tmax > tmin, tmin, tmax,
                                             _leaf_test(bvh, origins, dirs, tmin, tmax),
                                             any_hit=True)
    return win >= 0, boxes, tests


def tiles_work(origins, dirs, tmin, tmax, tris, last):
    """What K7's and K8's search needs of each ray: over the triangles 0 ..
    last[ray] of tris [n_tiles, 9, 128] (K7: every real one; K8: up to its
    first occluder), the pairs decided at det (|det| <= 1e-12), those
    decided at u (|det| > 1e-12 and u outside [-1e-6, 2], invalid whatever
    v is, as trace.cu u_may_hit), and the pairs. Returns (at_det, at_u,
    pairs), each [R] int64, zeros for a dead ray."""
    r = origins.shape[0]
    out = torch.zeros((3, r), dtype=torch.int64, device=origins.device)
    lanes = torch.arange(TRI_TILE, device=origins.device)
    for a in range(0, r, RAY_CHUNK):
        o, d = origins[a:a + RAY_CHUNK], dirs[a:a + RAY_CHUNK]
        lo, hi = tmin[a:a + RAY_CHUNK], tmax[a:a + RAY_CHUNK]
        lim = torch.where(hi > lo, last[a:a + RAY_CHUNK], -1)[:, None]
        counts = out[:, a:a + RAY_CHUNK]
        for j in range(tris.shape[0]):
            tested = j * TRI_TILE + lanes[None, :] <= lim
            ok = _mt_det(d, tris[j])[3].abs() > DET_EPS
            u = _mt_tile(o, d, tris[j], lo, hi)[1]
            at_u = ok & ~((u >= NEG_EPS) & (u <= 2.0))
            counts[0] += (tested & ~ok).sum(dim=1)
            counts[1] += (tested & at_u).sum(dim=1)
            counts[2] += tested.sum(dim=1)
    return out[0], out[1], out[2]


def intersect_matrix_ref(origins, dirs, tmin, tmax, coeffs):
    """K5's twin: closest hit from coeffs [n_tiles, 16, 512]."""
    return _closest(origins, dirs, tmin, tmax, coeffs, True)


def occluded_matrix_ref(origins, dirs, tmin, tmax, coeffs, first: bool = False):
    """K6's twin: [R] bool, any valid hit; with `first` the index of the
    first occluding triangle ([R] int32, -1 for none)."""
    idx = _first_occluder(origins, dirs, tmin, tmax, coeffs, True)
    return idx if first else idx >= 0


def intersect_tiles_ref(origins, dirs, tmin, tmax, tris):
    """K7's twin: closest hit by elementwise MT over tris [n_tiles, 9, 128]."""
    return _closest(origins, dirs, tmin, tmax, tris, False)


def occluded_tiles_ref(origins, dirs, tmin, tmax, tris, first: bool = False):
    """K8's twin, as occluded_matrix_ref over the [n_tiles, 9, 128] tiles."""
    idx = _first_occluder(origins, dirs, tmin, tmax, tris, False)
    return idx if first else idx >= 0


# ---------------------------------------------------------------------------
# B1/B2's twins: the JAX package's threaded-BVH `traverse` in lockstep
# ---------------------------------------------------------------------------

def _slab_threaded(o, inv_d, tmin, tmax, row):
    """The JAX `_slab_test` of rays [R] against their nodes' boxes (row
    [R, 8]: bbox_min xyz, bbox_max xyz): torch.minimum and maximum carry a
    NaN through, as jnp's and the kernel's min.NaN / max.NaN do."""
    t0 = (row[:, 0:3] - o) * inv_d
    t1 = (row[:, 3:6] - o) * inv_d
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tfar = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return (tnear <= tfar) & (tfar >= tmin) & (tnear <= tmax)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The f32 fused multiply-add a * b + c with one rounding (the kernels'
    __fmaf_rn; XLA contracts the JAX walk's products and sums into it on
    the CPU). The product is exact in f64; the sum rounded to f64 and then
    to f32 rounds twice only where the f64 sum sits on the midpoint of two
    f32 values, and there the sign of its rounding error (TwoSum) picks
    the side of the exact sum."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    r = s.float()
    rd = r.double()
    toward = torch.nextafter(r, torch.where(s > rd, float("inf"), float("-inf")).float())
    z = s - p
    err = (p - (s - z)) + (cd - z)  # s + err == p + c exactly
    past_mid = (s == (rd + toward.double()) * 0.5) & (err * (toward.double() - rd) > 0.0)
    return torch.where(past_mid, toward, r)


def _leaf_tests(o, d, tri, tmin):
    """The JAX `_leaf_intersect` of rays [R] against LEAF_SIZE gathered
    triangles each (tri [R, K, 12]: v0, e1, e2), in XLA's arithmetic on
    the CPU: jnp.cross's components as fma(a1, b2, -(a2 b1)), each sum of
    three products as fma(a2, b2, fma(a1, b1, fma(a0, b0, +0))), the
    reduction's +0 start kept (so that products of -0 alone sum to +0).
    Returns (t, u, v, valid over (tmin, inf)) [R, K]; the caller adds t <
    its segment's end."""
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*o.unbind(1), *d.unbind(1)))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[:, :, :9].unbind(2)

    def cross(a0, a1, a2, b0, b1, b2):
        return (fma_f32(a1, b2, -(a2 * b1)), fma_f32(a2, b0, -(a0 * b2)),
                fma_f32(a0, b1, -(a1 * b0)))

    def dot(a0, a1, a2, b0, b1, b2):  # fma(a0, b0, +0): the f64 product is exact
        return fma_f32(a2, b2, fma_f32(a1, b1, (a0.double() * b0.double() + 0.0).float()))

    px, py, pz = cross(dx, dy, dz, e2x, e2y, e2z)
    det = dot(px, py, pz, e1x, e1y, e1z)
    ok = det.abs() > DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = dot(tx, ty, tz, px, py, pz) * inv
    qx, qy, qz = cross(tx, ty, tz, e1x, e1y, e1z)
    v = dot(dx, dy, dz, qx, qy, qz) * inv
    t = dot(e2x, e2y, e2z, qx, qy, qz) * inv
    valid = ok & (u >= NEG_EPS) & (v >= NEG_EPS) & (u + v <= ONE_PLUS_EPS) & (t > tmin[:, None])
    return t, u, v, valid


def _threaded_walk(origins, dirs, tmin, tmax, bvh: ThreadedBvh, any_hit: bool):
    """Every ray's walk of the threaded BVH, all in lockstep as the JAX
    `traverse`: at each step a ray tests its node's box over (tmin,
    min(tmax, best t)); on a hit it descends to node + 1, or at a leaf
    tests its at most LEAF_SIZE triangles in index order and keeps a hit
    only with t < best t (the closest hit, the lower reordered index on a
    tie), or (`any_hit`) stops at the first valid one; on a miss, and
    after a leaf, it jumps to the node's skip link. A ray with tmax <=
    tmin has no valid hit and walks nothing (the JAX walk would, to the
    same result). Rays that finish leave the lockstep set, so a step costs
    what its walking rays need. Returns (t, tri, u, v, hit, boxes, tests):
    the closest hit, the any-hit flag, and the slab and triangle tests
    each ray made ([R] int64; with `any_hit`, the tests of a leaf up to
    its first valid one)."""
    r, dev = origins.shape[0], origins.device
    n, n_tris = bvh.num_nodes, bvh.tris.shape[0]
    words = bvh.nodes.view(torch.int32)
    out_t = torch.full((r,), float(FLOAT_MAX), dtype=torch.float32, device=dev)
    out_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    out_u, out_v = torch.zeros_like(out_t), torch.zeros_like(out_t)
    out_hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    boxes = torch.zeros((r,), dtype=torch.int64, device=dev)
    tests = torch.zeros_like(boxes)
    idx = torch.nonzero(tmax > tmin)[:, 0]
    o, d, lo, hi = origins[idx], dirs[idx], tmin[idx], tmax[idx]
    inv_d = 1.0 / d
    node = torch.zeros_like(idx)
    best_t = torch.full_like(lo, float(FLOAT_MAX))
    best_tri = torch.full_like(idx, -1, dtype=torch.int32)
    best_u, best_v = torch.zeros_like(lo), torch.zeros_like(lo)
    hit = torch.zeros_like(idx, dtype=torch.bool)
    n_box, n_test = torch.zeros_like(idx), torch.zeros_like(idx)
    lanes = torch.arange(LEAF_SIZE, device=dev)
    while idx.numel():
        w = words[node]
        hit_box = _slab_threaded(o, inv_d, lo, torch.minimum(hi, best_t), bvh.nodes[node])
        count = w[:, 7] & ((1 << LEAF_BITS) - 1)
        start = (w[:, 7] >> LEAF_BITS).long()
        do_leaf = hit_box & (count > 0)
        n_box += 1
        tri_idx = torch.clamp(start[:, None] + lanes, max=n_tris - 1)
        in_range = do_leaf[:, None] & (lanes < count[:, None])
        t, u, v, valid = _leaf_tests(o, d, bvh.tris[tri_idx], lo)
        for k in range(LEAF_SIZE):  # in index order, each against the best t so far
            ok = valid[:, k] & in_range[:, k] & (t[:, k] < torch.minimum(hi, best_t))
            if any_hit:
                n_test += in_range[:, k] & ~hit
                hit = hit | ok
            else:
                n_test += in_range[:, k]
                better = ok & (t[:, k] < best_t)
                best_tri = torch.where(better, tri_idx[:, k].to(torch.int32), best_tri)
                best_u = torch.where(better, u[:, k], best_u)
                best_v = torch.where(better, v[:, k], best_v)
                best_t = torch.where(better, t[:, k], best_t)
        node = torch.where(hit_box & (count == 0), node + 1, w[:, 6].long())
        if any_hit:
            node = torch.where(hit, n, node)
        done = node >= n
        if bool(done.any()):  # the finished rays' results out, the rest go on
            at = idx[done]
            out_t[at], out_tri[at], out_u[at], out_v[at] = (best_t[done], best_tri[done],
                                                             best_u[done], best_v[done])
            out_hit[at], boxes[at], tests[at] = hit[done], n_box[done], n_test[done]
            keep = ~done
            idx, o, d, inv_d, lo, hi, node = (x[keep] for x in (idx, o, d, inv_d, lo, hi, node))
            best_t, best_tri, best_u, best_v, hit, n_box, n_test = (
                x[keep] for x in (best_t, best_tri, best_u, best_v, hit, n_box, n_test))
    return out_t, out_tri, out_u, out_v, out_hit, boxes, tests


def intersect_threaded_ref(origins, dirs, tmin, tmax, bvh: ThreadedBvh):
    """B1's twin: the closest hit (t, tri, u, v) of rays o, d [R, 3] in
    (tmin, tmax) [R] by the JAX `traverse_closest` walk; tri indexes the
    reordered soup (bvh.tris)."""
    return _threaded_walk(origins, dirs, tmin, tmax, bvh, False)[:4]


def occluded_threaded_ref(origins, dirs, tmin, tmax, bvh: ThreadedBvh):
    """B2's twin: [R] bool, any valid hit in (tmin, tmax), by the JAX
    `traverse_occluded` walk."""
    return _threaded_walk(origins, dirs, tmin, tmax, bvh, True)[4]


def threaded_work(origins, dirs, tmin, tmax, bvh: ThreadedBvh, any_hit: bool = False):
    """B1's (or with `any_hit` B2's) walk: (answer, boxes, tests), the
    answer the twin's ((t, tri, u, v), or the flag) and the slab and
    triangle tests each ray's walk makes ([R] int64), for the bound."""
    t, tri, u, v, hit, boxes, tests = _threaded_walk(origins, dirs, tmin, tmax, bvh, any_hit)
    return (hit if any_hit else (t, tri, u, v)), boxes, tests


def _child_slabs(o, inv_d, row):
    """The JAX `_slab_test`'s tnear and tfar of rays [m] against the WIDE
    children of their wide rows (row [m, WIDE_ROW]): [m, WIDE] each, an
    empty slot's NaN."""
    lo = row[:, 0:3 * WIDE].view(-1, 3, WIDE)
    hi = row[:, 3 * WIDE:6 * WIDE].view(-1, 3, WIDE)
    t0 = (lo - o[:, :, None]) * inv_d[:, :, None]
    t1 = (hi - o[:, :, None]) * inv_d[:, :, None]
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tfar = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return tnear, tfar


def _wide_walk(origins, dirs, tmin, tmax, bvh: ThreadedBvh, any_hit: bool):
    """B1's (B2's with `any_hit`) walk of the wide rows, as csrc/trace.cu
    makes it for one ray, every ray in lockstep. A ray tests the root's
    box (node row 0) over (tmin, min(tmax, best t)), then at each wide row
    all its children's boxes; it goes on with the first child that passes
    and stacks the others with their tnear, in preorder (the binary
    walk's order). A leaf's triangles are tested as the twin tests them.
    A stacked child is taken again only when its tnear is still <=
    min(tmax, best t), the test the binary walk makes at that node with
    the same best t (B2's cap never changes). A ray whose 1/d has a
    non-finite component, and every ray of a tree without wide rows,
    walks the node rows (_threaded_walk). The kernel's lanes walk in
    step and a lane may walk a few rows past a leaf it has set aside
    before the warp tests it (trace.cu wide_walk): those rows are not
    counted here.
    Returns (t, tri, u, v, hit, rows, slabs, tests, binary): the answer,
    and per ray ([R]) the rows fetched (node or wide rows), the boxes
    tested (all WIDE slots of a wide row, as the kernels test them, and
    the root's box), the triangle tests and whether it walked the node
    rows."""
    r, dev = origins.shape[0], origins.device
    n_tris = bvh.tris.shape[0]
    out_t = torch.full((r,), float(FLOAT_MAX), dtype=torch.float32, device=dev)
    out_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    out_u, out_v = torch.zeros_like(out_t), torch.zeros_like(out_t)
    out_hit = torch.zeros((r,), dtype=torch.bool, device=dev)
    rows = torch.zeros((r,), dtype=torch.int64, device=dev)
    slabs, tests = torch.zeros_like(rows), torch.zeros_like(rows)
    binary = ~torch.isfinite(1.0 / dirs).all(dim=1) | (bvh.wide.shape[0] == 0)
    if bool(binary.any()):
        at = torch.nonzero(binary)[:, 0]
        res = _threaded_walk(origins[at], dirs[at], tmin[at], tmax[at], bvh, any_hit)
        out_t[at], out_tri[at], out_u[at], out_v[at], out_hit[at] = res[:5]
        rows[at], slabs[at], tests[at] = res[5], res[5], res[6]
    idx = torch.nonzero(~binary & (tmax > tmin))[:, 0]
    o, d, lo, hi = origins[idx], dirs[idx], tmin[idx], tmax[idx]
    inv_d = 1.0 / d
    m = idx.numel()
    best_t = torch.full_like(lo, float(FLOAT_MAX))
    best_tri = torch.full((m,), -1, dtype=torch.int32, device=dev)
    best_u, best_v = torch.zeros_like(lo), torch.zeros_like(lo)
    hit = torch.zeros((m,), dtype=torch.bool, device=dev)
    n_rows = torch.ones((m,), dtype=torch.int64, device=dev)  # the root's node row
    n_slabs, n_tests = n_rows.clone(), torch.zeros_like(n_rows)
    stack_w = torch.zeros((m, WIDE_STACK), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((m, WIDE_STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros((m,), dtype=torch.int64, device=dev)
    cur = torch.full((m,), -1, dtype=torch.int64, device=dev)  # wide row 0
    root = bvh.nodes[:1].expand(m, 8)
    going = _slab_threaded(o, inv_d, lo, torch.minimum(hi, best_t), root)
    lanes = torch.arange(LEAF_SIZE, device=dev)
    rows_i = bvh.wide.view(torch.int32)

    def cap():  # B2's best t stays FLOAT_MAX
        return torch.minimum(hi, best_t)

    while m:
        pop = torch.zeros((m,), dtype=torch.bool, device=dev)
        inner = going & (cur < 0)
        if bool(inner.any()):  # a wide row: every child's box, then on with the first
            w = torch.nonzero(inner)[:, 0]
            row = bvh.wide[-1 - cur[w]]
            tn, tf = _child_slabs(o[w], inv_d[w], row)
            passed = (tn <= tf) & (tf >= lo[w, None]) & (tn <= cap()[w, None])
            n_rows[w] += 1
            n_slabs[w] += WIDE  # every slot, an empty one's NaN box too
            order = torch.sort((~passed).long(), dim=1, stable=True)[1]  # passing, by slot
            words = torch.gather(rows_i[-1 - cur[w], 6 * WIDE:7 * WIDE].long(), 1, order)
            tns = torch.gather(tn, 1, order)
            c = passed.sum(dim=1)
            for j in range(1, WIDE):  # the j-th passing child onto the stack, the last lowest
                put = c > j
                pos = sp[w] + c - 1 - j
                stack_w[w[put], pos[put]] = words[put, j]
                stack_t[w[put], pos[put]] = tns[put, j]
            sp[w] += torch.clamp(c - 1, min=0)
            cur[w] = torch.where(c > 0, words[:, 0], cur[w])
            pop[w] = c == 0
        leaf = going & (cur >= 0)
        if bool(leaf.any()):  # a leaf's triangles, in index order
            f = torch.nonzero(leaf)[:, 0]
            start, count = cur[f] >> LEAF_BITS, cur[f] & ((1 << LEAF_BITS) - 1)
            tri_idx = torch.clamp(start[:, None] + lanes, max=n_tris - 1)
            in_range = lanes < count[:, None]
            t, u, v, valid = _leaf_tests(o[f], d[f], bvh.tris[tri_idx], lo[f])
            bt, btri, bu, bv, bh = best_t[f], best_tri[f], best_u[f], best_v[f], hit[f]
            for k in range(LEAF_SIZE):
                ok = valid[:, k] & in_range[:, k] & (t[:, k] < torch.minimum(hi[f], bt))
                if any_hit:
                    n_tests[f] += in_range[:, k] & ~bh
                    bh = bh | ok
                else:
                    n_tests[f] += in_range[:, k]
                    better = ok & (t[:, k] < bt)
                    btri = torch.where(better, tri_idx[:, k].to(torch.int32), btri)
                    bu = torch.where(better, u[:, k], bu)
                    bv = torch.where(better, v[:, k], bv)
                    bt = torch.where(better, t[:, k], bt)
            best_t[f], best_tri[f], best_u[f], best_v[f], hit[f] = bt, btri, bu, bv, bh
            pop[f] = True
        while True:  # pop until a stacked child still passes its cap, or none is left
            want = pop & going & ~hit & (sp > 0)
            if not bool(want.any()):
                break
            p = torch.nonzero(want)[:, 0]
            sp[p] -= 1
            ok = stack_t[p, sp[p]] <= cap()[p]
            cur[p[ok]] = stack_w[p[ok], sp[p[ok]]]
            pop[p[ok]] = False
        done = ~going | hit | (pop & (sp == 0))
        if bool(done.any()):
            at = idx[done]
            out_t[at], out_tri[at], out_u[at], out_v[at] = (best_t[done], best_tri[done],
                                                             best_u[done], best_v[done])
            out_hit[at], rows[at], slabs[at], tests[at] = (hit[done], n_rows[done],
                                                           n_slabs[done], n_tests[done])
            keep = ~done
            idx, o, d, inv_d, lo, hi, cur, sp, going = (
                x[keep] for x in (idx, o, d, inv_d, lo, hi, cur, sp, going))
            best_t, best_tri, best_u, best_v, hit = (
                x[keep] for x in (best_t, best_tri, best_u, best_v, hit))
            n_rows, n_slabs, n_tests, stack_w, stack_t = (
                x[keep] for x in (n_rows, n_slabs, n_tests, stack_w, stack_t))
            m = idx.numel()
    return out_t, out_tri, out_u, out_v, out_hit, rows, slabs, tests, binary


def wide_work(origins, dirs, tmin, tmax, bvh: ThreadedBvh, any_hit: bool = False):
    """B1's (or with `any_hit` B2's) walk as the kernel makes it, over the
    wide rows (_wide_walk): (answer, rows, slabs, tests, binary), the
    answer ((t, tri, u, v), or the flag; the twins' on every ray) and per
    ray [R] the rows fetched, the boxes and triangles tested, and whether
    it walked the node rows (a non-finite 1/d component)."""
    t, tri, u, v, hit, rows, slabs, tests, binary = _wide_walk(origins, dirs, tmin, tmax, bvh,
                                                               any_hit)
    return (hit if any_hit else (t, tri, u, v)), rows, slabs, tests, binary
