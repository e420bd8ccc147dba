"""Plain PyTorch twins of the trace kernels K5-K8, all brute force.

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
"""

from __future__ import annotations

import numpy as np
import torch

from gatling_tpu_torch.interface import BARY_EPS, FLOAT_MAX
from gatling_tpu_torch.ops.bounce_ref import bvh_walk
from gatling_tpu_torch.ops.bvh import TriBvh

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
