"""Brute-force trace of the wavefront integrator: tables and the kernels K5-K8.

The port of the JAX package's ops/pallas_trace.py. All four
Moller-Trumbore quantities are trilinear in the ray origin o and direction
d once per-triangle coefficients are precomputed:

    det  = e1 . (d x e2)            =  <d,    D(tri)>
    tnum = e2 . ((o - v0) x e1)     =  <o,    T(tri)> + const(tri)
    unum = (o - v0) . (d x e2)      =  <o o d, U(tri)> + <d, U'(tri)>
    vnum = d . ((o - v0) x e1)      =  <o o d, V(tri)> + <d, V'(tri)>

so with the 16 ray features f = [o, d, vec(o d^T), 1] each is a dot
product with a column of `TraceTables.coeffs` [n_tiles, 16, 4 * 128]
(column groups det | tnum | unum | vnum, 128 triangles a tile). The
elementwise form's twins read `TriTiles.tris` [n_tiles, 9, 128] (v0, e1,
e2 by component), its kernels `TriTiles.rows`, one row a real triangle;
`trace_ref.ray_features` builds f. Entry points, each on a
CUDA tensor the hand-written kernel of csrc/trace.cu (built at first use,
ops/cuda_lib.py; a failed build or launch raises) and on a CPU tensor its
twin in ops/trace_ref.py:

* `intersect_matrix` (K5, `intersect_pallas`) and `occluded_matrix` (K6,
  `occluded_pallas`): the tracer of the wavefront integrator for scenes
  of at most 8192 triangles (gi.py `_choose_tracer`). On the card both
  walk a BVH over the soup (`TraceTables.bvh`, ops/bvh.py) instead of
  testing every triangle, K5 for the closest hit and K6 to its first
  occluder, and find the twins' hit and flag bit for bit;
* `intersect_tiles` (K7, `intersect_pallas_vpu`) and `occluded_tiles`
  (K8, `occluded_pallas_vpu`): the elementwise form, which no entry point
  of the JAX package reaches (its comparison point); chip_smoke.py holds
  them against their twins and against K5 on the wavefront's waves. On
  the card both test the `n_real` triangles before the lane padding and
  nothing after (a padding row has det = 0 and never hits), K7 with four
  rays a thread, K8 with a group of lanes a shadow ray (csrc/trace.cu);
* `intersect_threaded` (B1) and `occluded_threaded` (B2): the tracer of
  the wavefront above 8192 triangles (`tracer="bvh"`), the JAX package's
  threaded-BVH walk `traverse` (gatling_tpu/ops/bvh.py, an XLA loop, no
  Pallas kernel) over a ThreadedBvh (ops/bvh.py); on the card a walk of
  its 4-wide rows, one thread a ray with a short stack, the lanes of a
  warp in step, bit-equal to the twins, which repeat the JAX walk in
  lockstep over its node rows.

`launches` counts the kernel launches made on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.ops.bvh import WIDE_ROW, ThreadedBvh, TriBvh, tri_bvh
from gatling_tpu_torch.ops import validate
from gatling_tpu_torch.ops.cuda_lib import I32, I64, PTR, CudaLibrary, check_tensor
from gatling_tpu_torch.ops.geometry import real_triangles
from gatling_tpu_torch.ops.intersect import Hit
from gatling_tpu_torch.ops.trace_ref import (
    DET_TERMS,
    T_TERMS,
    TRI_TILE,
    UV_TERMS,
    intersect_matrix_ref,
    intersect_threaded_ref,
    intersect_tiles_ref,
    occluded_matrix_ref,
    occluded_threaded_ref,
    occluded_tiles_ref,
)

N_FEATURES = 16


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)


class TraceTables(NamedTuple):
    """Per-triangle coefficient matrices, tiled: coeffs [n_tiles, 16, 512],
    and the BVH over the soup that K5 and K6 walk (leaf rows: the 25
    structurally non-zero coefficients of each triangle, DET_TERMS,
    T_TERMS, UV_TERMS twice)."""

    coeffs: torch.Tensor
    n_tris: int
    bvh: TriBvh


class TriTiles(NamedTuple):
    """The soup's v0, e1, e2 by component, tiled: tris [n_tiles, 9, 128]
    (the twins' table); n_real, the triangles before the lane padding; and
    rows [n_real, 12], each real triangle's v0, e1, e2 and three zeros (the
    kernels' table: 48-byte rows, three 16-byte loads)."""

    tris: torch.Tensor
    n_tris: int
    n_real: int
    rows: torch.Tensor


def build_trace_tables(geom, device) -> TraceTables:
    """The [16, 4T] coefficient matrix of the soup (pallas_trace.py:60-94):
    its einsums written out as f32 cross and dot products, which round as
    the JAX package's do. Padded (degenerate) triangles have all-zero
    coefficients, so det = 0 and they never hit."""
    v0, e1, e2 = (np.asarray(getattr(geom, k), np.float32) for k in ("v0", "e1", "e2"))
    t = v0.shape[0]
    if t % TRI_TILE:
        raise ValueError(f"the soup has {t} triangles, not a multiple of {TRI_TILE}")
    e2_v0 = _cross(e2, v0)
    zero = np.zeros(t, np.float32)
    c = np.zeros((t, N_FEATURES, 4), np.float32)
    c[:, 3:6, 0] = _cross(e2, e1)                                       # det: d
    c[:, 0:3, 1] = _cross(e1, e2)                                       # tnum: o
    c[:, 15, 1] = -((e1[:, 0] * e2_v0[:, 0] + e1[:, 1] * e2_v0[:, 1])
                    + e1[:, 2] * e2_v0[:, 2])                           # tnum: 1
    # unum: o_i d_j (the Levi-Civita entries of e2), then d
    c[:, 6:15, 2] = np.stack([zero, e2[:, 2], -e2[:, 1], -e2[:, 2], zero, e2[:, 0],
                              e2[:, 1], -e2[:, 0], zero], axis=1)
    c[:, 3:6, 2] = -e2_v0
    # vnum: o_j d_i (those of e1, transposed), then d
    c[:, 6:15, 3] = np.stack([zero, -e1[:, 2], e1[:, 1], e1[:, 2], zero, -e1[:, 0],
                              -e1[:, 1], e1[:, 0], zero], axis=1)
    c[:, 3:6, 3] = -_cross(v0, e1)
    rows = np.zeros((t, 28), np.float32)
    rows[:, :25] = np.concatenate([c[:, DET_TERMS, 0], c[:, T_TERMS, 1], c[:, UV_TERMS, 2],
                                   c[:, UV_TERMS, 3]], axis=1)
    corners = np.stack([v0, v0 + e1.astype(np.float64), v0 + e2.astype(np.float64)], axis=1)
    # det = <d, c[:, 3:6, 0]>: a triangle whose three are 0 never hits
    # (the padding); it goes into no leaf
    bvh = tri_bvh(corners.astype(np.float64), (c[:, 3:6, 0] != 0.0).any(axis=1), rows, device)
    n_tiles = t // TRI_TILE
    c = c.reshape(n_tiles, TRI_TILE, N_FEATURES, 4)
    c = np.ascontiguousarray(c.transpose(0, 2, 3, 1)).reshape(n_tiles, N_FEATURES, 4 * TRI_TILE)
    return TraceTables(coeffs=torch.tensor(c, device=device), n_tris=t, bvh=bvh)


def build_tri_tiles(geom, device) -> TriTiles:
    """[n_tiles, 9, 128] tiles of v0, e1, e2 (pallas_trace.py:276-281),
    and the rows of the triangles before the padding (real_triangles), so
    a degenerate real triangle before the last real one is still tested."""
    data = np.concatenate([np.asarray(geom.v0), np.asarray(geom.e1), np.asarray(geom.e2)],
                          axis=1).astype(np.float32)
    t = data.shape[0]
    if t % TRI_TILE:
        raise ValueError(f"the soup has {t} triangles, not a multiple of {TRI_TILE}")
    tiles = np.ascontiguousarray(data.reshape(t // TRI_TILE, TRI_TILE, 9).transpose(0, 2, 1))
    n_real = real_triangles(geom)
    rows = np.zeros((n_real, 12), np.float32)
    rows[:, :9] = data[:n_real]
    return TriTiles(tris=torch.tensor(tiles, device=device), n_tris=t, n_real=n_real,
                    rows=torch.tensor(rows, device=device))


class TraceKernel(CudaLibrary):
    """csrc/trace.cu built with nvcc and loaded with ctypes."""

    def __init__(self) -> None:
        # K7/K8: o d tmin tmax, the rows, n_real n_rays; K5/K6: o d tmin
        # tmax, the TriBvh's nodes kids rows, n_rays; B1/B2: o d tmin tmax,
        # the ThreadedBvh's nodes n_nodes wide n_wide tris, n_rays
        tiles = [PTR, PTR, PTR, PTR, PTR, I32, I64]
        walk = [PTR, PTR, PTR, PTR, PTR, PTR, PTR, I64]
        threaded = [PTR, PTR, PTR, PTR, PTR, I32, PTR, I32, PTR, I64]
        closest = [PTR, PTR, PTR, PTR, PTR]  # t tri u v stream
        occluded = [PTR, PTR]                # hit stream
        super().__init__("trace.cu", {
            "gatling_intersect_matrix": walk + closest, "gatling_occluded_matrix": walk + occluded,
            "gatling_intersect_tiles": tiles + closest, "gatling_occluded_tiles": tiles + occluded,
            "gatling_intersect_threaded": threaded + closest,
            "gatling_occluded_threaded": threaded + occluded,
            "gatling_trace_layout": [PTR],
        }, "gatling_trace_error_string")

    def layout(self) -> dict[str, int]:
        """K7's and K8's constants in the built source: rays a K7 thread,
        lanes a K8 shadow ray, rows a K8 lane tests a step, the rows staged
        whole, the rows of a streamed chunk, threads a block, rays a K8
        block lists at once."""
        out = (ctypes.c_int * 8)()
        self.call("gatling_trace_layout", ctypes.addressof(out))
        return dict(zip(("k7_rays", "k8_group", "k8_rows", "resident_rows", "chunk_rows",
                         "k7_threads", "k8_threads", "k8_batch"), out))

    @staticmethod
    def _check_rays(name: str, origins, dirs, tmin, tmax) -> int:
        r = origins.shape[0]
        for label, x in (("origins", origins), ("dirs", dirs), ("tmin", tmin), ("tmax", tmax)):
            check_tensor("trace", label, x, torch.float32)
        if origins.shape != (r, 3) or dirs.shape != (r, 3) or tmin.shape != (r,) \
                or tmax.shape != (r,):
            raise ValueError(f"trace kernel {name}: ray shape mismatch")
        return r

    def launch(self, name: str, origins, dirs, tmin, tmax, tiles: TriTiles, outputs) -> None:
        """K7/K8: a brute-force search over the tiles' real rows."""
        r = self._check_rays(name, origins, dirs, tmin, tmax)
        rows = tiles.rows
        check_tensor("trace", "rows", rows, torch.float32)
        if rows.shape != (tiles.n_real, 12):
            raise ValueError(f"trace kernel {name}: rows shape mismatch")
        if rows.data_ptr() % 16:
            raise ValueError(f"trace kernel {name}: the rows must be 16-byte aligned")
        self.call(name, origins.data_ptr(), dirs.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                  rows.data_ptr(), tiles.n_real, r, *(o.data_ptr() for o in outputs),
                  self.stream(origins))

    def launch_walk(self, name: str, origins, dirs, tmin, tmax, bvh: TriBvh | None,
                    outputs) -> None:
        """K5/K6: a walk over the soup's TriBvh; raises without a tree."""
        r = self._check_rays(name, origins, dirs, tmin, tmax)
        if bvh is None:
            raise ValueError(f"trace kernel {name}: the tables carry no TriBvh to walk")
        for label, x, dt in (("bvh nodes", bvh.nodes, torch.float32),
                             ("bvh kids", bvh.kids, torch.int32),
                             ("bvh rows", bvh.rows, torch.float32)):
            check_tensor("trace", label, x, dt)
        if bvh.nodes.dim() != 2 or bvh.nodes.shape[1] != 8 \
                or bvh.kids.shape != (bvh.nodes.shape[0], 2) or bvh.rows.dim() != 2 \
                or bvh.rows.shape[1] != 28:
            raise ValueError(f"trace kernel {name}: TriBvh shape mismatch")
        self.call(name, origins.data_ptr(), dirs.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                  bvh.nodes.data_ptr(), bvh.kids.data_ptr(), bvh.rows.data_ptr(), r,
                  *(o.data_ptr() for o in outputs), self.stream(origins))

    def launch_threaded(self, name: str, origins, dirs, tmin, tmax, bvh: ThreadedBvh,
                        outputs) -> None:
        """B1/B2: a walk of the ThreadedBvh's wide rows (its node rows for
        the rays the wide rows cannot take)."""
        r = self._check_rays(name, origins, dirs, tmin, tmax)
        check_tensor("trace", "threaded bvh nodes", bvh.nodes, torch.float32)
        check_tensor("trace", "threaded bvh wide rows", bvh.wide, torch.float32)
        check_tensor("trace", "threaded bvh tris", bvh.tris, torch.float32)
        if bvh.nodes.dim() != 2 or bvh.nodes.shape[1] != 8 or bvh.tris.dim() != 2 \
                or bvh.tris.shape[1] != 12 or bvh.wide.dim() != 2 \
                or bvh.wide.shape[1] != WIDE_ROW:
            raise ValueError(f"trace kernel {name}: ThreadedBvh shape mismatch")
        if bvh.nodes.data_ptr() % 16 or bvh.tris.data_ptr() % 16 or bvh.wide.data_ptr() % 16:
            raise ValueError(f"trace kernel {name}: the ThreadedBvh rows must be 16-byte aligned")
        self.call(name, origins.data_ptr(), dirs.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                  bvh.nodes.data_ptr(), bvh.num_nodes, bvh.wide.data_ptr(), bvh.wide.shape[0],
                  bvh.tris.data_ptr(), r, *(o.data_ptr() for o in outputs),
                  self.stream(origins))


_kernel: TraceKernel | None = None
# kernel launches made on CUDA tensors (chip_smoke.py reads them)
launches = {"K5": 0, "K6": 0, "K7": 0, "K8": 0, "B1": 0, "B2": 0}


def kernel() -> TraceKernel:
    """The kernels' build, made at first use."""
    global _kernel
    if _kernel is None:
        _kernel = TraceKernel()
    return _kernel


def _closest_cuda(key, origins, launch) -> Hit:
    r = origins.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=origins.device)
    tri = torch.empty((r,), dtype=torch.int32, device=origins.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    launch((t, tri, u, v))
    launches[key] += 1
    validate.after_launch(key, lambda: (t, u, v))
    return Hit(t, tri, u, v)


def _occluded_cuda(key, origins, launch) -> torch.Tensor:
    hit = torch.empty((origins.shape[0],), dtype=torch.bool, device=origins.device)
    launch((hit,))
    launches[key] += 1
    return hit


def _on_cpu(origins: torch.Tensor) -> bool:
    if origins.is_cuda:
        return False
    if origins.device.type != "cpu":
        raise NotImplementedError(f"the trace kernels run on CUDA or CPU tensors, not "
                                  f"{origins.device}")
    return True


def intersect_matrix(origins, dirs, tmin, tmax, tables: TraceTables) -> Hit:
    """K5 (`intersect_pallas`): the closest hit of rays o, d [R, 3] in
    (tmin, tmax) [R] over the coefficient tables; on the card a walk of
    their BVH, on the CPU the brute-force twin."""
    if _on_cpu(origins):
        return Hit(*intersect_matrix_ref(origins, dirs, tmin, tmax, tables.coeffs))
    return _closest_cuda("K5", origins, lambda out: kernel().launch_walk(
        "gatling_intersect_matrix", origins, dirs, tmin, tmax, tables.bvh, out))


def occluded_matrix(origins, dirs, tmin, tmax, tables: TraceTables) -> torch.Tensor:
    """K6 (`occluded_pallas`): [R] bool, any hit in (tmin, tmax); on the
    card an any-hit walk of the tables' BVH, on the CPU the brute-force
    twin."""
    if _on_cpu(origins):
        return occluded_matrix_ref(origins, dirs, tmin, tmax, tables.coeffs)
    return _occluded_cuda("K6", origins, lambda out: kernel().launch_walk(
        "gatling_occluded_matrix", origins, dirs, tmin, tmax, tables.bvh, out))


def intersect_tiles(origins, dirs, tmin, tmax, tiles: TriTiles) -> Hit:
    """K7 (`intersect_pallas_vpu`): the closest hit by elementwise
    Moller-Trumbore over the tiles; on the card over their real rows."""
    if _on_cpu(origins):
        return Hit(*intersect_tiles_ref(origins, dirs, tmin, tmax, tiles.tris))
    return _closest_cuda("K7", origins, lambda out: kernel().launch(
        "gatling_intersect_tiles", origins, dirs, tmin, tmax, tiles, out))


def occluded_tiles(origins, dirs, tmin, tmax, tiles: TriTiles) -> torch.Tensor:
    """K8 (`occluded_pallas_vpu`): [R] bool, any hit, elementwise form."""
    if _on_cpu(origins):
        return occluded_tiles_ref(origins, dirs, tmin, tmax, tiles.tris)
    return _occluded_cuda("K8", origins, lambda out: kernel().launch(
        "gatling_occluded_tiles", origins, dirs, tmin, tmax, tiles, out))


def intersect_threaded(origins, dirs, tmin, tmax, bvh: ThreadedBvh) -> Hit:
    """B1 (`traverse_closest`, gatling_tpu/ops/bvh.py): the closest hit of
    rays o, d [R, 3] in (tmin, tmax) [R] over the threaded BVH; tri
    indexes the reordered soup. On the card the kernel, on the CPU its
    lockstep twin."""
    if _on_cpu(origins):
        return Hit(*intersect_threaded_ref(origins, dirs, tmin, tmax, bvh))
    return _closest_cuda("B1", origins, lambda out: kernel().launch_threaded(
        "gatling_intersect_threaded", origins, dirs, tmin, tmax, bvh, out))


def occluded_threaded(origins, dirs, tmin, tmax, bvh: ThreadedBvh) -> torch.Tensor:
    """B2 (`traverse_occluded`): [R] bool, any hit in (tmin, tmax), by the
    any-hit walk of the threaded BVH."""
    if _on_cpu(origins):
        return occluded_threaded_ref(origins, dirs, tmin, tmax, bvh)
    return _occluded_cuda("B2", origins, lambda out: kernel().launch_threaded(
        "gatling_occluded_threaded", origins, dirs, tmin, tmax, bvh, out))
