"""Ray-triangle intersection: batched Moller-Trumbore over the triangle soup.

The port of the JAX package's ops/intersect.py: the classic elementwise
closest-hit and any-hit tests of every ray against every triangle, in
plain torch. It is the oracle the trace kernels are tested against and
the wavefront integrator's `tracer="brute"`, which the JAX package takes
on a CPU host. No backface culling: facing is resolved at shading time.
Triangles go in blocks of `tri_block` and rays in chunks, so a
[rays, triangles] temporary holds at most about 2M values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.interface import BARY_EPS, FLOAT_MAX

_PAIRS = 1 << 21  # ray-triangle pairs a temporary holds


class Hit(NamedTuple):
    t: torch.Tensor    # [R] f32 hit distance (FLOAT_MAX when missed)
    tri: torch.Tensor  # [R] int32 triangle index (-1 when missed)
    u: torch.Tensor    # [R] f32 barycentric u
    v: torch.Tensor    # [R] f32 barycentric v

    @property
    def missed(self) -> torch.Tensor:
        return self.tri < 0


def _mt_block(org, dirn, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore of rays [R] against triangles [T]: (t, u, v, valid)
    [R, T] (ops/intersect.py _mt_block)."""
    pvec = torch.linalg.cross(dirn[:, None, :].expand(-1, e2.shape[0], -1),
                              e2[None, :, :].expand(dirn.shape[0], -1, -1))
    det = (pvec * e1[None]).sum(-1)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = org[:, None, :] - v0[None]
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand(tvec.shape[0], -1, -1))
    v = (dirn[:, None, :] * qvec).sum(-1) * inv_det
    t = (e2[None] * qvec).sum(-1) * inv_det
    eps = float(BARY_EPS)
    valid = ((det.abs() > 1e-12) & (u >= -eps) & (v >= -eps)
             & (u + v <= float(np.float32(1.0) + BARY_EPS))
             & (t > tmin[:, None]) & (t < tmax[:, None]))
    return t, u, v, valid


def _blocks(n_rays: int, n_tris: int, tri_block: int):
    tri_block = min(tri_block, n_tris)
    ray_chunk = max(1, _PAIRS // tri_block)
    for a in range(0, n_rays, ray_chunk):
        for start in range(0, n_tris, tri_block):
            yield slice(a, a + ray_chunk), slice(start, start + tri_block)


def _soup(geom, device):
    return [torch.as_tensor(np.asarray(getattr(geom, k)), device=device)
            for k in ("v0", "e1", "e2")]


def intersect_brute(origins: torch.Tensor, dirs: torch.Tensor, tmin: torch.Tensor,
                    tmax: torch.Tensor, geom, tri_block: int = 2048) -> Hit:
    """Closest hit of every ray over all triangles of `geom` (ops/geometry
    SceneGeometry); ties keep the lower index."""
    r = origins.shape[0]
    v0, e1, e2 = _soup(geom, origins.device)
    best_t = torch.full((r,), float(FLOAT_MAX), dtype=torch.float32, device=origins.device)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=origins.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    for rs, ts in _blocks(r, v0.shape[0], tri_block):
        t, u, v, valid = _mt_block(origins[rs], dirs[rs], v0[ts], e1[ts], e2[ts], tmin[rs],
                                   torch.minimum(tmax[rs], best_t[rs]))
        t = torch.where(valid, t, float(FLOAT_MAX))
        j = torch.argmin(t, dim=1, keepdim=True)
        cand = torch.gather(t, 1, j)[:, 0]
        better = cand < best_t[rs]
        best_tri[rs] = torch.where(better, ts.start + j[:, 0].to(torch.int32), best_tri[rs])
        best_u[rs] = torch.where(better, torch.gather(u, 1, j)[:, 0], best_u[rs])
        best_v[rs] = torch.where(better, torch.gather(v, 1, j)[:, 0], best_v[rs])
        best_t[rs] = torch.where(better, cand, best_t[rs])
    return Hit(best_t, best_tri, best_u, best_v)


def occluded_brute(origins: torch.Tensor, dirs: torch.Tensor, tmin: torch.Tensor,
                   tmax: torch.Tensor, geom, tri_block: int = 2048) -> torch.Tensor:
    """Any-hit occlusion test ([R] bool), the shadow-ray stream
    (reference: rp_main.rgen:397-438)."""
    v0, e1, e2 = _soup(geom, origins.device)
    out = torch.zeros((origins.shape[0],), dtype=torch.bool, device=origins.device)
    for rs, ts in _blocks(origins.shape[0], v0.shape[0], tri_block):
        valid = _mt_block(origins[rs], dirs[rs], v0[ts], e1[ts], e2[ts], tmin[rs], tmax[rs])[3]
        out[rs] |= valid.any(dim=1)
    return out
