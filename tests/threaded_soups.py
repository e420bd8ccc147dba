"""An adversarial soup and rays for the threaded BVH's walks (B1, B2, their
twins and the wide walk's model), shared by tests/test_torch_threaded_bvh.py
(against the JAX package's `traverse`) and tests/test_torch_cuda.py (the
kernels on the card). No JAX here: the card's tests import this file.

The soup is a lattice of axis-aligned unit quads, two triangles each,
lying in the planes x = k, y = k and z = k: every leaf box is flat, and
its planes are the faces of boxes all the way up the tree. The rays:

* aimed at lattice vertices and at the midpoints of quad edges, so that
  two or more triangles tie in t, and at the centres of the cells;
* along directions with an exactly zero component (+0.0 or -0.0), from
  origins on a lattice plane of that axis, so that (b - o) * (1 / d) is 0
  * inf, a NaN, on the boxes of that plane, and from origins off them;
* some with tmax the distance to the point they aim at, or half of it,
  so that a segment ends inside a leaf; some with tmin > 0 from a point
  on a quad."""

import numpy as np

from gatling_tpu_torch.interface import FLOAT_MAX
from gatling_tpu_torch.ops.geometry import SceneGeometry


def lattice_soup(n: int = 8) -> SceneGeometry:
    """Quads of the unit lattice [0, n]^3 in its planes x, y, z = 0..n:
    6 n^2 (n + 1) triangles, each quad split along its diagonal."""
    v0, e1, e2 = [], [], []
    ij = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), axis=-1).reshape(-1, 2)
    for axis in range(3):
        a, b = (axis + 1) % 3, (axis + 2) % 3
        ea, eb = np.eye(3)[a], np.eye(3)[b]
        for k in range(n + 1):
            p = np.zeros((ij.shape[0], 3))
            p[:, axis] = k
            p[:, a], p[:, b] = ij[:, 0], ij[:, 1]
            v0 += [p, p + ea + eb]
            e1 += [np.broadcast_to(ea, p.shape), np.broadcast_to(-ea, p.shape)]
            e2 += [np.broadcast_to(eb, p.shape), np.broadcast_to(-eb, p.shape)]
    v0, e1, e2 = (np.concatenate(x).astype(np.float32) for x in (v0, e1, e2))
    t = v0.shape[0]
    z3, z2, zi = np.zeros((t, 3), np.float32), np.zeros((t, 2), np.float32), np.zeros(t, np.int32)
    return SceneGeometry(v0, e1, e2, z3, z3, z3, z3, z3, z3, z3, z2, z2, z2, z3, z3, z3,
                         zi, zi, zi, zi, zi)


def lattice_rays(n: int, count: int, seed: int):
    """`count` rays (origins, directions, tmin, tmax as f32 arrays) at the
    lattice of lattice_soup(n), a quarter of each kind above."""
    rng = np.random.default_rng(seed)
    q = count // 4
    # 1. from random points around the lattice at vertices, edge midpoints and cell centres
    o1 = rng.uniform(-2, n + 2, (q, 3))
    target = rng.integers(0, n + 1, (q, 3)).astype(np.float64)
    kind = np.arange(q) % 3
    half = rng.integers(0, 3, q)
    target[kind == 1, half[kind == 1]] += 0.5  # an edge's midpoint
    target[kind == 2] = np.minimum(target[kind == 2], n - 1) + 0.5  # a cell's centre
    # 2. directions with exact zeros, from origins on a lattice plane (or off it)
    o2 = rng.uniform(-1, n + 1, (q, 3))
    d2 = rng.normal(size=(q, 3))
    zero = rng.integers(0, 3, q)
    d2[np.arange(q), zero] = np.where(np.arange(q) % 2 == 0, 0.0, -0.0)
    on_plane = np.arange(q) % 4 != 3
    o2[on_plane, zero[on_plane]] = rng.integers(0, n + 1, int(on_plane.sum()))
    two = np.arange(q) % 5 == 0  # two zeros: along an axis
    d2[two, (zero[two] + 1) % 3] = 0.0
    # 3. aimed at vertices along lattice-parallel planes: o on a plane, d with a zero
    o3 = rng.integers(0, n + 1, (q, 3)).astype(np.float64)
    o3 += rng.uniform(-0.5, 0.5, (q, 3)) * (np.arange(q)[:, None] % 3 != np.arange(3))
    t3 = rng.integers(0, n + 1, (q, 3)).astype(np.float64)
    t3[np.arange(q), np.arange(q) % 3] = o3[np.arange(q), np.arange(q) % 3]
    # 4. from points on quads (tmin > 0), at vertices
    r = count - 3 * q
    o4 = rng.integers(0, n, (r, 3)).astype(np.float64)
    ax = np.arange(r) % 3
    o4 += rng.uniform(0, 1, (r, 3)) * (np.arange(3) != ax[:, None])
    t4 = rng.integers(0, n + 1, (r, 3)).astype(np.float64)

    def toward(o, t):
        d = t - o
        d[np.linalg.norm(d, axis=1) == 0] = [0.0, 0.0, 1.0]
        return d / np.linalg.norm(d, axis=1, keepdims=True), np.linalg.norm(t - o, axis=1)

    d1, dist1 = toward(o1, target)
    d3, dist3 = toward(o3, t3)
    d4, dist4 = toward(o4, t4)
    o = np.concatenate([o1, o2, o3, o4]).astype(np.float32)
    d = np.concatenate([d1, d2 / np.linalg.norm(d2, axis=1, keepdims=True), d3,
                        d4]).astype(np.float32)
    tmin = np.zeros(count, np.float32)
    tmin[3 * q:] = 1e-3
    tmax = np.full(count, FLOAT_MAX, np.float32)
    dist = np.concatenate([dist1, np.full(q, n * 2.0), dist3, dist4]).astype(np.float32)
    cut = np.arange(count) % 3 == 1
    tmax[cut] = dist[cut]  # the segment ends at the point aimed at
    halfway = np.arange(count) % 7 == 2
    tmax[halfway] = dist[halfway] * np.float32(0.5)
    tmax[np.arange(count) % 17 == 5] = 0.0  # dead
    return o, d, tmin, tmax
