"""NumPy procedural texture generators for the composite baker: the port
of the JAX package's render/procedural.py, bit for bit.

MaterialX generator nodes (checkerboard / ramps / perlin noise / fractal /
cellnoise / worley) evaluate here over the bake-time texel-center uv grid
(render/texture.py _eval_bake). The reference compiles these node graphs to
per-hit MDL code (src/mc/impl/MtlxMdlCodeGen.cpp:217-287); here, as in the
JAX package, a generator bakes into one pool slot that K4 taps like any
other texture, exact at texel centers. 3D-domain generators evaluate at
position=(u, v, 0), the documented approximation for uv-indexed baking.

All hashes are deterministic integer mixes (no RNG state), so bakes are
reproducible across processes: the pool cache key is the Expr repr.
"""

from __future__ import annotations

import numpy as np

PROC_BAKE_RES = 256  # default bake resolution for pure-procedural slots


def _hash_u32(*coords: np.ndarray) -> np.ndarray:
    """Deterministic lattice hash: int arrays -> uint32 (PCG-style mix)."""
    h = np.uint32(0x9E3779B9)
    for c in coords:
        h = (h ^ c.astype(np.uint32)) * np.uint32(0x85EBCA6B)
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _hash01(*coords: np.ndarray) -> np.ndarray:
    return _hash_u32(*coords).astype(np.float64) * (1.0 / 4294967296.0)


def _fade(t: np.ndarray) -> np.ndarray:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad2(xi: np.ndarray, yi: np.ndarray, seed: int = 0):
    ang = _hash01(xi, yi, np.full_like(xi, seed)) * (2.0 * np.pi)
    return np.cos(ang), np.sin(ang)


def perlin2(u: np.ndarray, v: np.ndarray, seed: int = 0) -> np.ndarray:
    """2D gradient (Perlin) noise in ~[-1, 1]."""
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    fx, fy = u - x0, v - y0
    sx, sy = _fade(fx), _fade(fy)
    out = 0.0
    wsum = []
    for dx in (0, 1):
        for dy in (0, 1):
            gx, gy = _grad2(x0 + dx, y0 + dy, seed)
            d = gx * (fx - dx) + gy * (fy - dy)
            w = (sx if dx else 1 - sx) * (sy if dy else 1 - sy)
            wsum.append(w * d)
    out = sum(wsum)
    return (out * np.sqrt(2.0)).astype(np.float32)


def perlin3(x: np.ndarray, y: np.ndarray, z: np.ndarray,
            seed: int = 0) -> np.ndarray:
    """3D gradient noise in ~[-1, 1] (uniformly hashed unit gradients)."""
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    z0 = np.floor(z).astype(np.int64)
    fx, fy, fz = x - x0, y - y0, z - z0
    sx, sy, sz = _fade(fx), _fade(fy), _fade(fz)
    total = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                # gradient from two hashed angles (uniform on the sphere
                # is unnecessary for noise quality at this use)
                a = _hash01(xi, yi, zi + seed) * (2.0 * np.pi)
                czz = _hash01(xi + 31, yi + 17, zi + seed) * 2.0 - 1.0
                szz = np.sqrt(np.maximum(0.0, 1.0 - czz * czz))
                gx, gy, gz = szz * np.cos(a), szz * np.sin(a), czz
                d = gx * (fx - dx) + gy * (fy - dy) + gz * (fz - dz)
                w = ((sx if dx else 1 - sx) * (sy if dy else 1 - sy)
                     * (sz if dz else 1 - sz))
                total = total + w * d
    return (total * np.sqrt(2.0)).astype(np.float32)


def fractal3(x: np.ndarray, y: np.ndarray, z: np.ndarray, octaves: int = 3,
             lacunarity: float = 2.0, diminish: float = 0.5) -> np.ndarray:
    """fBm sum of perlin3 octaves (MaterialX fractal3d semantics)."""
    total = np.zeros(np.broadcast(x, y, z).shape, np.float32)
    amp, freq = 1.0, 1.0
    for o in range(max(int(octaves), 1)):
        total += amp * perlin3(x * freq, y * freq, z * freq, seed=o)
        amp *= diminish
        freq *= lacunarity
    return total


def cellnoise2(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Per-integer-cell uniform value in [0, 1)."""
    return _hash01(np.floor(u).astype(np.int64),
                   np.floor(v).astype(np.int64)).astype(np.float32)


def cellnoise3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    return _hash01(np.floor(x).astype(np.int64),
                   np.floor(y).astype(np.int64),
                   np.floor(z).astype(np.int64)).astype(np.float32)


def worley2(u: np.ndarray, v: np.ndarray, jitter: float = 1.0) -> np.ndarray:
    """F1 euclidean worley noise (one jittered feature point per cell)."""
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    best = np.full(np.broadcast(u, v).shape, np.inf)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = x0 + dx, y0 + dy
            px = cx + 0.5 + (_hash01(cx, cy) - 0.5) * jitter
            py = cy + 0.5 + (_hash01(cy, cx + 13) - 0.5) * jitter
            d2 = (u - px) ** 2 + (v - py) ** 2
            best = np.minimum(best, d2)
    return np.sqrt(best).astype(np.float32)


def worley3(x: np.ndarray, y: np.ndarray, z: np.ndarray,
            jitter: float = 1.0) -> np.ndarray:
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    z0 = np.floor(z).astype(np.int64)
    best = np.full(np.broadcast(x, y, z).shape, np.inf)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cx, cy, cz = x0 + dx, y0 + dy, z0 + dz
                px = cx + 0.5 + (_hash01(cx, cy, cz) - 0.5) * jitter
                py = cy + 0.5 + (_hash01(cy, cz, cx + 13) - 0.5) * jitter
                pz = cz + 0.5 + (_hash01(cz, cx, cy + 29) - 0.5) * jitter
                d2 = (x - px) ** 2 + (y - py) ** 2 + (z - pz) ** 2
                best = np.minimum(best, d2)
    return np.sqrt(best).astype(np.float32)


def checkerboard_mask(u: np.ndarray, v: np.ndarray, tile_u: float,
                      tile_v: float, off_u: float, off_v: float) -> np.ndarray:
    """1.0 where in1 shows, 0.0 where in2 shows (MaterialX checkerboard)."""
    iu = np.floor(u * tile_u + off_u).astype(np.int64)
    iv = np.floor(v * tile_v + off_v).astype(np.int64)
    return ((iu + iv) % 2 == 0).astype(np.float32)


def eval_generator(op: str, const, args: list[np.ndarray],
                   u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Evaluate one generator Expr over the texel-center uv grid.
    `args` are the already-baked value inputs broadcast to [H, W, 4];
    `const` is the Expr's folded scalar quad. Returns [H, W, 4]."""
    c = const or (0.0, 0.0, 0.0, 0.0)
    uv_u, uv_v = u, v
    if op == "texcoord":
        return np.stack([uv_u, uv_v, np.zeros_like(uv_u),
                         np.zeros_like(uv_u)], axis=-1).astype(np.float32)
    if op == "checkerboard":
        m = checkerboard_mask(uv_u, uv_v, c[0] or 8.0, c[1] or 8.0,
                              c[2], c[3])[..., None]
        return args[0] * m + args[1] * (1.0 - m)
    if op == "ramplr":
        t = uv_u[..., None]
        return args[0] * (1.0 - t) + args[1] * t
    if op == "ramptb":
        # MaterialX: valuet at v=1 (top), valueb at v=0
        t = uv_v[..., None]
        return args[0] * t + args[1] * (1.0 - t)
    if op == "ramp4":
        tl, tr, bl, br = args
        s, t = uv_u[..., None], uv_v[..., None]
        top = tl * (1.0 - s) + tr * s
        bot = bl * (1.0 - s) + br * s
        return top * t + bot * (1.0 - t)
    if op == "noise2d":
        n = perlin2(uv_u, uv_v)[..., None]
        return args[1] + args[0] * n
    if op == "noise3d":
        n = perlin3(uv_u, uv_v, np.zeros_like(uv_u))[..., None]
        return args[1] + args[0] * n
    if op == "fractal3d":
        n = fractal3(uv_u, uv_v, np.zeros_like(uv_u),
                     octaves=int(c[0] or 3), lacunarity=c[1] or 2.0,
                     diminish=c[2] if c[2] else 0.5)[..., None]
        return args[0] * n
    if op == "cellnoise2d":
        return np.repeat(cellnoise2(uv_u, uv_v)[..., None], 4, axis=-1)
    if op == "cellnoise3d":
        return np.repeat(
            cellnoise3(uv_u, uv_v, np.zeros_like(uv_u))[..., None], 4, axis=-1)
    if op == "worleynoise2d":
        return np.repeat(
            worley2(uv_u, uv_v, jitter=c[0] if c[0] else 1.0)[..., None],
            4, axis=-1)
    if op == "worleynoise3d":
        return np.repeat(
            worley3(uv_u, uv_v, np.zeros_like(uv_u),
                    jitter=c[0] if c[0] else 1.0)[..., None], 4, axis=-1)
    raise ValueError(f"unknown procedural generator: {op}")
