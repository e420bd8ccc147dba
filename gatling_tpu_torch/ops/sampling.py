"""RNG and sampling transformations on tensors.

Bit-exact ports of the reference's shader helpers (reference:
src/gi/shaders/common.glsl). uint32 values ride int64 tensors masked to 32
bits: torch's uint32 lacks `*` and `>>` on several backends. A 32-bit
value times a constant below 2**31 stays below 2**63, so a plain int64
product masked to 32 bits is exact; larger factors go through `_mul32`,
which multiplies in 16-bit halves.
"""

from __future__ import annotations

import torch

PI = 3.1415926535897932384626433832795
_M32 = 0xFFFFFFFF
FLOAT_MIN_NORMAL = 1.1754944e-38


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for a, b in [0, 2**32) (int or int64 tensor):
    every partial product stays below 2**48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> its uint32 value as int64."""
    return x.to(torch.int64) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 in an int64 carrier -> int32 with the same bits."""
    x = x & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def u32_to_f32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 (int64 carrier) -> the f32 with those bits (state row 12)."""
    return _to_i32(x).view(torch.float32)


def f32_bits_to_u32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its bits as uint32 in an int64 carrier."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def uint_as_float(v: torch.Tensor) -> torch.Tensor:
    """Map uint32 -> [0,1) float (reference: common.glsl uintAsFloat:44-47)."""
    bits = 0x3F800000 | (v >> 9)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def hash_theironborn(x: torch.Tensor) -> torch.Tensor:
    """Hash-prospector parametrization (reference: common.glsl:79-88)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = _mul32(x, 0xD35A2D97)
    x = x ^ (x >> 15)
    return x


def pcg32_step(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One PCG step returning (new_state, word) (reference: common.glsl:91-97)."""
    new_state = (state * 747796405 + 2891336453) & _M32
    shift = (new_state >> 28) + 4
    word = (((new_state >> shift) ^ new_state) * 277803737) & _M32
    word = (word >> 22) ^ word
    return new_state, word


def rng_init(pixel_index: torch.Tensor, sample_index) -> torch.Tensor:
    """Per-(pixel,sample) decorrelated seed (reference: common.glsl rng1d_init:119-122)."""
    s = as_u32(torch.as_tensor(sample_index, device=pixel_index.device))
    return hash_theironborn(_mul32(as_u32(pixel_index), (s + 1) & _M32))


def rng_next1f(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw one float in [0,1) (reference: common.glsl rng1d_next1f:100-104)."""
    state, word = pcg32_step(state)
    return state, uint_as_float(word)


def rng_next2f(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    state, a = rng_next1f(state)
    state, b = rng_next1f(state)
    return state, torch.stack([a, b], dim=-1)


def rng_next4f(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    state, a = rng_next1f(state)
    state, b = rng_next1f(state)
    state, c = rng_next1f(state)
    state, d = rng_next1f(state)
    return state, torch.stack([a, b, c, d], dim=-1)


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Duff et al. 2017 ONB for unit normals n[..., 3] (common.glsl:127-137)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    nsign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (nsign + nz)
    b = nx * ny * a
    b1 = torch.stack([1.0 + nsign * nx * nx * a, nsign * b, -nsign * nx], dim=-1)
    b2 = torch.stack([b, nsign + ny * ny * a, -ny], dim=-1)
    return b1, b2


def sample_hemisphere(xi: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere sample from xi[...,2] (common.glsl:210-219)."""
    a = torch.sqrt(xi[..., 0])
    b = PI * 2.0 * xi[..., 1]
    return torch.stack([a * torch.cos(b), a * torch.sin(b), torch.sqrt(1.0 - xi[..., 0])], dim=-1)


def sample_sphere(xi: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Sphere-surface sample scaled by per-axis radius (common.glsl:222-229)."""
    a = 1.0 - 2.0 * xi[..., 0]
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    phi = 2.0 * PI * xi[..., 1]
    return torch.stack([b * torch.cos(phi), b * torch.sin(phi), a], dim=-1) * radius


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance (common.glsl:254-257)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0-on-0 division (reference: common.glsl safe_div:18-35)."""
    return torch.where(b == 0.0, torch.zeros_like(a * b), a / torch.where(b == 0.0, 1.0, b))


def sample_disk(xi: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Concentric disk sample scaled by radius[...,2] (common.glsl:232-252)."""
    a = 2.0 * xi[..., 0] - 1.0
    b = 2.0 * xi[..., 1] - 1.0
    use_a = (a * a) > (b * b)
    r = torch.where(use_a[..., None], radius * a[..., None], radius * b[..., None])
    phi = torch.where(
        use_a,
        (PI / 4.0) * safe_div(b, a),
        (PI / 2.0) - (PI / 4.0) * safe_div(a, b),
    )
    return r * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def offset_ray_origin(p: torch.Tensor, geom_normal: torch.Tensor) -> torch.Tensor:
    """Scale-adaptive offset along the geometric normal: about 64 ulps at
    magnitude |p|, in plain f32 arithmetic (reference: common.glsl:139-162,
    Wächter & Binder, RT Gems I ch. 6)."""
    off = geom_normal * torch.clamp(torch.abs(p) * 2.0 ** -16, min=1.0 / 65536.0)
    return p + off


def fis_gauss(xi: torch.Tensor) -> torch.Tensor:
    """Box-Muller sample of a sigma=0.375 Gaussian pixel filter
    (reference: rp_main.rgen:118-130). The lower clamp is the smallest
    NORMAL f32, so log() never sees a flushed zero."""
    u1 = torch.clamp(xi[..., 0], min=FLOAT_MIN_NORMAL)
    u2 = xi[..., 1]
    r = 0.375 * torch.sqrt(-2.0 * torch.log(u1))
    phi = 2.0 * PI * u2
    return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1) * r[..., None]
