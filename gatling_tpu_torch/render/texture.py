"""Textures: the host-side cache and the device-side texel pool.

Port of the JAX package's render/texture.py. The host side mirrors the
reference's TextureManager (src/gi/impl/TextureManager.cpp: a path-keyed
cache, a 1x1 black fallback when a file cannot be decoded). The device side
is one pool for every texture of a scene. When every texture is 8-bit
(PNG), each texel is one uint32 of its four 8-bit codes (held as int32
bits), and, when every slot wraps `repeat`, a second array holds each
texel's 2x2 neighbourhood so that a bilinear tap is one gathered row; sRGB
decoding follows the tap: the codes are the source data, so decoding after
the tap equals decoding at upload. One HDR slot (EXR, Radiance HDR) makes
the whole pool float, as the JAX package's `packable` rule does: every
slot's linear texels in `texels` ([N, 4] f32), sRGB decoded on the host.
`sample_pool` is plain torch gathers on the pool, on the CPU and on the
card alike.

A shader-graph composite that is not affine in one texture (render/
shadergraph.py: two textures in one node, clamp over a texture, texcoord
math, the procedural generators) is baked on the host into a slot of its
own (`baked_ref`, `TextureManager._eval_bake`): stored sRGB-encoded as
8-bit codes when its values lie in [0, 1], so that K4 taps it through
its 256-entry table; any other value makes the pool float.

UsdUVTexture semantics: wrap modes (black, clamp, repeat, mirror), scale
and bias applied after the lookup, v up (texel row 0 is the image top).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch import imgio
from gatling_tpu_torch.interface import MAX_TEXTURE_COUNT
from gatling_tpu_torch.render.assets import read_asset
from gatling_tpu_torch.utils.log import get_logger

# procedural generator Expr ops baked over a uv grid (render/procedural.py)
_PROC_OPS = frozenset((
    "checkerboard", "ramplr", "ramptb", "ramp4", "noise2d", "noise3d",
    "fractal3d", "cellnoise2d", "cellnoise3d", "worleynoise2d",
    "worleynoise3d", "texcoord",
))

WRAP_BLACK = 0
WRAP_CLAMP = 1
WRAP_REPEAT = 2
WRAP_MIRROR = 3

_WRAP_NAMES = {
    "black": WRAP_BLACK, "clamp": WRAP_CLAMP,
    "repeat": WRAP_REPEAT, "mirror": WRAP_MIRROR,
    "useMetadata": WRAP_REPEAT,
}


@dataclasses.dataclass(frozen=True)
class TextureRef:
    """One texture request from a material network."""

    file_path: str
    is_srgb: bool = False
    wrap_s: str = "repeat"
    wrap_t: str = "repeat"
    scale: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    bias: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    channel: str = "rgb"  # rgb / r / g / b / a
    # a non-affine shader-graph subtree (render/shadergraph.py Expr) baked
    # into this texture's texels at pool build; file_path is then the
    # synthetic baked:// cache key
    bake: "object | None" = None


class TexturePool(NamedTuple):
    """The device texture pool: texels and per-slot records. An 8-bit pool
    holds its texels in `texels_u32` (and `texels_q22`), a float pool in
    `texels`; the other arrays are one-row dummies."""

    texels: torch.Tensor  # [N, 4] f32 linear texels of a float pool ([1, 4] zeros else)
    texels_u32: torch.Tensor  # [N + 1] int32: the rgba8 codes of each texel as uint32 bits
    # [N + 1, 4] int32: each texel's 2x2 neighbourhood (self, +x, +y, +x+y),
    # repeat wrap baked in (when every slot wraps repeat; [1, 4] zeros else)
    texels_q22: torch.Tensor
    is_srgb: torch.Tensor  # [T] int32: decode sRGB after the tap
    offset: torch.Tensor   # [T] int32 first texel of the slot
    width: torch.Tensor    # [T] int32
    height: torch.Tensor   # [T] int32
    wrap_s: torch.Tensor   # [T] int32 WRAP_*
    wrap_t: torch.Tensor   # [T] int32
    scale: torch.Tensor    # [T, 4] f32
    bias: torch.Tensor     # [T, 4] f32
    # [T, 4] f32 per-slot mean of (linear texels * scale + bias): the "top
    # mip" that textureLodBounces substitutes for the per-ray tap
    mean: torch.Tensor

    @property
    def count(self) -> int:
        return self.offset.shape[0]

    @property
    def packed(self) -> bool:
        """The texels are 8-bit codes in texels_u32."""
        return self.texels_u32.shape[0] > 1

    @property
    def bilinear_packed(self) -> bool:
        return self.texels_q22.shape[0] > 1

    @property
    def has_texels(self) -> bool:
        """The pool holds textures (gatling_tpu/gi.py:345-346): 8-bit codes,
        or more than one float texel."""
        return self.packed or self.texels.shape[0] > 1


def empty_pool(device="cpu") -> TexturePool:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return TexturePool(
        texels=torch.zeros((1, 4), device=device), texels_u32=i32([0]), texels_q22=i32([[0, 0, 0, 0]]), is_srgb=i32([0]),
        offset=i32([0]), width=i32([1]), height=i32([1]), wrap_s=i32([WRAP_REPEAT]),
        wrap_t=i32([WRAP_REPEAT]), scale=torch.ones((1, 4), device=device),
        bias=torch.zeros((1, 4), device=device), mean=torch.zeros((1, 4), device=device))


def baked_ref(expr, channel: str = "rgb") -> TextureRef:
    """The TextureRef of a non-affine shader-graph composite, baked at pool
    build (TextureManager._eval_bake; gatling_tpu/render/texture.py
    baked_ref). Wrap modes come from the first texture leaf; the synthetic
    baked:// path is the cache key."""
    import hashlib

    def first_leaf(e):
        if e.op == "tex":
            return e.tex
        for a in e.args:
            leaf = first_leaf(a)
            if leaf is not None:
                return leaf
        return None

    leaf = first_leaf(expr)
    key = hashlib.md5(repr(expr).encode()).hexdigest()[:16]
    return TextureRef(
        file_path=f"baked://{key}",
        is_srgb=True,  # an LDR composite is stored sRGB-encoded in the 8-bit pool
        wrap_s=leaf.wrap_s if leaf is not None else "repeat",
        wrap_t=leaf.wrap_t if leaf is not None else "repeat",
        channel=channel, bake=expr)


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


class TextureManager:
    """Loads, caches and packs textures (TextureManager.cpp analog)."""

    def __init__(self) -> None:
        self._image_cache: dict[tuple[str, bool], np.ndarray] = {}  # -> linear RGBA f32
        # path -> (RGBA f32 as decoded, whether the file is HDR)
        self._raw_cache: dict[str, tuple[np.ndarray, bool]] = {}

    def _resize(self, img: np.ndarray, h: int, w: int) -> np.ndarray:
        """Bilinear resize [h0, w0, 4] -> [h, w, 4] (a composite of leaves
        of several resolutions bakes at the largest)."""
        h0, w0 = img.shape[:2]
        if (h0, w0) == (h, w):
            return img
        ys = (np.arange(h) + 0.5) * h0 / h - 0.5
        xs = (np.arange(w) + 0.5) * w0 / w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h0 - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w0 - 1)
        y1 = np.minimum(y0 + 1, h0 - 1)
        x1 = np.minimum(x0 + 1, w0 - 1)
        fy = np.clip(ys - y0, 0, 1)[:, None, None]
        fx = np.clip(xs - x0, 0, 1)[None, :, None]
        a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
        b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
        return (a * (1 - fy) + b * fy).astype(np.float32)

    def _eval_bake(self, expr) -> np.ndarray:
        """A shader-graph Expr as a LINEAR rgba image on the host (the
        composite baker of render/shadergraph.py, gatling_tpu/render/
        texture.py _eval_bake): texture leaves load through the cache with
        their own sRGB decode and affine, constants broadcast, leaves of
        several resolutions upsample bilinearly to the largest, generators
        evaluate over the texel-center uv grid (render/procedural.py)."""
        if expr.op == "const":
            return np.asarray(expr.const, np.float32).reshape(1, 1, 4)
        if expr.op == "tex":
            ref = expr.tex
            img = self._load(ref) * np.asarray(ref.scale, np.float32) \
                + np.asarray(ref.bias, np.float32)
            if ref.channel in ("r", "g", "b", "a"):
                i = "rgba".index(ref.channel)
                img = np.repeat(img[..., i:i + 1], 4, axis=-1)
            return img.astype(np.float32)
        from gatling_tpu_torch.render.procedural import PROC_BAKE_RES, eval_generator

        args = [self._eval_bake(a) for a in expr.args]
        is_proc = expr.op in _PROC_OPS
        h = max([a.shape[0] for a in args] + ([PROC_BAKE_RES] if is_proc else []))
        w = max([a.shape[1] for a in args] + ([PROC_BAKE_RES] if is_proc else []))
        args = [self._resize(a, h, w) if a.shape[:2] != (1, 1) else a for a in args]
        if is_proc:
            # texel-center uv grid; v = 0 is the BOTTOM row (sample_pool)
            u = ((np.arange(w) + 0.5) / w)[None, :] * np.ones((h, 1))
            v = (1.0 - (np.arange(h) + 0.5) / h)[:, None] * np.ones((1, w))
            args = [np.broadcast_to(a, (h, w, 4)) for a in args]
            return eval_generator(expr.op, expr.const, args, u, v)
        if expr.op == "multiply":
            return args[0] * args[1]
        if expr.op == "divide":
            d = args[1]
            return np.where(d != 0.0, args[0] / np.where(d != 0.0, d, 1.0), 0.0)
        if expr.op == "add":
            return args[0] + args[1]
        if expr.op == "subtract":
            return args[0] - args[1]
        if expr.op == "mix":
            fg, bg, m = args
            return fg * m + bg * (1.0 - m)
        if expr.op == "clamp":
            return np.clip(args[0], args[1], args[2])
        if expr.op == "extract":
            i = "rgba".index(expr.channel)
            return np.repeat(args[0][..., i:i + 1], 4, axis=-1)
        raise ValueError(f"unbakeable shader expr op: {expr.op}")

    def _bake_shape(self, expr) -> tuple[int, int, int]:
        """(H, W, 4) of a baked composite: the largest leaf's resolution."""
        if expr.op == "tex":
            img, _hdr = self._load_raw(expr.tex)
            return (img.shape[0], img.shape[1], 4)
        if expr.op == "const":
            return (1, 1, 4)
        from gatling_tpu_torch.render.procedural import PROC_BAKE_RES

        base = [PROC_BAKE_RES] if expr.op in _PROC_OPS else [1]
        shapes = [self._bake_shape(a) for a in expr.args]
        return (max([s[0] for s in shapes] + base), max([s[1] for s in shapes] + base), 4)

    def _load_raw(self, ref: TextureRef) -> tuple[np.ndarray, bool]:
        cached = self._raw_cache.get(ref.file_path)
        if cached is not None:
            return cached
        if ref.bake is not None:
            # the composite, stored sRGB-encoded and quantized to 8-bit codes
            # when LDR so that the pool stays 8-bit (ref.is_srgb decodes it
            # after the tap); an HDR composite keeps its linear floats and
            # makes the pool float (the JAX package's rule)
            linear = np.broadcast_to(self._eval_bake(ref.bake),
                                     self._bake_shape(ref.bake)).copy()
            if linear.min() >= 0.0 and linear.max() <= 1.0:
                rgb = linear[..., :3]
                enc = np.where(rgb <= 0.0031308, rgb * 12.92,
                               1.055 * np.maximum(rgb, 1e-12) ** (1 / 2.4) - 0.055)
                raw = np.concatenate([enc, linear[..., 3:]], axis=-1)
                raw = np.round(np.clip(raw, 0.0, 1.0) * 255.0) / 255.0
                out = (raw.astype(np.float32), False)
            else:
                out = (linear.astype(np.float32), True)
            self._raw_cache[ref.file_path] = out
            return out
        try:
            raw = read_asset(ref.file_path)
            if raw is None:
                raise FileNotFoundError(ref.file_path)
            img = imgio.load_image(raw)
            rgba, hdr = imgio.as_float_rgba(img), imgio.is_hdr(img)
        except NotImplementedError:
            raise  # a variant the port does not read yet: never render something else
        except Exception:  # noqa: BLE001
            # 1x1 black fallback (TextureManager.cpp:253-267)
            get_logger().error("texture load failed: %s", ref.file_path)
            rgba, hdr = np.zeros((1, 1, 4), np.float32), False
        self._raw_cache[ref.file_path] = (rgba, hdr)
        return self._raw_cache[ref.file_path]

    def _load(self, ref: TextureRef) -> np.ndarray:
        key = (ref.file_path, ref.is_srgb)
        cached = self._image_cache.get(key)
        if cached is not None:
            return cached
        rgba, hdr = self._load_raw(ref)
        if ref.is_srgb and not hdr:  # HDR data is linear
            rgba = np.concatenate([_srgb_to_linear(rgba[..., :3]), rgba[..., 3:]], axis=-1)
        self._image_cache[key] = rgba.astype(np.float32)
        return self._image_cache[key]

    def pass_rate(self, ref: TextureRef, threshold: float) -> float:
        """The UV-mean cutout pass rate of opacity texture `ref`: the share
        of its channel's texels at or above `threshold`, or the channel's
        mean without one (threshold 0); decoded once, as build_pool does."""
        vals = self._load(ref)[..., {"r": 0, "g": 1, "b": 2, "a": 3}.get(ref.channel, 0)]
        return float((vals >= threshold).mean() if threshold > 0.0 else vals.mean())

    def build_pool(self, refs: list[TextureRef], device="cpu") -> TexturePool:
        """Pack the given textures into a device pool; slot i holds refs[i].
        The 8-bit pool when every texture is exactly 8-bit, else the float
        pool of every slot's linear texels (gatling_tpu/render/texture.py
        :303-380)."""
        if not refs:
            return empty_pool(device)
        if len(refs) > MAX_TEXTURE_COUNT:
            raise ValueError(f"too many textures ({len(refs)} > {MAX_TEXTURE_COUNT})")
        texels, codes_all, srgbs, means = [], [], [], []
        offsets, widths, heights, ws, wt, scales, biases = [], [], [], [], [], [], []
        packable = True
        off = 0
        for ref in refs:
            img = self._load(ref)
            means.append(img.reshape(-1, 4).mean(axis=0) * np.asarray(ref.scale, np.float32)
                         + np.asarray(ref.bias, np.float32))
            raw, hdr = self._load_raw(ref)
            codes = np.round(raw * 255.0)
            if hdr or raw.size == 0 or np.abs(raw * 255.0 - codes).max() > 1e-3 \
                    or codes.min() < 0 or codes.max() > 255:
                packable = False
            else:
                c = codes.astype(np.uint32).reshape(-1, 4)
                codes_all.append(c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (c[:, 3] << 24))
                srgbs.append(1 if ref.is_srgb else 0)
            h, w = img.shape[:2]
            texels.append(img.reshape(-1, 4))
            offsets.append(off)
            widths.append(w)
            heights.append(h)
            ws.append(_WRAP_NAMES.get(ref.wrap_s, WRAP_REPEAT))
            wt.append(_WRAP_NAMES.get(ref.wrap_t, WRAP_REPEAT))
            scales.append(ref.scale)
            biases.append(ref.bias)
            off += h * w
        q22 = np.zeros((1, 4), np.uint32)
        if packable:
            tex_f32 = np.zeros((1, 4), np.float32)
            # a trailing dummy texel: `packed` (shape > 1) holds for a one-texel pool too
            u32 = np.concatenate(codes_all + [np.zeros(1, np.uint32)])
            if all(m == WRAP_REPEAT for m in ws + wt):
                q22 = []
                for codes, w, h in zip(codes_all, widths, heights):
                    c = codes.reshape(h, w)
                    q = np.stack([c, np.roll(c, -1, axis=1), np.roll(c, -1, axis=0),
                                  np.roll(np.roll(c, -1, axis=0), -1, axis=1)], axis=-1)
                    q22.append(q.reshape(-1, 4))
                q22.append(np.zeros((1, 4), np.uint32))
                q22 = np.concatenate(q22, axis=0)
        else:
            tex_f32 = np.concatenate(texels, axis=0)
            u32 = np.zeros(1, np.uint32)
            srgbs = [0] * len(refs)  # linear texels: decoded on the host

        def i32(a):  # uint32 values travel as their int32 bits
            return torch.as_tensor(np.asarray(a).astype(np.uint32).view(np.int32),
                                   device=device)

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        return TexturePool(
            texels=f32(tex_f32), texels_u32=i32(u32), texels_q22=i32(q22), is_srgb=i32(srgbs),
            offset=i32(offsets), width=i32(widths), height=i32(heights), wrap_s=i32(ws),
            wrap_t=i32(wt), scale=f32(scales), bias=f32(biases), mean=f32(means))


def srgb_decode(c: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded colour values in [0, 1] to linear (sample_pool's decode
    after the tap)."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def srgb_table(device) -> torch.Tensor:
    """[256] f32: the linear value of each 8-bit sRGB code, by sample_pool's
    own expressions on `device` (code * (1/255), then srgb_decode), so that
    the kernel K4 reads it in place of a pow and equals the taps of
    sample_pool on that device on every code."""
    code = torch.arange(256, dtype=torch.int32, device=device)
    return srgb_decode(code.to(torch.float32) * (1.0 / 255.0))


def _wrap_coord(x: torch.Tensor, size: torch.Tensor, mode: torch.Tensor):
    """Wrap integer texel coordinates; returns (index, inside mask)."""
    size = torch.clamp(size, min=1)
    rep = torch.remainder(x, size)
    clamped = torch.minimum(torch.clamp(x, min=0), size - 1)
    period = torch.remainder(x, 2 * size)
    mirrored = torch.where(period < size, period, 2 * size - 1 - period)
    inside = (x >= 0) & (x < size)
    idx = torch.where(mode == WRAP_REPEAT, rep,
                      torch.where(mode == WRAP_CLAMP, clamped,
                                  torch.where(mode == WRAP_MIRROR, mirrored, clamped)))
    valid = torch.where(mode == WRAP_BLACK, inside, True)
    return idx, valid


def sample_pool(pool: TexturePool, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup for a batch of rays (the JAX package's
    sample_pool, the same float operations in the same order).

    tex_id [R] (values < 0 sample slot 0: callers select the constant),
    uv [R, 2] in the UsdUVTexture convention. Returns RGBA [R, 4] with the
    slot's scale and bias applied. An 8-bit pool taps its codes, a float
    pool four [4] rows of `texels` through the wrap modes."""
    t = torch.clamp(tex_id, min=0).long()
    w = pool.width[t]
    h = pool.height[t]
    off = pool.offset[t]
    x = uv[:, 0] * w.to(torch.float32) - 0.5
    y = (1.0 - uv[:, 1]) * h.to(torch.float32) - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    srgb = (pool.is_srgb[t] > 0)[:, None]

    def unpack(code):
        # rgba8 codes [R, ...] -> [R, ..., 4] f32; sRGB decoded after the tap
        val = torch.stack([code & 0xFF, (code >> 8) & 0xFF, (code >> 16) & 0xFF,
                           (code >> 24) & 0xFF], dim=-1).to(torch.float32) * (1.0 / 255.0)
        c = val[..., :3]
        lin = srgb_decode(c)
        on = srgb.reshape(srgb.shape + (1,) * (c.dim() - 2))
        return torch.cat([torch.where(on, lin, c), val[..., 3:]], dim=-1)

    if pool.bilinear_packed:
        # one gathered row per tap: the 2x2 neighbourhood baked per texel,
        # its four texels unpacked together
        xw = torch.remainder(x0, w)
        yw = torch.remainder(y0, h)
        c00, c10, c01, c11 = unpack(pool.texels_q22[(off + yw * w + xw).long()]).unbind(1)
    else:
        ws = pool.wrap_s[t]
        wt = pool.wrap_t[t]

        def texel(xi, yi):
            xi_w, vx = _wrap_coord(xi, w, ws)
            yi_w, vy = _wrap_coord(yi, h, wt)
            idx = (off + yi_w * w + xi_w).long()
            val = unpack(pool.texels_u32[idx]) if pool.packed else pool.texels[idx]
            return torch.where((vx & vy)[:, None], val, 0.0)

        c00 = texel(x0, y0)
        c10 = texel(x0 + 1, y0)
        c01 = texel(x0, y0 + 1)
        c11 = texel(x0 + 1, y0 + 1)
    out = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
           + (c01 * (1 - fx) + c11 * fx) * fy)
    return out * pool.scale[t] + pool.bias[t]
