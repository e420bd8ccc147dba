"""GIF as Pillow's GifImagePlugin reads its first frame (the JAX package's
imgio goes through Pillow).

The frame's extension blocks are walked as GifImageFile._seek walks them:
a graphic control extension gives the transparent index, comments and
application blocks are skipped. The image descriptor's frame may lie
anywhere on the logical screen (a frame past its edge widens it); the
pixels around it are index 0, or the transparent index when there is one.
Its LZW stream (variable code width, interlaced or not) is decoded by the
native library's gatling_gif_lzw_decode, Pillow's GifDecode.c. A frame
whose palette (local, else global) is a grey ramp (entry i = (i, i, i)),
or that has none, is Pillow's mode "L": its indices as grey, opaque. Any
other is mode "P", converted to RGBA through its palette, the transparent
index at alpha 0.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish

MAGICS = (b"GIF87a", b"GIF89a")


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: not the grey ramp (i, i, i)."""
    return any(not (k // 3 == p[k] == p[k + 1] == p[k + 2]) for k in range(0, len(p), 3))


def _block(f: Reader) -> bytes | None:
    """GifImageFile.data: one sub-block, None at a terminator or EOF."""
    s = f.read(1)
    if s and s[0]:
        return f.read(s[0])
    return None


def _u16(s: bytes, at: int) -> int:
    if len(s) < at + 2:
        raise Skip("GIF: short read")
    return struct.unpack_from("<H", s, at)[0]


def _byte(s: bytes, at: int) -> int:
    if len(s) <= at:
        raise Skip("GIF: short read")
    return s[at]


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> RGBA of its first frame, the JAX package's
    imgio.load_image(data).data."""
    f = Reader(data)
    s = f.read(13)
    if not s.startswith(MAGICS):
        raise Skip("not a GIF file")
    w, h = _u16(s, 6), _u16(s, 8)
    flags = _byte(s, 10)
    global_palette = None
    if flags & 128:
        _byte(s, 11)
        p = f.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            global_palette = p
    # GifImageFile._seek(0)
    s = f.read(1)
    if not s or s == b";":
        raise ValueError("no more images in GIF file")
    transparency = None
    frame = None
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = f.read(1)
            block = _block(f)
            kind = _byte(s, 0)
            if kind == 249 and block is not None:
                if block[0] & 1:
                    transparency = _byte(block, 3)
                _u16(block, 1)
            elif kind == 254:
                while block:
                    block = _block(f)
                s = b""
                continue
            elif kind == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                _block(f)
            while _block(f):
                pass
        elif s == b",":
            s = f.read(9)
            x0, y0 = _u16(s, 0), _u16(s, 2)
            x1, y1 = x0 + _u16(s, 4), y0 + _u16(s, 6)
            if x1 > w or y1 > h:
                w, h = max(x1, w), max(y1, h)
                bomb_check(w, h)
            fflags = _byte(s, 8)
            palette = None
            if fflags & 128:
                p = f.read(3 << ((fflags & 7) + 1))
                palette = p if _palette_needed(p) else False
            bits = _byte(f.read(1), 0)
            frame = (x0, y0, x1, y1, bool(fflags & 64), bits, palette, f.pos)
            break
        s = b""
    if frame is None:
        raise ValueError("image not found in GIF frame")
    x0, y0, x1, y1, interlace, bits, palette, at = frame
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    pal = palette if palette is not None else global_palette
    fw, fh = x1 - x0, y1 - y0
    idx = np.full((h, w), transparency if transparency is not None else 0, np.uint8)
    if fw > 0 and fh > 0:
        src = np.ascontiguousarray(np.frombuffer(data, np.uint8)[at:])
        out = np.zeros((fh, fw), np.uint8)
        got = native.library().gatling_gif_lzw_decode(
            native.ptr(src, ctypes.c_uint8), src.size, bits, int(interlace), fw, fh,
            native.ptr(out, ctypes.c_uint8))
        if got == -2:
            raise ValueError("image file is truncated")
        if got < 0:
            raise ValueError("GIF: broken LZW data")
        idx[y0:y1, x0:x1] = out
    if not pal:
        return finish("L", idx)
    entries = np.frombuffer(pal[:len(pal) // 3 * 3], np.uint8).reshape(-1, 3)
    return finish("P", idx, entries, transparency)
