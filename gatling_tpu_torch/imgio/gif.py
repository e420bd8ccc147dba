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
import math
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio import quantize
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


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _optimized(idx: np.ndarray, grey: bool, n_palette: int) -> list[int] | None:
    """GifImagePlugin._get_optimize with optimize on (the save default):
    the palette entries in use, or None where the palette stays whole."""
    h, w = idx.shape
    if not grey and w * h >= 512 * 512:
        return None
    used = np.flatnonzero(np.bincount(idx.ravel(), minlength=256)).tolist()
    if grey or max(used) >= len(used):
        return used
    current = 1 << (n_palette - 1).bit_length()
    if len(used) <= current // 2 and current > 2:
        return used
    return None


def _color_table_size(n: int) -> int:
    """GifImagePlugin._get_color_table_size of n palette entries."""
    if n == 0:
        return 0
    if n * 3 < 9:
        return 1
    return math.ceil(math.log(n, 2)) - 1


def indexed(img: np.ndarray) -> tuple[np.ndarray, np.ndarray, int | None]:
    """What GifImagePlugin._save makes of an L, RGB or RGBA image before its
    LZW stream: (palette [n, 3] as the file stores it before padding,
    indices [H, W], transparent index or None). An RGB or RGBA image takes
    Pillow's adaptive palette (quantize.py), an RGBA one the first entry of
    alpha 0 as transparent (_normalize_mode); then the palette is cut to the
    entries in use, in index order, where _get_optimize says so."""
    img = np.asarray(img, np.uint8)
    transparency = None
    if img.ndim == 2:
        grey, idx = True, img
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    else:
        grey = False
        palette, idx = quantize.adaptive(img)
        if palette.shape[1] == 4:
            clear = np.flatnonzero(palette[:, 3] == 0)
            transparency = int(clear[0]) if clear.size else None
    used = _optimized(idx, grey, len(palette))
    if used is not None:
        position = np.zeros(256, np.uint8)
        position[used] = np.arange(len(used), dtype=np.uint8)
        idx, palette = position[idx], palette[used]
        if transparency is not None:
            transparency = used.index(transparency) if transparency in used else None
    return palette[:, :3], idx, transparency


def encode_gif(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes
    GifImagePlugin._save writes: the header (89a with a transparent index,
    else 87a), the global palette padded to a power of two, a graphic control
    extension for the transparent index, the image descriptor (interlaced
    unless a side is under 16 pixels) and the LZW stream at 8 bits."""
    palette, idx, transparency = indexed(img)
    h, w = idx.shape
    size = _color_table_size(len(palette))
    table = np.zeros((2 << size, 3), np.uint8)
    table[:len(palette)] = palette
    out = [b"GIF89a" if transparency is not None else b"GIF87a", struct.pack("<HH", w, h),
           bytes((size + 128, 0, 0)), table.tobytes()]
    if transparency is not None:
        out.append(b"!\xf9\x04\x01\x00\x00" + bytes((transparency, 0)))
    interlace = min(w, h) >= 16
    out += [b"," + struct.pack("<HHHH", 0, 0, w, h) + bytes((64 if interlace else 0, 8)),
            lzw_encode(idx, interlace), b"\0;"]
    return b"".join(out)


def lzw_encode(idx: np.ndarray, interlace: bool) -> bytes:
    """The native library's gatling_gif_lzw_encode, GifEncode.c at 8 bits:
    the sub-blocks of the LZW stream, without their terminator."""
    idx = np.ascontiguousarray(idx, np.uint8)
    h, w = idx.shape
    cap = idx.size * 2 + 1024
    out = np.empty(cap, np.uint8)
    n = native.library().gatling_gif_lzw_encode(native.ptr(idx, ctypes.c_uint8), w, h,
                                                int(interlace), native.ptr(out, ctypes.c_uint8),
                                                cap)
    if n < 0:
        raise RuntimeError("GIF: LZW output overran its buffer")
    return out[:n].tobytes()


def interlaced_rows(h: int) -> list[int]:
    """The rows of an interlaced GIF in stream order."""
    return [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for y in range(start, h, step)]


def lzw_encode_ref(idx: np.ndarray, interlace: bool) -> bytes:
    """The NumPy twin of `lzw_encode`."""
    idx = np.asarray(idx, np.uint8)
    rows = interlaced_rows(idx.shape[0]) if interlace else range(idx.shape[0])
    data = idx[list(rows)].ravel().tolist()
    clear, eoi = 256, 257
    codes: list[tuple[int, int]] = [(clear, 9)]
    table: dict[tuple[int, int], int] = {}
    width, nxt, prefix = 9, 258, None
    for s in data:
        if prefix is None:
            prefix = s
            continue
        if (prefix, s) in table:
            prefix = table[prefix, s]
            continue
        codes.append((prefix, width))
        if nxt < 4096:
            table[prefix, s] = nxt
            if nxt == 1 << width and width < 12:
                width += 1
            nxt += 1
        else:
            codes.append((clear, width))
            table.clear()
            width, nxt = 9, 258
        prefix = s
    if prefix is not None:
        codes.append((prefix, width))
    codes.append((eoi, width))
    acc = nbits = 0
    stream = bytearray()
    for code, bits in codes:
        acc |= code << nbits
        nbits += bits
        while nbits >= 8:
            stream.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        stream.append(acc & 0xFF)
    return b"".join(bytes((len(stream[i:i + 255]),)) + bytes(stream[i:i + 255])
                    for i in range(0, len(stream), 255))
