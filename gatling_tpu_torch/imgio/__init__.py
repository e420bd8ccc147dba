"""Image IO on zlib, struct and numpy alone: an 8-bit PNG decoder and
writer, and the OpenEXR and Radiance HDR codecs (exr.py, hdr.py).

The JAX package decodes and writes LDR images through Pillow, which the
port does not depend on. The decoder reads 8-bit, non-interlaced PNGs of
every colour type (grey, RGB, palette with its PLTE/tRNS chunks, grey +
alpha, RGBA) into the RGBA array that the JAX package's Pillow path gives
for the same file: tRNS applies to palette images only, as Pillow's
RGBA conversion of a "P" image does. `load_image` picks the decoder by
magic, as the JAX package's does: EXR, Radiance HDR, PNG. A decoded image
is an RGBA array, uint8 for PNG and float32 for the HDR formats, so its
dtype says whether it is HDR (`is_hdr`, the JAX package's Image.is_hdr).
Other PNG bit depths, Adam7 interlacing and the JPEG/TGA/TIFF formats
raise (ROADMAP: 'USD content').
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from gatling_tpu_torch.imgio.exr import decode_exr, encode_exr
from gatling_tpu_torch.imgio.hdr import decode_hdr, encode_hdr

EXR_MAGIC = b"\x76\x2f\x31\x01"
HDR_MAGIC = b"#?"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unfilter(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of filt [h, w, bpp] (uint8) with filter
    types ftype [h]. Every filter predicts a byte from its left (a), upper
    (b) and upper-left (c) neighbours, all on earlier anti-diagonals of the
    pixel grid, so the pixels of one anti-diagonal are reconstructed
    together, whatever mix of the five filters their rows use."""
    h, w, _ = filt.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # row 0 and column 0: zeros
    src = filt.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        out[r + 1, x + 1] = (src[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8 RGBA."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, trns, header = 8, [], None, None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"PNG of bit depth {depth}, colour type {ctype}, interlace {interlace}: only "
            "8-bit non-interlaced PNGs are ported (ROADMAP: 'USD content')")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0], bpp)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[:min(len(trns), len(alpha))] = trns[:len(alpha)]
        idx = np.minimum(px[..., 0], len(palette) - 1)
        out[..., :3] = palette[idx]
        out[..., 3] = alpha[idx]
    elif ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
    else:
        out[..., :bpp] = px
    return out


def load_image(data: bytes) -> np.ndarray:
    """Decode image bytes into [H, W, 4] RGBA: uint8 from a PNG, float32
    from an EXR (half widened) or a Radiance HDR file (the JAX package's
    imgio.load_image(data).data for the formats ported so far)."""
    if data[:4] == EXR_MAGIC:
        return decode_exr(data)
    if data[:2] == HDR_MAGIC:
        return decode_hdr(data)
    if data[:8] != PNG_SIGNATURE:
        raise NotImplementedError("only PNG images are decoded so far; JPEG, TGA and TIFF "
                                  "are not ported yet (ROADMAP: 'USD content')")
    return decode_png(data)


def load_image_file(path: str | os.PathLike) -> np.ndarray:
    with open(path, "rb") as f:
        return load_image(f.read())


def is_hdr(img: np.ndarray) -> bool:
    """A decoded image holds HDR data (float texels, not 8-bit codes)."""
    return img.dtype != np.uint8


def as_float_rgba(img: np.ndarray) -> np.ndarray:
    """[H, W, 4] float32: 8-bit codes / 255, HDR data as decoded (the JAX
    package's Image.as_float_rgba)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] or [H, W, 4] uint8 -> PNG bytes (colour type 2 or 6,
    filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"expected [H, W, 3] RGB or [H, W, 4] RGBA, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_image_file(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write [H, W, 3] RGB or [H, W, 4] RGBA by extension: .png as 8 bits
    (floats in [0, 1] or uint8), .exr (ZIP, half) and .hdr (flat RGBE) as
    the float values."""
    ext = os.path.splitext(str(path))[1].lower()
    img = np.asarray(img)
    if ext in (".exr", ".hdr"):
        encode = encode_exr if ext == ".exr" else encode_hdr
        with open(path, "wb") as f:
            f.write(encode(img.astype(np.float32)))
        return
    if ext != ".png":
        raise NotImplementedError(f"{ext} output is not ported yet; write .png, .exr or .hdr")
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img))
