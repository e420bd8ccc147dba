"""Image IO on zlib, struct, numpy and the port's native library alone:
the decoders and writers of every format the JAX package reads and writes
(it goes through Pillow, which the port does not depend on).

`load_image` picks the decoder by magic, as Pillow picks its plugin: EXR
and Radiance HDR (exr.py, hdr.py), PNG (here), JPEG (jpeg.py), TIFF
(tiff.py), then TGA by its header checks (tga.py). Each returns the RGBA
array [H, W, 4] that the JAX package's imgio.load_image(data).data gives
for the same bytes: uint8 codes for 8-bit data; float32 for the HDR
formats, for 16-bit grey PNGs and TIFFs (code / 65535) and float TIFFs;
bool for 1-bit grey PNGs. So the dtype says whether the image is HDR
(`is_hdr`, the JAX package's Image.is_hdr). Bytes that no decoder accepts
raise ValueError, as the JAX package's load_image does. A recognised
container in a variant that is not ported (arithmetic-coded or 12-bit
JPEG, JPEG-in-TIFF, CMYK, 16-bit TGA ...) or a format of Pillow's that is
not ported (BMP, GIF, WebP ...) raises NotImplementedError (ROADMAP: 'USD
content'), so that the port never renders something else where the JAX
package renders the image.

`write_image_file` writes by extension: .png (8-bit), .jpg / .jpeg (jpeg.py:
Pillow's defaults, alpha dropped), .tga and .tif / .tiff (uncompressed),
.exr and .hdr.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from gatling_tpu_torch.imgio import jpeg, tga, tiff
from gatling_tpu_torch.imgio.exr import decode_exr, encode_exr
from gatling_tpu_torch.imgio.hdr import decode_hdr, encode_hdr
from gatling_tpu_torch.utils.log import get_logger

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


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_samples(raw: np.ndarray, w: int, h: int, depth: int, chans: int) -> tuple[np.ndarray, int]:
    """The samples [h, w, chans] of one (sub)image's filtered rows at the
    head of raw, and the bytes they took."""
    row = (w * chans * depth + 7) // 8
    bpp = max(1, chans * depth // 8)  # the filters' byte distance
    n = h * (1 + row)
    if raw.size < n:
        raise ValueError("PNG: truncated image data")
    rows = raw[:n].reshape(h, 1 + row)
    px = _unfilter(rows[:, 1:].reshape(h, row // bpp, bpp), rows[:, 0], bpp).reshape(h, row)
    if depth == 16:
        return px.view(">u2").reshape(h, w, chans), n
    if depth < 8:
        bits = np.unpackbits(px, axis=1)[:, :w * depth].reshape(h, w, depth)
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        return px[..., None], n
    return px.reshape(h, w, chans), n


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 4] RGBA as the JAX package's Pillow path gives it
    for every bit depth and colour type, interlaced or not: uint8 codes;
    float32 code / 65535 for 16-bit grey (Pillow's "I;16" over 65535); bool
    for 1-bit grey (Pillow's "1"). 2- and 4-bit grey scale to 8-bit codes;
    16-bit colour keeps the high byte of each sample; a palette image takes
    its PLTE entries (black past the end) and tRNS alphas, as Pillow's RGBA
    conversion of a "P" image does; tRNS is ignored for every other
    colour type, as Pillow's array of the image ignores it."""
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
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _compression, _filter, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    chans = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        px = _png_samples(raw, w, h, depth, chans)[0]
    else:
        px = np.zeros((h, w, chans), np.uint16 if depth == 16 else np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], used = _png_samples(raw, pw, ph, depth, chans)
                raw = raw[used:]
    if ctype == 0 and depth == 16:
        grey = px[..., 0].astype(np.float32) / np.float32(65535.0)
        return np.concatenate([np.repeat(grey[..., None], 3, -1),
                               np.ones((h, w, 1), np.float32)], axis=-1)
    if ctype == 0 and depth == 1:
        return np.repeat(px.astype(bool), 4, axis=-1) | np.array([False, False, False, True])
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(palette), :3] = palette[:256]
        if trns is not None:
            table[:min(len(trns), 256), 3] = trns[:256]
        out[:] = table[px[..., 0]]
    elif ctype in (0, 4):
        scale = {1: 255, 2: 85, 4: 17, 8: 1}[depth] if ctype == 0 else 1
        out[..., :3] = px[..., :1] * np.uint8(scale)
        if ctype == 4:
            out[..., 3] = px[..., 1]
    else:
        out[..., :chans] = px
    return out


# formats Pillow reads that the port does not, by their magic
_UNPORTED_MAGIC = ((b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"8BPS", "PSD"),
                   (b"DDS ", "DDS"), (b"qoif", "QOI"), (b"\xffO\xffQ", "JPEG 2000"),
                   (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"II+\x00", "BigTIFF"),
                   (b"MM\x00+", "BigTIFF"))


def load_image(data: bytes) -> np.ndarray:
    """Decode image bytes into [H, W, 4] RGBA (the JAX package's
    imgio.load_image(data).data): the decoder is picked by magic, and
    bytes it rejects, or that no decoder accepts, raise ValueError."""
    data = bytes(data)
    if data[:4] == EXR_MAGIC:
        return decode_exr(data)
    if data[:2] == HDR_MAGIC:
        return decode_hdr(data)
    if data[:8] == PNG_SIGNATURE:
        decode = decode_png
    elif data[:3] == b"\xff\xd8\xff":
        decode = jpeg.decode_jpeg
    elif tiff.accepts(data):
        decode = tiff.decode_tiff
    else:
        for magic, name in _UNPORTED_MAGIC:
            if data.startswith(magic):
                raise NotImplementedError(f"{name} images are not ported (ROADMAP: 'USD "
                                          "content')")
        if not tga.accepts(data):
            raise ValueError("no decoder accepted image data: not a PNG, JPEG, TIFF, TGA, "
                             "EXR or Radiance HDR file")
        decode = tga.decode_tga
    try:
        return decode(data)
    except NotImplementedError:
        raise
    except Exception as e:  # noqa: BLE001 - a corrupt file, whatever the decoder met
        raise ValueError(f"no decoder accepted image data: {decode.__name__}: {e}") from e


def load_image_file(path: str | os.PathLike) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return load_image(data)
    except ValueError:
        get_logger().error("failed to decode image %s", path)
        raise


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
    """Write [H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA by extension (the
    JAX package's write_image_file): .exr (ZIP, half) and .hdr (flat RGBE)
    as the float values; .png (RGB or RGBA), .jpg / .jpeg (the alpha
    dropped), .tga and .tif / .tiff as 8-bit codes, floats in [0, 1]
    scaled and rounded."""
    ext = os.path.splitext(str(path))[1].lower()
    img = np.asarray(img)
    if ext in (".exr", ".hdr"):
        encode = encode_exr if ext == ".exr" else encode_hdr
        with open(path, "wb") as f:
            f.write(encode(img.astype(np.float32)))
        return
    encoders = {".png": encode_png, ".jpg": jpeg.encode_jpeg, ".jpeg": jpeg.encode_jpeg,
                ".tga": tga.encode_tga, ".tif": tiff.encode_tiff, ".tiff": tiff.encode_tiff}
    if ext not in encoders:
        raise ValueError(f"cannot write {ext} images: write .png, .jpg, .tga, .tif, .exr or "
                         ".hdr")
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if ext in (".jpg", ".jpeg") and img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    with open(path, "wb") as f:
        f.write(encoders[ext](img))
