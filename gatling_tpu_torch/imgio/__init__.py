"""Image IO on zlib, struct, numpy and the port's native library alone:
the decoders and writers of every format the JAX package reads and writes
(it goes through Pillow, which the port does not depend on).

`load_image` takes EXR and Radiance HDR by their magic (exr.py, hdr.py),
as the JAX package does, then makes Pillow 12.1's open decision
(identify.py): Pillow's plugins in Pillow's order, each by its accept test
and its opening's checks. A ported plugin's decoder returns the RGBA array
[H, W, 4] that the JAX package's imgio.load_image(data).data gives for the
same bytes: PNG (here), JPEG (jpeg.py: baseline, progressive with
libjpeg's block smoothing, lossless, Huffman- or arithmetic-coded), TIFF
(tiff.py: every compression libtiff here decodes, CCITT, LZMA, ZSTD,
ThunderScan and old-style JPEG among them; YCbCr, orientations, planes),
TGA (tga.py), BMP, DIB, ICO and CUR (bmp.py), GIF (gif.py),
DDS (dds.py), PSD (psd.py), QOI (qoi.py), Netpbm (pnm.py), WebP
(webp.py: VP8 lossy, VP8L lossless, ALPH alpha and an animation's first
frame, as libwebp decodes them) and JPEG 2000 (jpeg2000.py: JP2 files and
raw codestreams, as OpenJPEG decodes them for Pillow). The array is uint8 codes for 8-bit data;
float32 for the HDR formats, for Pillow's "I" and "F" modes (16-bit grey
PNGs, TIFFs and PGMs as code / 65535, float TIFFs and PFMs as stored);
bool for Pillow's "1" (1-bit grey PNGs, BMPs, TIFFs, PBMs). So the dtype
says whether the image is HDR (`is_hdr`, the JAX package's Image.is_hdr).

The contract with the JAX package, for any bytes: where it returns an
array, the port returns the same array or raises NotImplementedError
naming its ROADMAP item ('USD content': a plugin or variant not ported),
and never another array (a TIFF whose array in Pillow holds memory no
decoder wrote, or data libtiff keeps from a damaged LZMA strip, raises
ValueError: tiff.py); where it raises ValueError (no plugin takes the
bytes, or the plugin that takes them cannot finish: EPS without
Ghostscript, WMF off Windows, a truncated or corrupt file), the port
raises ValueError. Both packages' texture managers turn that ValueError
into the 1x1 black texel; a NotImplementedError is raised to the caller.

`write_image_file` writes by extension: .png (8-bit), .jpg / .jpeg (jpeg.py:
Pillow's defaults, alpha dropped), .tga and .tif / .tiff (uncompressed),
.bmp (bmp.py), .pbm / .pgm / .ppm / .pnm / .pfm (pnm.py), .exr
and .hdr.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from gatling_tpu_torch.imgio import bmp, dds, gif, jpeg, jpeg2000, pnm, psd, qoi, tga, tiff, webp
from gatling_tpu_torch.imgio.identify import PLUGINS, accepts, open_unported
from gatling_tpu_torch.imgio.modes import Skip
from gatling_tpu_torch.imgio.exr import decode_exr, encode_exr
from gatling_tpu_torch.imgio.hdr import decode_hdr, encode_hdr
from gatling_tpu_torch.utils.log import get_logger

EXR_MAGIC = b"\x76\x2f\x31\x01"
HDR_MAGIC = b"#?"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_CID = re.compile(rb"\w\w\w\w")  # PngImagePlugin.is_cid


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
    pos, palette, trns, header = 8, None, None, None
    while True:  # PngImageFile._open: the chunks up to the first IDAT, checksummed
        s = data[pos:pos + 8]
        if len(s) < 8 or not _CID.match(s[4:]):
            raise ValueError("broken PNG file")
        (length,) = struct.unpack(">I", s[:4])
        tag, pos = s[4:], pos + 8
        if tag == b"IDAT":
            break
        if tag == b"IEND":
            raise ValueError("PNG: no image data")
        body, crc = data[pos:pos + length], data[pos + length:pos + length + 4]
        if len(body) < length:
            raise ValueError("PNG: Truncated File Read")
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"broken PNG file (bad header checksum in {tag!r})")
        pos += length + 4
        if tag == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE" and header is not None and header[3] == 3:
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif tag == b"tRNS" and header is not None and header[3] == 3:
            trns = np.frombuffer(body, np.uint8)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    idat = []  # PngImageFile.load_read: the IDAT chunks that follow one another
    while tag == b"IDAT":
        idat.append(data[pos:pos + length])
        pos += length + 4
        s = data[pos:pos + 8]
        if len(s) < 8:
            break
        (length,) = struct.unpack(">I", s[:4])
        tag, pos = s[4:], pos + 8
    w, h, depth, ctype, _compression, filt, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1 or w == 0 or h == 0 or filt:
        raise ValueError(f"PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    chans = _CHANNELS[ctype]
    # Pillow's zip decoder stops once the image is filled: the stream's end
    # (and whatever corruption lies past the last row) is never read
    passes = [(w, h, 0, 0, 1, 1)] if interlace == 0 else [
        (-(-(w - x0) // dx), -(-(h - y0) // dy), x0, y0, dx, dy) for x0, y0, dx, dy in _ADAM7]
    need = sum(ph * (1 + (pw * chans * depth + 7) // 8) for pw, ph, *_ in passes
               if pw > 0 and ph > 0)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data: {e}") from e
    if len(raw) < need:
        raise ValueError("image file is truncated")
    raw = np.frombuffer(raw, np.uint8)
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


def _tga(data: bytes) -> np.ndarray:
    if not tga.accepts(data):
        raise Skip("not a TGA file")
    return tga.decode_tga(data)


# the decoder of each ported plugin of Pillow's (identify.PLUGINS)
_DECODERS = {"BMP": bmp.decode_bmp, "DIB": bmp.decode_dib, "GIF": gif.decode_gif,
             "JPEG": jpeg.decode_jpeg, "PPM": pnm.decode_pnm, "PNG": decode_png,
             "CUR": bmp.decode_cur, "DDS": dds.decode_dds, "ICO": bmp.decode_ico,
             "TIFF": tiff.decode_tiff, "PSD": psd.decode_psd, "QOI": qoi.decode_qoi,
             "TGA": _tga, "WEBP": webp.decode_webp, "JPEG2000": jpeg2000.decode_jpeg2000}


def load_image(data: bytes) -> np.ndarray:
    """Decode image bytes into [H, W, 4] RGBA (the JAX package's
    imgio.load_image(data).data): EXR and Radiance HDR by their magic, then
    Pillow's plugins in Pillow's order (identify.py). A ported plugin's
    decoder returns the array the JAX package gives; an unported one raises
    NotImplementedError (ROADMAP: 'USD content'). Bytes that no plugin
    takes, or that the plugin taking them cannot decode, raise ValueError,
    as the JAX package's load_image does."""
    data = bytes(data)
    if data[:4] == EXR_MAGIC:
        return decode_exr(data)
    if data[:2] == HDR_MAGIC:
        return decode_hdr(data)
    prefix = data[:16]
    for name, accept in PLUGINS:
        if not accepts(accept, prefix):
            continue
        try:
            if name in _DECODERS:
                return _DECODERS[name](data)
            open_unported(name, data)
        except Skip:
            continue
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001 - a corrupt file, whatever the decoder met
            raise ValueError(f"no decoder accepted image data: {name}: {e}") from e
    raise ValueError("no decoder accepted image data: cannot identify image file")


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
    dropped), .tga, .tif / .tiff, .bmp and the Netpbm extensions
    (.pbm, .pgm, .ppm, .pnm and .pfm alike: Pillow's P5 or P6, the alpha
    dropped) as 8-bit codes, floats in [0, 1] scaled and rounded; each file
    byte for byte what Pillow saves for the same array."""
    ext = os.path.splitext(str(path))[1].lower()
    img = np.asarray(img)
    if ext in (".exr", ".hdr"):
        encode = encode_exr if ext == ".exr" else encode_hdr
        with open(path, "wb") as f:
            f.write(encode(img.astype(np.float32)))
        return
    encoders = {".png": encode_png, ".jpg": jpeg.encode_jpeg, ".jpeg": jpeg.encode_jpeg,
                ".tga": tga.encode_tga, ".tif": tiff.encode_tiff, ".tiff": tiff.encode_tiff,
                ".bmp": bmp.encode_bmp,
                **dict.fromkeys((".pbm", ".pgm", ".ppm", ".pnm", ".pfm"), pnm.encode_pnm)}
    if ext not in encoders:
        raise ValueError(f"cannot write {ext} images: write .png, .jpg, .tga, .tif, .bmp, "
                         ".ppm (.pbm, .pgm, .pnm, .pfm), .exr or .hdr (ROADMAP: 'USD content')")
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if ext in (".jpg", ".jpeg") and img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    with open(path, "wb") as f:
        f.write(encoders[ext](img))
