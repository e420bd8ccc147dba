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
frame, as libwebp decodes them), JPEG 2000 (jpeg2000.py: JP2 files and
raw codestreams, as OpenJPEG decodes them for Pillow) and Pillow's legacy
plugins: SGI (sgi.py), PCX and DCX (pcx.py), BLP (blp.py), FTEX (ftex.py),
Sun raster (sun.py), ICNS (icns.py), FITS (fits.py), IM (im.py), XPM and
XBM (xpm.py), MSP (msp.py), FLI (fli.py), Photo CD (pcd.py), and SPIDER,
McIdas, PIXAR, IMT, XV thumbnails, GIMP brushes and IPTC
(rawformats.py). The array is uint8 codes for 8-bit data;
float32 for the HDR formats, for Pillow's "I" and "F" modes (16-bit grey
PNGs, TIFFs and PGMs as code / 65535, float TIFFs and PFMs as stored);
bool for Pillow's "1" (1-bit grey PNGs, BMPs, TIFFs, PBMs). So the dtype
says whether the image is HDR (`is_hdr`, the JAX package's Image.is_hdr).

The contract with the JAX package, for any bytes: where it returns an
array, the port returns the same array or raises NotImplementedError
naming its ROADMAP item ('USD content': a plugin or variant not ported),
and never another array (a TIFF whose array in Pillow holds memory no
decoder wrote raises ValueError: tiff.py); where it raises ValueError (no plugin takes the
bytes, or the plugin that takes them cannot finish: EPS without
Ghostscript, WMF off Windows, a truncated or corrupt file), the port
raises ValueError. Both packages' texture managers turn that ValueError
into the 1x1 black texel; a NotImplementedError is raised to the caller.

`write_image_file` writes by extension every format the JAX package's
writer saves through Pillow (its docstring has the table): Pillow's bytes
for PNG (here), JPEG (jpeg.py), TGA, TIFF, BMP/DIB, Netpbm, GIF (gif.py over
quantize.py), DDS, QOI, PCX, SGI, IM, EPS (eps.py), ICO (ico.py) and ICNS
(icns.py, over resample.py); a lossless JPEG 2000 of the port's own
(jpeg2000.py); PDF (pdf.py); EXR and Radiance HDR as floats. Where
Pillow's saver refuses, the same exception class; WebP and AVIF raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from gatling_tpu_torch.imgio import (blp, bmp, dds, eps, fits, fli, ftex, gif, icns, ico, im,
                                     jpeg, jpeg2000, msp, pcd, pcx, pdf, pnm, psd, qoi, rawformats,
                                     sgi, sun, tga, tiff, webp, xpm)
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


def decode_png(data: bytes, transparency: bool = True) -> np.ndarray:
    """PNG bytes -> [H, W, 4] RGBA as the JAX package's Pillow path gives it
    for every bit depth and colour type, interlaced or not: uint8 codes;
    float32 code / 65535 for 16-bit grey (Pillow's "I;16" over 65535); bool
    for 1-bit grey (Pillow's "1"). 2- and 4-bit grey scale to 8-bit codes;
    16-bit colour keeps the high byte of each sample; a palette image takes
    its PLTE entries (black past the end) and tRNS alphas, as Pillow's RGBA
    conversion of a "P" image does (unless `transparency` is false: an
    image that does not carry the PNG's info, as an ICNS icon's); tRNS is
    ignored for every other colour type, as Pillow's array of the image
    ignores it."""
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
        if trns is not None and transparency:
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
             "TGA": _tga, "WEBP": webp.decode_webp, "JPEG2000": jpeg2000.decode_jpeg2000,
             "SGI": sgi.decode_sgi, "PCX": pcx.decode_pcx, "DCX": pcx.decode_dcx,
             "BLP": blp.decode_blp, "FTEX": ftex.decode_ftex, "SUN": sun.decode_sun,
             "ICNS": icns.decode_icns, "FITS": fits.decode_fits, "IM": im.decode_im,
             "XPM": xpm.decode_xpm, "XBM": xpm.decode_xbm, "MSP": msp.decode_msp,
             "FLI": fli.decode_fli, "SPIDER": rawformats.decode_spider,
             "MCIDAS": rawformats.decode_mcidas, "PIXAR": rawformats.decode_pixar,
             "IMT": rawformats.decode_imt, "XVTHUMB": rawformats.decode_xvthumb,
             "GBR": rawformats.decode_gbr, "IPTC": rawformats.decode_iptc, "PCD": pcd.decode_pcd}


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


def png_rows(img: np.ndarray) -> np.ndarray:
    """The filtered rows [H, 1 + W * C] of img [H, W, C] uint8 as Pillow's
    ZipEncode.c picks them: each row's filter the one of None, Up, Sub and
    Paeth (tried in that order, a later one taken only when strictly
    better, and none tried once a row sums to 0) whose bytes, each counted
    as its distance from 0 mod 256, sum the least."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), raw[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), raw[:, :-c]])
    corner = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    filtered = np.stack([(raw - x) & 0xFF for x in (0, up, left, paeth)]).astype(np.uint8)
    cost = np.minimum(filtered, 256 - filtered.astype(np.int32)).sum(axis=2)
    choice = np.zeros(h, np.int64)
    best = cost[0].copy()
    for k in (1, 2, 3):
        take = (best > 0) & (cost[k] < best)
        choice[take] = k
        best = np.where(take, cost[k], best)
    types = np.array([0, 2, 1, 4], np.uint8)[choice]
    return np.concatenate([types[:, None], filtered[choice, np.arange(h)]], axis=1)


def encode_png(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes
    PngImagePlugin._save writes: IHDR, the filtered rows (png_rows) deflated
    as ZipEncode.c deflates them (level 6, memory level 9, Z_FILTERED) in
    IDAT chunks of ImageFile's buffer size, IEND."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3, 4):
        raise ValueError(f"expected grey, RGB or RGBA, got {img.shape}")
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = z.compress(png_rows(img).tobytes()) + z.flush()
    block = max(65536, w * 4)  # ImageFile._save's bufsize: one IDAT an encoder call
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0))
            + b"".join(_chunk(b"IDAT", stream[i:i + block]) for i in range(0, len(stream), block))
            + _chunk(b"IEND", b""))


# Pillow 12.1's save registry (Image.EXTENSION, Image.SAVE): each extension
# the JAX package's writer takes and the format Pillow saves it as
EXTENSION_FORMAT = {
    **dict.fromkeys((".png", ".apng"), "PNG"),
    **dict.fromkeys((".jpg", ".jpeg", ".jfif", ".jpe"), "JPEG"), ".mpo": "MPO",
    **dict.fromkeys((".tga", ".icb", ".vda", ".vst"), "TGA"),
    **dict.fromkeys((".tif", ".tiff"), "TIFF"), ".bmp": "BMP", ".dib": "DIB",
    **dict.fromkeys((".pbm", ".pgm", ".ppm", ".pnm", ".pfm"), "PPM"),
    ".gif": "GIF", ".dds": "DDS", ".qoi": "QOI", ".pcx": "PCX",
    **dict.fromkeys((".sgi", ".rgb", ".rgba", ".bw"), "SGI"), ".im": "IM",
    **dict.fromkeys((".eps", ".ps"), "EPS"), ".ico": "ICO", ".icns": "ICNS",
    **dict.fromkeys((".j2k", ".j2c", ".jpc", ".jp2", ".jpf", ".jpx"), "JPEG2000"),
    ".pdf": "PDF", ".blp": "BLP", ".msp": "MSP", ".xbm": "XBM", ".palm": "PALM",
    ".bufr": "BUFR", ".grib": "GRIB", **dict.fromkeys((".h5", ".hdf"), "HDF5"),
    **dict.fromkeys((".emf", ".wmf"), "WMF"), ".webp": "WEBP",
    **dict.fromkeys((".avif", ".avifs"), "AVIF"),
    ".cur": "CUR", ".dcx": "DCX", **dict.fromkeys((".fit", ".fits"), "FITS"),
    **dict.fromkeys((".flc", ".fli"), "FLI"), **dict.fromkeys((".ftc", ".ftu"), "FTEX"),
    ".gbr": "GBR", ".iim": "IPTC", **dict.fromkeys((".mpeg", ".mpg"), "MPEG"), ".pcd": "PCD",
    ".psd": "PSD", ".pxr": "PIXAR", ".ras": "SUN", ".xpm": "XPM",
}
# registered for reading only: Image.save raises KeyError on the format
READ_ONLY_FORMATS = frozenset(("CUR", "DCX", "FITS", "FLI", "FTEX", "GBR", "IPTC", "MPEG", "PCD",
                               "PSD", "PIXAR", "SUN", "XPM"))
# the formats whose Pillow saver refuses every image the writer passes it
_REFUSED = {"BLP": (ValueError, "Unsupported BLP image mode"),
            "MSP": (OSError, "cannot write mode {mode} as MSP"),
            "XBM": (OSError, "cannot write mode {mode} as XBM"),
            "PALM": (OSError, "cannot write mode {mode} as Palm"),
            "BUFR": (OSError, "BUFR save handler not installed"),
            "GRIB": (OSError, "GRIB save handler not installed"),
            "HDF5": (OSError, "HDF5 save handler not installed"),
            "WMF": (OSError, "WMF save handler not installed")}
UNPORTED_WRITERS = {"WEBP": "ROADMAP Queue 1 item 2: the WebP encoder (lossy VP8 at quality 80 "
                            "and the VP8L alpha)",
                    "AVIF": "ROADMAP Queue 1 item 2: AVIF (an AV1 encoder)"}


def _jpeg(img: np.ndarray) -> bytes:
    if img.ndim == 3 and img.shape[2] == 4:
        raise OSError("cannot write mode RGBA as JPEG")
    return jpeg.encode_jpeg(img)


def encode_image(path: str | os.PathLike, img: np.ndarray) -> bytes:
    """The bytes write_image_file writes for img (uint8 [H, W], [H, W, 3]
    or [H, W, 4]) at `path`, by its extension (case aside): Pillow's bytes
    where the table of write_image_file says so."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in EXTENSION_FORMAT:
        raise ValueError(f"unknown file extension: {ext}")
    fmt = EXTENSION_FORMAT[ext]
    if fmt in READ_ONLY_FORMATS:
        raise KeyError(fmt)
    if fmt in UNPORTED_WRITERS:
        raise NotImplementedError(f"writing {ext} images: {UNPORTED_WRITERS[fmt]}")
    if fmt in _REFUSED:
        kind, msg = _REFUSED[fmt]
        raise kind(msg.format(mode={1: "L", 3: "RGB", 4: "RGBA"}[
            1 if img.ndim == 2 else img.shape[2]]))
    writers = {"PNG": encode_png, "JPEG": _jpeg, "MPO": _jpeg, "TGA": tga.encode_tga,
               "TIFF": tiff.encode_tiff, "BMP": bmp.encode_bmp, "DIB": bmp.encode_dib,
               "PPM": pnm.encode_pnm, "GIF": gif.encode_gif, "DDS": dds.encode_dds,
               "QOI": qoi.encode_qoi, "PCX": pcx.encode_pcx, "EPS": eps.encode_eps,
               "ICO": ico.encode_ico, "ICNS": icns.encode_icns,
               "SGI": lambda a: sgi.encode_sgi(a, path), "IM": lambda a: im.encode_im(a, path),
               "PDF": lambda a: pdf.encode_pdf(a, path),
               "JPEG2000": lambda a: jpeg2000.encode_jpeg2000(a, jp2=not path.endswith(".j2k"))}
    return writers[fmt](img)


def write_image_file(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write [H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA by extension, as
    the JAX package's write_image_file does through Pillow 12.1: .exr (ZIP,
    half) and .hdr (flat RGBE) as the float values; every other extension
    as 8-bit codes (floats in [0, 1] scaled and rounded), a grey image
    squeezed first (so one row high it is written one column wide, as
    there), an RGBA image's alpha dropped for .jpg and .jpeg alone. The
    contract with the JAX package's writer, on the same array and path:
    - the same bytes for .png .apng, .jpg .jpeg .jfif .jpe .mpo (RGBA:
      OSError), .tga .icb .vda .vst, .tif .tiff, .bmp, .dib, the Netpbm
      five, .dds, .qoi (grey: ValueError), .pcx and .eps .ps (RGBA:
      ValueError), .sgi .rgb .rgba .bw, .im, .gif, .ico and .icns;
    - .j2k .j2c .jpc .jp2 .jpf .jpx: a lossless JPEG 2000 (a bare
      codestream for .j2k, else the JP2 boxes) that Pillow opens with the
      same format, mode, size and samples; the bytes are the port's own;
    - .pdf: the same bytes but for the dates and, for RGBA, the JPX stream
      (and the lengths and offsets it moves);
    - the class Pillow raises where its saver refuses: ValueError for .blp
      and unknown extensions, OSError for .msp .xbm .palm .bufr .grib .h5
      .hdf .emf .wmf, KeyError for the extensions Pillow only reads;
    - .webp, .avif and .avifs raise NotImplementedError naming their
      ROADMAP item.
    Nothing is written where it raises."""
    ext = os.path.splitext(str(path))[1].lower()
    img = np.asarray(img)
    if ext in (".exr", ".hdr"):
        data = (encode_exr if ext == ".exr" else encode_hdr)(img.astype(np.float32))
        with open(path, "wb") as f:
            f.write(data)
        return
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] not in (1, 3, 4):
        raise KeyError(img.shape[2])  # the JAX writer's channels -> mode table
    if img.ndim == 2 or img.shape[2] == 1:
        img = img.squeeze()
        if img.ndim == 1:  # Image.fromarray takes a 1-D array as one column
            img = img[:, None]
        elif img.ndim == 0:
            raise IndexError("tuple index out of range")  # Image.fromarray of a 0-d array
    elif ext in (".jpg", ".jpeg") and img.shape[2] == 4:
        img = img[..., :3]
    data = encode_image(path, img)
    with open(path, "wb") as f:
        f.write(data)
