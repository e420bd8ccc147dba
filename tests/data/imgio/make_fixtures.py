"""Write the image fixtures of tests/test_torch_imgio.py and chip_smoke.py
phase 4n, and fixtures.npz beside them: for each file, the array the JAX
package decodes it to (gatling_tpu.imgio.load_image(data).data), which the
port's decoders must equal bit for bit, also where Pillow is absent.

Pillow writes every file it can write: JPEG baseline at 4:2:0, 4:2:2 and
4:4:4, with restart markers, progressive, grey and CMYK; TGA raw and
run-length; TIFF LZW with predictor 2, Deflate of 16-bit grey, Deflate of
floats with predictor 3, palette, CMYK, 32-bit integer, JPEG-compressed
and BigTIFF; 16-bit and 1-bit grey PNGs; BMP, ICO, GIF, DDS (DXT1, DXT5,
BC5), QOI, PPM, PGM and PFM. The writers below make the files Pillow
cannot write: `raw_png` the Adam7-interlaced and 16-bit RGB PNGs;
`bmp_rle8`, `cur_file`, `bc7_dds` (BC7 mode 6 blocks), `dds_blocks` (any
BCn format's random blocks), `psd_file`, `tga16`, `tiff_file` (any
layout: sub-byte samples, planar configuration 2, bit fill order 2,
old-style LZW) and, through the port's native entropy coder, JPEGs of any
sampling factors (`jpeg_sampled`). The images are smooth procedural
textures with a little noise, from a seed.

The WebP fixtures (`webp_fixtures`, chip_smoke.py phase 4q) are Pillow's
lossy and lossless files, RGB and RGBA, and a three-frame animation; the
three 1024^2 ones (`smooth_texture`: a lossy RGB ground, a lossy RGBA with
an alpha ramp, a lossless one posterised to 16 levels) are kept in
fixtures.npz as the SHA-256 of their array (`digest`), so that the
repository stays small.

The JPEG 2000 fixtures (`jpeg2000_fixtures`, chip_smoke.py phase 4r) are
Pillow's files (5/3 lossless, 9/7 with MCT, a tiled RPCL codestream with
precincts, 16-bit grey, a 1024^2 9/7 ground kept as its digest) and JP2
boxes Pillow does not write (`jp2_file`: RGBA with a cdef box, a pclr
palette with cmap). The JPEG processes Pillow does not write come from the
writers here: `jpeg_arith`, a jcarith.c encoder re-coding a Pillow
Huffman file's coefficients as SOF9 or SOF10 (with DAC conditioning if
asked); `jpeg_lossless`, SOF3 with any predictor and point transform;
`jpeg_scans`, a progressive file with some scans cut out, which libjpeg
decodes with block smoothing.

The TIFF fixtures (`tiff_fixtures`, chip_smoke.py phase 4s) are Pillow's
ZSTD, LZMA and CCITT files and LZW with an Orientation, and what Pillow
cannot write, from the writers here: `tiff_raw` (any fields, strips or
tiles, tables beside them), `thunder_encode` (ThunderScan codes),
`ycbcr_units` (subsampled YCbCr data units) over `lzw_new` (new-style
LZW), planes of 16-bit samples, `ojpeg_tables` (an old-style JPEG: the
tables of a Pillow JPEG in tags, its restart intervals the strips) and
`ojpeg_jif` (a whole JPEG at JPEGInterchangeFormat); a 1024^2 ZSTD ground
and Group 4 stencil are kept as their digest.

The fixtures of Pillow's legacy plugins (`legacy_fixtures`, chip_smoke.py
phase 4t) are Pillow's PCX, DCX frames, IM, SPIDER and XBM files, and the
writers here for what Pillow does not write: `sgi_file` (SGI RLE: a 1024^2
tile ground, `tile_ground`, kept as its digest), `pcx_file`, `dcx_file`,
`blp_file` over `dxt1_blocks` (a plain DXT1 encoder) or a JPEG's header
and scan, `ftex_file`, `sun_file` (raw and RLE), `icns_file` over
`icns_rgb`, `fits_file` and `fits_gzip`, `fli_file` with `fli_color`,
`fli_brun`, `fli_lc` and `fli_ss2` chunks, `xpm_file`, `msp_file`,
`gbr_file`, `imt_file`, `iptc_file`, `mcidas_file`, `pixar_file` and
`xvthumb_file` (tests/test_torch_imgio_legacy.py makes its own files with
the same writers).

writers.json (`writers`, tests/test_torch_writers.py and chip_smoke.py
phase 4u) holds three seeded arrays (L, RGB, RGBA, odd sizes) and the
SHA-256 of the file Pillow saves for each at every extension where the
port's writer must give Pillow's bytes, so that the card's host, without
Pillow, can hold the port's files to them.

Run from the repository root, where Pillow and JAX are installed:

    JAX_PLATFORMS=cpu python tests/data/imgio/make_fixtures.py
"""

from __future__ import annotations

import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def texture(h: int, w: int, channels: int, seed: int, depth: int = 8) -> np.ndarray:
    """A smooth colourful pattern with noise: [h, w, channels] of `depth`
    bits (uint8 or uint16)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    phase = rng.uniform(0, 6.3, channels)
    base = np.stack([0.5 + 0.35 * np.sin(9.0 * xx + 5.0 * yy * (k + 1) + phase[k])
                     for k in range(channels)], axis=-1)
    tiles = ((xx * 6).astype(int) + (yy * 6).astype(int)) % 2
    img = base * (0.8 + 0.2 * tiles[..., None]) + rng.normal(0, 0.03, base.shape)
    top = (1 << depth) - 1
    return np.clip(np.round(img * top), 0, top).astype(np.uint8 if depth == 8 else np.uint16)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def raw_png(samples: np.ndarray, interlace: bool = False, depth: int | None = None,
            colour_type: int | None = None, palette: bytes | None = None,
            trns: bytes | None = None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of samples [h, w, c] (uint8 or uint16, or the values of a
    1/2/4-bit depth), each row filtered by the next of `filters` in turn
    (the filter is undone by the decoder whatever the row holds)."""
    h, w, c = samples.shape
    depth = depth or samples.dtype.itemsize * 8
    ctype = COLOUR_TYPES[c] if colour_type is None else colour_type

    def rows(px: np.ndarray) -> bytes:
        if depth == 16:
            lines = px.astype(">u2").reshape(px.shape[0], -1).view(np.uint8)
        elif depth < 8:
            bits = (px.reshape(px.shape[0], -1, 1).astype(np.uint8)
                    >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
            lines = np.packbits(bits.reshape(px.shape[0], -1), axis=1)
        else:
            lines = px.astype(np.uint8).reshape(px.shape[0], -1)
        bpp = max(1, c * depth // 8)
        out = bytearray()
        prev = np.zeros(lines.shape[1], np.int32)
        for y, line in enumerate(lines.astype(np.int32)):
            f = filters[y % len(filters)]
            left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            if f == 4:
                p = left + prev - upleft
                pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            else:
                pred = [0 * line, left, prev, (left + prev) >> 1][f]
            out += bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
            prev = line
        return bytes(out)

    if interlace:
        raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                       if x0 < w and y0 < h)
    else:
        raw = rows(samples)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
            + (_chunk(b"PLTE", palette) if palette is not None else b"")
            + (_chunk(b"tRNS", trns) if trns is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def pillow(img: np.ndarray, fmt: str, mode: str | None = None, **kwargs) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(img.squeeze(-1) if img.ndim == 3 and img.shape[2] == 1 else img)
    if mode:
        im = im.convert(mode) if mode == "1" else im
    im.save(buf, fmt, **kwargs)
    return buf.getvalue()


def bmp_rle8(img: np.ndarray, palette: np.ndarray) -> bytes:
    """An RLE8 BMP of palette indices img [h, w] (runs and absolute runs,
    an end-of-line after each row, end-of-bitmap at the end)."""
    h, w = img.shape
    body = bytearray()
    for row in img[::-1]:
        x = 0
        while x < w:
            k = 1
            while x + k < w and k < 255 and row[x + k] == row[x]:
                k += 1
            if k >= 3 or w - x < 3:
                body += bytes([k, row[x]])
            else:
                k = min(w - x, 255)
                k = max(3, min(k, next((j for j in range(x + 2, x + k)
                                        if j + 2 < w and row[j] == row[j + 1] == row[j + 2]),
                                       x + k) - x))
                body += bytes([0, k]) + bytes(row[x:x + k].tolist()) + (b"\0" if k % 2 else b"")
            x += k
        body += b"\0\0"
    body += b"\0\1"
    pal = np.zeros((256, 4), np.uint8)
    pal[:len(palette), :3] = palette[:, ::-1]
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, len(body), 2835, 2835, 256, 0)
    off = 14 + 40 + 1024
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + pal.tobytes() \
        + bytes(body)


def cur_file(dib: bytes, w: int, h: int) -> bytes:
    """A one-entry CUR of a DIB (its header at the entry's offset)."""
    entry = struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, 1, len(dib), 22)
    return b"\0\0\2\0\1\0" + entry + dib


def dds_header(w: int, h: int, fourcc: bytes, dxgi: int | None = None) -> bytes:
    head = b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1) + b"\0" * 44
    head += struct.pack("<8I", 32, 4, struct.unpack("<I", fourcc)[0], 0, 0, 0, 0, 0) + b"\0" * 20
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head


def dds_blocks(w: int, h: int, dxgi: int, seed: int, size: int = 16) -> bytes:
    """A DX10 DDS of random blocks (any BCn format: the decoders take any
    bits)."""
    n = ((w + 3) // 4) * ((h + 3) // 4)
    rng = np.random.default_rng(seed)
    return dds_header(w, h, b"DX10", dxgi) + rng.integers(0, 256, n * size, np.uint8).tobytes()


def bc7_dds(img: np.ndarray) -> bytes:
    """A BC7 DDS of img [h, w, 4] (h, w multiples of 4) in mode 6 blocks:
    each block's endpoints its channel minima and maxima (7 bits, p-bits
    0 and 1), each texel's 4-bit index its position between them (the
    endpoints swapped where the anchor texel's index would need 4 bits)."""
    h, w = img.shape[:2]
    blocks = img.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    out = bytearray()
    for b in blocks.astype(np.int64):
        e0, e1 = (b.min(0) >> 1) << 1, ((b.max(0) >> 1) << 1) | 1
        d = e1 - e0
        idx = np.clip(np.round(((b - e0) * d).sum(1) / max((d * d).sum(), 1) * 15), 0, 15)
        idx = idx.astype(np.int64)
        if idx[0] > 7:
            e0, e1, idx = e1, e0, 15 - idx
        bits, pos = 1 << 6, 7
        for c in range(4):
            for v in (e0[c] >> 1, e1[c] >> 1):
                bits |= int(v) << pos
                pos += 7
        bits |= int(e0[0] & 1) << pos | int(e1[0] & 1) << (pos + 1)
        pos += 2
        for k, i in enumerate(idx):
            bits |= int(i) << pos
            pos += 3 if k == 0 else 4
        out += bits.to_bytes(16, "little")
    return dds_header(w, h, b"DX10", 98) + bytes(out)


def packbits(row: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(row):
        k = 1
        while i + k < len(row) and k < 128 and row[i + k] == row[i]:
            k += 1
        if k >= 2:
            out += bytes([257 - k, row[i]])
            i += k
        else:
            j = i
            while j < len(row) and j - i < 128 and not (
                    j + 1 < len(row) and row[j] == row[j + 1]):
                j += 1
            out += bytes([j - i - 1]) + row[i:j]
            i = j
    return bytes(out)


def psd_file(planes: np.ndarray, mode: int, compression: int = 1) -> bytes:
    """A PSD of channel planes [c, h, w] (uint8) in colour mode `mode`
    (3 RGB, 4 CMYK, 1 grey), raw or PackBits."""
    c, h, w = planes.shape
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, 8, mode) + struct.pack(">III", 0, 0, 0)
    if compression == 0:
        return out + struct.pack(">H", 0) + planes.tobytes()
    rows = [packbits(r.tobytes()) for p in planes for r in p]
    return out + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows) \
        + b"".join(rows)


def tga16(img: np.ndarray) -> bytes:
    """A 16-bit true-colour TGA (5-5-5, top-left origin) of img [h, w, 3]."""
    h, w = img.shape[:2]
    v = ((img[..., 0].astype(np.uint16) >> 3) << 10) | ((img[..., 1].astype(np.uint16) >> 3)
                                                        << 5) | (img[..., 2] >> 3)
    return struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 16, 0x20) \
        + v.astype("<u2").tobytes()


def lzw_old(data: bytes) -> bytes:
    """Old-style (LSB-first) TIFF LZW, as libtiff's LZWDecodeCompat reads
    it: a clear code, then codes whose width grows once the decoder's next
    free entry passes 2^width - 1 (one code later than the new style), a
    clear when the table fills, EOI."""
    out, acc, nacc = bytearray(), 0, 0
    table = {bytes([i]): i for i in range(256)}
    nbits, free = 9, 258

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def grow():
        nonlocal nbits
        if free > (1 << nbits) and nbits < 12:
            nbits += 1

    put(256)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if free < 4000:
            table[wc] = free
            free += 1
            grow()
        else:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nbits, free = 9, 258
        w = bytes([byte])
    if w:
        put(table[w])
        free += 1
        grow()
    put(257)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def tiff_file(strips: list[bytes], w: int, h: int, rows_per_strip: int, fields: dict,
              bo: str = "<") -> bytes:
    """A classic TIFF of the given strips and extra fields {tag: (type,
    values)}; width, height, rows per strip and the strip tables added."""
    head = (b"II*\0" if bo == "<" else b"MM\0*")
    data, offsets = bytearray(), []
    pos = 8
    for s in strips:
        offsets.append(pos + len(data))
        data += s
    fields = dict(fields)
    fields.update({256: (4, [w]), 257: (4, [h]), 278: (4, [rows_per_strip]),
                   273: (4, offsets), 279: (4, [len(s) for s in strips])})
    ifd_at = pos + len(data) + (len(data) & 1)
    data += b"\0" * (len(data) & 1)
    sizes = {1: 1, 3: 2, 4: 4, 7: 1}
    codes = {1: "B", 3: "H", 4: "I", 7: "B"}
    entries, extra = [], bytearray()
    extra_at = ifd_at + 2 + 12 * len(fields) + 4
    for tag in sorted(fields):
        typ, vals = fields[tag]
        raw = struct.pack(bo + codes[typ] * len(vals), *vals)
        if len(raw) <= 4:
            value = raw.ljust(4, b"\0")
        else:
            value = struct.pack(bo + "I", extra_at + len(extra))
            extra += raw + b"\0" * (len(raw) & 1)
        entries.append(struct.pack(bo + "HHI", tag, typ, len(vals)) + value)
    return head + struct.pack(bo + "I", ifd_at) + bytes(data) + struct.pack(
        bo + "H", len(fields)) + b"".join(entries) + b"\0\0\0\0" + bytes(extra)


def jpeg_sampled(img: np.ndarray, factors: list[tuple[int, int]], seed: int,
                 adobe: int | None = None) -> bytes:
    """A baseline JPEG whose components have the given sampling factors:
    each block's DC from img's mean grey over it, small random AC terms,
    coded by the port's native Huffman coder (standard tables)."""
    import ctypes

    from gatling_tpu_torch import native
    from gatling_tpu_torch.imgio import jpeg as jp

    rng = np.random.default_rng(seed)
    h, w = img.shape[:2]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = []
    for k, (ch, cv) in enumerate(factors):
        bh, bw = mcuy * cv, mcux * ch
        plane = img[..., k % img.shape[2]].astype(np.float64)
        ys = np.minimum(np.arange(bh) * 8 * vmax // cv, h - 1)
        xs = np.minimum(np.arange(bw) * 8 * hmax // ch, w - 1)
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = np.round((plane[ys][:, xs] - 128) / 2).astype(np.int16)
        c[..., 1:4] = rng.integers(-3, 4, (bh, bw, 3))
        coefs.append(c)
    info = np.array([(ch, cv, c.shape[1], min(k, 1), min(k, 1), 0)
                     for k, ((ch, cv), c) in enumerate(zip(factors, coefs))], np.int32)
    tables = np.stack([jp._spec(t) for t in (jp._DC_LUMA, jp._DC_CHROMA, jp._AC_LUMA,
                                             jp._AC_CHROMA)])
    cap = sum(c.size for c in coefs) * 4 + 1024
    body = np.empty(cap, np.uint8)
    n = native.library().gatling_jpeg_encode_scan(
        len(factors), native.ptr(info, ctypes.c_int32), native.pointers(coefs), mcux, mcuy,
        native.ptr(tables, ctypes.c_uint8), native.ptr(body, ctypes.c_uint8), cap)

    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    q = np.full(64, 2, np.uint8)
    out = [b"\xff\xd8"]
    if adobe is not None:
        out.append(seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe])))
    out.append(seg(0xDB, b"\x00" + q.tobytes()) + seg(0xDB, b"\x01" + q.tobytes()))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, len(factors)) + b"".join(
        bytes([i + 1, ch << 4 | cv, min(i, 1)]) for i, (ch, cv) in enumerate(factors))))
    for cls, k, t in ((0, 0, jp._DC_LUMA), (1, 0, jp._AC_LUMA), (0, 1, jp._DC_CHROMA),
                      (1, 1, jp._AC_CHROMA)):
        out.append(seg(0xC4, bytes([cls << 4 | k, *t[0], *t[1]])))
    out.append(seg(0xDA, bytes([len(factors)]) + b"".join(
        bytes([i + 1, 0x11 if i else 0]) for i in range(len(factors))) + b"\x00\x3f\x00"))
    return b"".join(out) + body[:n].tobytes() + b"\xff\xd9"


def new_fixtures() -> dict[str, bytes]:
    """The fixtures of the remaining formats (tests/test_torch_imgio_formats.py
    and chip_smoke.py phase 4p)."""
    from PIL import Image

    rgb = texture(48, 64, 3, 20)
    rgba = texture(40, 56, 4, 21)
    pal_im = Image.fromarray(texture(44, 60, 3, 22)).quantize(64)
    grey = texture(36, 52, 1, 23)[..., 0]
    dib = pillow(texture(32, 32, 4, 24), "DIB")
    pgm16 = io.BytesIO()
    Image.frombytes("I;16", (48, 40), texture(40, 48, 1, 25, depth=16)[..., 0]
                    .astype("<u2").tobytes()).save(pgm16, "PPM")
    pfm = io.BytesIO()
    Image.fromarray(texture(40, 48, 1, 26)[..., 0].astype(np.float32) / 255.0, "F").save(
        pfm, "PPM")
    gif = io.BytesIO()
    Image.fromarray(texture(40, 50, 3, 27)).quantize(32).save(gif, "GIF", interlace=True,
                                                               transparency=5)
    tif_pal = io.BytesIO()
    pal_im.save(tif_pal, "TIFF", compression="tiff_lzw")
    tif_jpeg = io.BytesIO()
    Image.fromarray(texture(48, 64, 3, 28)).save(tif_jpeg, "TIFF", compression="jpeg")
    tif_cmyk = io.BytesIO()
    Image.fromarray(texture(30, 40, 4, 29), "CMYK").save(tif_cmyk, "TIFF",
                                                         compression="packbits")
    tif_i32 = io.BytesIO()
    Image.fromarray((texture(30, 40, 1, 30, depth=16)[..., 0].astype(np.int32) - 30000),
                    "I").save(tif_i32, "TIFF", compression="tiff_adobe_deflate")
    tif_big = io.BytesIO()
    Image.fromarray(texture(30, 40, 3, 31)).save(tif_big, "TIFF", big_tiff=True,
                                                 compression="tiff_lzw")
    jpeg_cmyk = pillow_im(Image.fromarray(texture(40, 56, 4, 32), "CMYK"), "JPEG")
    ycck = bytearray(jpeg_cmyk)
    ycck[jpeg_cmyk.find(b"Adobe") + 11] = 2  # the same scans read as YCCK
    grey4 = (texture(24, 30, 1, 33)[..., 0] >> 4).astype(np.uint8)
    g4 = np.zeros((24, 16), np.uint8)
    g4[:, :15] = (grey4[:, 0::2] << 4) | grey4[:, 1::2]
    planar = texture(20, 28, 3, 34)
    bits1 = texture(26, 40, 1, 35)[..., 0] > 127
    fill2 = np.packbits(bits1, axis=1)
    rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
    oldlzw = texture(30, 36, 3, 36)
    bc4 = dds_blocks(24, 20, 80, 37, 8)
    bc6 = dds_blocks(20, 16, 95, 38)
    bc6s = dds_blocks(20, 16, 96, 39)
    return {
        # (b): the interior's 8-bit slots
        "bmp_rgb24.bmp": pillow(rgb, "BMP"),
        "gif_palette.gif": pillow_im(pal_im, "GIF"),
        "dds_bc1.dds": pillow(texture(48, 64, 4, 40), "DDS", pixel_format="DXT1"),
        "dds_bc3.dds": pillow(texture(48, 64, 4, 41), "DDS", pixel_format="DXT5"),
        "dds_bc7.dds": bc7_dds(texture(48, 64, 4, 42)),
        "psd_rgb.psd": psd_file(texture(40, 56, 3, 43).transpose(2, 0, 1).copy(), 3),
        "qoi_rgba.qoi": pillow(rgba, "QOI"),
        "ppm_rgb.ppm": pillow(texture(44, 52, 3, 44), "PPM"),
        "tga_rgb16.tga": tga16(texture(36, 48, 3, 45)),
        "tiff_palette.tif": tif_pal.getvalue(),
        "tiff_jpeg.tif": tif_jpeg.getvalue(),
        "jpeg_cmyk.jpg": jpeg_cmyk,
        # (c): float and bool images
        "pgm_grey16.pgm": pgm16.getvalue(),
        "pfm_grey.pfm": pfm.getvalue(),
        "bmp_grey1.bmp": pillow(texture(40, 48, 1, 46) > 127, "BMP", mode="1"),
        # (a) alone
        "bmp_rle8.bmp": bmp_rle8(np.asarray(pal_im)[:, :40] // 4,
                                 np.asarray(pal_im.getpalette()[:64 * 3], np.uint8)
                                 .reshape(-1, 3)),
        "dib_rgba.dib": dib,
        "ico_png.ico": pillow(texture(32, 32, 4, 47), "ICO", sizes=[(32, 32), (16, 16)]),
        "ico_bmp.ico": pillow(texture(32, 32, 4, 48), "ICO", sizes=[(32, 32)],
                              bitmap_format="bmp"),
        "cur_rgb.cur": cur_file(double_height(pillow(texture(16, 16, 3, 49), "DIB")), 16, 16),
        "gif_interlaced.gif": gif.getvalue(),
        "pgm_grey.pgm": pillow(grey, "PPM"),
        "pbm_bits.pbm": pillow(texture(30, 37, 1, 50) > 127, "PPM", mode="1"),
        "dds_bc4.dds": bc4,
        "dds_bc5.dds": pillow(texture(32, 40, 3, 51), "DDS", pixel_format="BC5"),
        "dds_bc6h.dds": bc6,
        "dds_bc6h_signed.dds": bc6s,
        "dds_rgba.dds": pillow(texture(24, 28, 4, 52), "DDS"),
        "psd_cmyk.psd": psd_file(texture(24, 32, 4, 53).transpose(2, 0, 1).copy(), 4, 0),
        "tiff_cmyk.tif": tif_cmyk.getvalue(),
        "tiff_int32.tif": tif_i32.getvalue(),
        "tiff_bigtiff.tif": tif_big.getvalue(),
        "tiff_grey4.tif": tiff_file([g4.tobytes()], 30, 24, 24, {258: (3, [4]), 262: (3, [1]),
                                                                259: (3, [1])}),
        "tiff_planar.tif": tiff_file([planar[..., c].tobytes() for c in range(3)], 28, 20, 20,
                                     {258: (3, [8, 8, 8]), 262: (3, [2]), 259: (3, [1]),
                                      277: (3, [3]), 284: (3, [2])}),
        "tiff_fill2.tif": tiff_file([rev[fill2].tobytes()], 40, 26, 26,
                                    {262: (3, [1]), 259: (3, [1]), 266: (3, [2])}),
        "tiff_oldlzw.tif": tiff_file([lzw_old(oldlzw.tobytes())], 36, 30, 30,
                                     {258: (3, [8, 8, 8]), 262: (3, [2]), 259: (3, [5]),
                                      277: (3, [3])}),
        "jpeg_ycck.jpg": bytes(ycck),
        "jpeg_411.jpg": jpeg_sampled(texture(32, 64, 3, 54), [(4, 1), (1, 1), (1, 1)], 55),
        "jpeg_31.jpg": jpeg_sampled(texture(40, 48, 3, 56), [(3, 1), (1, 1), (1, 1)], 57),
    }


def double_height(dib: bytes) -> bytes:
    """A DIB whose header says twice its height (an icon's XOR bitmap
    above its AND mask; CUR reads the first half)."""
    (h,) = struct.unpack_from("<i", dib, 8)
    return dib[:8] + struct.pack("<i", 2 * h) + dib[12:] + b"\0" * (len(dib) - 54)


def pillow_im(im, fmt: str, **kwargs) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kwargs)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# JPEG's arithmetic and lossless processes, and progressive files cut short
# (tests/test_torch_jpeg_arith.py, chip_smoke.py phase 4r). Pillow's saver
# writes none of these: the arithmetic files are Pillow's Huffman files
# transcoded (their coefficients read back by the port's decoder, which
# tests/test_torch_jpeg_arith.py holds to Pillow's decode of both).
# ---------------------------------------------------------------------------

# jaricom.c jpeg_aritab (T.81 Table D.2): (Qe, Next_Index_LPS, Next_Index_MPS,
# Switch_MPS), the last entry the fixed probability 0.5
ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class ArithEncoder:
    """jcarith.c's coder (T.81 Annex D) over statistics bins: a bin is a
    one-element list [state index | MPS << 7]."""

    def __init__(self) -> None:
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _flush_stack(self, byte: int, carry: bool) -> None:
        """jcarith.c: the buffered byte (plus a carry), the stacked 0x00
        and 0xFF bytes."""
        if carry:
            if self.buffer >= 0:
                for _ in range(self.zc):
                    self._emit(0)
                self.zc = 0
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = byte
            return
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            for _ in range(self.zc):
                self._emit(0)
            self.zc = 0
            self._emit(self.buffer)
        if self.sc:
            for _ in range(self.zc):
                self._emit(0)
            self.zc = 0
            for _ in range(self.sc):
                self._emit(0xFF)
                self._emit(0)
            self.sc = 0
        self.buffer = byte

    def encode(self, st: list, val: int) -> None:
        sv = st[0]
        qe, nl, nm, switch = ARITAB[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._flush_stack(temp & 0xFF, carry=True)
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack(temp & 0xFF, carry=False)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        """jcarith.c finish_pass (T.81 D.1.8)."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                for _ in range(self.zc):
                    self._emit(0)
                self.zc = 0
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stack(-1, carry=False)
        if self.c & 0x7FFF800:
            for _ in range(self.zc):
                self._emit(0)
            self.zc = 0
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)


def _arith_value(e: ArithEncoder, st_bins: list, base: int, v: int, far: int | None) -> None:
    """Figures F.8 and F.9: the magnitude category and bits of v - 1 >= 0
    from bin base (far: the AC table's X2 bin when v - 1 >= 2, None for DC,
    whose X1 is bin 20)."""
    m = 0
    st = base
    v -= 1
    if v:
        e.encode(st_bins[st], 1)
        m = 1
        v2 = v
        if far is None:
            st = 20
            while (v2 := v2 >> 1):
                e.encode(st_bins[st], 1)
                m <<= 1
                st += 1
        elif (v2 := v2 >> 1):
            e.encode(st_bins[st], 1)
            m <<= 1
            st = far
            while (v2 := v2 >> 1):
                e.encode(st_bins[st], 1)
                m <<= 1
                st += 1
    e.encode(st_bins[st], 0)
    st += 14
    while (m := m >> 1):
        e.encode(st_bins[st], 1 if m & v else 0)
    return m


def jpeg_arith(huffman: bytes, dac: dict | None = None) -> bytes:
    """A Huffman-coded JPEG (Pillow's) re-coded by jcarith.c's rules: SOF9
    for a sequential frame, SOF10 for a progressive one, the same scans,
    restart interval and coefficients. dac: {table: (L, U, K)} written as
    a DAC segment (libjpeg's defaults are 0, 1 and 5)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from gatling_tpu_torch.imgio import jpeg

    f = jpeg.read(huffman)
    width, height, hmax, vmax, mcux, mcuy = f.frame
    natural = [int(x) for x in jpeg.NATURAL]
    conditioning = {t: (0, 1, 5) for t in range(16)}
    conditioning.update(dac or {})

    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8"]
    if f.jfif:
        out.append(seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if f.adobe is not None:
        out.append(seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, f.adobe)))
    for tq in sorted({c.tq for c in f.comps}):
        table = next(c.quant for c in f.comps if c.tq == tq)
        out.append(seg(0xDB, bytes([tq]) + bytes(int(table[k]) for k in natural)))
    if dac:
        out.append(seg(0xCC, b"".join(bytes([t, (u << 4) | lo, 16 + t, k])
                                      for t, (lo, u, k) in sorted(dac.items()))))
    if f.restart:
        out.append(seg(0xDD, struct.pack(">H", f.restart)))
    out.append(seg(0xCA if f.progressive else 0xC9, struct.pack(">BHHB", 8, height, width,
                                                                len(f.comps))
                   + b"".join(bytes([c.cid, c.h << 4 | c.v, c.tq]) for c in f.comps)))
    for ss, se, ah, al, idx in f.scans:
        comps = [f.comps[i] for i in idx]
        tbl = [min(i, 1) for i in idx]
        out.append(seg(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c.cid, t << 4 | t]) for c, t in zip(comps, tbl)) + bytes([ss, se, ah << 4 | al])))
        e = ArithEncoder()
        dc_stats = {t: [[0] for _ in range(64)] for t in set(tbl)}
        ac_stats = {t: [[0] for _ in range(256)] for t in set(tbl)}
        fixed = [113]
        last_dc = [0] * len(comps)
        context = [0] * len(comps)
        if len(comps) > 1:
            mcus = [(r, col) for r in range(mcuy) for col in range(mcux)]
            blocks = lambda r, col: [(k, r * c.v + y, col * c.h + x) for k, c in enumerate(comps)
                                     for y in range(c.v) for x in range(c.h)]
        else:
            c0 = comps[0]
            mcus = [(r, col) for r in range(c0.blocks_h) for col in range(c0.blocks_w)]
            blocks = lambda r, col: [(0, r, col)]
        to_go, rst = f.restart, 0
        for r, col in mcus:
            if f.restart:
                if to_go == 0:  # jcarith.c emit_restart
                    e.finish()
                    e.out += bytes([0xFF, 0xD0 + rst])
                    rst = (rst + 1) & 7
                    for k in range(len(comps)):
                        if not f.progressive or (ss == 0 and ah == 0):
                            dc_stats[tbl[k]] = [[0] for _ in range(64)]
                            last_dc[k] = context[k] = 0
                        if not f.progressive or se:
                            ac_stats[tbl[k]] = [[0] for _ in range(256)]
                    e.reset()
                    to_go = f.restart
                to_go -= 1
            for k, y, x in blocks(r, col):
                blk = [int(v) for v in comps[k].coefs[y, x]]
                t = tbl[k]
                lo, u, kk = conditioning[t]
                if not f.progressive or (ss == 0 and ah == 0):  # DC (Figure F.4)
                    m = blk[0] >> al
                    st0 = context[k]
                    bins = dc_stats[t]
                    v = m - last_dc[k]
                    if v == 0:
                        e.encode(bins[st0], 0)
                        context[k] = 0
                    else:
                        last_dc[k] = m
                        e.encode(bins[st0], 1)
                        if v > 0:
                            e.encode(bins[st0 + 1], 0)
                            base, context[k] = st0 + 2, 4
                        else:
                            v = -v
                            e.encode(bins[st0 + 1], 1)
                            base, context[k] = st0 + 3, 8
                        cat = 0
                        if v - 1:
                            cat = 1
                            while (v - 1) >> cat:
                                cat += 1
                            cat = 1 << (cat - 1)
                        _arith_value(e, bins, base, v, None)
                        if cat < (1 << lo) >> 1:
                            context[k] = 0
                        elif cat > (1 << u) >> 1:
                            context[k] += 8
                    if f.progressive:
                        continue
                if f.progressive and ss == 0:  # DC refinement: bit Al
                    e.encode(fixed, (blk[0] >> al) & 1)
                    continue
                lo_k = 1 if not f.progressive else ss
                hi_k = 63 if not f.progressive else se
                bins = ac_stats[t]
                mag = [abs(blk[natural[q]]) >> al for q in range(64)]
                ke = hi_k
                while ke > 0 and not mag[ke]:
                    ke -= 1
                if f.progressive and ah:  # Figure G.10
                    kex = ke
                    while kex > 0 and not abs(blk[natural[kex]]) >> ah:
                        kex -= 1
                    q = lo_k
                    while q <= ke:
                        st = 3 * (q - 1)
                        if q > kex:
                            e.encode(bins[st], 0)
                        while True:
                            v = mag[q]
                            if v:
                                if v >> 1:
                                    e.encode(bins[st + 2], v & 1)
                                else:
                                    e.encode(bins[st + 1], 1)
                                    e.encode(fixed, 1 if blk[natural[q]] < 0 else 0)
                                break
                            e.encode(bins[st + 1], 0)
                            st += 3
                            q += 1
                        q += 1
                    if q <= hi_k:
                        e.encode(bins[3 * (q - 1)], 1)
                    continue
                q = lo_k  # Figure F.5
                while q <= ke:
                    st = 3 * (q - 1)
                    e.encode(bins[st], 0)
                    while True:
                        v = mag[q]
                        if v:
                            e.encode(bins[st + 1], 1)
                            e.encode(fixed, 1 if blk[natural[q]] < 0 else 0)
                            break
                        e.encode(bins[st + 1], 0)
                        st += 3
                        q += 1
                    _arith_value(e, bins, st + 2, v, 189 if q <= kk else 217)
                    q += 1
                if q <= hi_k:
                    e.encode(bins[3 * (q - 1)], 1)
        e.finish()
        out.append(bytes(e.out))
    out.append(b"\xff\xd9")
    return b"".join(out)


# jstdhuff.c's DC luminance table: categories 0-11
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))


def jpeg_lossless(img: np.ndarray, psv: int, pt: int = 0, restart_rows: int = 0,
                  arith: bool = False) -> bytes:
    """A lossless JPEG (SOF3; SOF11's header over the same data when
    `arith`) of [H, W] grey or [H, W, 3] RGB (an Adobe segment with
    transform 0: no colour conversion), one interleaved scan with
    predictor psv and point transform pt, the standard DC luminance
    table, a restart every `restart_rows` rows."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    x = img.astype(np.int64) >> pt
    counts, symbols = _DC_LUMA
    code, codes, k = 0, {}, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    bits = []

    def put(v: int, n: int) -> None:
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def flush() -> bytes:
        while len(bits) % 8:
            bits.append(1)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = int("".join(map(str, bits[i:i + 8])), 2)
            out.append(b)
            if b == 0xFF:
                out.append(0)
        bits.clear()
        return bytes(out)

    body, rst, first = bytearray(), 0, 0
    for y in range(h):
        if restart_rows and y and y % restart_rows == 0:
            body += flush() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            first = y
        for xx in range(w):
            for c in range(nc):
                if y == first:
                    pred = (1 << (8 - pt - 1)) if xx == 0 else x[y, xx - 1, c]
                elif xx == 0:
                    pred = x[y - 1, 0, c]
                else:
                    ra, rb, rc = x[y, xx - 1, c], x[y - 1, xx, c], x[y - 1, xx - 1, c]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
                diff = int(x[y, xx, c] - pred) & 0xFFFF
                if diff >= 0x8000:
                    diff -= 0x10000
                size = abs(diff).bit_length()
                put(*codes[size])
                if size:
                    put(diff if diff > 0 else diff - 1 + (1 << size), size)
    body += flush()

    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8"]
    if nc == 3:
        out.append(seg(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)))
    if restart_rows:
        out.append(seg(0xDD, struct.pack(">H", restart_rows * w)))
    out.append(seg(0xCB if arith else 0xC3, struct.pack(">BHHB", 8, h, w, nc)
                   + b"".join(bytes([c + 1, 0x11, 0]) for c in range(nc))))
    out.append(seg(0xC4, bytes([0]) + bytes(counts) + bytes(symbols)))
    out.append(seg(0xDA, bytes([nc]) + b"".join(bytes([c + 1, 0]) for c in range(nc))
                   + bytes([psv, 0, pt])))
    out += [bytes(body), b"\xff\xd9"]
    return b"".join(out)


def jpeg_scans(data: bytes, keep) -> bytes:
    """A JPEG with only the scans for which keep(Ss, Se, Ah, Al) holds (the
    markers between scans kept)."""
    out, pos = [data[:2]], 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("jpeg_scans: a marker was expected")
        m = data[pos + 1]
        if m == 0xD9:
            out.append(data[pos:])
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + length
        if m != 0xDA:
            out.append(data[pos:end])
            pos = end
            continue
        n = data[pos + 4]
        ss, se, ahl = data[pos + 5 + 2 * n:pos + 8 + 2 * n]
        scan_end = end
        while not (data[scan_end] == 0xFF and data[scan_end + 1] not in (0,) + tuple(
                range(0xD0, 0xD8))):
            scan_end += 1
        if keep(ss, se, ahl >> 4, ahl & 15):
            out.append(data[pos:scan_end])
        pos = scan_end
    return b"".join(out)


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_file(codestream: bytes, h: int, w: int, nc: int, colr: int = 16, extra: bytes = b"",
             bpc: int = 7) -> bytes:
    """A JP2 file around a raw codestream: the signature, ftyp, and a jp2h
    with ihdr, colr (enumerated colour space `colr`) and `extra` boxes."""
    header = (jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
              + jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr)) + extra)
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", header) + jp2_box(b"jp2c", codestream))


def jpeg2000_fixtures() -> dict[str, bytes]:
    """The JPEG 2000 fixtures, and the JPEG ones of the arithmetic, lossless
    and smoothed processes (tests/test_torch_imgio.py, chip_smoke.py phase
    4r)."""
    from PIL import Image

    def j2k(arr: np.ndarray, **kw) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG2000", no_jp2=True, **kw)
        return buf.getvalue()

    rgba = texture(40, 52, 4, 71)
    indices = (texture(36, 44, 1, 72)[..., 0] // 32).astype(np.uint8)
    palette = [(230, 60, 40), (40, 200, 90), (30, 80, 220), (240, 220, 60), (120, 40, 160),
               (20, 20, 20), (250, 250, 250), (140, 100, 60)]
    grey16 = texture(64, 64, 1, 73, depth=16)[..., 0]
    buf = io.BytesIO()
    Image.frombytes("I;16", (64, 64), grey16.astype("<u2").tobytes()).save(
        buf, "JPEG2000", no_jp2=True)
    progressive = pillow(texture(64, 80, 3, 76), "JPEG", progressive=True)
    return {
        "j2k_lossless.jp2": pillow(texture(40, 48, 3, 70), "JPEG2000"),
        "j2k_97_mct.jp2": pillow(texture(44, 56, 3, 74), "JPEG2000", irreversible=True, mct=1,
                                 quality_mode="rates", quality_layers=[12]),
        "j2k_rgba_cdef.jp2": jp2_file(j2k(rgba), 40, 52, 4, extra=jp2_box(b"cdef", struct.pack(
            ">H", 4) + b"".join(struct.pack(">HHH", k, 1 if k == 3 else 0, 0 if k == 3 else k + 1)
                               for k in range(4)))),
        "j2k_tiled_rpcl.j2k": j2k(texture(64, 72, 3, 75), tile_size=(32, 32),
                                  progression="RPCL", precinct_size=(16, 16), num_resolutions=3,
                                  irreversible=True, quality_mode="dB", quality_layers=[38]),
        "j2k_pclr.jp2": jp2_file(j2k(indices), 36, 44, 1, extra=jp2_box(
            b"pclr", struct.pack(">HB", len(palette), 3) + bytes([7, 7, 7])
            + b"".join(bytes(c) for c in palette)) + jp2_box(b"cmap", b"".join(
                struct.pack(">HBB", 0, 1, k) for k in range(3)))),
        "j2k_grey16.j2k": buf.getvalue(),
        "j2k_ground_1024.jp2": pillow(smooth_texture(1024, 3, 77), "JPEG2000", irreversible=True,
                                      quality_mode="rates", quality_layers=[48]),
        "jpeg_arith.jpg": jpeg_arith(pillow(texture(56, 72, 3, 78), "JPEG")),
        "jpeg_arith_progressive.jpg": jpeg_arith(progressive, dac={0: (1, 4, 3), 1: (0, 2, 7)}),
        "jpeg_lossless.jpg": jpeg_lossless(texture(40, 56, 3, 79), psv=6, pt=0, restart_rows=8),
        "jpeg_smoothed.jpg": jpeg_scans(progressive, lambda ss, se, ah, al: not (ss and ah)),
    }


# ---------------------------------------------------------------------------
# TIFF variants Pillow cannot write (chip_smoke.py phase 4s,
# tests/test_torch_tiff_codecs.py)
# ---------------------------------------------------------------------------

_TIFF_CODES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
               11: "f", 12: "d"}


def tiff_raw(blobs: list[bytes], w: int, h: int, fields: dict, bo: str = "<",
             rows_per_strip: int | None = None, tile: tuple[int, int] | None = None) -> bytes:
    """A classic TIFF of `blobs` (each at an even offset from 8) and fields
    {tag: (type, values)} of any type (rationals as (num, den) pairs, bytes
    for types 2 and 7). The blobs are the strips (or tiles of `tile`) unless
    `fields` gives StripOffsets and StripByteCounts itself (tables put
    beside the strips)."""
    data, offsets = bytearray(), []
    for b in blobs:
        offsets.append(8 + len(data))
        data += b + b"\0" * (len(b) & 1)
    f = {256: (4, [w]), 257: (4, [h])}
    if tile:
        f.update({322: (4, [tile[0]]), 323: (4, [tile[1]]), 324: (4, offsets),
                  325: (4, [len(b) for b in blobs])})
    else:
        f.update({278: (4, [rows_per_strip or h]), 273: (4, offsets),
                  279: (4, [len(b) for b in blobs])})
    f.update(fields)
    ifd_at = 8 + len(data)
    extra_at = ifd_at + 2 + 12 * len(f) + 4
    entries, extra = [], bytearray()
    for tag in sorted(f):
        typ, vals = f[tag]
        if isinstance(vals, (bytes, bytearray)):
            raw, n = bytes(vals), len(vals)
        elif typ in (5, 10):
            raw = struct.pack(bo + _TIFF_CODES[typ][0] * 2 * len(vals),
                              *[x for v in vals for x in v])
            n = len(vals)
        else:
            raw, n = struct.pack(bo + _TIFF_CODES[typ] * len(vals), *vals), len(vals)
        if len(raw) <= 4:
            value = raw.ljust(4, b"\0")
        else:
            value = struct.pack(bo + "I", extra_at + len(extra))
            extra += raw + b"\0" * (len(raw) & 1)
        entries.append(struct.pack(bo + "HHI", tag, typ, n) + value)
    head = b"II*\0" if bo == "<" else b"MM\0*"
    return (head + struct.pack(bo + "I", ifd_at) + bytes(data) + struct.pack(bo + "H", len(f))
            + b"".join(entries) + b"\0\0\0\0" + bytes(extra))


def thunder_encode(rows: np.ndarray, seed: int) -> bytes:
    """ThunderScan codes for rows of 4-bit pixels, picked from a seed: runs
    of the last pixel (never to a row's end, where libtiff writes nothing),
    three 2-bit deltas, two 3-bit deltas, raw pixels."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in rows.astype(int):
        last, i, n = 0, 0, len(row)
        while i < n:
            v, pick = row[i], rng.integers(4)
            run = 0
            while i + run < n - 1 and row[i + run] == last and run < 63:
                run += 1
            if run > 1 and pick != 3:
                out.append(run)
                i += run
            elif pick == 1 and i + 2 < n and {v - last, row[i + 1] - v,
                                              row[i + 2] - row[i + 1]} <= set(two):
                d = (two[v - last], two[row[i + 1] - v], two[row[i + 2] - row[i + 1]])
                out.append(0x40 | d[0] << 4 | d[1] << 2 | d[2])
                last, i = row[i + 2], i + 3
            elif pick == 2 and -3 <= v - last <= 3:
                out.append(0x80 | three[v - last] << 3 | 4)  # the second delta skipped
                last, i = v, i + 1
            else:
                out.append(0xC0 | v)
                last, i = v, i + 1
    return bytes(out)


def ycbcr_units(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Y [h, w] and Cb, Cr at one sample a data unit -> rows of TIFF YCbCr
    data units (hs x vs luma samples, Cb, Cr), uint8 [units down, bytes]."""
    h, w = y.shape
    uy, ux = -(-h // vs), -(-w // hs)
    yp = np.pad(y, ((0, uy * vs - h), (0, ux * hs - w)), mode="edge")
    lum = yp.reshape(uy, vs, ux, hs).transpose(0, 2, 1, 3).reshape(uy, ux, vs * hs)
    return np.concatenate([lum, cb[:uy, :ux, None], cr[:uy, :ux, None]],
                          axis=-1).astype(np.uint8).reshape(uy, -1)


def jpeg_segments(jpg: bytes) -> tuple[list, bytes]:
    """A baseline JPEG's marker segments up to SOS [(marker, payload)], and
    the bytes after the SOS segment."""
    out, p = [], 2
    while True:
        m = jpg[p + 1]
        (n,) = struct.unpack(">H", jpg[p + 2:p + 4])
        out.append((m, jpg[p + 4:p + 2 + n]))
        p += 2 + n
        if m == 0xDA:
            return out, jpg[p:]


def ojpeg_jif(jpg: bytes, w: int, h: int, photometric: int = 6, spp: int = 3,
              strip_at_scan: bool = True) -> bytes:
    """An old-style JPEG TIFF (compression 6) of a whole JPEG stream at
    JPEGInterchangeFormat, its one strip the stream's entropy-coded data (or
    the whole stream)."""
    scan = len(jpg) - len(jpeg_segments(jpg)[1]) if strip_at_scan else 0
    return tiff_raw([jpg], w, h, {258: (3, [8] * spp), 259: (3, [6]), 262: (3, [photometric]),
                                  277: (3, [spp]), 512: (3, [1]), 513: (4, [8]),
                                  514: (4, [len(jpg)]), 273: (4, [8 + scan]),
                                  279: (4, [len(jpg) - scan])})


def ojpeg_tables(jpg: bytes, w: int, h: int, rows_per_strip: int, spp: int = 3,
                 photometric: int = 6, sampling: tuple[int, int] | None = (2, 2),
                 tiles: bool = False) -> bytes:
    """An old-style JPEG TIFF in the other form writers use: JPEGQTables,
    JPEGDCTables and JPEGACTables offsets to the tables of a baseline JPEG
    (component m's at the m-th), and each restart interval of its
    entropy-coded data a strip (the JPEG written with a restart marker every
    strip's MCUs, the markers dropped); with `tiles`, tiles of w x
    rows_per_strip in one column."""
    segs, scan = jpeg_segments(jpg)
    q, dc, ac = {}, {}, {}
    for m, pl in segs:
        i = 0
        while m == 0xDB and i < len(pl):
            q[pl[i] & 15] = pl[i + 1:i + 65]
            i += 65
        while m == 0xC4 and i < len(pl):
            n = sum(pl[i + 1:i + 17])
            (ac if pl[i] >> 4 else dc)[pl[i] & 15] = pl[i + 1:i + 17 + n]
            i += 17 + n
    scan = scan[:scan.rindex(b"\xff\xd9")]
    parts, start, i = [], 0, 0
    while i < len(scan) - 1:
        if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7:
            parts.append(scan[start:i])
            start = i = i + 2
        else:
            i += 1
    parts.append(scan[start:])
    ids = [0, 1, 1][:spp]
    blobs = parts + [q[t] for t in ids] + [dc[t] for t in ids] + [ac[t] for t in ids]
    offs, pos = [], 8
    for b in blobs:
        offs.append(pos)
        pos += len(b) + (len(b) & 1)
    n = len(parts)
    fields = {258: (3, [8] * spp), 259: (3, [6]), 262: (3, [photometric]), 277: (3, [spp]),
              512: (3, [1]), 519: (4, offs[n:n + spp]), 520: (4, offs[n + spp:n + 2 * spp]),
              521: (4, offs[n + 2 * spp:])}
    if sampling:
        fields[530] = (3, list(sampling))
    if tiles:
        fields.update({324: (4, offs[:n]), 325: (4, [len(p) for p in parts])})
        return tiff_raw(blobs, w, h, fields, tile=(w, rows_per_strip))
    fields.update({273: (4, offs[:n]), 279: (4, [len(p) for p in parts]),
                   278: (4, [rows_per_strip])})
    return tiff_raw(blobs, w, h, fields)


def lzw_new(data: bytes) -> bytes:
    """New-style TIFF LZW (MSB-first codes), every code 9 bits: a ClearCode
    before the table would need a tenth bit (libtiff's early change)."""
    out = bytearray()
    acc = nacc = 0

    def put(code: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << 9) | code, nacc + 9
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8

    table = {bytes([i]): i for i in range(256)}
    put(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = len(table) + 2
        if len(table) + 2 == 511:
            put(256)
            table = {bytes([i]): i for i in range(256)}
        w = bytes([b])
    if w:
        put(table[w])
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def bilevel(h: int, w: int, seed: int) -> np.ndarray:
    """A stencil: bands and blobs with a little noise, bool [h, w]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    v = np.sin(40 * xx + 9 * np.sin(6 * yy)) + np.cos(31 * yy * (1 + xx))
    return (v > 0.2) ^ (rng.random((h, w)) < 0.01)


def tiff_fixtures() -> dict[str, bytes]:
    """The TIFF variants of chip_smoke.py phase 4s: Pillow's ZSTD (predictor
    2 and 3), LZMA, Group 4, Group 3 2D with fill bits, Modified Huffman and
    LZW with Orientation 6; and the writers here: ThunderScan, YCbCr 4:2:0
    in LZW strips, 16-bit RGB in planes, an old-style JPEG of tables in tags
    and strips of restart intervals, 16-bit grey LZMA. The 1024^2 ZSTD
    ground and Group 4 stencil are kept as their digest."""
    from PIL import Image

    def save(img, **kw) -> bytes:
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        return buf.getvalue()

    oriented = Image.fromarray(texture(40, 56, 3, 91))
    exif = oriented.getexif()
    exif[274] = 6
    grey4 = (texture(36, 44, 1, 92)[..., 0] >> 4).astype(np.uint8)
    ycc = texture(36, 42, 3, 93)
    units = ycbcr_units(ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2], 2, 2)
    rgb16 = texture(30, 34, 3, 94, depth=16).astype("<u2")
    grey16 = texture(48, 48, 1, 97, depth=16)[..., 0]
    floats = texture(48, 48, 1, 96)[..., 0].astype(np.float32) / 255.0
    ojpeg = pillow(texture(48, 64, 3, 95), "JPEG", restart_marker_rows=1)
    return {
        "tiff_zstd_pred2.tif": save(Image.fromarray(texture(44, 52, 3, 86)), compression="zstd",
                                    tiffinfo={317: 2}),
        "tiff_lzma_rgba.tif": save(Image.fromarray(texture(40, 48, 4, 87)), compression="lzma"),
        "tiff_g4.tif": save(Image.fromarray(bilevel(60, 80, 88)), compression="group4"),
        "tiff_g3_2d_fill.tif": save(Image.fromarray(bilevel(50, 70, 89)), compression="group3",
                                    tiffinfo={292: 5}),
        "tiff_mh.tif": save(Image.fromarray(bilevel(40, 66, 90)), compression="tiff_ccitt"),
        "tiff_orient6_lzw.tif": save(oriented, compression="tiff_lzw", exif=exif),
        "tiff_thunder.tif": tiff_raw([thunder_encode(grey4[r:r + 12], r) for r in range(0, 36, 12)],
                                     44, 36, {258: (3, [4]), 259: (3, [32809]), 262: (3, [1])},
                                     rows_per_strip=12),
        "tiff_ycbcr420_lzw.tif": tiff_raw([lzw_new(units[r:r + 4].tobytes())
                                           for r in range(0, len(units), 4)], 42, 36,
                                          {258: (3, [8] * 3), 259: (3, [5]), 262: (3, [6]),
                                           277: (3, [3]), 530: (3, [2, 2])}, rows_per_strip=8),
        "tiff_planar16.tif": tiff_raw([zlib.compress(rgb16[..., c].tobytes()) for c in range(3)],
                                      34, 30, {258: (3, [16] * 3), 259: (3, [8]), 262: (3, [2]),
                                               277: (3, [3]), 284: (3, [2])}),
        "tiff_ojpeg.tif": ojpeg_tables(ojpeg, 64, 48, 16),
        "tiff_float_zstd_pred3.tif": save(Image.fromarray(floats, "F"), compression="zstd",
                                          tiffinfo={317: 3}),
        "tiff_grey16_lzma.tif": save(Image.frombytes("I;16", (48, 48), grey16.astype("<u2")
                                                     .tobytes()), compression="lzma"),
        "tiff_zstd_ground_1024.tif": save(Image.fromarray(smooth_texture(1024, 3, 98)),
                                          compression="zstd", tiffinfo={317: 2}),
        "tiff_g4_stencil_1024.tif": save(Image.fromarray(bilevel(1024, 1024, 99)),
                                         compression="group4"),
    }


# ---------------------------------------------------------------------------
# Pillow's legacy plugins (tests/test_torch_imgio_legacy.py, chip_smoke.py
# phase 4t): writers of what Pillow does not write
# ---------------------------------------------------------------------------

def sgi_file(img: np.ndarray, bpc: int = 1, rle: bool = True, dimension: int | None = None,
             rows=None) -> bytes:
    """An SGI image of img [h, w, c] (c 1, 3 or 4; uint8, or uint16 for bpc
    2), raw or RLE (each channel's rows: runs and copies of at most 127
    atoms, a 0 terminator); rows(r, c, encoded) may change a row's bytes."""
    h, w, c = img.shape
    dim = dimension or (3 if c > 1 else 2)
    head = struct.pack(">HBBHHHH", 474, 1 if rle else 0, bpc, dim, w, h, c).ljust(512, b"\0")
    planes = img[::-1].transpose(2, 0, 1)  # bottom row first
    if not rle:
        dt = ">u2" if bpc == 2 else "u1"
        return head + planes.astype(dt).tobytes()
    offsets, lengths, body = [], [], bytearray()
    start = 512 + 8 * h * c
    for ch in range(c):
        for r in range(h):
            samples = planes[ch, r]
            enc = bytearray()
            vals = samples.astype(np.int64).tolist()
            i = 0
            while i < w:
                j = i
                while j < w and vals[j] == vals[i] and j - i < 127:
                    j += 1
                if j - i >= 3:
                    enc += (bytes([j - i]) + bytes([vals[i]]) if bpc == 1 else
                            struct.pack(">HH", j - i, vals[i]))
                    i = j
                    continue
                k = i + 1
                while k < w and k - i < 127 and not (k + 2 < w and vals[k] == vals[k + 1]
                                                      == vals[k + 2]):
                    k += 1
                enc += (bytes([0x80 | (k - i)]) + bytes(vals[i:k]) if bpc == 1 else
                        struct.pack(">H", 0x80 | (k - i)) + struct.pack(f">{k - i}H",
                                                                         *vals[i:k]))
                i = k
            enc += b"\0" * bpc
            if rows is not None:
                enc = bytearray(rows(r, ch, bytes(enc)))
            offsets.append(start + len(body))
            lengths.append(len(enc))
            body += enc
    # the lengths are bytes; Pillow's decoder takes them as a count of
    # chunks, never fewer than the row's, and stops at the terminator
    table = struct.pack(f">{h * c}I", *offsets) + struct.pack(f">{h * c}I", *lengths)
    return head + table + bytes(body)


def pcx_file(planes: np.ndarray, bits: int, palette: bytes = b"\0" * 48, version: int = 5,
             stride: int | None = None, vga: bytes | None = None) -> bytes:
    """A PCX of `planes` [p, h, w] sample planes (bits 1 or 8): rows of each
    plane packed MSB first at `stride` bytes, run-length coded; a VGA
    palette (768 bytes) after the data if given."""
    p, h, w = planes.shape
    line = (w * bits + 7) // 8
    stride = stride or line + (line % 2)
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72)
    head += palette[:48].ljust(48, b"\0") + bytes([0, p]) + struct.pack("<HH", stride, 1)
    head = head.ljust(128, b"\0")
    data = bytearray()
    for r in range(h):
        row = bytearray()
        for k in range(p):
            v = planes[k, r]
            packed = np.packbits(v.astype(bool)) if bits == 1 else v.astype(np.uint8)
            row += packed.tobytes().ljust(stride, b"\0")
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 63:
                j += 1
            if j - i > 1 or row[i] >= 0xC0:
                data += bytes([0xC0 | (j - i), row[i]])
                i = j
            else:
                data.append(row[i])
                i += 1
    return bytes(head) + bytes(data) + (b"\x0c" + vga if vga is not None else b"")


def dcx_file(frames: list[bytes]) -> bytes:
    """A DCX directory of PCX frames."""
    at = 4 + 4 * (len(frames) + 1)
    offsets = []
    for f in frames:
        offsets.append(at)
        at += len(f)
    return struct.pack(f"<I{len(frames) + 1}I", 987654321, *offsets, 0) + b"".join(frames)


def dxt1_blocks(img: np.ndarray) -> bytes:
    """A plain DXT1 encoder: each 4x4 block's darkest and lightest pixels
    as its end points (4-colour mode), every pixel the nearest of the four;
    img [h, w, 3], h and w multiples of 4."""
    h, w, _ = img.shape
    blocks = img.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    lum = blocks.astype(np.int64).sum(-1)
    hi = blocks[np.arange(len(blocks)), lum.argmax(1)].astype(np.int64)
    lo = blocks[np.arange(len(blocks)), lum.argmin(1)].astype(np.int64)
    def q(c):
        return (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | (c[:, 2] >> 3)
    c0, c1 = q(hi), q(lo)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)
    c1 = np.where(c0 == c1, np.maximum(c0 - 1, 0), c1)
    def rgb(c):
        return np.stack([(c >> 11) << 3, ((c >> 5) & 63) << 2, (c & 31) << 3], -1)
    p0, p1 = rgb(c0), rgb(c1)
    pal = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], 1)  # [n, 4, 3]
    d = ((blocks[:, :, None, :].astype(np.int64) - pal[:, None]) ** 2).sum(-1)
    idx = d.argmin(-1)
    four = c0 > c1
    idx = np.where(four[:, None], idx, np.minimum(idx, 1))
    bits = (idx << (2 * np.arange(16))).sum(1)
    return b"".join(struct.pack("<HHI", int(a), int(b), int(c)) for a, b, c in zip(c0, c1, bits))


def blp_file(version: int, w: int, h: int, body: bytes, compression: int = 1, encoding: int = 1,
             alpha: int = 0, alpha_encoding: int = 0, palette: bytes = b"",
             jpeg_header: bytes | None = None) -> bytes:
    """A BLP1 or BLP2 with one mipmap, `body` its bytes (palette indices,
    DXT blocks or, for a BLP1 JPEG, the stream after `jpeg_header`)."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 1,
                                     w, h)
    extra = palette.ljust(1024, b"\0") if palette else b""
    if jpeg_header is not None:
        extra = struct.pack("<I", len(jpeg_header)) + jpeg_header
    offset = len(head) + 128 + len(extra)
    tables = struct.pack("<16I", offset, *([0] * 15)) + struct.pack("<16I", len(body), *([0] * 15))
    return head + tables + extra + body


def ftex_file(w: int, h: int, fmt: int, mip: bytes) -> bytes:
    return (b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, 1, fmt, 32) + struct.pack("<i", len(mip))
            + mip)


def sun_file(rows: np.ndarray, w: int, depth: int, file_type: int = 1,
             palette: np.ndarray | None = None, palette_type: int = 1) -> bytes:
    """A Sun raster of packed rows [h, (w * depth + 7) // 8]: raw rows padded
    to 16 bits, or (type 2) the unpadded rows run-length coded."""
    h = rows.shape[0]
    pal = b"" if palette is None else palette.T.astype(np.uint8).tobytes()  # planar
    if file_type == 2:
        flat = rows.tobytes()
        data = bytearray()
        i = 0
        while i < len(flat):
            j = i
            while j < len(flat) and flat[j] == flat[i] and j - i < 256:
                j += 1
            n = j - i
            if n >= 3 or flat[i] == 0x80:
                if n == 1:
                    data += b"\x80\x00"
                else:
                    data += bytes([0x80, n - 1, flat[i]])
                i = j
            else:
                data.append(flat[i])
                i += 1
    else:
        stride = ((w * depth + 15) // 16) * 2
        data = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), file_type,
                       palette_type if palette is not None else 0, len(pal))
    return head + pal + bytes(data)


def icns_rle_channel(v: np.ndarray) -> bytes:
    """IcnsImagePlugin's packbits-like coding of one channel."""
    out = bytearray()
    vals = v.tobytes()
    i = 0
    while i < len(vals):
        j = i
        while j < len(vals) and vals[j] == vals[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            out += bytes([(j - i) + 125, vals[i]])
            i = j
            continue
        k = i + 1
        while k < len(vals) and k - i < 128 and not (k + 2 < len(vals) and vals[k] ==
                                                     vals[k + 1] == vals[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + vals[i:k]
        i = k
    return bytes(out)


def icns_file(elements: list[tuple[bytes, bytes]]) -> bytes:
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in elements)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(img: np.ndarray, kind: bytes, rle: bool = True) -> bytes:
    """An it32 / ih32 / il32 / is32 element's data of img [n, n, 3]."""
    data = (b"".join(icns_rle_channel(img[..., c]) for c in range(3)) if rle
            else img.tobytes())
    return (b"\0\0\0\0" if kind == b"it32" else b"") + data


def fits_file(arr: np.ndarray, bitpix: int, extra: list[bytes] = ()) -> bytes:
    """A FITS primary image of arr [h, w] as BITPIX samples (big-endian),
    rows in file order (Pillow reads them bottom first)."""
    h, w = arr.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    cards = [f"SIMPLE  = {'T':>20}", f"BITPIX  = {bitpix:>20}", f"NAXIS   = {2:>20}",
             f"NAXIS1  = {w:>20}", f"NAXIS2  = {h:>20}", *[c.decode() for c in extra], "END"]
    head = "".join(c.ljust(80) for c in cards).encode().ljust(2880 * (-(-len(cards) * 80 // 2880)),
                                                                b" ")
    data = arr.astype(dt).tobytes()
    return head + data.ljust(-(-len(data) // 2880) * 2880, b"\0")


def fits_gzip(arr: np.ndarray, zbitpix: int) -> bytes:
    """Pillow's GZIP_1 layout: an empty primary HDU, then a BINTABLE with
    ZIMAGE T, ZCMPTYPE 'GZIP_1  ' and the image's 32-bit big-endian words
    gzipped as its heap (no padding after it)."""
    import gzip

    h, w = arr.shape
    primary = "".join(c.ljust(80) for c in [f"SIMPLE  = {'T':>20}", f"BITPIX  = {8:>20}",
                                            f"NAXIS   = {0:>20}", "END"]).encode().ljust(2880)
    cards = [f"XTENSION= 'BINTABLE'", f"BITPIX  = {8:>20}", f"NAXIS   = {2:>20}",
             f"NAXIS1  = {8:>20}", f"NAXIS2  = {1:>20}", f"ZIMAGE  = {'T':>20}",
             f"ZBITPIX = {zbitpix:>20}", f"ZNAXIS  = {2:>20}", f"ZNAXIS1 = {w:>20}",
             f"ZNAXIS2 = {h:>20}", "ZCMPTYPE= 'GZIP_1  '", "END"]
    table_head = "".join(c.ljust(80) for c in cards).encode().ljust(2880)
    words = arr.astype(">i4").tobytes()
    return primary + table_head + b"\0" * 8 + gzip.compress(words, mtime=0)


def fli_file(w: int, h: int, chunks: list[tuple[int, bytes]], flc: bool = True,
             prefix: bytes | None = None) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) of one frame of subchunks [(type,
    data)], each padded to an even size."""
    sub = b""
    for kind, data in chunks:
        data = data + b"\0" * (len(data) % 2)
        sub += struct.pack("<IH", 6 + len(data), kind) + data
    frame = struct.pack("<IHH", 16 + len(sub), 0xF1FA, len(chunks)) + b"\0" * 8 + sub
    pre = b"" if prefix is None else struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 128 + len(pre) + len(frame), 0xAF12 if flc else 0xAF11,
                     1, w, h, 8, 0)
    struct.pack_into("<I", head, 16, 5)
    return bytes(head) + pre + frame


def fli_color(entries: np.ndarray, start: int = 0) -> bytes:
    """A COLOR chunk's data: one packet of `entries` [n, 3] after `start`
    skipped."""
    n = len(entries)
    return struct.pack("<HBB", 1, start, n & 255) + entries.astype(np.uint8).tobytes()


def fli_brun(img: np.ndarray) -> bytes:
    """BRUN lines of img [h, w]: a packet-count byte, then runs (count,
    byte) and literals (-count, bytes)."""
    out = bytearray()
    for row in img:
        out.append(0)
        vals = row.tobytes()
        i = 0
        while i < len(vals):
            j = i
            while j < len(vals) and vals[j] == vals[i] and j - i < 127:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, vals[i]])
                i = j
            else:
                k = i + 1
                while k < len(vals) and k - i < 128 and (k + 1 >= len(vals) or
                                                         vals[k] != vals[k + 1]):
                    k += 1
                out += bytes([256 - (k - i)]) + vals[i:k]
                i = k
    return bytes(out)


def fli_lc(y0: int, rows: list[list[tuple[int, bytes | tuple[int, int]]]]) -> bytes:
    """An LC chunk from line y0: each line a list of (skip, bytes) copies or
    (skip, (count, byte)) runs."""
    out = struct.pack("<HH", y0, len(rows))
    for packets in rows:
        out += bytes([len(packets)])
        for skip, what in packets:
            if isinstance(what, tuple):
                out += bytes([skip, 256 - what[0], what[1]])
            else:
                out += bytes([skip, len(what)]) + what
    return out


def fli_ss2(lines: list) -> bytes:
    """An SS2 chunk: each line a list of words (a flag word or packet
    count) and packets (skip, bytes of an even length) or (skip, (count,
    two bytes)) runs."""
    out = struct.pack("<H", len(lines))
    for words, packets in lines:
        for wd in words:
            out += struct.pack("<H", wd)
        out += struct.pack("<H", len(packets))
        for skip, what in packets:
            if isinstance(what, tuple):
                out += bytes([skip, 256 - what[0]]) + what[1]
            else:
                out += bytes([skip, len(what) // 2]) + what
    return out


def xpm_file(idx: np.ndarray, colours: list[bytes], cpp: int = 1, keys: list[bytes] | None = None,
             pixels_comment: bool = True) -> bytes:
    """An XPM of palette indices idx [h, w] over colour values ("#rrggbb",
    "None", ...), keys of `cpp` characters."""
    h, w = idx.shape
    alphabet = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+@"
    if keys is None:
        keys = []
        for k in range(len(colours)):
            key = b""
            v = k
            for _ in range(cpp):
                key += alphabet[v % len(alphabet):v % len(alphabet) + 1]
                v //= len(alphabet)
            keys.append(key)
    lines = [b"/* XPM */", b"static char *img[] = {", b"/* columns rows colors cpp */",
             b'"%d %d %d %d",' % (w, h, len(colours), cpp)]
    lines += [b'"' + keys[k] + b" c " + colours[k] + b'",' for k in range(len(colours))]
    if pixels_comment:
        lines.append(b"/* pixels */")
    lines += [b'"' + b"".join(keys[v] for v in row) + b'",' for row in idx]
    lines.append(b"};")
    return b"\n".join(lines) + b"\n"


def msp_file(bits: np.ndarray, version: int = 2) -> bytes:
    """A Windows Paint file of bits [h, w] (True white): version 1 raw, or
    version 2 rows of runs and literals."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(bool), axis=1)
    words = [0] * 16
    words[0], words[1] = struct.unpack("<HH", b"DanM" if version == 1 else b"LinS")
    words[2], words[3] = w, h
    for k in range(12):
        words[12] ^= words[k]  # the header's words XOR to 0
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    body, rowmap = b"", []
    for r in rows:
        if (r == 255).all():
            rowmap.append(0)
            continue
        enc = bytearray()
        vals = r.tobytes()
        i = 0
        while i < len(vals):
            j = i
            while j < len(vals) and vals[j] == vals[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                enc += bytes([0, j - i, vals[i]])
                i = j
            else:
                k = i + 1
                while k < len(vals) and k - i < 255 and not (k + 2 < len(vals) and vals[k] ==
                                                             vals[k + 1] == vals[k + 2]):
                    k += 1
                enc += bytes([k - i]) + vals[i:k]
                i = k
        rowmap.append(len(enc))
        body += bytes(enc)
    return head + struct.pack(f"<{h}H", *rowmap) + body


def gbr_file(px: np.ndarray, version: int = 2, comment: bytes = b"brush\0") -> bytes:
    h, w, depth = px.shape
    size = (28 if version == 2 else 20) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + comment + px.astype(np.uint8).tobytes()


def imt_file(img: np.ndarray) -> bytes:
    h, w = img.shape
    return b"* IM Tools\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h) + img.tobytes()


def iptc_file(img: np.ndarray, band: int | None = None, layers: int = 1, component: int = 0,
              chunk: int = 1000) -> bytes:
    """An IPTC/NAA record set holding the raw image img [h, w] (one band)."""
    h, w = img.shape

    def field(rec: int, tag: int, data: bytes) -> bytes:
        if len(data) < 0x8000:
            return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data
        return bytes([0x1C, rec, tag, 0x80 | 4]) + b"\0" + struct.pack(">I", len(data)) + data

    out = (field(2, 0, b"\0\2") + field(3, 60, bytes([layers, component]))
           + field(3, 20, struct.pack(">H", w)) + field(3, 30, struct.pack(">H", h))
           + field(3, 120, b"\1"))
    if band is not None:
        out += field(3, 65, bytes([band]))
    data = img.astype(np.uint8).tobytes()
    for k in range(0, len(data), chunk):
        out += field(8, 10, data[k:k + chunk])
    return out


def mcidas_file(arr: np.ndarray, size: int, prefix: int = 0) -> bytes:
    """A McIdas area of arr [h, w] at `size` bytes a sample (big-endian),
    each line after a prefix of `prefix` bytes."""
    h, w = arr.shape
    head = np.zeros(64, ">i4")
    head[1] = 4
    head[8], head[9], head[10], head[13] = h, w, size, 1
    head[14] = prefix
    head[33] = 256
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[size]
    lines = np.concatenate([np.zeros((h, prefix), np.uint8),
                            arr.astype(dt).view(np.uint8).reshape(h, -1)], 1)
    return b"\0\0\0\0\0\0\0\4" + head.tobytes()[8:] + lines.tobytes()


def pixar_file(img: np.ndarray) -> bytes:
    h, w, _ = img.shape
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + img.astype(np.uint8).tobytes()


def xvthumb_file(idx: np.ndarray) -> bytes:
    h, w = idx.shape
    return (b"P7 332\n#XVVERSION:Version 2.28\n#IMGINFO:\n#END_OF_COMMENTS\n%d %d 255\n" % (w, h)
            + idx.astype(np.uint8).tobytes())


def tile_ground(n: int, seed: int) -> np.ndarray:
    """A floor of flat tiles, 64 x 8 texels each, their colours from a
    seed: [n, n, 3] uint8 whose rows are runs (an RLE-compressible 1024^2
    ground)."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(40, 230, (n // 8 + 1, n // 64 + 1, 3), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    return colours[yy // 8, (xx + 32 * ((yy // 8) % 2)) // 64]


def legacy_fixtures() -> dict[str, bytes]:
    """The fixtures of Pillow's legacy plugins (chip_smoke.py phase 4t):
    8-bit base colours (a 1024^2 SGI RLE tile ground kept as its digest,
    PCX with a VGA palette, DCX, BLP2 DXT1, BLP1 JPEG, FTEX, Sun RLE, an
    ICNS it32 icon with its mask, XPM, IM) and float roughnesses (SPIDER,
    FITS -32 of big- and of little-endian floats, FITS 16, McIdas 16-bit,
    IM "F" and "I;16"), and a few more decoded on the card's host (FLI,
    MSP, GBR, XV thumbnail, XBM)."""
    from PIL import Image

    def save(img, fmt, **kw) -> bytes:
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    t64 = texture(64, 64, 3, 120)
    jpg = pillow(texture(64, 64, 3, 121), "JPEG")
    cut = jpg.find(b"\xff\xda")
    pal8 = texture(48, 64, 1, 122)[..., 0]
    rle8 = (pal8 // 16).astype(np.uint8)
    icon = texture(128, 128, 4, 123)
    grey = texture(40, 48, 1, 124)[..., 0].astype(np.int64)
    idx = (texture(32, 40, 1, 125)[..., 0] // 32).astype(np.uint8)
    rng = np.random.default_rng(126)
    return {
        "sgi_ground_1024.sgi": sgi_file(tile_ground(1024, 127)),
        "pcx_vga.pcx": save(Image.fromarray(texture(48, 64, 3, 128)).quantize(64), "PCX"),
        "dcx_rgb.dcx": dcx_file([save(Image.fromarray(texture(40, 56, 3, 129)), "PCX"),
                                 save(Image.fromarray(texture(20, 20, 3, 130)), "PCX")]),
        "blp2_dxt1.blp": blp_file(2, 64, 64, dxt1_blocks(t64), 1, 2, 0, 0,
                                  bytes(1024)),
        "blp1_jpeg.blp": blp_file(1, 64, 64, jpg[cut:], 0, 5, 0, jpeg_header=jpg[:cut]),
        "ftex_dxt1.ftex": ftex_file(64, 64, 0, dxt1_blocks(texture(64, 64, 3, 131))),
        "sun_rle8.ras": sun_file(rle8, 64, 8, 2, rng.integers(0, 256, (16, 3), np.uint8)),
        "icns_it32.icns": icns_file([(b"it32", icns_rgb(icon[..., :3], b"it32")),
                                     (b"t8mk", icon[..., 3].tobytes())]),
        "xpm_p.xpm": xpm_file(idx, [b"#%06x" % int(v) for v in rng.integers(0, 1 << 24, 8)]),
        "im_rgb.im": save(Image.fromarray(texture(36, 52, 3, 132)), "IM"),
        "spider_f.spi": save(Image.fromarray(grey.astype(np.float32) / 255.0, "F"), "SPIDER"),
        "fits_m32.fits": fits_file(grey.astype(np.float64) / 255.0, -32),
        # Pillow reads FITS floats as little-endian: a file of little-endian
        # floats gives it finite texels (the big-endian one above gives it
        # byte-swapped values, NaN and infinities among them)
        "fits_m32_le.fits": fits_file(np.frombuffer((grey.astype(np.float32) / 255.0)
                                                    .astype("<f4").tobytes(), ">f4")
                                      .reshape(grey.shape), -32),
        "fits_16.fits": fits_file(grey * 100, 16),
        "mcidas_2.area": mcidas_file(grey * 250, 2, 4),
        "im_f.im": save(Image.fromarray(grey.astype(np.float32) / 255.0, "F"), "IM"),
        "im_grey16.im": save(Image.frombytes("I;16", (48, 40), (grey * 257).astype("<u2")
                                             .tobytes()), "IM"),
        "fli_brun.flc": fli_file(40, 32, [(11, fli_color(rng.integers(0, 64, (256, 3)))),
                                          (15, fli_brun(idx))]),
        "msp_v2.msp": msp_file(texture(30, 44, 1, 133)[..., 0] > 120, 2),
        "gbr_rgba.gbr": gbr_file(texture(24, 24, 4, 134), 2),
        "xvthumb.xv": xvthumb_file(texture(30, 40, 1, 135)[..., 0]),
        "xbm_bits.xbm": pillow(texture(30, 44, 1, 136) > 128, "XBM"),
    }


def fixtures() -> dict[str, bytes]:
    """Every fixture's file name and bytes."""
    return {**first_fixtures(), **new_fixtures(), **webp_fixtures(), **jpeg2000_fixtures(),
            **tiff_fixtures(), **legacy_fixtures()}


# fixtures.npz keeps these as the digest of their array
DIGESTED = ("webp_ground_1024.webp", "webp_rgba_1024.webp", "webp_lossless_1024.webp",
            "j2k_ground_1024.jp2", "tiff_zstd_ground_1024.tif", "tiff_g4_stencil_1024.tif",
            "sgi_ground_1024.sgi")


def digest(arr: np.ndarray) -> np.ndarray:
    """SHA-256 of an array's dtype, shape and bytes, as uint8 [32] (a bool
    array by value: Pillow's "1" arrays hold 255 for True)."""
    import hashlib

    if arr.dtype == bool:
        arr = arr != 0

    h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode() + np.ascontiguousarray(arr)
                       .tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def smooth_texture(n: int, channels: int, seed: int) -> np.ndarray:
    """texture's pattern without its noise, n x n (a 1024^2 WebP of it
    stays some tens of kilobytes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    phase = rng.uniform(0, 6.3, channels)
    base = np.stack([0.5 + 0.35 * np.sin(9.0 * xx + 5.0 * yy * (k + 1) + phase[k])
                     for k in range(channels)], axis=-1)
    tiles = ((xx * 6).astype(int) + (yy * 6).astype(int)) % 2
    return np.clip(np.round(base * (0.8 + 0.2 * tiles[..., None]) * 255), 0, 255
                   ).astype(np.uint8)


def webp_fixtures() -> dict[str, bytes]:
    """The WebP fixtures (tests/test_torch_imgio.py, chip_smoke.py phase 4q)."""
    from PIL import Image

    frames = [Image.fromarray(texture(40, 48, 4, 64 + k)) for k in range(3)]
    anim = io.BytesIO()
    frames[0].save(anim, "WEBP", save_all=True, append_images=frames[1:], quality=70,
                   duration=100)
    rgba = np.concatenate([smooth_texture(1024, 3, 67),
                           np.broadcast_to((np.arange(1024) // 4).astype(np.uint8)[None, :, None],
                                           (1024, 1024, 1))], axis=-1)
    return {
        "webp_lossy_rgb.webp": pillow(texture(48, 64, 3, 60), "WEBP", quality=80),
        "webp_lossy_rgba.webp": pillow(texture(40, 56, 4, 61), "WEBP", quality=75,
                                       alpha_quality=90),
        "webp_lossless_rgb.webp": pillow(texture(44, 60, 3, 62), "WEBP", lossless=True),
        "webp_lossless_rgba.webp": pillow(texture(36, 52, 4, 63), "WEBP", lossless=True),
        "webp_anim.webp": anim.getvalue(),
        "webp_ground_1024.webp": pillow(smooth_texture(1024, 3, 66), "WEBP", quality=80),
        "webp_rgba_1024.webp": pillow(rgba, "WEBP", quality=80),
        "webp_lossless_1024.webp": pillow((smooth_texture(1024, 3, 68) >> 4) << 4, "WEBP",
                                          lossless=True),
    }


def first_fixtures() -> dict[str, bytes]:
    """The fixtures of the first formats (tests/test_torch_imgio.py and
    chip_smoke.py phase 4n)."""
    from PIL import Image

    grey16 = texture(64, 64, 1, 12, depth=16)[..., 0]
    buf = io.BytesIO()
    Image.frombytes("I;16", (64, 64), grey16.astype("<u2").tobytes()).save(buf, "PNG")
    png_grey16 = buf.getvalue()
    buf = io.BytesIO()
    Image.frombytes("I;16", (50, 40), texture(40, 50, 1, 13, depth=16)[..., 0]
                    .astype("<u2").tobytes()).save(buf, "TIFF", compression="tiff_adobe_deflate")
    tiff_deflate16 = buf.getvalue()
    floats = (texture(40, 48, 1, 14).astype(np.float32)[..., 0] / 64.0 - 1.0)
    buf = io.BytesIO()
    Image.fromarray(floats, "F").save(buf, "TIFF", compression="tiff_adobe_deflate",
                                      tiffinfo={317: 3})
    tiff_float = buf.getvalue()
    return {
        "jpeg_420.jpg": pillow(texture(93, 117, 3, 1), "JPEG"),
        "jpeg_422.jpg": pillow(texture(80, 96, 3, 2), "JPEG", subsampling=1),
        "jpeg_444.jpg": pillow(texture(72, 80, 3, 3), "JPEG", subsampling=0, quality=90),
        "jpeg_restart.jpg": pillow(texture(96, 128, 3, 4), "JPEG", restart_marker_blocks=3),
        "jpeg_progressive.jpg": pillow(texture(77, 101, 3, 5), "JPEG", progressive=True),
        "jpeg_grey.jpg": pillow(texture(66, 90, 1, 6), "JPEG"),
        "tga_raw.tga": pillow(texture(48, 64, 3, 7), "TGA"),
        "tga_rle.tga": pillow(texture(50, 70, 4, 8), "TGA", compression="tga_rle"),
        "tiff_lzw_pred2.tif": pillow(texture(60, 80, 3, 9), "TIFF", compression="tiff_lzw",
                                     tiffinfo={317: 2}),
        "tiff_deflate16.tif": tiff_deflate16,
        "tiff_float.tif": tiff_float,
        "png_interlaced.png": raw_png(texture(55, 77, 4, 10), interlace=True),
        "png_rgb16.png": raw_png(texture(44, 60, 3, 11, depth=16)),
        "png_grey16.png": png_grey16,
        "png_grey1.png": pillow(texture(48, 64, 1, 15) > 127, "PNG"),
    }


# the writers' byte-equal extensions for each mode (tests/test_torch_writers.py,
# chip_smoke.py phase 4u)
WRITER_EXTS = (".png", ".apng", ".jpg", ".jpeg", ".jfif", ".jpe", ".mpo", ".tga", ".icb", ".vda",
               ".vst", ".tif", ".tiff", ".bmp", ".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm",
               ".dds", ".qoi", ".pcx", ".eps", ".ps", ".sgi", ".rgb", ".rgba", ".bw", ".im",
               ".gif", ".ico", ".icns")
WRITER_REFUSED = {"L": (".qoi",), "RGB": (),
                  "RGBA": (".jfif", ".jpe", ".mpo", ".jpg", ".jpeg", ".pcx", ".eps", ".ps")}
WRITER_SHAPES = {"L": (19, 33), "RGB": (37, 21, 3), "RGBA": (29, 47, 4)}
WRITER_NAME = "fixture"


def writer_arrays() -> dict[str, np.ndarray]:
    """The three seeded arrays of writers.json: textures with noise, odd
    sizes, an alpha of every level."""
    out = {}
    for k, (mode, shape) in enumerate(WRITER_SHAPES.items()):
        img = texture(shape[0], shape[1], shape[2] if len(shape) == 3 else 1, 700 + k)
        out[mode] = img[..., 0] if len(shape) == 2 else img
    return out


# the full-size arrays of writers.json: the CLI frame's size, and the
# extensions whose encoders take other branches there (GIF: the palette
# kept whole, the median cut's hash rescaling above 65,536 colours, the
# octree's 256 entries with a transparent one)
WRITER_FULL_SIZE = (1200, 1200)
WRITER_FULL_EXTS = {"L": (".gif", ".jpg", ".png"), "RGB": (".gif", ".jpg", ".png"),
                    "RGBA": (".gif", ".png")}


def writer_ramp(mode: str, h: int, w: int) -> np.ndarray:
    """A [h, w] (L), [h, w, 3] (RGB) or [h, w, 4] (RGBA) uint8 array of
    integer arithmetic alone, so that a script without this file can make
    it (chip_smoke.py `writer_ramp`): over a million colours at 1200 x
    1200, and an alpha of 0 on every seventh diagonal, 128-255 elsewhere."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    channels = [(x * 3 + y * y // 97) % 256, (y * 5 + x * y // 311) % 256,
                ((x ^ y) + x * x // 173) % 256,
                np.where((x + y) % 7 == 0, 0, 128 + (x + 2 * y) % 128)]
    n = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = np.stack(channels[:n], -1).astype(np.uint8)
    return img[..., 0] if n == 1 else img


def writers() -> dict:
    """writers.json: the arrays (base64 of their bytes) and the SHA-256 of
    the file Pillow saves for each array at each byte-equal extension, the
    base name WRITER_NAME (SGI and IM files hold it). The .jpg and .jpeg
    files of RGBA are left out: the writer drops the alpha first. Under
    "full_size": writer_ramp's arrays at WRITER_FULL_SIZE, by the SHA-256
    of their bytes, Pillow's files of them at WRITER_FULL_EXTS, and the
    SHA-256 of Pillow's decode of each JPEG (the lossy file's samples)."""
    import base64
    import hashlib
    import tempfile

    from PIL import Image

    doc = {"pillow": Image.__version__, "name": WRITER_NAME, "arrays": {}, "sha256": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, arr in writer_arrays().items():
            doc["arrays"][mode] = {"shape": list(arr.shape),
                                   "base64": base64.b64encode(arr.tobytes()).decode("ascii")}
            doc["sha256"][mode] = {}
            for ext in WRITER_EXTS:
                if ext in WRITER_REFUSED[mode]:
                    continue
                path = os.path.join(tmp, WRITER_NAME + ext)
                Image.fromarray(arr, mode).save(path)
                with open(path, "rb") as f:
                    doc["sha256"][mode][ext] = hashlib.sha256(f.read()).hexdigest()
        full = {"shape": list(WRITER_FULL_SIZE), "arrays": {}, "sha256": {}, "jpeg_decoded": {}}
        for mode, exts in WRITER_FULL_EXTS.items():
            arr = writer_ramp(mode, *WRITER_FULL_SIZE)
            full["arrays"][mode] = hashlib.sha256(arr.tobytes()).hexdigest()
            full["sha256"][mode] = {}
            for ext in exts:
                path = os.path.join(tmp, WRITER_NAME + ext)
                Image.fromarray(arr, mode).save(path)
                with open(path, "rb") as f:
                    full["sha256"][mode][ext] = hashlib.sha256(f.read()).hexdigest()
                if ext == ".jpg":
                    with Image.open(path) as im:
                        samples = np.asarray(im.convert("RGBA")).tobytes()
                    full["jpeg_decoded"][mode] = hashlib.sha256(samples).hexdigest()
        doc["full_size"] = full
    return doc


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from gatling_tpu import imgio

    with open(os.path.join(HERE, "writers.json"), "w") as f:
        json.dump(writers(), f, indent=1, sort_keys=True)
        f.write("\n")

    decoded = {}
    for name, data in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        arr = imgio.load_image(data).data
        decoded[name] = digest(arr) if name in DIGESTED else arr
        print(f"{name}: {len(data)} bytes, {arr.dtype} {arr.shape}")
    np.savez_compressed(os.path.join(HERE, "fixtures.npz"), **decoded)
    return 0


if __name__ == "__main__":
    sys.exit(main())
