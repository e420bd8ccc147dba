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

Run from the repository root, where Pillow and JAX are installed:

    JAX_PLATFORMS=cpu python tests/data/imgio/make_fixtures.py
"""

from __future__ import annotations

import io
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


def fixtures() -> dict[str, bytes]:
    """Every fixture's file name and bytes."""
    return {**first_fixtures(), **new_fixtures(), **webp_fixtures()}


# fixtures.npz keeps these as the digest of their array
DIGESTED = ("webp_ground_1024.webp", "webp_rgba_1024.webp", "webp_lossless_1024.webp")


def digest(arr: np.ndarray) -> np.ndarray:
    """SHA-256 of an array's dtype, shape and bytes, as uint8 [32]."""
    import hashlib

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


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from gatling_tpu import imgio

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
