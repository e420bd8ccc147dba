"""Windows bitmaps as Pillow's BmpImagePlugin, DibImagePlugin,
IcoImagePlugin and CurImagePlugin read them (the JAX package's imgio goes
through Pillow).

BMP and DIB: core (12-byte), V3 (40), V4 (108), V5 (124) and the 52-,
56- and 64-byte headers; 1-, 4- and 8-bit palettes (a black-and-white
palette of two entries is Pillow's mode "1", a bool image; a grey ramp
its mode "L"), RLE8 and RLE4 (Pillow's BmpRleDecoder, its quirks
included), 16, 24 and 32 bits raw or with the BITFIELDS masks Pillow
knows; bottom-up and top-down rows. A 32-bit raw BMP is RGB (its fourth
byte dropped), unless it is the first entry of a CUR file, as in Pillow.

ICO: the entry Pillow picks (the largest, and of those the lowest colour
depth), a BMP (its AND mask, or for a 32-bit entry its fourth bytes, as
the alpha) or a PNG (decoded by the port's PNG decoder). CUR: the largest
entry's bitmap at half its height, no mask.
"""

from __future__ import annotations

import io
import math
import struct

import numpy as np

from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish, raw_rows, unpack_bgr15, \
    unpack_bgr16, unpack_bits

_HEADERS = (40, 52, 56, 64, 108, 124)
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# bits a pixel of each raw mode, and for the byte-per-band modes the byte
# of R, G, B (and A)
_RAW_BITS = {"P;1": 1, "P;4": 4, "P": 8, "1": 1, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}
_BYTE_ORDER = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1), "BGXR": (3, 1, 0),
               "ABGR": (3, 2, 1, 0), "RGBA": (0, 1, 2, 3), "BGRA": (2, 1, 0, 3),
               "BGAR": (3, 1, 0, 2)}


def _u32(data: bytes, at: int) -> int:
    if at < 0 or at + 4 > len(data):
        raise Skip("BMP: short read")
    return struct.unpack_from("<I", data, at)[0]


def _safe_read(data: bytes, pos: int, n: int) -> bytes:
    """ImageFile._safe_read: n bytes, or OSError (here ValueError) if short."""
    if n <= 0:
        return b""
    got = data[pos:pos + n]
    if len(got) < n:
        raise ValueError("BMP: Truncated File Read")
    return got


class Bitmap:
    """BmpImageFile._bitmap's reading of a bitmap header at `pos`."""

    def __init__(self, data: bytes, pos: int, offset: int = 0, cur22: bool = False) -> None:
        hs = _u32(data, pos)
        pos += 4
        hd = _safe_read(data, pos, hs - 4)
        pos += max(hs - 4, 0)
        masks = None
        if hs == 12:
            w, h, _planes, bits = struct.unpack_from("<HHHH", hd)
            compression, colors, padding, direction = 0, 0, 3, -1
        elif hs in _HEADERS:
            y_flip = hd[7] == 0xFF
            direction = 1 if y_flip else -1
            w, h = struct.unpack_from("<II", hd)
            if y_flip:
                h = 2 ** 32 - h
            bits, compression = struct.unpack_from("<HI", hd, 10)
            (colors,) = struct.unpack_from("<I", hd, 28)
            padding = 4
            if compression == 3:
                if len(hd) >= 48:
                    masks = list(struct.unpack_from("<III", hd, 36))
                    masks.append(struct.unpack_from("<I", hd, 48)[0] if len(hd) >= 52 else 0)
                else:
                    masks = [_u32(data, pos), _u32(data, pos + 4), _u32(data, pos + 8), 0]
                    pos += 12
        else:
            raise ValueError(f"Unsupported BMP header type ({hs})")
        self.size = (w, h)
        colors = colors or (1 << bits)
        if offset == 14 + hs and bits <= 8:
            offset += 4 * colors
        if bits not in _BIT2MODE:
            raise ValueError(f"Unsupported BMP pixel depth ({bits})")
        mode, raw = _BIT2MODE[bits]
        rle = False
        if compression == 3:
            key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
            if key not in _MASK_MODES:
                raise ValueError("Unsupported BMP bitfields layout")
            raw = _MASK_MODES[key]
            if bits == 32 and "A" in raw:
                mode = "RGBA"
        elif compression == 0:
            if bits == 32 and cur22:
                raw, mode = "BGRA", "RGBA"
        elif compression in (1, 2):
            rle = True
        else:
            raise ValueError(f"Unsupported BMP compression ({compression})")
        self.palette = None
        if mode == "P":
            if not 0 < colors <= 65536:
                raise ValueError(f"Unsupported BMP Palette size ({colors})")
            pal = data[pos:pos + padding * colors]
            pos += len(pal)
            indices = (0, 255) if colors == 2 else range(colors)
            grey = all(pal[k * padding:k * padding + 3] == bytes([v & 255]) * 3
                       for k, v in enumerate(indices))
            if grey:
                mode = raw = "1" if colors == 2 else "L"
            else:
                n = len(pal) // padding
                if n > 256:  # ImagePalette's data is refused at load
                    raise ValueError("invalid palette size")
                self.palette = np.frombuffer(pal[:n * padding], np.uint8).reshape(
                    n, padding)[:, 2::-1]
        self.mode, self.raw, self.bits, self.rle = mode, raw, bits, rle
        self.rle4 = compression == 2
        self.stride = ((w * bits + 31) >> 3) & ~3
        self.direction = direction
        self.offset = offset or pos

    def pixels(self, data: bytes, size: tuple[int, int] | None = None) -> np.ndarray:
        """The image's bands (or palette indices) [h, w(, bands)] of size
        `size` (the header's if None), from the tile's offset."""
        w, h = size or self.size
        if self.rle:
            idx = _rle_decode(data, self.offset, w, h, self.rle4)
            if self.mode == "1":
                raise ValueError("BMP: cannot unpack P data into a mode 1 image")
            return raw_rows(idx, 0, w, h, w, 0, self.direction).reshape(h, w)
        bits = _RAW_BITS.get(self.raw, 32)
        rows = raw_rows(data, self.offset, w, h, (w * bits + 7) // 8, self.stride,
                        self.direction)
        if self.raw in ("P;1", "P;4", "1"):
            return unpack_bits(rows, w, bits)
        if self.raw in ("P", "L"):
            return rows.reshape(h, w)
        if self.raw in ("BGR;15", "BGR;16"):
            v = rows.view("<u2").reshape(h, w)
            return unpack_bgr15(v) if self.raw == "BGR;15" else unpack_bgr16(v)
        px = rows.reshape(h, w, bits // 8)
        order = _BYTE_ORDER[self.raw]
        return px[..., list(order[:4 if self.mode == "RGBA" else 3])]


def _rle_decode(data: bytes, offset: int, w: int, h: int, rle4: bool) -> bytes:
    """BmpRleDecoder.decode: the palette indices of an RLE8 or RLE4 image,
    bottom row first, as the decoder builds them (its delta escape reads
    two bytes more than it uses, as Pillow's does)."""
    fd = io.BytesIO(data)
    fd.seek(offset)
    out = bytearray()
    x = 0
    dest = w * h
    while len(out) < dest:
        pixels, byte = fd.read(1), fd.read(1)
        if not pixels or not byte:
            break
        num = pixels[0]
        if num:
            if x + num > w:
                num = max(0, w - x)
            if rle4:
                first, second = bytes([byte[0] >> 4]), bytes([byte[0] & 0x0F])
                for k in range(num):
                    out += first if k % 2 == 0 else second
            else:
                out += byte * num
            x += num
        elif byte[0] == 0:
            while len(out) % w != 0:
                out += b"\x00"
            x = 0
        elif byte[0] == 1:
            break
        elif byte[0] == 2:
            if len(fd.read(2)) < 2:
                break
            right, up = fd.read(2)  # ValueError when fewer than 2 bytes remain
            out += b"\x00" * (right + up * w)
            x = len(out) % w
        else:
            if rle4:
                count = byte[0] // 2
                got = fd.read(count)
                for b in got:
                    out += bytes([b >> 4, b & 0x0F])
            else:
                count = byte[0]
                got = fd.read(count)
                out += got
            if len(got) < count:
                break
            x += byte[0]
            if fd.tell() % 2 != 0:
                fd.seek(1, io.SEEK_CUR)
    return bytes(out)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> RGBA, the JAX package's imgio.load_image(data).data."""
    if len(data) < 14 or not data.startswith(b"BM"):
        raise Skip("not a BMP file")
    bm = Bitmap(data, 14, _u32(data, 10))
    _identified(*bm.size)
    return finish(bm.mode, bm.pixels(data), bm.palette)


def _identified(w: int, h: int) -> None:
    """ImageFile's check after _open (an empty size gives the file up), then
    Image.open's decompression bomb check."""
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)


def dib_accepts(data: bytes) -> bool:
    return len(data) >= 4 and _u32(data, 0) in (12, 40, 52, 56, 64, 108, 124)


def decode_dib(data: bytes) -> np.ndarray:
    """A headerless bitmap (Pillow's DIB): the header at byte 0."""
    bm = Bitmap(data, 0)
    _identified(*bm.size)
    return finish(bm.mode, bm.pixels(data), bm.palette)


def decode_cur(data: bytes) -> np.ndarray:
    """CurImageFile: the entry of the largest width and height (the first
    of equals), its bitmap at half height."""
    if len(data) < 6 or not data.startswith(b"\0\0\2\0"):
        raise Skip("not a CUR file")
    (count,) = struct.unpack_from("<H", data, 4)
    m, pos = b"", 6
    for _ in range(count):
        s = data[pos:pos + 16]
        pos += len(s)
        if not m:
            m = s
        elif len(s) < 2:
            raise Skip("CUR: truncated directory")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise Skip("No cursors were found")
    if len(m) < 16:
        raise Skip("CUR: truncated directory entry")
    at = struct.unpack_from("<I", m, 12)[0]
    bm = Bitmap(data, at if at else pos, 0, cur22=at == 22)
    w, h = bm.size
    _identified(w, h // 2)
    return finish(bm.mode, bm.pixels(data, (w, h // 2)), bm.palette)


def _ico_entries(data: bytes) -> list[dict]:
    """IcoFile's directory, sorted as Pillow sorts it: by area, largest
    first, and within an area by colour depth, lowest first."""
    (count,) = struct.unpack_from("<H", data, 4)
    entries = []
    for k in range(count):
        s = data[6 + 16 * k:22 + 16 * k]
        if len(s) < 16:
            raise Skip("ICO: truncated directory")
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append(dict(w=w, h=h, bpp=bpp, size=size, offset=offset, depth=depth))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["w"] * e["h"], reverse=True)
    if not entries:
        raise Skip("ICO: no entries")
    return entries


def _strip_trns(png: bytes) -> bytes:
    """A PNG's chunks without tRNS: an ICO keeps its PNG frame's mode and
    palette but not the frame's info, where Pillow keeps the transparency."""
    out, pos = [png[:8]], 8
    while pos + 8 <= len(png):
        (length,) = struct.unpack_from(">I", png, pos)
        chunk = png[pos:pos + 12 + length]
        if png[pos + 4:pos + 8] != b"tRNS":
            out.append(chunk)
        pos += 12 + length
        if png[pos - 8 - length:pos - 4 - length] == b"IEND":
            break
    out.append(png[pos:])
    return b"".join(out)


def decode_ico(data: bytes) -> np.ndarray:
    """IcoImageFile: the first entry of the sorted directory, as a PNG or as
    a DIB at half its height with its alpha from the AND mask (or, for a
    32-bit entry, from each pixel's fourth byte)."""
    from gatling_tpu_torch.imgio import decode_png

    if len(data) < 6 or not data.startswith(b"\0\0\1\0"):
        raise Skip("not an ICO file")
    e = _ico_entries(data)[0]
    at = e["offset"]
    if data[at:at + 8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(_strip_trns(data[at:]))
    bm = Bitmap(data, at)
    w, h = bm.size
    bomb_check(w, h)
    h = int(h / 2)
    px = bm.pixels(data, (w, h))
    rgba = finish(bm.mode, px, bm.palette)
    if rgba.dtype == bool:
        rgba = np.where(rgba, np.uint8(255), np.uint8(0))
    rgba = rgba.copy()
    if e["bpp"] == 32:
        raw = data[bm.offset:bm.offset + w * h * 4][3::4]
        if len(raw) < w * h:
            raise ValueError("ICO: not enough image data for the alpha")
        rgba[..., 3] = np.frombuffer(raw, np.uint8, w * h).reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32 if w % 32 else 0)
        total = int((wp * h) / 8)
        mask = raw_rows(data, e["offset"] + e["size"] - total, wp, h, (w + 7) // 8,
                        int(wp / 8), -1)
        rgba[..., 3] = np.where(unpack_bits(mask, w, 1) == 0, 255, 0)
    return rgba


def encode_bmp(img: np.ndarray, file_header: bool = True) -> bytes:
    """[H, W] or [H, W, 1] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 ->
    the bytes Pillow's BmpImagePlugin._save writes: a V3 header at 96 dpi,
    grey as 8-bit indices into a grey palette, RGB as BGR and RGBA as BGRA,
    rows bottom-up, each padded to 4 bytes; without the 14-byte file header
    (`file_header` false) the bytes of its DIB save (_dib_save)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        bits, colors, px = 8, 256, img[..., None]
        palette = b"".join(bytes((i, i, i, 0)) for i in range(256))
    elif img.shape[2] in (3, 4):
        bits, colors, palette = 8 * img.shape[2], 0, b""
        px = img[..., [2, 1, 0, 3][:img.shape[2]]]
    else:
        raise ValueError(f"BMP: expected 1, 3 or 4 channels, got {img.shape}")
    h, w = px.shape[:2]
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = px.reshape(h, -1)
    ppm = int(96 * 39.3701 + 0.5)
    offset = 14 + 40 + colors * 4
    head = b"BM" + struct.pack("<IHHI", offset + stride * h, 0, 0, offset)
    info = struct.pack("<IIIHHIIIIII", 40, w, h, 1, bits, 0, stride * h, ppm, ppm, colors,
                       colors)
    return (head if file_header else b"") + info + palette + rows[::-1].tobytes()


def encode_dib(img: np.ndarray) -> bytes:
    """Pillow's .dib file of img: encode_bmp without its file header."""
    return encode_bmp(img, file_header=False)
