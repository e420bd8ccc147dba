"""Pillow 12.1's small raw-image plugins, for the JAX package's imgio:
SPIDER, MCIDAS, PIXAR, IMT, XVTHUMB, GBR and IPTC.

Quirks reproduced:
- SPIDER (SpiderImagePlugin): a header of 27 floats, big-endian tried
  first; the integer fields it checks, a 2D image (IFORM 1) alone; the
  first image of a stack after two headers; one that names an image of a
  stack without its header (no stack offset) fails; "F" samples in the
  header's byte order;
- MCIDAS: 1, 2 or 4 bytes a sample ("L", "I;16B" read as "I;16B", 32-bit
  big-endian into "I"), each line after its prefix, lines the header's
  stride apart;
- PIXAR: RGB at 1024 when the header says (14, 2), else no mode;
- IMT: "width", "height" and "pixel n8" lines up to a form feed, then
  width x height grey bytes;
- XVTHUMB: "P" over xv's fixed 3-3-2 palette, after the size line;
- GBR: a GIMP brush, version 1 or 2 (its "GIMP" magic and spacing), its
  comment skipped, 1 byte a pixel ("L") or 4 (RGBA);
- IPTC: the records up to the first (8, 10) record give the image's
  layers, size and compression; a raw image is the (8, 10) records' data
  read as a PGM of that size (pnm.py), put in its band of an RGB or CMYK
  image whose other bands are 0 (the band (3, 65) names, 0 meaning the
  last). Not ported: JPEG-compressed IPTC images (NotImplementedError).
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio import pnm
from gatling_tpu_torch.imgio.modes import UNPORTED, Reader, Skip, bomb_check, finish, raw_rows


def _size(w: int, h: int) -> None:
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)


# --------------------------------------------------------------------------
# SPIDER
# --------------------------------------------------------------------------

def _is_int(v: float) -> bool:
    try:
        return v - int(v) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t: tuple) -> int:
    """isSpiderHeader: the header's length in bytes, or 0."""
    h = (99, *t)
    if not all(_is_int(h[k]) for k in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _pyint(v: float) -> int:
    try:
        return int(v)
    except (ValueError, OverflowError) as e:
        raise ValueError(f"SPIDER: not an integer: {v}") from e


def decode_spider(data: bytes) -> np.ndarray:
    f = data[:108]
    if len(f) < 108:
        raise Skip("not a valid Spider file")
    order = ">"
    t = struct.unpack(">27f", f)
    n = _spider_header(t)
    if n == 0:
        order = "<"
        t = struct.unpack("<27f", f)
        n = _spider_header(t)
    if n == 0:
        raise Skip("not a valid Spider file")
    h = (99, *t)
    if int(h[5]) != 1:
        raise Skip("not a Spider 2D image")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = _pyint(h[24]), _pyint(h[27])
    if istack == 0 and imgnumber == 0:
        offset = n
    elif istack > 0 and imgnumber == 0:
        _pyint(h[26])
        offset = 2 * n
    elif istack == 0 and imgnumber > 0:
        raise ValueError("SPIDER: an image of a stack without its stack")  # AttributeError
    else:
        raise Skip("inconsistent stack header values")
    _size(w, ht)
    rows = raw_rows(data, offset, w, ht, 4 * w)
    return finish("F", rows.view(order + "f4").reshape(ht, w).astype(np.float32))


# --------------------------------------------------------------------------
# MCIDAS
# --------------------------------------------------------------------------

def decode_mcidas(data: bytes) -> np.ndarray:
    s = data[:256]
    if not s.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04") or len(s) != 256:
        raise Skip("not an McIdas area file")
    w = (0, *struct.unpack("!64i", s))
    if w[11] not in (1, 2, 4):
        raise Skip("unsupported McIdas format")
    width, height = w[10], w[9]
    _size(width, height)
    offset, stride = w[34] + w[15], w[15] + w[10] * w[11] * w[14]
    rows = raw_rows(data, offset, width, height, width * w[11], stride)
    if w[11] == 1:
        return finish("L", rows)
    if w[11] == 2:
        return finish("I;16B", rows.view(">u2").reshape(height, width))
    return finish("I", rows.view(">i4").reshape(height, width).astype(np.int32))


# --------------------------------------------------------------------------
# PIXAR, IMT, XVTHUMB, GBR
# --------------------------------------------------------------------------

def decode_pixar(data: bytes) -> np.ndarray:
    if not data.startswith(b"\200\350\000\000"):
        raise Skip("not a PIXAR file")
    s = data[:512]
    if len(s) < 428:
        raise Skip("PIXAR: short header")  # struct.error in i16
    w, h = struct.unpack_from("<H", s, 418)[0], struct.unpack_from("<H", s, 416)[0]
    if struct.unpack_from("<HH", s, 424) != (14, 2):
        raise Skip("not identified by this plugin")  # no mode
    _size(w, h)
    return finish("RGB", raw_rows(data, 1024, w, h, 3 * w).reshape(h, w, 3))


def decode_imt(data: bytes) -> np.ndarray:
    import re

    field = re.compile(rb"([a-z]*) ([^ \r\n]*)")
    buffer = data[:100]
    if b"\n" not in buffer:
        raise Skip("not an IM file")
    f = Reader(data, len(buffer))
    w = h = 0
    mode = ""
    offset = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = f.pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += f.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = field.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError as e:
            raise ValueError("IMT: bad number") from e
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode:
        raise Skip("not identified by this plugin")
    _size(w, h)
    if offset is None:
        raise ValueError("cannot load this image")  # no tile
    return finish("L", raw_rows(data, offset, w, h, w))


# XVThumbImagePlugin.PALETTE: 3 bits red, 3 green, 2 blue
_XV = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def decode_xvthumb(data: bytes) -> np.ndarray:
    if not data.startswith(b"P7 332"):
        raise Skip("not an XV thumbnail file")
    f = Reader(data, 6)
    f.readline()
    while True:
        s = f.readline()
        if not s:
            raise Skip("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    parts = s.strip().split(maxsplit=2)[:2]
    if len(parts) < 2:
        raise ValueError("XV thumbnail: bad size line")
    try:
        w, h = int(parts[0]), int(parts[1])
    except ValueError as e:
        raise ValueError("XV thumbnail: bad size line") from e
    _size(w, h)
    return finish("P", raw_rows(data, f.pos, w, h, w), _XV)


def decode_gbr(data: bytes) -> np.ndarray:
    f = Reader(data)

    def i32() -> int:
        s = f.read(4)
        if len(s) < 4:
            raise Skip("GBR: short header")  # struct.error
        return struct.unpack(">I", s)[0]

    hs = i32()
    if hs < 20:
        raise Skip("not a GIMP brush")
    version = i32()
    if version not in (1, 2):
        raise Skip("Unsupported GIMP brush version")
    w, h, depth = i32(), i32(), i32()
    if w == 0 or h == 0:
        raise Skip("not a GIMP brush")
    if depth not in (1, 4):
        raise Skip("Unsupported GIMP brush color depth")
    if version == 2:
        if f.read(4) != b"GIMP":
            raise Skip("not a GIMP brush, bad magic number")
        i32()
    f.read(hs - (20 if version == 1 else 28))
    bomb_check(w, h)
    raw = f.read(w * h * depth)
    if len(raw) < w * h * depth:
        raise ValueError("not enough image data")
    px = np.frombuffer(raw, np.uint8).reshape(h, w, depth)
    return finish("L" if depth == 1 else "RGBA", px)


# --------------------------------------------------------------------------
# IPTC
# --------------------------------------------------------------------------

def _iptc_field(f: Reader, on_open: bool):
    """IptcImageFile.field: (tag, size), or (None, 0) at the end."""
    s = f.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    if len(s) < 3:
        raise (Skip if on_open else ValueError)("IPTC: short field")  # IndexError
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise (Skip if on_open else ValueError)("invalid IPTC/NAA file")
    if len(s) < 4:
        raise (Skip if on_open else ValueError)("IPTC: short field")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(f.read(size - 128))
    else:
        if len(s) < 5:
            raise (Skip if on_open else ValueError)("IPTC: short field")  # struct.error
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _i(c: bytes) -> int:
    return struct.unpack(">I", (bytes(4) + c)[-4:])[0]


def decode_iptc(data: bytes) -> np.ndarray:
    f = Reader(data)
    info: dict = {}
    while True:
        offset = f.pos
        tag, size = _iptc_field(f, True)
        if not tag or tag == (8, 10):
            break
        tagdata = f.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] + [tagdata]) if isinstance(info[tag], list) \
                else [info[tag], tagdata]
        else:
            info[tag] = tagdata
    if (3, 60) not in info:
        raise Skip("IPTC: no (3, 60) record")  # KeyError
    rec = info[(3, 60)]
    if not isinstance(rec, bytes) or len(rec) < 2:
        raise Skip("IPTC: a bad (3, 60) record")  # TypeError / IndexError
    layers, component = rec[0], rec[1]
    band = None
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        b65 = info.get((3, 65))
        if b65 is not None:
            if not isinstance(b65, bytes) or not b65:
                raise Skip("IPTC: a bad (3, 65) record")
            band = b65[0] - 1
        else:
            band = 0
    for key in ((3, 20), (3, 30), (3, 120)):
        if key not in info:
            raise Skip("IPTC: a record missing")  # KeyError
        if not isinstance(info[key], bytes):
            raise Skip("IPTC: a bad record")  # TypeError
    w, h = _i(info[(3, 20)]), _i(info[(3, 30)])
    compression = {1: "raw", 5: "jpeg"}.get(_i(info[(3, 120)]))
    if compression is None:
        raise ValueError("Unknown IPTC image compression")
    if not mode:
        raise Skip("not identified by this plugin")
    _size(w, h)
    if tag != (8, 10):
        raise ValueError("cannot load this image")
    if compression == "jpeg":
        raise NotImplementedError(f"JPEG-compressed IPTC images are not ported {UNPORTED}")
    f.pos = offset
    body = bytearray(b"P5\n%d %d\n255\n" % (w, h))
    while True:
        kind, size = _iptc_field(f, False)
        if kind != (8, 10):
            break
        got = f.read(size)
        body += got
    grey = pnm.decode_pnm(bytes(body))[..., 0]
    if band is None:
        return finish("L", grey)
    bands = [np.zeros((h, w), np.uint8)] * len(mode)
    try:
        bands[band] = grey
    except IndexError as e:
        raise ValueError("IPTC: no such band") from e
    return finish(mode, np.stack(bands, -1))
