"""Pillow's open decision, carried into the port: which of Pillow 12.1's
plugins takes a file (the JAX package decodes every texture through
Pillow, which the port does not depend on).

Image.open tries its plugins in the order of Image.ID (the five of
Image.preinit first: BMP, DIB, GIF, JPEG, PPM, PNG; then the rest in
alphabetical order of their modules). A plugin whose `_accept` test takes
the first 16 bytes opens the file; if its `_open` raises SyntaxError,
IndexError, TypeError, KeyError, EOFError or struct.error, or leaves an
empty size or no mode, Image.open goes on to the next plugin (`Skip`
here); any other error ends the search, and the JAX package's load_image
raises ValueError.

`PLUGINS` lists the plugins in that order as (name, accept). The
decoders of the ported formats do their own opening (raising Skip where
Pillow's `_open` gives the file up); for the others, `open_unported` is
their `_open`'s header checks, after which the port raises
NotImplementedError, or ValueError for the formats Pillow cannot load here
at all (EPS without Ghostscript, WMF off Windows, the BUFR, GRIB and HDF5
stubs without a handler, MPEG and PCD, whose plugins only read a header).
"""

from __future__ import annotations

import math
import re
import struct

from gatling_tpu_torch.imgio.modes import Reader, Skip

UNPORTED = "(ROADMAP: 'USD content')"


def _i16(s: bytes, at: int = 0, bo: str = "<") -> int:
    if len(s) < at + 2:
        raise Skip("short read")
    return struct.unpack_from(bo + "H", s, at)[0]


def _i32(s: bytes, at: int = 0, bo: str = "<") -> int:
    if len(s) < at + 4:
        raise Skip("short read")
    return struct.unpack_from(bo + "I", s, at)[0]


# TiffImagePlugin.PREFIXES
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                  b"II\x2b\x00")


_WEBP_MODES = (b"VP8X", b"VP8 ", b"VP8L")

# (name, accept over the first 16 bytes); None: no test, every file is tried
PLUGINS = (
    ("BMP", lambda p: p.startswith(b"BM")),
    ("DIB", lambda p: len(p) >= 4 and _i32(p) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a"))),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff")),
    ("PPM", lambda p: len(p) >= 2 and p.startswith(b"P") and p[1] in b"0123456fy"),
    ("PNG", lambda p: p.startswith(b"\x89PNG\r\n\x1a\n")),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2"))),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0")),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)),
    ("DCX", lambda p: len(p) >= 4 and _i32(p) == 987654321),
    ("DDS", lambda p: p.startswith(b"DDS ")),
    ("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _i32(p) == 0xC6D3D0C5)),
    ("FITS", lambda p: p.startswith(b"SIMPLE")),
    ("FLI", lambda p: len(p) >= 16 and _i16(p, 4) in (0xAF11, 0xAF12) and _i16(p, 14) in (0, 3)),
    ("FTEX", lambda p: p.startswith(b"FTEX")),
    ("GBR", lambda p: len(p) >= 8 and _i32(p, 0, ">") >= 20 and _i32(p, 4, ">") in (1, 2)),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", lambda p: p.startswith((b"\xff\x4f\xff\x51",
                                         b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", lambda p: p.startswith(b"icns")),
    ("ICO", lambda p: p.startswith(b"\0\0\1\0")),
    ("IM", None),
    ("IMT", None),
    ("IPTC", None),
    ("MCIDAS", lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04")),
    ("MPEG", lambda p: p.startswith(b"\x00\x00\x01\xb3")),
    ("TIFF", lambda p: p.startswith(_TIFF_PREFIXES)),
    ("MSP", lambda p: p.startswith((b"DanM", b"LinS"))),
    ("PCD", None),
    ("PIXAR", lambda p: p.startswith(b"\200\350\000\000")),
    ("PSD", lambda p: p.startswith(b"8BPS")),
    ("QOI", lambda p: p.startswith(b"qoif")),
    ("SGI", lambda p: len(p) >= 2 and _i16(p, 0, ">") == 474),
    ("SPIDER", None),
    ("SUN", lambda p: len(p) >= 4 and _i32(p, 0, ">") == 0x59A66A95),
    ("TGA", None),
    ("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP" and p[12:16] in _WEBP_MODES),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"))),
    ("XBM", lambda p: p.lstrip().startswith(b"#define")),
    ("XPM", lambda p: p.startswith(b"/* XPM */")),
    ("XVTHUMB", lambda p: p.startswith(b"P7 332")),
)


def accepts(accept, prefix: bytes) -> bool:
    try:
        return accept is None or bool(accept(prefix))
    except Skip:
        return False


def _size(w: int, h: int) -> None:
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")


# Each checker mirrors the plugin's _open up to where Pillow knows the
# image's size and mode; it raises Skip or ValueError where _open gives up.

def _blp(d: bytes) -> None:
    """BlpImageFile._open, then the decoder's offset and length tables:
    the first mip level must lie inside the file."""
    blp1 = d.startswith(b"BLP1")
    head = d[:28 if blp1 else 20]
    if len(head) < (28 if blp1 else 20):
        raise Skip("BLP: short header")
    compression, encoding = struct.unpack_from("<i", head, 4)[0], head[8]
    w, h = struct.unpack_from("<II", head, 12)
    if blp1:
        encoding = struct.unpack_from("<i", head, 20)[0]
    _size(w, h)
    ok = (compression == 0 or (compression == 1 and encoding in (4, 5))) if blp1 else (
        compression == 1 and encoding in (1, 2, 3))
    if not ok:
        raise ValueError(f"Unsupported BLP compression {compression} / encoding {encoding}")
    offset = len(head)
    if len(d) < offset + 128:
        raise ValueError("Truncated BLP file")
    offsets = struct.unpack_from("<16I", d, offset)
    lengths = struct.unpack_from("<16I", d, offset + 64)
    if offsets[0] + lengths[0] > len(d):
        raise ValueError("Truncated File Read")


def _pcx(d: bytes) -> None:
    s = d[:68]
    x0, y0, x1, y1 = _i16(s, 4), _i16(s, 6), _i16(s, 8) + 1, _i16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise Skip("bad PCX image size")
    if len(s) < 68:
        raise Skip("PCX: short header")
    version, bits, planes = s[1], s[3], s[65]
    if not ((bits == 1 and planes in (1, 2, 4)) or (version == 5 and bits == 8
                                                     and planes in (1, 3))):
        raise ValueError("unknown PCX mode")
    w = x1 - x0
    stride = (w * bits + 7) // 8
    if _i16(s, 66) != stride:
        stride += stride % 2
    need, pos = planes * stride * (y1 - y0), 128
    while need > 0:  # PcxDecode.c: runs (0xC0 | n, byte) and literal bytes
        if pos >= len(d):
            raise ValueError("image file is truncated")
        c = d[pos]
        if c & 0xC0 == 0xC0:
            if pos + 1 >= len(d):
                raise ValueError("image file is truncated")
            need -= c & 0x3F
            pos += 2
        else:
            need -= 1
            pos += 1


def _dcx(d: bytes) -> None:
    f = Reader(d, 4)
    offsets = []
    for _ in range(1024):
        off = _i32(f.read(4))
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise Skip("DCX: no frames")
    frame = d[offsets[0]:]
    if not (len(frame) >= 2 and frame[0] == 10 and frame[1] in (0, 2, 3, 5)):
        raise Skip("not a PCX file")
    _pcx(frame)


def _fits(d: bytes) -> None:
    f = Reader(d)
    headers: dict[bytes, bytes] = {}
    in_progress = False
    found = False
    while True:
        header = f.read(80)
        if not header:
            raise ValueError("Truncated FITS file")
        keyword = header[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            f.pos = math.ceil(f.pos / 2880) * 2880
            if not found:
                naxis = int(headers.get(b"NAXIS", b"0"))
                if naxis:
                    _size(int(headers.get(b"NAXIS1", b"0")), int(headers.get(b"NAXIS2", b"1")
                                                               if naxis > 1 else b"1"))
                    found = True
            in_progress = False
            continue
        if found:
            continue
        value = header[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise Skip("Not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("No image data")


def _fli(d: bytes) -> None:
    s = d[:128]
    if not (len(s) >= 16 and s[20:22] == b"\x00" * 2 and s[42:80] == b"\x00" * 38
            and s[88:] == b"\x00" * 40):
        raise Skip("not an FLI/FLC file")
    _i32(s, 16)
    _size(_i16(s, 8), _i16(s, 10))
    _i16(d[128:144], 4)  # the first chunk's header: struct.error when short


def _ftex(d: bytes) -> None:
    f = Reader(d, 4)
    if len(f.read(4)) < 4:
        raise Skip("FTEX: short read")
    head = f.read(16)
    if len(head) < 16:
        raise Skip("FTEX: short read")
    w, h, _mips, count = struct.unpack("<4i", head)
    if count != 1:
        raise ValueError("FTEX: format count is not 1")  # an AssertionError in Pillow
    fmt_where = f.read(8)
    if len(fmt_where) < 8:
        raise Skip("FTEX: short read")
    fmt, where = struct.unpack("<2i", fmt_where)
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt}")
    _size(w, h)
    if where < 0 or len(d) < where + 4:
        raise Skip("FTEX: short read")
    (size,) = struct.unpack_from("<i", d, where)
    got = max(0, min(size, len(d) - where - 4))
    need = ((w + 3) // 4) * ((h + 3) // 4) * 8 if fmt == 0 else w * h * 3
    if got < need:
        raise ValueError("image file is truncated")


def _gbr(d: bytes) -> None:
    f = Reader(d)
    hs = _i32(f.read(4), 0, ">")
    if hs < 20:
        raise Skip("not a GIMP brush")
    version = _i32(f.read(4), 0, ">")
    if version not in (1, 2):
        raise Skip("Unsupported GIMP brush version")
    w, h, depth = (_i32(f.read(4), 0, ">") for _ in range(3))
    if w == 0 or h == 0 or depth not in (1, 4):
        raise Skip("not a GIMP brush")
    if version == 2:
        if f.read(4) != b"GIMP":
            raise Skip("not a GIMP brush, bad magic number")
        _i32(f.read(4), 0, ">")
    f.read(hs - (20 if version == 1 else 28))
    if len(d) - f.pos < w * h * depth:
        raise ValueError("not enough image data")


def _icns(d: bytes) -> None:
    if len(d) < 8:
        raise Skip("icns: short header")
    (filesize,) = struct.unpack_from(">i", d, 4)
    if filesize <= 8:
        raise Skip("icns: no entries")
    pos = 8
    while pos < filesize:
        if pos + 8 > len(d):
            raise ValueError("icns: truncated entry header")
        (size,) = struct.unpack_from(">i", d, pos + 4)
        if size <= 8 or pos + size > len(d):
            raise ValueError("image file is truncated")
        body = d[pos + 8:pos + size]
        if body.startswith(b"\x89PNG\r\n\x1a\n"):
            from gatling_tpu_torch.imgio import decode_png

            decode_png(body)
        pos += size


def _im(d: bytes) -> None:
    if b"\n" not in d[:100]:
        raise Skip("not an IM file")
    split = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
    tags = {"Comment", "Date", "Equipment", "File size", "Frame size", "Image type", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)"}
    f = Reader(d)
    n = 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + f.readline()
        if len(s) > 100:
            raise Skip("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = split.match(s)
        if not m:
            raise Skip("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k == "Image size (x*y)":
            try:
                v = tuple(int(x) if x.isdigit() else float(x) for x in v.replace("*", ",")
                          .split(","))
            except ValueError as e:
                raise ValueError("IM: bad size") from e
        info[k] = v
        if k in tags:
            n += 1
    if not n:
        raise Skip("Not an IM file")
    size = info["Image size (x*y)"]
    if not isinstance(size, tuple) or len(size) != 2:
        raise Skip("IM: bad size")
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise Skip("File truncated")
    _size(*size)
    kind = info["Image type"]
    if kind not in _IM_BITS:
        raise ValueError("unrecognized image mode")
    lut = 768 if "Lut" in info else 0
    w, h = size
    if _IM_BITS[kind] and len(d) - f.pos - lut < h * ((w * _IM_BITS[kind] + 7) // 8):
        raise ValueError("image file is truncated")


# ImImagePlugin.OPEN's image types, by the bits a pixel of each takes
# (0: Pillow's bit decoder, not checked; "L": no type line, Pillow's default)
_IM_BITS = {"L": 8, "0 1 image": 1, "L 1 image": 1, "Greyscale image": 8, "Grayscale image": 8,
            "RGB image": 24, "RLB image": 24, "RYB image": 24, "B1 image": 1, "B2 image": 2,
            "B4 image": 4, "X 24 image": 24, "L 32 S image": 32, "L 32 F image": 32,
            "RGB3 image": 24, "RYB3 image": 24, "LA image": 16, "PA image": 16,
            "RGBA image": 32, "RGBX image": 32, "CMYK image": 32, "YCC image": 24,
            **{f"L{s} {i} image": b for s in (" ", "*")
               for i, b in (("8", 8), ("8S", 8), ("16", 16), ("16S", 16), ("32", 32),
                            ("32F", 32), ("16L", 16), ("16B", 16), ("32S", 32))},
            **{f"L*{j} image": (j if j in (8, 16, 32) else 0) for j in range(2, 33)}}


def _imt(d: bytes) -> None:
    if b"\n" not in d[:100]:
        raise Skip("not an IM file")
    field = re.compile(rb"([a-z]*) ([^ \r\n]*)")
    f = Reader(d, min(100, len(d)))
    buffer = d[:100]
    w = h = 0
    mode = ""
    tile = False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = f.read(1)
        if not s:
            break
        if s == b"\x0c":
            tile = True
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
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode:
        raise Skip("not identified by this plugin")
    if not tile:
        raise Skip("IMT: no image data")
    _size(w, h)
    if len(d) - (f.pos - len(buffer)) < w * h:
        raise ValueError("image file is truncated")


def _iptc(d: bytes) -> None:
    f = Reader(d)
    info: dict = {}
    tag = None
    while True:
        s = f.read(5)
        if not s.strip(b"\x00"):
            break
        if len(s) < 3:
            raise Skip("IPTC: short field")
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise Skip("invalid IPTC/NAA file")
        size = s[3] if len(s) > 3 else None
        if size is None:
            raise Skip("IPTC: short field")
        if size > 132:
            raise ValueError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _i32(f.read(size - 128), 0, ">")
        else:
            size = _i16(s, 3, ">")
        if tag == (8, 10):
            break
        info[tag] = f.read(size) if size else None
    if (3, 60) not in info:
        raise Skip("IPTC: no (3, 60) record")
    if tag != (8, 10):
        raise ValueError("cannot load this image")
    while True:  # IptcImageFile.load: the (8, 10) records, then one more field
        s = f.read(5)
        if not s.strip(b"\x00"):
            break
        if s[0] != 0x1C or len(s) < 5 or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise ValueError("invalid IPTC/NAA file")
        if (s[1], s[2]) != (8, 10):
            break
        f.read(struct.unpack_from(">H", s, 3)[0] if s[3] < 128 else 0)


def _mcidas(d: bytes) -> None:
    s = d[:256]
    if len(s) != 256:
        raise Skip("not an McIdas area file")
    w = (0, *struct.unpack("!64i", s))
    if w[11] not in (1, 2, 4):
        raise Skip("unsupported McIdas format")
    _size(w[10], w[9])
    offset, stride, line = w[34] + w[15], w[15] + w[10] * w[11] * w[14], w[10] * w[11]
    if stride < line or len(d) < offset + stride * (w[9] - 1) + line:
        raise ValueError("image file is truncated")


def _msp(d: bytes) -> None:
    s = d[:32]
    checksum = 0
    for k in range(0, 32, 2):
        checksum ^= _i16(s, k)
    if checksum != 0:
        raise Skip("bad MSP checksum")
    w, h = _i16(s, 4), _i16(s, 6)
    _size(w, h)
    if d.startswith(b"DanM") and len(d) < 32 + (w + 7) // 8 * h:
        raise ValueError("image file is truncated")


def _pcd(d: bytes) -> None:
    s = d[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise Skip("not a PCD file")
    if len(s) < 1539:
        raise Skip("PCD: short header")
    if len(d) < 96 * 2048 + 768 * 512 * 3 // 2:
        raise ValueError("image file is truncated")


def _pixar(d: bytes) -> None:
    s = d[:512]
    _size(_i16(s, 418), _i16(s, 416))
    if (_i16(s, 424), _i16(s, 426)) != (14, 2):
        raise Skip("not identified by this plugin")
    if len(d) < 1024 + 3 * _i16(s, 418) * _i16(s, 416):
        raise ValueError("image file is truncated")


def _sgi(d: bytes) -> None:
    s = d[:512]
    modes = {(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3), (2, 3, 3), (1, 3, 4),
             (2, 3, 4)}
    key = (s[3] if len(s) > 3 else None, _i16(s, 4, ">"), _i16(s, 10, ">"))
    _i16(s, 6, ">")
    _i16(s, 8, ">")
    if len(s) < 4:
        raise Skip("SGI: short header")
    if key not in modes:
        raise ValueError("Unsupported SGI image mode")
    if s[2] not in (0, 1):
        raise Skip("not identified by this plugin")
    w, h = _i16(s, 6, ">"), _i16(s, 8, ">")
    _size(w, h)
    if s[2] == 0 and len(d) < 512 + w * h * s[3] * key[2]:
        raise ValueError("image file is truncated")


def _spider_header(t: tuple) -> int:
    h = (99, *t)

    def is_int(v) -> bool:
        try:
            return v - int(v) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[k]) for k in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider(d: bytes) -> None:
    f = d[:108]
    if len(f) < 108:
        raise Skip("not a valid Spider file")
    t = struct.unpack(">27f", f)
    n = _spider_header(t)
    if n == 0:
        t = struct.unpack("<27f", f)
        n = _spider_header(t)
    if n == 0:
        raise Skip("not a valid Spider file")
    h = (99, *t)
    if int(h[5]) != 1:
        raise Skip("not a Spider 2D image")
    istack, imgnumber = int(h[24]), int(h[27])
    if istack < 0 or imgnumber < 0 or (istack > 0 and imgnumber > 0):
        raise Skip("inconsistent stack header values")
    w, ht = int(h[12]), int(h[2])
    _size(w, ht)
    if istack == 0 and imgnumber == 0 and len(d) < n + 4 * w * ht:
        raise ValueError("image file is truncated")


def _sun(d: bytes) -> None:
    s = d[:32]
    w, h, depth = _i32(s, 4, ">"), _i32(s, 8, ">"), _i32(s, 12, ">")
    file_type, palette_type, palette_length = (_i32(s, k, ">") for k in (20, 24, 28))
    if depth not in (1, 4, 8, 24, 32):
        raise Skip("Unsupported Mode/Bit Depth")
    if palette_length and (palette_length > 1024 or palette_type != 1):
        raise Skip("Unsupported Color Palette")
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise Skip("Unsupported Sun Raster file type")
    _size(w, h)
    if file_type != 2:
        stride = ((w * depth + 15) // 16) * 2
        bits = {1: 1, 4: 4, 8: 8, 24: 24, 32: 32}[depth]
        if len(d) < 32 + palette_length + stride * (h - 1) + (w * bits + 7) // 8:
            raise ValueError("image file is truncated")


def _xbm(d: bytes) -> None:
    head = re.compile(
        rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
        rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
        rb"(?P<hotspot>"
        rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
        rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
        rb")?"
        rb"[\000-\377]*_bits\[]")
    m = head.match(d[:512])
    if not m:
        raise Skip("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    _size(w, h)
    if len(re.findall(rb"0x[0-9A-Fa-f]{2}", d[m.end():])) < (w + 7) // 8 * h:
        raise ValueError("image file is truncated")


def _xpm(d: bytes) -> None:
    head = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
    f = Reader(d, 9)
    while True:
        line = f.readline()
        if not line:
            raise Skip("broken XPM file")
        m = head.match(line)
        if m:
            break
    try:
        w, h, n, bpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise ValueError("XPM: bad header") from e
    keys = set()
    for _ in range(n):
        line = f.readline().rstrip()
        keys.add(line[1:bpp + 1])
        s = line[bpp + 1:-2].split()
        for k in range(0, len(s), 2):
            if s[k] == b"c":
                rgb = s[k + 1] if k + 1 < len(s) else None
                if rgb is None:
                    raise Skip("XPM: short colour entry")
                if rgb != b"None" and not rgb.startswith(b"#"):
                    raise ValueError("cannot read this XPM file")
                if rgb.startswith(b"#"):
                    try:
                        int(rgb[1:], 16)
                    except ValueError as e:
                        raise ValueError("cannot read this XPM file") from e
                break
        else:
            raise ValueError("cannot read this XPM file")
    _size(w, h)
    for _ in range(h):  # XpmDecoder: each row's pixels from its palette
        row = f.readline()[1:1 + w * bpp]
        if len(row) < w * bpp:
            raise ValueError("not enough image data")
        if any(row[k:k + bpp] not in keys for k in range(0, w * bpp, bpp)):
            raise ValueError("XPM: a pixel outside the palette")


def _xvthumb(d: bytes) -> None:
    f = Reader(d, 6)
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
    if len(d) - f.pos < w * h:
        raise ValueError("image file is truncated")


def _boxes_fill(d: bytes, pos: int = 0) -> bool:
    """The ISOBMFF / JP2 top-level boxes from pos reach the data's end
    exactly (a cut file's last box runs past it)."""
    while pos < len(d):
        if pos + 8 > len(d):
            return False
        (size,) = struct.unpack_from(">I", d, pos)
        if size == 1:
            if pos + 16 > len(d):
                return False
            (size,) = struct.unpack_from(">Q", d, pos + 8)
        elif size == 0:
            return True
        if size < 8 or pos + size > len(d):
            return False
        pos += size
    return True


def _avif(d: bytes) -> None:
    if not _boxes_fill(d):
        raise ValueError("AVIF: a box runs past the end of the file")


def _never(reason: str):
    def check(d: bytes) -> None:
        raise ValueError(reason)
    return check


# formats Pillow opens here but that the port does not decode: the check
# of each, and whether Pillow can load such an image here at all
UNPORTED_OPEN = {
    "AVIF": _avif, "BLP": _blp, "PCX": _pcx, "DCX": _dcx, "FITS": _fits, "FLI": _fli,
    "FTEX": _ftex, "GBR": _gbr, "ICNS": _icns, "IM": _im, "IMT": _imt,
    "IPTC": _iptc, "MCIDAS": _mcidas, "MSP": _msp, "PCD": _pcd, "PIXAR": _pixar, "SGI": _sgi,
    "SPIDER": _spider, "SUN": _sun, "XBM": _xbm, "XPM": _xpm,
    "XVTHUMB": _xvthumb,
    "EPS": _never("EPS images need Ghostscript, which Pillow does not find"),
    "WMF": _never("WMF images are drawn only on Windows"),
    "BUFR": _never("no BUFR handler is installed"),
    "GRIB": _never("no GRIB handler is installed"),
    "HDF5": _never("no HDF5 handler is installed"),
    "MPEG": _never("Pillow's MPEG plugin reads only the header"),
}


def open_unported(name: str, data: bytes) -> None:
    """The header checks of an unported plugin: Skip to try the next
    plugin, ValueError where Pillow gives up, else NotImplementedError."""
    UNPORTED_OPEN[name](data)
    raise NotImplementedError(f"{name} images are not ported {UNPORTED}")
