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
NotImplementedError (AVIF), or ValueError for the formats Pillow cannot
load here at all (EPS without Ghostscript, WMF off Windows, the BUFR,
GRIB and HDF5 stubs without a handler, and MPEG, whose plugin only reads
a header).
"""

from __future__ import annotations

import struct

from gatling_tpu_torch.imgio.modes import Skip

UNPORTED = "(ROADMAP: 'USD content')"


def i16(s: bytes, at: int = 0, bo: str = "<") -> int:
    """Pillow's i16 at `at`: Skip (its struct.error) on a short read."""
    if len(s) < at + 2:
        raise Skip("short read")
    return struct.unpack_from(bo + "H", s, at)[0]


def i32(s: bytes, at: int = 0, bo: str = "<") -> int:
    """Pillow's i32 at `at`: Skip (its struct.error) on a short read."""
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
    ("DIB", lambda p: len(p) >= 4 and i32(p) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a"))),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff")),
    ("PPM", lambda p: len(p) >= 2 and p.startswith(b"P") and p[1] in b"0123456fy"),
    ("PNG", lambda p: p.startswith(b"\x89PNG\r\n\x1a\n")),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2"))),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0")),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)),
    ("DCX", lambda p: len(p) >= 4 and i32(p) == 987654321),
    ("DDS", lambda p: p.startswith(b"DDS ")),
    ("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and i32(p) == 0xC6D3D0C5)),
    ("FITS", lambda p: p.startswith(b"SIMPLE")),
    ("FLI", lambda p: len(p) >= 16 and i16(p, 4) in (0xAF11, 0xAF12) and i16(p, 14) in (0, 3)),
    ("FTEX", lambda p: p.startswith(b"FTEX")),
    ("GBR", lambda p: len(p) >= 8 and i32(p, 0, ">") >= 20 and i32(p, 4, ">") in (1, 2)),
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
    ("SGI", lambda p: len(p) >= 2 and i16(p, 0, ">") == 474),
    ("SPIDER", None),
    ("SUN", lambda p: len(p) >= 4 and i32(p, 0, ">") == 0x59A66A95),
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
    "AVIF": _avif,
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
