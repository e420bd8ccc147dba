"""TIFF decoder and writer, as Pillow 12.1 reads and writes TIFF (through
its libtiff 4.7.1 for compressed files; the JAX package's imgio goes
through Pillow).

Read: the first image of a little- or big-endian TIFF or BigTIFF, in
strips or tiles, planar configuration 1 or 2, compressed with
- none (Pillow's raw decoder); LZW (new style by the native library's
  gatling_tiff_lzw_decode; old style, LSB first, by
  gatling_tiff_lzw_compat_decode); Deflate (both tags, Python's zlib);
  PackBits (gatling_tiff_packbits_decode);
- CCITT Modified Huffman (2), RLEW (32771), T.4 (3, 1D or 2D by
  T4Options) and T.6 (4): libtiff's tif_fax3.c in the native
  gatling_tiff_fax_decode (csrc/tiff_codecs.cpp), the bits in the file's
  fill order; a T.4 strip whose EOL search runs out of data decoded again
  without EOLs, as libtiff does;
- LZMA (34925): each strip an xz stream through the native
  gatling_tiff_xz_decode (csrc/tiff_codecs.cpp: liblzma's stream, block
  and LZMA2 decoders with their checks, the delta and every branch
  filter), as libtiff's one lzma_code
  call writes it: the strip is kept when its last byte is written, an
  error met after it unseen;
- ZSTD (50000): the strip's first frame by the native
  gatling_tiff_zstd_decode (RFC 8878, as libzstd 1.5.7's
  ZSTD_decompressStream hands it to libtiff: a dictionary refused, the
  content checksum verified, damaged four-stream literals read on past
  their streams as libzstd's fast Huffman path reads them);
- ThunderScan (32809, 4-bit grey): tif_thunder.c in the native
  gatling_tiff_thunder_decode;
- JPEG (7): each strip or tile a JPEG stream completed by the JPEGTables
  tag, decoded by jpeg.py with tif_jpeg.c's checks (its component count and
  sampling), a contiguous YCbCr image converted to RGB by libjpeg, any
  other layout (RGBA with an extra sample, planes, CMYK) as coded;
- old-style JPEG (6): tif_ojpeg.c's one stream over the strips or tiles
  (`_OJpeg`: the header at JPEGInterchangeFormat, or in the first strip, or
  made from the JPEGQTables, JPEGDCTables and JPEGACTables tags; RST
  markers between striles), libtiff's directory fix-ups (RGB is YCbCr);
with predictor 2 (horizontal differencing of 8-, 16- or 32-bit samples) or
3 (floating point), which libtiff applies to LZW, Deflate, LZMA and ZSTD
strips (TIFFPredictorInit) by its own reading of the samples; bit fill
order 2. SGILog (34676, 34677) on a photometric other than LogL or LogLuv,
and WebP (50001, not configured in this libtiff), raise ValueError, as
Pillow fails on them.

Pillow's mode and raw mode come from its own reading of the directory
(`_ifd`) and its OPEN_INFO table, copied here (`OPEN_INFO`): a layout it
lacks is given up, as Pillow gives it up, and the array each raw mode gives
is Pillow's. A compressed file's layout (strips or tiles, their offsets and
byte counts, rows per strip, planar configuration, fill order, predictor) is
libtiff's reading of the same directory (`_libtiff_directory`,
tif_dirread.c TIFFReadDirectory: the tags it must read or refuse the file,
those it leaves unset when they do not read, strip arrays padded with zeros,
byte counts estimated), decoded as Pillow's libtiff decoder does
(`_read_libtiff`: its rows must be libtiff's; each strip through
TIFFFillStrip's byte-count checks); an uncompressed file is Pillow's raw
decoder over Pillow's reading:
- 1-bit grey: bool (WhiteIsZero inverted); 2- and 4-bit grey scaled to
  8 bits (x 85, x 17); 8-bit grey, grey + alpha, RGB and RGBA: the codes
  (WhiteIsZero inverted; associated alpha divided out as Pillow's "RGBa"
  unpacker does; unspecified extra samples dropped);
- 12- and 16-bit grey: float32 code / 65535 (Pillow's "I;16"); signed
  16-bit and 32-bit integer grey: Pillow's "I", the same division;
  16-bit RGB, RGBA and CMYK: the high byte of each sample;
- 32-bit float grey: the floats (Pillow's "F"; in a compressed big-endian
  file each float's bytes swapped, as Pillow reads them);
- palette images (1, 2, 4 and 8 bits): their ColorMap's high bytes, as
  Pillow converts "P" to RGBA; CMYK: Pillow's CMYK to RGBA conversion;
- CIE Lab: its L*, a* and b* samples as stored, three bands the JAX
  package takes for RGB.
Planar configuration 2: uncompressed, Pillow's raw decoder takes each plane
by the character of the raw mode at its place (`_read_samples`); compressed,
Pillow's per-plane unpackers copy 8- or 16-bit planes (the high byte) into
its four-byte pixels (an LA image's alpha stays 0, CIE Lab's a and b read
unsigned), other depths fail.
A YCbCr image other than JPEG's, old-style JPEG's included, goes through
libtiff's RGBA interface (`_read_rgba`, tif_getimage.c: data units of the
YCbCrSubsampling tile routines, TIFFYCbCrToRGB over ReferenceBlackWhite and
YCbCrCoefficients); an uncompressed one Pillow reads past its strips and
fails (ValueError). The Orientation tag, or an XMP packet's
tiff:Orientation, transposes the image after the load, as
TiffImageFile.load_end does (ImageOps.exif_transpose).
In the RGBA interface a damaged strip keeps what its codec wrote, as
libtiff's buffer does: Deflate's and LZMA's prefix, LZW's and PackBits'
prefix then zeros, ZSTD's zeros (libzstd's failed call reports no
output). Where Pillow's array holds memory no decoder wrote (a T.6 strip
that ends before its last row), the port raises ValueError; old-style
JPEG in planes raises
NotImplementedError (ROADMAP Queue 3); a file Pillow gives up on raises
ValueError.

Write: uncompressed 8-bit grey, RGB or RGBA (unassociated alpha), one
strip, little-endian.
"""

from __future__ import annotations

import ctypes
import re
import struct
import zlib

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio import jpeg
from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish, unpack_bits

UNPORTED = "(ROADMAP: 'USD content')"
MAGICS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

# field types: (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
# Pillow's COMPRESSION_INFO codes by the port's codec name; the ones libtiff
# here cannot decode, with its reason
_COMPRESSIONS = {1: "none", 2: "ccitt", 3: "ccitt", 4: "ccitt", 32771: "ccitt", 5: "lzw",
                 6: "ojpeg", 7: "jpeg", 8: "deflate", 32946: "deflate", 32773: "packbits",
                 32809: "thunder", 34925: "lzma", 50000: "zstd"}
_REFUSED = {34676: "SGILog (LogLuvSetupDecode: not a LogL or LogLuv image)",
            34677: "SGILog (LogLuvSetupDecode: not a LogL or LogLuv image)",
            50001: "WebP (not configured in this libtiff)"}
_KNOWN_COMPRESSIONS = set(_COMPRESSIONS) | set(_REFUSED)
_PREDICTED = ("lzw", "deflate", "lzma", "zstd")  # TIFFPredictorInit's codecs


def _open_info() -> dict[tuple, tuple[str, str]]:
    """TiffImagePlugin.OPEN_INFO: (byte order, photometric, sample format,
    fill order, bits per sample, extra samples) -> (mode, raw mode)."""
    both = [  # the same for either byte order
        (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"),
        (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
        (0, (1,), 1, (2,), (), "L", "L;2I"), (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"),
        (0, (1,), 1, (4,), (), "L", "L;4I"), (0, (1,), 2, (4,), (), "L", "L;4IR"),
        (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
        (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"),
        (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
        (1, (1,), 2, (8,), (), "L", "L;R"), (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"), (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8,) * 4, (), "RGBA", "RGBA"), (2, (1,), 1, (8,) * 4, (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX"),
        (2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8,) * 4, (1,), "RGBA", "RGBa"),
        (2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"),
        (2, (1,), 1, (8,) * 4, (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"),
        (2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8,) * 4, (999,), "RGBA", "RGBA"),
        (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"),
        (3, (1,), 1, (2,), (), "P", "P;2"), (3, (1,), 2, (2,), (), "P", "P;2R"),
        (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
        (3, (1,), 1, (8,), (), "P", "P"), (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"), (3, (1,), 2, (8,), (), "P", "P;R"),
        (5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK"),
        (5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), (), "L", "L"), (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    by_order = [  # (II mode, II raw mode, MM mode, MM raw mode); None: no entry
        ((1, (1,), 1, (12,), ()), ("I;16", "I;12"), None),
        ((0, (1,), 1, (16,), ()), ("I;16", "I;16"), None),
        ((1, (1,), 1, (16,), ()), ("I;16", "I;16"), ("I;16B", "I;16B")),
        ((1, (1,), 2, (16,), ()), ("I;16", "I;16R"), None),
        ((1, (2,), 1, (16,), ()), ("I", "I;16S"), ("I", "I;16BS")),
        ((0, (3,), 1, (32,), ()), ("F", "F;32F"), ("F", "F;32BF")),
        ((1, (1,), 1, (32,), ()), ("I", "I;32N"), None),
        ((1, (2,), 1, (32,), ()), ("I", "I;32S"), ("I", "I;32BS")),
        ((1, (3,), 1, (32,), ()), ("F", "F;32F"), ("F", "F;32BF")),
        ((2, (1,), 1, (16,) * 3, ()), ("RGB", "RGB;16L"), ("RGB", "RGB;16B")),
        ((2, (1,), 1, (16,) * 4, ()), ("RGBA", "RGBA;16L"), ("RGBA", "RGBA;16B")),
        ((2, (1,), 1, (16,) * 4, (0,)), ("RGB", "RGBX;16L"), ("RGB", "RGBX;16B")),
        ((2, (1,), 1, (16,) * 4, (1,)), ("RGBA", "RGBa;16L"), ("RGBA", "RGBa;16B")),
        ((2, (1,), 1, (16,) * 4, (2,)), ("RGBA", "RGBA;16L"), ("RGBA", "RGBA;16B")),
        ((5, (1,), 1, (16,) * 4, ()), ("CMYK", "CMYK;16L"), ("CMYK", "CMYK;16B")),
    ]
    table = {}
    for photo, fmt, fill, bps, extra, mode, raw in both:
        for bo in ("<", ">"):
            table[(bo, photo, fmt, fill, bps, extra)] = (mode, raw)
    for key, ii, mm in by_order:
        table[("<", *key)] = ii
        if mm is not None:
            table[(">", *key)] = mm
    return table


OPEN_INFO = _open_info()
_MAX_SAMPLES = max(len(k[4]) for k in OPEN_INFO)
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def accepts(data: bytes) -> bool:
    return data[:4] in MAGICS


def _ifd(data: bytes, bo: str, big: bool) -> dict[int, tuple]:
    """The first IFD's fields as Pillow reads them: tag -> tuple of values
    (BigTIFF: 8-byte counts and offsets, 20-byte entries). As in Pillow's
    ImageFileDirectory_v2.load, an entry or a value that runs past the end
    of the data ends the directory, keeping the fields before it, and
    fields of no values or of an unknown type are left out."""
    if big:
        if len(data) < 16:
            raise Skip("TIFF: short BigTIFF header")
        (offset,) = struct.unpack_from(bo + "Q", data, 8)
        head, entry_size, count_code, inline = 8, 20, "Q", 8
    else:
        if len(data) < 8:
            raise Skip("TIFF: short header")
        (offset,) = struct.unpack_from(bo + "I", data, 4)
        head, entry_size, count_code, inline = 2, 12, "I", 4
    fields: dict[int, tuple] = {}
    if offset + head > len(data):
        return fields
    (n,) = struct.unpack_from(bo + ("Q" if big else "H"), data, offset)
    for k in range(n):
        at = offset + head + entry_size * k
        entry = data[at:at + entry_size]
        if len(entry) < entry_size:
            return fields
        tag, typ, count = struct.unpack_from(bo + "HH" + count_code, entry)
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= inline:
            raw = entry[entry_size - inline:entry_size - inline + nbytes]
        else:
            (pos,) = struct.unpack_from(bo + count_code, entry, entry_size - inline)
            raw = data[pos:pos + nbytes]
            if len(raw) < nbytes:
                return fields
        if not raw:
            continue
        fields[tag] = struct.unpack(bo + code * count, raw) if typ not in (2, 7) else (raw,)
    return fields


# libtiff's view of the first directory (tif_dirread.c TIFFReadDirectory),
# which Pillow's libtiff decoder opens for a compressed file: the values it
# decodes by, or the failure that makes Pillow raise "decoder error -2"
_LT_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
            16: 8, 17: 8, 18: 8}
_LT_INT = {1: "B", 6: "b", 3: "H", 8: "h", 4: "I", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_LT_ARRAY_TYPES = (1, 6, 3, 8, 4, 9, 16, 17)  # TIFFReadDirEntry*Array: integers only
NO_ROWS = 0xFFFFFFFF  # td_rowsperstrip when the tag is absent


class _LibtiffError(ValueError):
    """libtiff refuses the directory or a strip (Pillow's decoder error -2)."""


def _lt_values(data: bytes, bo: str, big: bool, e: tuple, types) -> list[int]:
    """TIFFReadDirEntry*Array: the integer values of entry e (type, count,
    value field), read inline or at its offset in the mapped file."""
    typ, count, field = e
    if typ not in types:
        raise _LibtiffError("TIFF: incompatible type")
    size = _LT_SIZE[typ] * count
    if size <= len(field):
        raw = field[:size]
    else:
        (off,) = struct.unpack_from(bo + ("Q" if big else "I"), field)
        if off > len(data) or size > len(data) - off:
            raise _LibtiffError("TIFF: IO error reading a tag")
        raw = data[off:off + size]
    vals = list(struct.unpack(bo + _LT_INT[typ] * count, raw)) if count else []
    if any(v < 0 for v in vals):
        raise _LibtiffError("TIFF: a negative value")
    return vals


def _lt_one(data, bo, big, e, limit: int) -> int:
    """TIFFReadDirEntryShort / Long: one value of an integer type in range."""
    if e[1] != 1:
        raise _LibtiffError("TIFF: incorrect count")
    (v,) = _lt_values(data, bo, big, e, (*_LT_ARRAY_TYPES, 13, 18) if limit > 0xFFFF else
                      _LT_ARRAY_TYPES)
    if v > limit:
        raise _LibtiffError("TIFF: value out of range")
    return v


def _lt_per_sample(data, bo, big, e, spp: int) -> int:
    """TIFFReadDirEntryShort, else (a count error) the per-sample form: at
    least spp values, the first spp equal."""
    if e[1] == 1:
        return _lt_one(data, bo, big, e, 0xFFFF)
    if e[1] < spp:
        raise _LibtiffError("TIFF: incorrect count")
    vals = _lt_values(data, bo, big, e, _LT_ARRAY_TYPES)
    if any(v > 0xFFFF for v in vals) or len(set(vals[:spp])) > 1:
        raise _LibtiffError("TIFF: per-sample values differ")
    return vals[0]


def _libtiff_directory(data: bytes, bo: str, big: bool) -> dict:
    """TIFFReadDirectory of the first IFD, memory-mapped as Pillow's decoder
    maps its buffer. Raises _LibtiffError where libtiff gives up."""
    (off,) = struct.unpack_from(bo + ("Q" if big else "I"), data, 8 if big else 4)
    head, size, cnt = (8, 20, "Q") if big else (2, 12, "I")
    if off + head > len(data):
        raise _LibtiffError("TIFF: cannot read the directory count")
    (n,) = struct.unpack_from(bo + ("Q" if big else "H"), data, off)
    if n > (65535 if big else 4096) or n == 0:
        raise _LibtiffError("TIFF: sanity check on the directory count failed")
    if off + head + size * n > len(data):
        raise _LibtiffError("TIFF: cannot read the directory")
    entries: dict[int, tuple] = {}
    for k in range(n):  # a repeated tag: its first entry counts
        at = off + head + size * k
        tag, typ, count = struct.unpack_from(bo + "HH" + cnt, data, at)
        entries.setdefault(tag, (typ, count, data[at + size - (8 if big else 4):at + size]))
    d = {"spp": 1, "compression": 1, "planar": 1, "rows": NO_ROWS, "fill": 1, "predictor": 1,
         "bits": 1, "format": 1, "photometric": 0}
    if 277 in entries:
        d["spp"] = _lt_one(data, bo, big, entries[277], 0xFFFF)
        if d["spp"] == 0:
            raise _LibtiffError("TIFF: bad SamplesPerPixel")
    if 259 in entries:
        d["compression"] = _lt_per_sample(data, bo, big, entries[259], d["spp"])
    # the first pass: the layout tags, whose failure ends the read
    dims = False
    for tag, e in entries.items():
        if tag in (256, 257, 322, 323):
            v = _lt_one(data, bo, big, e, 0xFFFFFFFF)
            d[{256: "width", 257: "height", 322: "tile_w", 323: "tile_l"}[tag]] = v
            dims = dims or tag in (256, 257)
        elif tag == 284:
            d["planar"] = _lt_one(data, bo, big, e, 0xFFFF)
            if d["planar"] not in (1, 2):
                raise _LibtiffError("TIFF: bad PlanarConfiguration")
        elif tag == 278:
            d["rows"] = _lt_one(data, bo, big, e, 0xFFFFFFFF)
            if d["rows"] == 0:
                raise _LibtiffError("TIFF: bad RowsPerStrip")
        elif tag == 338:
            vals = _lt_values(data, bo, big, e, _LT_ARRAY_TYPES) if e[1] <= 0xFFFF else None
            if vals is None or len(vals) > d["spp"] or any(v > 2 and v != 999 for v in vals):
                raise _LibtiffError("TIFF: bad ExtraSamples")
    if not dims:
        raise _LibtiffError("TIFF: missing ImageLength")
    w, h, spp = d.get("width", 0), d.get("height", 0), d["spp"]
    tiled = "tile_w" in d or "tile_l" in d
    if tiled:
        tw, tl = d.get("tile_w", 0), d.get("tile_l", 0)
        across = -(-w // tw) if tw else 0
        down = -(-h // tl) if tl else 0
        per_plane = across * down
    else:
        per_plane = 1 if d["rows"] == NO_ROWS else -(-h // d["rows"])
    nstrips = per_plane * (spp if d["planar"] == 2 else 1)
    if nstrips == 0:
        raise _LibtiffError("TIFF: zero strips")
    if 273 not in entries and 324 not in entries:
        raise _LibtiffError("TIFF: missing StripOffsets")
    # the second pass: the per-sample tags and the strip arrays must read;
    # any other tag that does not is left unset
    for tag, e in entries.items():
        if tag in (258, 339):
            v = _lt_per_sample(data, bo, big, e, spp)
            if tag == 339 and not 1 <= v <= 6:
                raise _LibtiffError("TIFF: bad SampleFormat")
            d["bits" if tag == 258 else "format"] = v
        elif tag in (273, 324, 279, 325):
            vals = _lt_values(data, bo, big, e, _LT_ARRAY_TYPES)
            d["counts" if tag in (279, 325) else "offsets"] = (
                vals[:nstrips] + [0] * (nstrips - len(vals)))
        elif tag in (262, 266, 317):
            try:
                v = _lt_one(data, bo, big, e, 0xFFFF)
            except _LibtiffError:
                continue
            if tag != 266 or v in (1, 2):
                d[{262: "photometric", 266: "fill", 317: "predictor"}[tag]] = v
                d["photometric_set"] = d.get("photometric_set", False) or tag == 262
    if d["photometric"] == 3 and 320 not in entries and d["bits"] < 8:
        raise _LibtiffError("TIFF: missing Colormap")
    counts = d.get("counts")
    if counts is None:
        if (d["planar"] == 1 and nstrips > 1) or (d["planar"] == 2 and nstrips != spp):
            raise _LibtiffError("TIFF: missing StripByteCounts")
        counts = _estimate_counts(data, d, entries, big, nstrips)
    elif nstrips == 1 and not tiled and d["offsets"][0] != 0 and counts[0] == 0:
        counts = _estimate_counts(data, d, entries, big, nstrips)
    d["counts"] = counts
    row_samples = w * (spp if d["planar"] == 1 else 1)
    d["scanline"] = (row_samples * d["bits"] + 7) // 8
    if d["scanline"] == 0:
        raise _LibtiffError("TIFF: zero scanline size")
    d["entries"], d["bo"], d["big"] = entries, bo, big
    return d


def _lt_tag(data: bytes, lt: dict, tag: int, count: int | None = None) -> list | None:
    """TIFFFetchNormalTag of a tag libtiff reads by its value: the values
    (integers; floats of a rational or float type, as float32), or None
    where the tag is absent, of another count than `count`, or unreadable
    (libtiff then ignores it)."""
    e = lt["entries"].get(tag)
    if e is None or (count is not None and e[1] != count):
        return None
    typ, n, field = e
    bo = lt["bo"]
    if typ in (5, 10, 11, 12):
        size = {5: 8, 10: 8, 11: 4, 12: 8}[typ] * n
        if size <= len(field):
            raw = field[:size]
        else:
            (off,) = struct.unpack_from(bo + ("Q" if lt["big"] else "I"), field)
            if off > len(data) or size > len(data) - off:
                return None
            raw = data[off:off + size]
        if typ in (11, 12):
            return [np.float32(v) for v in struct.unpack(bo + ("f" if typ == 11 else "d") * n, raw)]
        v = struct.unpack(bo + ("I" if typ == 5 else "i") * 2 * n, raw)
        num, den = (np.float32(x) for x in v[0::2]), (np.float32(x) for x in v[1::2])
        return [np.float32(0) if d == 0 else np.float32(a / d) for a, d in zip(num, den)]
    try:
        return _lt_values(data, bo, lt["big"], e, (*_LT_ARRAY_TYPES, 13, 18))
    except _LibtiffError:
        return None


def _estimate_counts(data: bytes, d: dict, entries: dict, big: bool, nstrips: int) -> list:
    """EstimateStripByteCounts of a compressed file: the file past the
    header, the directory and its out-of-line values, shared by every
    strip, the last trimmed to the file's end."""
    space = (16 + 8 + 20 * len(entries) + 8) if big else (8 + 2 + 12 * len(entries) + 4)
    for typ, count, _field in entries.values():
        size = _LT_SIZE.get(typ, 0) * count
        space += size if size > (8 if big else 4) else 0
    space = len(data) if len(data) < space else len(data) - space
    if d["planar"] == 2:
        space //= d["spp"]
    counts = [space] * nstrips
    last = d["offsets"][-1]
    if last + counts[-1] > len(data):
        counts[-1] = 0 if last >= len(data) else len(data) - last
    return counts


def _native_decode(fn, blob: bytes, n: int, partial: bool = False) -> np.ndarray:
    """A native codec's n bytes. Its error returns -2 - the bytes it wrote
    before it (what libtiff's buffer keeps, with `partial`)."""
    src = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
    dst = np.zeros(n, np.uint8)
    got = fn(native.ptr(src, ctypes.c_uint8), src.size, native.ptr(dst, ctypes.c_uint8), n)
    if got < 0:
        if not partial:
            raise ValueError("TIFF: corrupt compressed data")
        got = -2 - got
    return dst[:got]


def _lzma(blob: bytes, n: int, partial: bool = False) -> np.ndarray:
    """tif_lzma.c LZMADecode: the strip's xz stream through liblzma's stream
    decoder in one lzma_code call with n bytes of room. The strip is kept
    when liblzma fills them, whatever error it meets after; else it fails,
    and the RGBA interface (`partial`) keeps what liblzma wrote before its
    error. The native decoder (csrc/tiff_codecs.cpp gatling_tiff_xz_decode)
    writes what liblzma writes (Python's lzma module drops the output of a
    call that meets an error)."""
    src = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
    dst = np.zeros(max(n, 1), np.uint8)
    status = ctypes.c_int32()
    got = native.library().gatling_tiff_xz_decode(
        native.ptr(src, ctypes.c_uint8), src.size, native.ptr(dst, ctypes.c_uint8), n,
        ctypes.byref(status))
    if got < n and not partial:
        raise ValueError(f"TIFF: corrupt LZMA data: {got} of the strip's {n} bytes")
    return dst[:got]


def _deflate_prefix(blob: bytes, n: int) -> bytes:
    """What zlib writes of a damaged Deflate stream before its error (fed in
    pieces: Python's zlib drops a call's output on an error)."""
    d, out = zlib.decompressobj(), b""
    for at in range(0, len(blob), 256):
        try:
            out += d.decompress(blob[at:at + 256], n - len(out))
        except zlib.error:
            break
        if len(out) >= n:
            break
    return out


def _decompress(kind: str, blob: bytes, n: int, partial: bool = False) -> np.ndarray:
    """One strip or tile's n bytes; with `partial`, what the codec writes
    of a short or damaged strip (libtiff keeps it), else ValueError."""
    if kind == "none":
        out = np.frombuffer(blob[:n], np.uint8)
    elif kind == "deflate":
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(blob, n), np.uint8)
        except zlib.error as e:
            if not partial:
                raise ValueError(f"TIFF: corrupt Deflate data: {e}") from e
            out = np.frombuffer(_deflate_prefix(blob, n), np.uint8)
    elif kind == "lzma":
        out = _lzma(blob, n, partial)
    else:
        lib = native.library()
        if kind == "lzw":
            old = len(blob) >= 2 and blob[0] == 0 and blob[1] & 1
            fn = lib.gatling_tiff_lzw_compat_decode if old else lib.gatling_tiff_lzw_decode
        else:
            fn = {"zstd": lib.gatling_tiff_zstd_decode,
                  "packbits": lib.gatling_tiff_packbits_decode}[kind]
        out = _native_decode(fn, blob, n, partial)
        if partial and out.size < n and (kind in ("packbits", "zstd") or (kind == "lzw" and
                                                                       not old)):
            # LZWDecode, PackBitsDecode and ZSTDDecode zero the rest of the
            # buffer when they fail (ZSTD's from 0: libzstd's failed call
            # reports no output), and a tile row's buffer loses what the
            # last tile left there
            out = np.concatenate([out, np.zeros(n - out.size, np.uint8)])
    if out.size < n and not partial:
        raise ValueError(f"TIFF: a {kind} strip or tile holds {out.size} of its {n} bytes")
    return out[:n]


def _predict(px: np.ndarray, predictor: int, spp: int, bits: int, bo: str) -> np.ndarray:
    """libtiff's view of a decompressed strip: rows [r, row bytes] in the
    file's byte order -> rows of native-order samples, the predictor undone
    (2: horizontal differencing modulo the sample width; 3: bytes
    differenced, then byte planes MSB first)."""
    r = px.shape[0]
    if predictor == 3:
        acc = px.reshape(r, -1, spp).astype(np.uint64).cumsum(axis=1).astype(np.uint8)
        planes = np.ascontiguousarray(acc.reshape(r, bits // 8, -1).transpose(0, 2, 1))
        return planes.view(">f4").astype("=f4").view(np.uint8).reshape(r, -1)
    if bits not in (16, 32):
        if predictor == 2:
            return (px.reshape(r, -1, spp).astype(np.uint64).cumsum(axis=1)
                    .astype(np.uint8).reshape(r, -1))
        return px
    dt = np.dtype(f"{bo}u{bits // 8}")
    vals = px.view(dt).astype(np.uint64)
    if predictor == 2:
        vals = vals.reshape(r, -1, spp).cumsum(axis=1) & np.uint64((1 << bits) - 1)
    return np.ascontiguousarray(vals.astype(f"=u{bits // 8}")).view(np.uint8).reshape(r, -1)


def _samples(rows: np.ndarray, w: int, spp: int, bits: int, fmt, dt_order: str) -> np.ndarray:
    """Byte rows [r, row bytes] -> sample values [r, w, spp]."""
    r = rows.shape[0]
    if bits < 8:
        return unpack_bits(rows, w, bits)[..., None]
    if bits == 12:  # Pillow's I;12 unpacker: MSB-first 12-bit pairs in 3 bytes
        b = rows[:, :(w * 12 + 7) // 8].astype(np.uint16)
        b = np.pad(b, ((0, 0), (0, (-b.shape[1]) % 3)))
        trip = b.reshape(r, -1, 3)
        even = (trip[..., 0] << 4) | (trip[..., 1] >> 4)
        odd = ((trip[..., 1] & 15) << 8) | trip[..., 2]
        return np.stack([even, odd], axis=-1).reshape(r, -1)[:, :w, None]
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt if isinstance(fmt, int) else 1, "u")
    dt = np.dtype(f"{dt_order}{kind}{bits // 8}")
    return rows[:, :w * spp * bits // 8].copy().view(dt).reshape(r, w, spp)


# ImageOps.exif_transpose, which TiffImageFile.load_end applies
_TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
              5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
              7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: np.rot90(a, 1)}
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')


def _orientation(f: dict) -> int | None:
    """The EXIF orientation Pillow reads (Image.getexif): the Orientation
    tag's one value, else an XMP packet's tiff:Orientation."""
    if 274 in f:
        return f[274][0] if len(f[274]) == 1 else None
    xmp = f.get(700)  # BYTE values, or UNDEFINED and ASCII bytes
    if xmp is not None:
        xmp = xmp[0] if len(xmp) == 1 and isinstance(xmp[0], bytes) else bytes(
            v & 255 for v in xmp if isinstance(v, int))
        m = _XMP_ORIENTATION.search(xmp)
        return int(m[2]) if m else None
    return None


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> [H, W, 4] RGBA: uint8, float32 (12-, 16- and 32-bit
    grey) or bool (1-bit grey), the JAX package's imgio.load_image(data).data."""
    if not accepts(data):
        raise Skip("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    # Pillow takes a file for BigTIFF by its third byte alone, so a
    # big-endian BigTIFF ("MM\x00+") is read as a classic TIFF
    f = _ifd(data, bo, data[2] == 0x2B)

    def one(tag, default=None):
        return f[tag][0] if tag in f else default

    if 0xBC01 in f:
        raise ValueError("Windows Media Photo files not yet supported")
    comp = one(259, 1)
    if comp not in _KNOWN_COMPRESSIONS:
        raise Skip(f"TIFF: unknown compression {comp}")
    planar = one(284, 1)
    photo = 6 if comp == 6 else one(262, 0)
    fill = one(266, 1)
    w, h = one(256), one(257)
    if w is None or h is None:
        raise Skip("Missing dimensions")
    fmt = f.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = f.get(258, (1,))
    extra = f.get(338, ())
    spp = one(277, 3 if comp == 6 and photo in (2, 6) else 1)
    if spp > _MAX_SAMPLES:
        raise Skip("Invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise Skip("unknown data organization")
    key = (bo, photo, tuple(fmt), fill, tuple(bps), tuple(extra))
    if key not in OPEN_INFO:
        raise Skip("unknown pixel mode")
    mode, raw = OPEN_INFO[key]
    if comp != 1 and fill == 2:
        key = key[:3] + (1,) + key[4:]
        if key not in OPEN_INFO:
            raise Skip("unknown pixel mode")
        mode, raw = OPEN_INFO[key]
    if mode in ("P", "PA") and 320 not in f:
        raise Skip("TIFF: a palette image without a ColorMap")
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    orient = _orientation(f)
    if comp in _REFUSED:
        raise ValueError(f"TIFF: libtiff here cannot decode compression {comp}: {_REFUSED[comp]}")
    kind = _COMPRESSIONS[comp]
    bits = bps[0]
    if kind == "none":
        if photo == 6:
            raise ValueError("TIFF: Pillow's raw YCbCr layout reads past its strips")
        if raw in _NO_RAW_UNPACKER:
            raise ValueError("unknown raw mode for given image mode")
        px, raw, bits = _read_samples(data, f, one, w, h, spp, bits, fmt, bo, planar, fill, mode,
                                      raw)
        out = _to_mode(px, mode, raw, bits, bo, kind, f, planar == 2 and _BANDS[mode] > 1)
    else:
        out = _decode_libtiff(data, f, bo, kind, w, h, spp, bits, fmt, mode, raw, photo)
    return _TRANSPOSE[orient](out) if orient in _TRANSPOSE else out


def _decode_libtiff(data, f, bo, kind, w, h, spp, bits, fmt, mode, raw, photo) -> np.ndarray:
    """A compressed image, as libtiff decodes it by its own reading of the
    directory and Pillow's decoder unpacks it, in Pillow's `mode`."""
    lt = _libtiff_directory(data, bo, data[2] == 0x2B)
    if (lt.get("width"), lt.get("height")) != (w, h):
        raise _LibtiffError("TIFF: libtiff's image size is not Pillow's")
    tables = f.get(347, (b"",))[0]
    lt["ycbcr_sub"] = _lt_tag(data, lt, 530, 2)
    if kind == "ojpeg":
        _ojpeg_fixups(lt, w)
    if lt["photometric"] == 6 and not (kind == "jpeg" and lt["planar"] == 1):
        # TiffDecode.c: a YCbCr image other than JPEG's through libtiff's
        # RGBA interface (tif_getimage.c), Pillow's raw mode RGBX over it
        if mode != "RGB":
            raise ValueError("TIFF: libtiff's RGBA interface takes no such YCbCr layout")
        px = _read_rgba(data, lt, kind, w, h, tables)
    else:
        if lt["planar"] == 2 and _BANDS[mode] > 1 and lt["bits"] not in (8, 16):
            # TiffDecode.c _pickUnpackers: planes of 8 or 16 bits alone
            raise ValueError(f"TIFF: Pillow unpacks no planes of {lt['bits']}-bit samples")
        predictor = lt["predictor"] if kind in _PREDICTED else 1
        if predictor not in (1, 2, 3) or (predictor == 2 and lt["bits"] not in (8, 16, 32, 64)) \
                or (predictor == 3 and (lt["format"] != 3 or lt["bits"] not in (16, 24, 32, 64))):
            raise _LibtiffError(f"TIFF: predictor {predictor} not supported by libtiff here")
        px = _read_libtiff(data, lt, kind, w, h, spp, bits, fmt, mode, predictor, photo, tables)
    return _to_mode(px, mode, raw, bits, bo, kind, f, lt["planar"] == 2 and _BANDS[mode] > 1)


# the modes whose bands Pillow's raw decoder unpacks a plane at a time by
# the raw mode's character (a byte a pixel)
_PLANE_MODES = ("RGB", "RGBA", "CMYK", "LAB")


def _read_samples(data, f, one, w, h, spp, bits, fmt, bo, planar, fill, mode,
                  raw) -> tuple:
    """An uncompressed image's samples [h, w, spp] from its strips or tiles
    as Pillow's raw decoder reads them (Pillow's own reading of the
    directory), with the raw mode and depth they were unpacked by. Planar
    configuration 2 unpacks each plane by the character of the raw mode at
    its place, as TiffImagePlugin does: a band's bytes (8 bits a pixel,
    whatever the samples' depth), or for one band "1" (bits, not inverted),
    "L" and "P" (bytes), "I" and "F" (native 32-bit)."""
    if 324 in f:
        tw, tl = one(322), one(323)
        offsets = f[324]
        if not isinstance(tw, int) or not isinstance(tl, int) or tw <= 0 or tl <= 0:
            raise ValueError("Invalid tile dimensions")
        grid = (-(-h // tl), -(-w // tw))
    elif 273 in f:
        tw, tl = w, min(one(278, h), h) or h
        offsets = f[273]
        grid = (-(-h // tl), 1)
        if tl == h and planar != 2:
            offsets = offsets[-1:]  # TiffImageFile._setup's one-strip case
    else:
        raise ValueError("TIFF: no strips or tiles")
    planes = spp if planar == 2 else 1
    per_plane = grid[0] * grid[1]
    chans = 1 if planar == 2 else spp
    out = None
    used = (raw, bits) if planar != 2 else (raw, 8)
    for p in range(planes):
        ubits, ufmt, unpack = bits, fmt[0] if len(fmt) == 1 else 1, bits
        if planar == 2:
            c = raw[p] if p < len(raw) else ""
            if _BANDS[mode] == 1:
                if p:
                    break  # one band: the other planes' tiles are never decoded
                if c == "1":
                    ubits = unpack = 1
                    used = ("1", 1)
                elif c in ("L", "P"):
                    ubits, unpack, ufmt = 8, 8, 1
                    used = (c, 8)
                elif c in ("I", "F") and mode in ("I", "F"):
                    ubits = unpack = 32
                    ufmt = 3 if c == "F" else 2
                    used = (raw, 32)
                else:
                    raise ValueError("unknown raw mode for given image mode")
            elif mode in _PLANE_MODES and c and c in mode:
                ubits, unpack, ufmt = 8, 8, 1
            else:
                raise ValueError("unknown raw mode for given image mode")
        for k in range(per_plane):
            if p * per_plane + k >= len(offsets):
                break  # Pillow's raw tiles: strips past the last offset stay zero
            ty, tx = divmod(k, grid[1])
            rows = tl if 324 in f else min(tl, h - ty * tl)
            off = offsets[p * per_plane + k]
            row_bytes = (tw * chans * ubits + 7) // 8
            nbytes = rows * row_bytes
            blob = data[off:off + nbytes]
            if len(blob) < nbytes:
                raise ValueError("image file is truncated")
            px = np.frombuffer(blob, np.uint8).reshape(rows, row_bytes)
            if fill == 2:
                px = _REVERSED[px]
            vals = _samples(px, tw, chans, unpack, ufmt, "<" if planar == 2 else bo)
            if out is None:
                dt = vals.dtype if planar != 2 or _BANDS[mode] == 1 else np.uint8
                out = np.zeros((grid[0] * tl, grid[1] * tw, spp), dt)
            y0, x0 = ty * tl, tx * tw
            out[y0:y0 + rows, x0:x0 + tw, p:p + vals.shape[2]] = vals[:rows, :tw]
    if out is None:
        raise ValueError("TIFF: no strips or tiles")
    return out[:h, :w], *used


# raw modes of OPEN_INFO for which Pillow's raw decoder has no unpacker (a
# bit fill order of 2 on an uncompressed file): it raises ValueError
_NO_RAW_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "I;16": 1, "I;16B": 1, "F": 1, "LA": 2, "PA": 2,
          "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def _strile_layout(lt: dict, w: int, h: int) -> tuple:
    """(tiled, tile or strip width, rows a block, tiles across)."""
    tiled = "tile_w" in lt or "tile_l" in lt
    if tiled:
        tw, tl = lt.get("tile_w", 0), lt.get("tile_l", 0)
        if tw == 0 or tl == 0:
            raise _LibtiffError("TIFF: zero tile size")
        return True, tw, tl, -(-w // tw)
    return False, w, h if lt["rows"] == NO_ROWS else min(lt["rows"], h), 1


def _read_libtiff(data, lt: dict, kind: str, w: int, h: int, spp: int, bits: int, fmt,
                  mode: str, predictor: int, photo: int, tables: bytes) -> np.ndarray:
    """A compressed image's samples [h, w, spp] as Pillow's libtiff decoder
    reads them (TiffDecode.c _decodeStrip, _decodeTile): libtiff's strips or
    tiles (TIFFReadEncodedStrip, TIFFReadTile: TIFFFillStrip's byte-count
    checks, the codec, the predictor), each row of libtiff's scanline
    unpacked by Pillow's raw mode (spp samples of `bits`)."""
    planes = _BANDS[mode] if lt["planar"] == 2 else 1
    chans = 1 if lt["planar"] == 2 else spp
    lt_chans = 1 if lt["planar"] == 2 else lt["spp"]
    tiled, tw, rps, across = _strile_layout(lt, w, h)
    unpack_bytes = (tw * spp * bits // planes + 7) // 8
    if tiled:
        tl = rps
        row_bytes = (tw * lt_chans * lt["bits"] + 7) // 8
        if row_bytes != unpack_bytes:  # Pillow's decoder: its rows must be libtiff's
            raise _LibtiffError("TIFF: libtiff's tile rows are not Pillow's")
        stripsize = tl * row_bytes
    else:
        row_bytes = lt["scanline"]
        if row_bytes != unpack_bytes:
            raise _LibtiffError("TIFF: libtiff's rows are not Pillow's")
    per_plane = len(lt["offsets"]) // (lt["spp"] if lt["planar"] == 2 else 1)
    out = None
    ojpeg = _OJpeg(data, lt, w, h) if kind == "ojpeg" else None
    for y in range(0, h, rps):
        for p in range(planes):
            for x in range(0, w, tw):
                if tiled:
                    k = (y // tl) * across + x // tw
                    rows = tl
                else:
                    k = 0 if lt["rows"] == NO_ROWS else y // lt["rows"]
                    rows = min(lt["rows"], h) if lt["rows"] != NO_ROWS else h
                    rows = min(rows, h - k * rows)
                    stripsize = rows * row_bytes
                k += p * per_plane
                if k >= len(lt["offsets"]):
                    raise _LibtiffError("TIFF: strip out of range")
                if ojpeg is not None:
                    px = ojpeg.strip(k, rows)
                else:
                    px = _libtiff_strip(data, lt, kind, k, rows, row_bytes, stripsize, predictor,
                                        lt_chans, tables, photo, tw)
                if kind in ("jpeg", "ojpeg"):
                    vals = px
                else:
                    vals = _samples(px, tw, chans, bits, fmt[0] if len(fmt) == 1 else 1, "=")
                if out is None:
                    out = np.zeros((-(-h // rps) * rps, across * tw, spp), vals.dtype)
                n = min(rps, h - y, vals.shape[0])
                out[y:y + n, x:x + tw, p:p + vals.shape[2]] = vals[:n, :tw]
    if out is None:
        raise ValueError("TIFF: no strips or tiles")
    return out[:h, :w]


def _fill_strip(data, lt, k: int) -> bytes:
    """TIFFFillStrip: strip or tile k's bytes, or _LibtiffError."""
    off, count = lt["offsets"][k], lt["counts"][k]
    if count == 0:
        raise _LibtiffError(f"TIFF: invalid strip byte count 0, strip {k}")
    full = lt.get("tile_l", min(lt["rows"], lt["height"])) * lt["scanline"]
    if count > 1024 * 1024 and full and (count - 4096) // 10 > full:
        count = full * 10 + 4096  # "Too large strip byte count ... Limiting"
    if count > len(data) or off > len(data) - count:
        raise _LibtiffError(f"TIFF: read error on strip {k}")
    return data[off:off + count]


def _libtiff_strip(data, lt, kind, k, rows, row_bytes, stripsize, predictor, chans, tables,
                   photo, tw) -> np.ndarray:
    """TIFFFillStrip and the codec: strip or tile k's `rows` rows of
    row_bytes."""
    blob = _fill_strip(data, lt, k)
    if kind == "jpeg":
        return _jpeg_tile(blob, tables, lt, photo, tw, rows)
    if kind == "ccitt":  # the codec reads the bits in the file's fill order itself
        px = _fax(data, lt, k, blob, rows, row_bytes, tw, stripsize)
        return px.reshape(rows, row_bytes)
    if lt["fill"] == 2:
        blob = _REVERSED[np.frombuffer(blob, np.uint8)].tobytes()
    if kind == "thunder":
        px = _thunder(lt, blob, stripsize)
    else:
        px = _decompress(kind, blob, stripsize)
    px = px.reshape(rows, row_bytes)
    return _predict(px, predictor, chans, lt["bits"], "<" if data[:2] == b"II" else ">")


def _fax(data, lt, k, blob: bytes, rows: int, row_bytes: int, rowpixels: int,
         stripsize: int) -> np.ndarray:
    """tif_fax3.c over one strip or tile (Fax3SetupState's checks first)."""
    if lt["bits"] != 1:
        raise _LibtiffError("TIFF: Bits/sample must be 1 for Group 3/4 decoding")
    if lt["spp"] != 1 and lt["planar"] == 1:
        raise _LibtiffError("TIFF: Samples/pixel shall be 1 for Group 3/4 decoding")
    if row_bytes < (rowpixels + 7) // 8:
        raise _LibtiffError("TIFF: inconsistent number of bytes per row")
    opts = _lt_tag(data, lt, 292, 1) if lt["compression"] == 3 else None
    src = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
    dst = np.zeros(stripsize, np.uint8)
    ok = native.library().gatling_tiff_fax_decode(
        native.ptr(src, ctypes.c_uint8), src.size, native.ptr(dst, ctypes.c_uint8),
        stripsize // row_bytes, row_bytes, rowpixels, lt["compression"],
        int(bool(opts and opts[0] & 1)), int(lt["fill"] != 2), lt["offsets"][k])
    if ok < 0:
        raise ValueError(f"TIFF: corrupt CCITT data in strip or tile {k}")
    if ok == 0:  # Pillow's array holds its buffer's uninitialized memory there
        raise ValueError(f"TIFF: a T.6 strip or tile ends before its last row (strip {k}); "
                         f"libtiff leaves the rows after it unwritten")
    return dst


def _thunder(lt, blob: bytes, stripsize: int) -> np.ndarray:
    """tif_thunder.c ThunderDecodeRow over one strip."""
    if lt["bits"] != 4:
        raise _LibtiffError("TIFF: the ThunderScan decoder takes 4-bit samples alone")
    scan = lt["scanline"]
    if stripsize % scan:
        raise _LibtiffError("TIFF: fractional scanlines cannot be read")
    src = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
    dst = np.zeros(stripsize, np.uint8)
    ok = native.library().gatling_tiff_thunder_decode(
        native.ptr(src, ctypes.c_uint8), src.size, native.ptr(dst, ctypes.c_uint8),
        stripsize // scan, lt["width"], scan)
    if ok <= 0:
        raise ValueError("TIFF: corrupt ThunderScan data")
    return dst


def _jpeg_tile(blob: bytes, tables: bytes, lt: dict, photo: int, tw: int,
               rows: int) -> np.ndarray:
    """One JPEG-compressed strip or tile (tif_jpeg.c): its stream with the
    JPEGTables' segments put after its SOI, decoded with libtiff's colour
    handling (a contiguous YCbCr image converted to RGB by libjpeg, any other
    as coded); JPEGPreDecode's checks of the component count and sampling."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("TIFF: a JPEG strip or tile without SOI")
    body = tables[2:-2] if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" else b""
    stream = blob[:2] + body + blob[2:]
    contig = lt["planar"] == 1
    ycc = contig and lt["photometric"] == 6
    f = jpeg.read(stream, components=None)
    want = lt["spp"] if contig else 1
    if len(f.comps) != want:
        raise ValueError("TIFF: improper JPEG component count")
    if ycc:
        hs, vs = lt["ycbcr_sub"] or (f.comps[0].h, f.comps[0].v)  # JPEGFixupTags
    else:
        hs = vs = 1
    if (f.comps[0].h, f.comps[0].v) != (hs, vs) or any((c.h, c.v) != (1, 1)
                                                      for c in f.comps[1:]):
        raise ValueError("TIFF: improper JPEG sampling factors")
    planes = jpeg.decode_planes(stream, ycc=ycc, frame=f)
    if planes.shape[0] < rows or planes.shape[1] < tw:
        raise ValueError("TIFF: a JPEG strip or tile smaller than its layout")
    return planes[:rows, :tw]


def _to_mode(px: np.ndarray, mode: str, raw: str, bits: int, bo: str, kind: str,
             f: dict, planes: bool = False) -> np.ndarray:
    """Pillow's unpacking of samples px [h, w, spp] by raw mode `raw` into
    `mode`, then the JAX package's array of that mode (`planes`: a planar
    image of several bands, each plane copied into one byte of Pillow's
    four-byte pixel: an LA or PA image's second plane lands in a byte the
    mode ignores, its alpha left 0, and CIE Lab's a and b planes are read
    as unsigned where the contiguous LAB unpacker reads them signed)."""
    base = raw.split(";")[0]
    inverted = "I" in raw.split(";")[1] if ";" in raw else False
    if mode == "1":
        v = px[..., 0] != 0
        return finish("1", ~v if inverted else v)
    if mode == "L":
        v = px[..., 0].astype(np.uint8)
        if bits in (2, 4):
            v = v * np.uint8(255 // ((1 << bits) - 1))
        return finish("L", 255 - v if inverted else v)
    if mode in ("I;16", "I;16B", "I"):
        return finish("I", px[..., 0].astype(np.int32) if px.dtype != np.uint32 else
                      px[..., 0].view(np.int32))
    if mode == "F":
        v = px[..., 0].astype(np.float32)
        if bo == ">" and kind != "none":
            # libtiff hands Pillow native-order floats, which Pillow's
            # "F;32BF" unpacker reads as big-endian: the bytes swapped
            v = v.byteswap()
        return finish("F", v)
    if bits == 16 and px.dtype != np.uint8:
        px = (px >> 8).astype(np.uint8)
    px = px.astype(np.uint8)
    if planes and mode in ("LA", "PA"):
        px = np.concatenate([px[..., :1], np.zeros_like(px[..., :1])], axis=-1)
    if planes and mode == "LAB":
        px = px[..., :3] ^ np.array([0, 128, 128], np.uint8)
    if mode in ("P", "PA"):
        cmap = np.array(f[320], np.int64) // 256
        n = len(cmap) // 3
        entries = cmap[:3 * n].reshape(3, n).T.astype(np.uint8)
        if mode == "PA":
            return finish("LA", px[..., :2])
        return finish("P", px[..., 0], entries)
    if mode == "LA":
        return finish("LA", px[..., :2])
    if mode == "CMYK":
        return finish("CMYK", px[..., :4])
    if mode == "RGB":
        return finish("RGB", px[..., :3])
    if mode == "LAB":  # three bands, which the JAX package takes for RGB
        return finish("RGB", px[..., :3])
    out = px[..., :4].copy()
    if base == "RGBa":  # Unpack.c unpackRGBa: the associated alpha divided out
        a = px[..., 3:4].astype(np.int32)
        rgb = np.minimum(px[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
        out[..., :3] = np.where(a == 255, px[..., :3], np.where(a == 0, 0, rgb))
    return finish("RGBA", out)


# tif_getimage.c: the YCbCr subsamplings putcontig8bitYCbCr*tile handles
_YCC_PUTS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
_LUMA = [np.float32(0.299), np.float32(0.587), np.float32(0.114)]
_YCC_BLACK_WHITE = [np.float32(v) for v in (0, 255, 128, 255, 128, 255)]


def _ycbcr_to_rgb_tables(luma, rbw) -> tuple:
    """TIFFYCbCrToRGBInit's tables (float32 arithmetic as libtiff's C):
    Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab, Cb_g_tab, each [256] int64."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)

    def clamp(v, lo, hi):
        return lo if not v >= lo else hi if v > hi else v

    def fix(x):  # (int32_t)((x) * (1L << 16) + 0.5)
        return int(float(f32(x) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, f32(0), f32(2)))
    d2 = -fix(clamp(f32(lr * f1) / lg, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, f32(0), f32(2)))
    d4 = -fix(clamp(f32(lb * f3) / lg, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = f32(rw - rb)
        return f32(f32(c - int(rb)) * f32(cr)) / (den if den != 0 else f32(1))

    tabs = [np.zeros(256, np.int64) for _ in range(5)]
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, f32(rbw[4] - f32(128)), f32(rbw[5] - f32(128)), 127),
                       f32(-4096), f32(4096)))
        cb = int(clamp(code2v(x, f32(rbw[2] - f32(128)), f32(rbw[3] - f32(128)), 127),
                       f32(-4096), f32(4096)))
        tabs[0][i] = int(clamp(code2v(x + 128, rbw[0], rbw[1], 255), f32(-4096), f32(4096)))
        tabs[1][i] = (d1 * cr + 32768) >> 16
        tabs[2][i] = (d3 * cb + 32768) >> 16
        tabs[3][i] = d2 * cr
        tabs[4][i] = d4 * cb + 32768
    return tuple(tabs)


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables: tuple) -> np.ndarray:
    """TIFFYCbCrtoRGB over uint8 planes -> [..., 3] uint8."""
    ytab, crr, cbb, crg, cbg = tables
    yv = ytab[y]
    r = yv + crr[cr]
    g = yv + ((cbg[cb] + crg[cr]) >> 16)
    b = yv + cbb[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _ycbcr_units(buf: np.ndarray, w: int, rows: int, hs: int, vs: int, tables,
                 skip: int = 0) -> np.ndarray:
    """putcontig8bitYCbCr*tile: rows of YCbCr data units (hs x vs luma
    samples, then Cb and Cr) -> [rows, w, 3] RGB, each pixel its own Y and
    its unit's Cb and Cr; `skip` columns of a clipped tile passed over after
    each row of units (putcontig8bitYCbCr44tile skips 10 bytes for each 4,
    not a unit's 18)."""
    ux, uy = -(-w // hs), -(-rows // vs)
    unit = hs * vs + 2
    stride = ux * unit + (skip // hs) * (10 if (hs, vs) == (4, 4) else unit)
    need = (uy - 1) * stride + ux * unit
    if buf.size < need:
        buf = np.concatenate([buf, np.zeros(need - buf.size, np.uint8)])
    u = np.lib.stride_tricks.as_strided(buf, (uy, ux, unit), (stride, unit, 1))
    y = u[..., :hs * vs].reshape(uy, ux, vs, hs).transpose(0, 2, 1, 3).reshape(uy * vs, ux * hs)
    cb = np.repeat(np.repeat(u[..., hs * vs], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(u[..., hs * vs + 1], vs, 0), hs, 1)
    return ycbcr_to_rgb(y, cb, cr, tables)[:rows, :w]


def _read_rgba(data, lt: dict, kind: str, w: int, h: int, tables: bytes) -> np.ndarray:
    """TiffDecode.c _decodeAsRGBA: a YCbCr image through TIFFRGBAImageGet,
    a block of rows (a strip or a row of tiles) at a time -> [h, w, 3] RGB,
    top-left first whatever the Orientation (which load_end applies after),
    each data unit converted by TIFFYCbCrtoRGB (YCbCrCoefficients,
    ReferenceBlackWhite; YCbCrPositioning plays no part). Pillow's decoder
    stops at a strip libtiff cannot read at all; one whose data is damaged
    leaves its decoded part and zeros (TIFFRGBAImageBegin with stoponerr 0)."""
    if lt["bits"] != 8 or lt["spp"] != 3 or lt["format"] == 3:
        raise ValueError("TIFF: the RGBA interface cannot handle this YCbCr format")
    contig = lt["planar"] == 1
    ojpeg = _OJpeg(data, lt, w, h) if kind == "ojpeg" else None
    sub = lt["ycbcr_sub"]
    hs, vs = sub if sub else (2, 2)
    if (hs, vs) not in (_YCC_PUTS if contig else ((1, 1),)):
        raise ValueError(f"TIFF: the RGBA interface cannot handle YCbCr {hs}x{vs}")
    luma = _lt_tag(data, lt, 529, 3) or _LUMA
    rbw = _lt_tag(data, lt, 532, 6) or _YCC_BLACK_WHITE
    if any(np.isnan(v) for v in luma) or luma[1] == 0:
        raise ValueError("TIFF: invalid YCbCrCoefficients")
    if not all(-0x7FFFFFFF + 128 < v < 0x7FFFFFFF for v in rbw):
        raise ValueError("TIFF: invalid ReferenceBlackWhite")
    conv = _ycbcr_to_rgb_tables(luma, rbw)
    tiled, tw, rps, across = _strile_layout(lt, w, h)
    unit = hs * vs + 2
    unit_row = -(-tw // hs) * unit  # TIFFScanlineSize's sampling row
    scanline = unit_row // vs
    per_plane = len(lt["offsets"]) // (1 if contig else 3)
    out = np.zeros((h, w, 3), np.uint8)

    def read(k: int, nbytes: int, buf: np.ndarray | None) -> np.ndarray:
        """_TIFFReadEncodedStripAndAllocBuffer (buf None: the block's first
        read, whose TIFFFillStrip failure ends the decode) or
        TIFFReadEncodedStrip into buf: what the codec writes is kept, a
        strip that cannot be read zeroes its part of the buffer."""
        fresh = buf is None
        if fresh:
            buf = np.zeros(max(nbytes, 1), np.uint8)
        try:
            if ojpeg is not None:
                got = ojpeg.raw(k, nbytes)
            else:
                blob = _fill_strip(data, lt, k)
                if lt["fill"] == 2:
                    blob = _REVERSED[np.frombuffer(blob, np.uint8)].tobytes()
                if kind == "jpeg":
                    got = _jpeg_tile(blob, tables, lt, 6, tw, nbytes // tw).reshape(-1)
                else:
                    got = _decompress(kind, blob, nbytes, partial=True)
        except _LibtiffError:
            if fresh:
                raise
            got = np.zeros(nbytes, np.uint8)
        got = got[:buf.size]
        buf[:got.size] = got
        return buf

    for y in range(0, h, rps):
        n = min(rps, h - y)
        buf = None  # gtTileContig's buffer, kept across one row of tiles
        for x in range(0, w, tw):
            k = (y // rps) * across + x // tw
            cols = min(tw, w - x)
            if contig:
                if tiled:
                    buf = read(k, -(-rps // vs) * unit_row, buf)
                else:
                    size = min(-(-n // vs) * unit_row, -(-n // vs) * vs * scanline)
                    buf = read(k, size, None)
                rgb = _ycbcr_units(buf, cols, n, hs, vs, conv, tw - cols)
            else:  # gtStripSeparate, gtTileSeparate: three planes a block
                size = (rps if tiled else n) * tw
                p0 = read(k, size, None if not tiled or buf is None else buf[0])
                buf = [p0] + [read(k + p * per_plane, size, np.zeros(size, np.uint8))
                              for p in (1, 2)]
                rgb = ycbcr_to_rgb(*(b[:n * tw].reshape(n, tw) for b in buf), conv)
            out[y:y + n, x:x + cols] = rgb[:n, :cols]
    return out


def _ojpeg_fixups(lt: dict, w: int) -> None:
    """TIFFReadDirectory's old-style JPEG hack: no Photometric, or RGB, is
    YCbCr; no BitsPerSample is 8; no SamplesPerPixel is 3 for YCbCr and 1 for
    grey."""
    if not lt.get("photometric_set") or lt["photometric"] == 2:
        lt["photometric"] = 6
    if 258 not in lt["entries"]:
        lt["bits"] = 8
    if 277 not in lt["entries"]:
        if lt["photometric"] == 6:
            lt["spp"] = 3
        elif lt["photometric"] in (0, 1):
            lt["spp"] = 1
    lt["scanline"] = (w * (lt["spp"] if lt["planar"] == 1 else 1) * lt["bits"] + 7) // 8


class _OJpeg:
    """tif_ojpeg.c: an old-style JPEG image (compression 6) as the one JPEG
    stream libtiff builds for libjpeg: its header read from the bytes at
    JPEGInterchangeFormat (513, 514), else from the first strip's, else
    made from the tables in tags (JPEGQTables 519, JPEGDCTables 520,
    JPEGACTables 521: component m's tables at the m-th offset, a repeated
    offset sharing a table); then the entropy-coded data that follows, the
    strips' bytes after it with an RST marker between strips (the restart
    interval one strip's MCUs when there is more than one strip, unless a
    DRI says otherwise), then EOI. A YCbCr image of three samples is read
    raw (jpeg_read_raw_data: each component at its own resolution, packed
    into TIFF data units of the JPEG's sampling, which overrides the
    YCbCrSubsampling tag), for the RGBA interface to convert; grey as its
    samples. JPEG sampling TIFF cannot express makes libtiff upsample inside
    libjpeg (data units of 1 x 1)."""

    def __init__(self, data: bytes, lt: dict, w: int, h: int):
        if lt["planar"] != 1:
            raise NotImplementedError("TIFF: old-style JPEG in planes (libtiff's scan a plane) "
                                      f"is not ported {UNPORTED}")
        spp = lt["spp"]
        if spp not in (1, 3):
            raise _LibtiffError("TIFF: SamplesPerPixel not supported for old-style JPEG")
        size = len(data)
        tiled, sw, rps, _across = _strile_layout(lt, w, h)
        total = -(-h // rps) * rps if tiled else h  # strile_length_total
        ycc = spp == 3 and lt["photometric"] in (6, 10)
        sub = _lt_tag(data, lt, 530, 2) if spp == 3 else None
        hs, vs = (sub or [2, 2]) if ycc else (1, 1)
        # the byte source: the interchange format's bytes, then each strip's
        jif = (_lt_tag(data, lt, 513, 1) or [0])[0]
        jif_len = (_lt_tag(data, lt, 514, 1) or [0])[0]
        parts = []
        if jif:
            if jif >= size:
                jif = 0
            elif jif_len == 0 or jif + jif_len > size:
                jif_len = size - jif
        if jif:
            parts.append(data[jif:jif + jif_len])
        first_strip = len(parts)
        for off, count in zip(lt["offsets"], lt["counts"]):
            if off == 0 or off >= size:
                parts.append(b"")
            else:
                parts.append(data[off:off + count] if count else data[off:])
        head, sof, at = self._header(parts)
        restart = 0
        if rps < h:
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise _LibtiffError("TIFF: invalid subsampling values")
            if rps % (vs * 8):
                raise _LibtiffError("TIFF: incompatible vertical subsampling and strip length")
            restart = -(-sw // (hs * 8)) * (rps // (vs * 8))
        forced = False
        if sof is None:  # tables from tags
            head = self._tables(data, lt, spp, hs, vs, sw, total)
        else:
            if ycc:  # OJPEGSubsamplingCorrect: the JPEG's sampling rules
                hv = [(sof[7 + 3 * c] >> 4, sof[7 + 3 * c] & 15) for c in range(sof[5])]
                forced = (hv[0][0] not in (1, 2, 4) or hv[0][1] not in (1, 2, 4)
                          or any(x != (1, 1) for x in hv[1:]))
                hs, vs = (1, 1) if forced else hv[0]
            sof_h, sof_w = struct.unpack(">HH", sof[1:5])
            if (sof_h < h and sof_h < total) or (sof_w < w and sof_w < sw) or sof_w > sw:
                raise _LibtiffError("TIFF: JPEG compressed data indicates an unexpected size")
        dri = [seg for seg in head if seg[1] == 0xDD]
        if dri:
            restart = struct.unpack(">H", dri[-1][2][:2])[0]
        head = [seg for seg in head if seg[1] != 0xDD]
        if restart:  # OJPEGWriteStream's order: the tables, DRI, SOF, SOS
            head.insert(len(head) - 2, (0, 0xDD, struct.pack(">H", restart)))
        segs = b"".join(bytes([0xFF, m]) + struct.pack(">H", len(p) + 2) + p for _, m, p in head)
        body = bytearray()
        k, pos = at
        index = 0
        for j in range(k, len(parts)):
            piece = parts[j][pos if j == k else 0:]
            if not piece and j != k:
                continue  # a strip with no bytes is passed over
            body += piece
            if j >= first_strip and any(parts[j + 1:]):
                body += bytes([0xFF, 0xD0 + index])  # OJPEGWriteStreamRst
                index = (index + 1) & 7
        stream = b"\xff\xd8" + segs + bytes(body) + b"\xff\xd9"
        self.w, self.rps, self.hs, self.vs = sw, rps, hs, vs
        if ycc:
            planes = jpeg._decode(stream, None)[0] if forced else jpeg.raw_planes(stream)[0]
            self.units = self._units(planes, hs, vs)
        else:
            self.grey = jpeg.decode_planes(stream, ycc=False)
        lt["ycbcr_sub"] = [hs, vs]

    @staticmethod
    def _header(parts: list) -> tuple:
        """OJPEGReadHeaderInfoSec: the marker segments up to SOS from the
        byte source, [(0, marker, payload)], the SOF payload or None, and
        where the entropy-coded data starts (part, offset)."""
        segs, sof = [], None
        k, pos = 0, 0

        def take(n):
            nonlocal k, pos
            out = b""
            while len(out) < n and k < len(parts):
                piece = parts[k][pos:pos + n - len(out)]
                out += piece
                pos += len(piece)
                if pos >= len(parts[k]):
                    k, pos = k + 1, 0
            if len(out) < n:
                raise _LibtiffError("TIFF: old-style JPEG data ends in its header")
            return out

        while True:
            while k < len(parts) and pos >= len(parts[k]):
                k, pos = k + 1, 0
            if k >= len(parts) or parts[k][pos] != 0xFF:
                return segs, sof, (k, pos)
            take(1)
            m = 0xFF
            while m == 0xFF:
                m = take(1)[0]
            if m == 0xD8:
                continue
            if m in (0xFE, *range(0xE0, 0xF0)) or m in (0xDD, 0xDB, 0xC4, 0xC0, 0xC1, 0xC3, 0xDA):
                (n,) = struct.unpack(">H", take(2))
                if n < 2:
                    raise _LibtiffError("TIFF: corrupt old-style JPEG data")
                payload = take(n - 2)
                if m in (0xFE, *range(0xE0, 0xF0)):
                    continue
                if m in (0xC0, 0xC1, 0xC3):
                    sof = payload
                segs.append((0, m, payload))
                if m == 0xDA:
                    while k < len(parts) and pos >= len(parts[k]):
                        k, pos = k + 1, 0
                    return segs, sof, (k, pos)
                continue
            raise _LibtiffError(f"TIFF: unknown marker type {m} in old-style JPEG data")

    @staticmethod
    def _tables(data: bytes, lt: dict, spp: int, hs: int, vs: int, w: int, h: int) -> list:
        """The header libtiff makes from the tables in tags."""
        segs = []
        tq, td = [], []
        for tag, kind in ((519, "q"), (520, "dc"), (521, "ac")):
            offs = _lt_tag(data, lt, tag)
            if not offs or offs[0] == 0:
                raise _LibtiffError("TIFF: missing old-style JPEG tables")
            ids = []
            for m in range(spp):
                off = offs[m] if m < len(offs) else 0
                if m and (off == 0 or off == offs[m - 1]):
                    ids.append(ids[-1])
                    continue
                ids.append(m)
                if kind == "q":
                    table = data[off:off + 64]
                    if len(table) < 64:
                        raise _LibtiffError("TIFF: a JPEGQTables table runs past the file")
                    segs.append((0, 0xDB, bytes([m]) + table))
                else:
                    counts = data[off:off + 16]
                    n = sum(counts)
                    values = data[off + 16:off + 16 + n]
                    if len(counts) < 16 or len(values) < n:
                        raise _LibtiffError("TIFF: a JPEG Huffman table runs past the file")
                    segs.append((0, 0xC4, bytes([(16 if kind == "ac" else 0) | m]) + counts
                                 + values))
            (tq if kind == "q" else td).append(ids)
        comps = b"".join(bytes([m + 1, (hs << 4 | vs) if m == 0 else 0x11, tq[0][m]])
                         for m in range(spp))
        segs.append((0, 0xC0, struct.pack(">BHHB", 8, h, w, spp) + comps))
        segs.append((0, 0xDA, bytes([spp]) + b"".join(bytes([m + 1, td[0][m] << 4 | td[1][m]])
                                                      for m in range(spp)) + b"\x00\x3f\x00"))
        return segs

    def _units(self, planes: list, hs: int, vs: int) -> np.ndarray:
        """OJPEGDecodeRaw: the component planes packed into data units, one
        row of units for each vs rows of the stream (every strile's)."""
        ux, uy = -(-self.w // hs), planes[0].shape[0] // vs
        y = planes[0][:uy * vs, :ux * hs]
        if y.shape[1] != ux * hs:
            raise ValueError("TIFF: old-style JPEG data narrower than its striles")
        lum = y.reshape(uy, vs, ux, hs).transpose(0, 2, 1, 3).reshape(uy, ux, vs * hs)
        cb, cr = planes[1][:uy, :ux], planes[2][:uy, :ux]
        return np.concatenate([lum, cb[..., None], cr[..., None]], axis=-1).reshape(uy, -1)

    def raw(self, k: int, nbytes: int) -> np.ndarray:
        """Strile k's data units, nbytes of them (the striles follow one
        another down the stream)."""
        first = k * self.rps // self.vs
        got = np.ascontiguousarray(self.units[first:]).reshape(-1)[:nbytes]
        if got.size < nbytes:
            raise ValueError(f"TIFF: old-style JPEG data ends before strile {k}")
        return got

    def strip(self, k: int, rows: int) -> np.ndarray:
        """Strile k's grey rows [rows, strile width, 1]."""
        got = self.grey[k * self.rps:k * self.rps + rows, :self.w]
        if got.shape[0] < rows:
            raise ValueError(f"TIFF: old-style JPEG data ends before strile {k}")
        return got


def encode_tiff(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes
    TiffImagePlugin._save writes: an uncompressed little-endian TIFF of one
    strip, its tags those Pillow writes (PlanarConfiguration 1 among them,
    SamplesPerPixel only for colour)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3, 4):
        raise ValueError(f"TIFF: expected 1, 3 or 4 channels, got {img.shape}")
    pixels = np.ascontiguousarray(img).tobytes()
    ifd_at = 8
    bps_at = ifd_at + 2 + 12 * (9 + (c > 1) + (c == 4)) + 4
    data_at = bps_at + (2 * c if c > 2 else 0)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, c, bps_at if c > 2 else 8),
               (259, 3, 1, 1), (262, 3, 1, 2 if c >= 3 else 1), (273, 4, 1, data_at),
               (278, 4, 1, h), (279, 4, 1, len(pixels)), (284, 3, 1, 1)]
    if c > 1:
        entries.append((277, 3, 1, c))
    if c == 4:
        entries.append((338, 3, 1, 2))
    out = [b"II*\x00", struct.pack("<I", ifd_at), struct.pack("<H", len(entries))]
    for tag, typ, count, value in sorted(entries):
        packed = struct.pack("<H", value) + b"\0\0" if typ == 3 and count == 1 else \
            struct.pack("<I", value)
        out.append(struct.pack("<HHI", tag, typ, count) + packed)
    out.append(struct.pack("<I", 0))
    if c > 2:
        out.append(struct.pack("<" + "H" * c, *([8] * c)))
    out.append(pixels)
    return b"".join(out)
