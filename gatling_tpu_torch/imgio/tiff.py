"""TIFF decoder and writer, as Pillow reads and writes TIFF (through
libtiff for compressed files; the JAX package's imgio goes through
Pillow).

Read: the first image of a little- or big-endian TIFF or BigTIFF, in
strips or tiles, planar configuration 1 or 2, compressed with none, LZW
(new style by the native library's gatling_tiff_lzw_decode; old style,
LSB first, by gatling_tiff_lzw_compat_decode), Deflate (both tags,
Python's zlib), PackBits (gatling_tiff_packbits_decode) or JPEG
(compression 7: each strip or tile a JPEG stream completed by the
JPEGTables tag, decoded by jpeg.py), with predictor 2 (horizontal
differencing of 8-, 16- or 32-bit samples) or 3 (floating point), which
libtiff applies to LZW and Deflate strips alone; bit fill order 2 (each
byte's bits reversed). Pillow's mode and raw mode come from its own reading
of the directory (`_ifd`) and its OPEN_INFO table, copied here
(`OPEN_INFO`): a layout it lacks is given up, as Pillow gives it up, and
the array each raw mode gives is Pillow's. A compressed file's layout
(strips or tiles, their offsets and byte counts, rows per strip, planar
configuration, fill order, predictor) is libtiff's reading of the same
directory (`_libtiff_directory`, tif_dirread.c TIFFReadDirectory: the
tags it must read or refuse the file, those it leaves unset when they do
not read, strip arrays padded with zeros, byte counts estimated), decoded
as Pillow's libtiff decoder does (`_read_libtiff`: its rows must be
libtiff's; each strip through TIFFFillStrip's byte-count checks); an
uncompressed file is Pillow's raw decoder over Pillow's reading:
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
- JPEG-compressed YCbCr: libjpeg's YCbCr to RGB (libtiff's RGB colour
  mode), JPEG-compressed RGB and grey: the samples as coded.
CIE Lab: its L*, a* and b* samples as stored, three bands the JAX package
takes for RGB. YCbCr without JPEG (which Pillow
reads through libtiff's RGBA interface; uncompressed, Pillow reads it past
its strips and fails: ValueError), old-style JPEG (compression 6), the other codecs (CCITT, LZMA,
ZSTD, WebP ...) and orientations that swap the axes raise
NotImplementedError (ROADMAP: 'USD content'); a file Pillow gives up on
raises ValueError.

Write: uncompressed 8-bit grey, RGB or RGBA (unassociated alpha), one
strip, little-endian.
"""

from __future__ import annotations

import ctypes
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
# Pillow's COMPRESSION_INFO codes; the ported ones by the port's codec name
_KNOWN_COMPRESSIONS = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677,
                       34925, 50000, 50001}
_COMPRESSIONS = {1: "none", 5: "lzw", 7: "jpeg", 8: "deflate", 32946: "deflate",
                 32773: "packbits"}


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
    return d


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


def _native_decode(fn, blob: bytes, n: int) -> np.ndarray:
    src = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
    dst = np.zeros(n, np.uint8)
    got = fn(native.ptr(src, ctypes.c_uint8), src.size, native.ptr(dst, ctypes.c_uint8), n)
    if got < 0:
        raise ValueError("TIFF: corrupt compressed data")
    return dst[:got]


def _decompress(kind: str, blob: bytes, n: int) -> np.ndarray:
    """One strip or tile's n bytes."""
    if kind == "none":
        out = np.frombuffer(blob[:n], np.uint8)
    elif kind == "deflate":
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(blob, n), np.uint8)
        except zlib.error as e:
            raise ValueError(f"TIFF: corrupt Deflate data: {e}") from e
    elif kind == "lzw":
        lib = native.library()
        old = len(blob) >= 2 and blob[0] == 0 and blob[1] & 1
        out = _native_decode(lib.gatling_tiff_lzw_compat_decode if old
                             else lib.gatling_tiff_lzw_decode, blob, n)
    else:
        out = _native_decode(native.library().gatling_tiff_packbits_decode, blob, n)
    if out.size < n:
        raise ValueError(f"TIFF: a {kind} strip or tile holds {out.size} of its {n} bytes")
    return out


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
    nbands = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
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
    if comp not in _COMPRESSIONS:
        raise NotImplementedError(f"TIFF: compression {comp} is not ported {UNPORTED}")
    kind = _COMPRESSIONS[comp]
    lt = None
    if kind != "none":  # libtiff decodes by its own reading of the directory
        lt = _libtiff_directory(data, bo, data[2] == 0x2B)
        if (lt.get("width"), lt.get("height")) != (w, h):
            raise _LibtiffError("TIFF: libtiff's image size is not Pillow's")
        planar, fill = lt["planar"], lt["fill"]
    if one(274) in (5, 6, 7, 8):
        raise NotImplementedError(f"TIFF: orientations that swap the axes are not ported "
                                  f"{UNPORTED}")
    if photo == 6 and kind == "none":
        raise ValueError("TIFF: Pillow's raw YCbCr layout reads past its strips")
    if photo == 6 and kind != "jpeg":
        raise NotImplementedError(f"TIFF: YCbCr without JPEG compression is not ported "
                                  f"{UNPORTED}")
    bits = bps[0]
    if planar == 2 and (bits != 8 or spp == 1 or kind == "jpeg"):
        raise NotImplementedError(f"TIFF: planar configuration 2 of {bits}-bit samples is "
                                  f"not ported {UNPORTED}")
    if kind == "jpeg" and (bits != 8 or spp not in (1, 3, 4) or extra):
        raise NotImplementedError(f"TIFF: JPEG compression of this layout is not ported "
                                  f"{UNPORTED}")
    if lt is None:
        if raw in _NO_RAW_UNPACKER:
            raise ValueError("unknown raw mode for given image mode")
        px = _read_samples(data, f, one, w, h, spp, bits, fmt, bo, planar, fill)
    else:
        predictor = lt["predictor"] if kind in ("lzw", "deflate") else 1
        if predictor not in (1, 2, 3) or (predictor == 2 and lt["bits"] not in (8, 16, 32, 64)) \
                or (predictor == 3 and (lt["format"] != 3 or lt["bits"] not in (16, 24, 32, 64))):
            raise _LibtiffError(f"TIFF: predictor {predictor} not supported by libtiff here")
        if predictor > 1 and (lt["bits"], lt["spp"]) != (bits, spp):
            raise NotImplementedError(f"TIFF: a predictor over samples libtiff and Pillow read "
                                      f"differently is not ported {UNPORTED}")
        px = _read_libtiff(data, lt, kind, w, h, spp, bits, fmt, mode, predictor, photo,
                           f.get(347, (b"",))[0])
    return _to_mode(px, mode, raw, bits, bo, kind, f)


def _read_samples(data, f, one, w, h, spp, bits, fmt, bo, planar, fill) -> np.ndarray:
    """An uncompressed image's samples [h, w, spp] from its strips or tiles,
    as Pillow's raw decoder reads them (Pillow's own reading of the
    directory)."""
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
    for p in range(planes):
        for k in range(per_plane):
            if p * per_plane + k >= len(offsets):
                break  # Pillow's raw tiles: strips past the last offset stay zero
            ty, tx = divmod(k, grid[1])
            rows = tl if 324 in f else min(tl, h - ty * tl)
            off = offsets[p * per_plane + k]
            row_bytes = (tw * chans * bits + 7) // 8
            nbytes = rows * row_bytes
            blob = data[off:off + nbytes]
            if len(blob) < nbytes:
                raise ValueError("image file is truncated")
            px = np.frombuffer(blob, np.uint8).reshape(rows, row_bytes)
            if fill == 2:
                px = _REVERSED[px]
            vals = _samples(px, tw, chans, bits, fmt[0] if len(fmt) == 1 else 1, bo)
            if out is None:
                out = np.zeros((grid[0] * tl, grid[1] * tw, spp), vals.dtype)
            y0, x0 = ty * tl, tx * tw
            out[y0:y0 + rows, x0:x0 + tw, p:p + vals.shape[2]] = vals[:rows, :tw]
    if out is None:
        raise ValueError("TIFF: no strips or tiles")
    return out[:h, :w]


# raw modes of OPEN_INFO for which Pillow's raw decoder has no unpacker (a
# bit fill order of 2 on an uncompressed file): it raises ValueError
_NO_RAW_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "I;16": 1, "I;16B": 1, "F": 1, "LA": 2, "PA": 2,
          "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def _read_libtiff(data, lt: dict, kind: str, w: int, h: int, spp: int, bits: int, fmt,
                  mode: str, predictor: int, photo: int, tables: bytes) -> np.ndarray:
    """A compressed image's samples [h, w, spp] as Pillow's libtiff decoder
    reads them (TiffDecode.c _decodeStrip, _decodeTile): libtiff's strips or
    tiles (TIFFReadEncodedStrip, TIFFReadTile: TIFFFillStrip's byte-count
    checks, the codec, the predictor), each row of libtiff's scanline
    unpacked by Pillow's raw mode (spp samples of `bits`)."""
    planes = _BANDS[mode] if lt["planar"] == 2 else 1
    chans = 1 if lt["planar"] == 2 else spp
    unpack_bytes = (w * spp * bits // planes + 7) // 8
    tiled = "tile_w" in lt or "tile_l" in lt
    if tiled:
        tw, tl = lt.get("tile_w", 0), lt.get("tile_l", 0)
        if tw == 0 or tl == 0:
            raise _LibtiffError("TIFF: zero tile size")
        row_bytes = (tw * (lt["spp"] if lt["planar"] == 1 else 1) * lt["bits"] + 7) // 8
        unpack_bytes = (tw * spp * bits // planes + 7) // 8
        if row_bytes != unpack_bytes:  # Pillow's decoder: its rows must be libtiff's
            raise _LibtiffError("TIFF: libtiff's tile rows are not Pillow's")
        across, stripsize = -(-w // tw), tl * row_bytes
        rps = tl
    else:
        tw, row_bytes = w, lt["scanline"]
        if row_bytes != unpack_bytes:
            raise _LibtiffError("TIFF: libtiff's rows are not Pillow's")
        rps = h if lt["rows"] == NO_ROWS else min(lt["rows"], h)
        across = 1
    per_plane = len(lt["offsets"]) // (lt["spp"] if lt["planar"] == 2 else 1)
    out = None
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
                px = _libtiff_strip(data, lt, kind, k, rows, row_bytes, stripsize, predictor,
                                    chans, tables, photo, tw)
                if kind == "jpeg":
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


def _libtiff_strip(data, lt, kind, k, rows, row_bytes, stripsize, predictor, chans, tables,
                   photo, tw) -> np.ndarray:
    """TIFFFillStrip and the codec: strip or tile k's `rows` rows of
    row_bytes."""
    off, count = lt["offsets"][k], lt["counts"][k]
    if count == 0:
        raise _LibtiffError(f"TIFF: invalid strip byte count 0, strip {k}")
    full = lt.get("tile_l", min(lt["rows"], lt["height"])) * row_bytes
    if count > 1024 * 1024 and full and (count - 4096) // 10 > full:
        count = full * 10 + 4096  # "Too large strip byte count ... Limiting"
    if count > len(data) or off > len(data) - count:
        raise _LibtiffError(f"TIFF: read error on strip {k}")
    blob = data[off:off + count]
    if kind == "jpeg":
        return _jpeg_tile(blob, tables, photo, tw, rows)
    if lt["fill"] == 2:
        blob = _REVERSED[np.frombuffer(blob, np.uint8)].tobytes()
    px = _decompress(kind, blob, stripsize).reshape(rows, row_bytes)
    return _predict(px, predictor, chans, lt["bits"], "<" if data[:2] == b"II" else ">")


def _jpeg_tile(blob: bytes, tables: bytes, photo: int, tw: int, rows: int) -> np.ndarray:
    """One JPEG-compressed strip or tile: its stream with the JPEGTables'
    segments put after its SOI, decoded with libtiff's colour handling
    (YCbCr converted to RGB, RGB and grey as coded)."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("TIFF: a JPEG strip or tile without SOI")
    body = tables[2:-2] if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" else b""
    planes = jpeg.decode_planes(blob[:2] + body + blob[2:], ycc=photo == 6)
    if planes.shape[0] < rows or planes.shape[1] < tw:
        raise ValueError("TIFF: a JPEG strip or tile smaller than its layout")
    return planes[:rows, :tw]


def _to_mode(px: np.ndarray, mode: str, raw: str, bits: int, bo: str, kind: str,
             f: dict) -> np.ndarray:
    """Pillow's unpacking of samples px [h, w, spp] by raw mode `raw` into
    `mode`, then the JAX package's array of that mode."""
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
    if bits == 16:
        px = (px >> 8).astype(np.uint8)
    px = px.astype(np.uint8)
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


def encode_tiff(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> an uncompressed
    little-endian TIFF of one strip."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3, 4):
        raise ValueError(f"TIFF: expected 1, 3 or 4 channels, got {img.shape}")
    pixels = np.ascontiguousarray(img).tobytes()
    n_fields = 9 + (c == 4)
    ifd_at = 8
    bps_at = ifd_at + 2 + 12 * n_fields + 4
    data_at = bps_at + (2 * c if c > 2 else 0)
    entries = [(256, 4, 1, w), (257, 4, 1, h),
               (258, 3, c, bps_at if c > 2 else 8), (259, 3, 1, 1),
               (262, 3, 1, 2 if c >= 3 else 1), (273, 4, 1, data_at), (277, 3, 1, c),
               (278, 4, 1, h), (279, 4, 1, len(pixels))]
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
