"""TIFF decoder and writer, as Pillow reads and writes TIFF (through
libtiff for compressed files; the JAX package's imgio goes through
Pillow).

Read: the first image of a little- or big-endian TIFF, in strips or
tiles, planar configuration 1, compressed with none, LZW (the native
library's gatling_tiff_lzw_decode), Deflate (both tags, Python's zlib) or
PackBits (gatling_tiff_packbits_decode), with predictor 2 (horizontal
differencing of 8-, 16- or 32-bit samples) or 3 (floating point), which
libtiff applies to LZW and Deflate strips alone. Samples of 8 or 16
unsigned bits, or 32-bit floats, in grey, grey + alpha, RGB and RGBA;
the array each gives is Pillow's:
- 8-bit grey, grey + alpha, RGB and RGBA: the codes (WhiteIsZero grey
  inverted; RGBA with associated alpha divided out as Pillow's "RGBa"
  unpacker does; an unspecified fourth sample dropped);
- 16-bit grey: float32 code / 65535 (Pillow's "I;16"); 16-bit RGB and
  RGBA: the high byte of each sample (Pillow's 8-bit modes);
- 32-bit float grey: the floats (Pillow's "F"; in a compressed
  big-endian file each float's bytes swapped, as Pillow reads them).
JPEG-in-TIFF, palette, CMYK, YCbCr and Lab images, other sample widths,
signed samples, bit fill order 2 and planar configuration 2 raise
NotImplementedError (ROADMAP: 'USD content'); a layout Pillow rejects
(float RGB, 16-bit grey + alpha, big-endian 16-bit WhiteIsZero) raises
ValueError.

Write: uncompressed 8-bit grey, RGB or RGBA (unassociated alpha), one
strip, little-endian.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from gatling_tpu_torch import native

UNPORTED = "(ROADMAP: 'USD content')"
MAGICS = (b"II*\x00", b"MM\x00*")

# field types: (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          16: ("Q", 8)}
_COMPRESSIONS = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}
# (photometric, bits, samples, extra samples) of Pillow's OPEN_INFO that
# are read here: grey (0: WhiteIsZero, 1: BlackIsZero), grey + alpha, RGB,
# RGB + an unspecified (0), associated (1) or unassociated (2, 999, or
# none named) fourth sample
_LAYOUTS = {(0, 8, 1, ()), (1, 8, 1, ()), (0, 16, 1, ()), (1, 16, 1, ()), (0, 32, 1, ()),
            (1, 32, 1, ()), (1, 8, 2, (2,)),
            *((2, b, 3, ()) for b in (8, 16)),
            *((2, b, 4, e) for b in (8, 16) for e in ((), (0,), (1,), (2,))), (2, 8, 4, (999,))}


def accepts(data: bytes) -> bool:
    return data[:4] in MAGICS


def _ifd(data: bytes, bo: str) -> dict[int, tuple]:
    """The first IFD's fields: tag -> tuple of values."""
    (offset,) = struct.unpack(bo + "I", data[4:8])
    if offset + 2 > len(data):
        raise ValueError("TIFF: truncated IFD")
    (n,) = struct.unpack(bo + "H", data[offset:offset + 2])
    fields = {}
    for k in range(n):
        entry = data[offset + 2 + 12 * k:offset + 14 + 12 * k]
        if len(entry) < 12:
            raise ValueError("TIFF: truncated IFD")
        tag, typ, count = struct.unpack(bo + "HHI", entry[:8])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= 4:
            raw = entry[8:8 + nbytes]
        else:
            (at,) = struct.unpack(bo + "I", entry[8:12])
            raw = data[at:at + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"TIFF: truncated field {tag}")
        fields[tag] = struct.unpack(bo + code * count, raw) if typ != 2 else (raw,)
    return fields


def _decompress(kind: str, blob: bytes, n: int) -> np.ndarray:
    """One strip or tile's n bytes."""
    if kind == "none":
        out = np.frombuffer(blob[:n], np.uint8)
    elif kind == "deflate":
        out = np.frombuffer(zlib.decompressobj().decompress(blob, n), np.uint8)
    else:
        src = np.ascontiguousarray(np.frombuffer(blob, np.uint8))
        dst = np.zeros(n, np.uint8)
        fn = (native.library().gatling_tiff_lzw_decode if kind == "lzw"
              else native.library().gatling_tiff_packbits_decode)
        if kind == "lzw" and src.size >= 2 and src[0] == 0 and src[1] & 1:
            raise NotImplementedError(f"TIFF: old-style (LSB-first) LZW is not ported {UNPORTED}")
        got = fn(native.ptr(src, ctypes.c_uint8), src.size, native.ptr(dst, ctypes.c_uint8), n)
        if got < 0:
            raise ValueError(f"TIFF: corrupt {kind} data")
        out = dst[:got]
    if out.size < n:
        raise ValueError(f"TIFF: a {kind} strip or tile holds {out.size} of its {n} bytes")
    return out


def _predict(px: np.ndarray, predictor: int, spp: int, bits: int, bo: str) -> np.ndarray:
    """Rows [r, w * spp * bits / 8] of bytes, the predictor undone, as
    samples [r, w * spp] of the file's sample type in native order."""
    r = px.shape[0]
    if predictor == 3:  # libtiff fpAcc: bytes differenced, then byte planes, MSB first
        acc = px.reshape(r, -1, spp).astype(np.uint64).cumsum(axis=1).astype(np.uint8)
        planes = acc.reshape(r, bits // 8, -1)
        return np.ascontiguousarray(planes.transpose(0, 2, 1)).view(">f4").reshape(r, -1)
    dt = np.dtype({8: "u1", 16: "u2", 32: "u4"}[bits]).newbyteorder(bo)
    vals = px.view(dt).reshape(r, -1).astype(dt.newbyteorder("="))
    if predictor == 2:  # horizontal differencing, modulo the sample width
        per = vals.reshape(r, -1, spp).astype(np.uint64).cumsum(axis=1)
        vals = (per & np.uint64((1 << bits) - 1)).astype(vals.dtype).reshape(r, -1)
    return vals


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> [H, W, 4] RGBA: uint8, or float32 for 16-bit and float
    grey (the JAX package's imgio.load_image(data).data)."""
    if not accepts(data):
        raise ValueError("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    f = _ifd(data, bo)

    def one(tag, default=None):
        return f[tag][0] if tag in f else default

    w, h = one(256), one(257)
    if w is None or h is None or w <= 0 or h <= 0:
        raise ValueError("TIFF: no image size")
    comp = one(259, 1)
    if comp not in _COMPRESSIONS:
        kind = {6: "old-style JPEG", 7: "JPEG"}.get(comp, f"compression {comp}")
        raise NotImplementedError(f"TIFF: {kind} is not ported {UNPORTED}")
    kind = _COMPRESSIONS[comp]
    photo = one(262, 0)
    if photo not in (0, 1, 2):
        name = {3: "palette", 4: "mask", 5: "CMYK", 6: "YCbCr", 8: "CIE Lab"}.get(photo, photo)
        raise NotImplementedError(f"TIFF: photometric {name} is not ported {UNPORTED}")
    spp = one(277, 1)
    bps = f.get(258, (1,))
    bps = bps * spp if len(bps) == 1 else bps[:spp]
    extra = f.get(338, ())
    fmt = f.get(339, (1,))
    fmt = fmt[0] if len(set(fmt)) == 1 else fmt
    if one(284, 1) != 1:
        raise NotImplementedError(f"TIFF: planar configuration 2 is not ported {UNPORTED}")
    if one(266, 1) != 1:
        raise NotImplementedError(f"TIFF: bit fill order 2 is not ported {UNPORTED}")
    bits = bps[0]
    if len(set(bps)) != 1 or (bits, fmt) not in ((8, 1), (16, 1), (32, 3)):
        raise NotImplementedError(f"TIFF: samples of {bps} bits, format {fmt}, are not "
                                  f"ported {UNPORTED}")
    layout = (photo, bits, spp, tuple(extra))
    if layout not in _LAYOUTS or (layout == (0, 16, 1, ()) and bo == ">"):
        if photo == 2 and bits != 32 and spp > 4:
            raise NotImplementedError(f"TIFF: {spp} samples a pixel are not ported {UNPORTED}")
        raise ValueError(f"TIFF: Pillow reads no image of layout {layout}")
    predictor = one(317, 1) if kind in ("lzw", "deflate") else 1
    if predictor not in (1, 2, 3) or (predictor == 3 and bits != 32):
        raise NotImplementedError(f"TIFF: predictor {predictor} on {bits}-bit samples is not "
                                  f"ported {UNPORTED}")
    if 324 in f:  # tiles
        tw, tl = one(322), one(323)
        offsets, counts = f[324], f.get(325, ())
        grid = (-(-h // tl), -(-w // tw))
    elif 273 in f:  # strips
        tw, tl = w, min(one(278, h), h)
        offsets, counts = f[273], f.get(279, ())
        grid = (-(-h // tl), 1)
    else:
        raise ValueError("TIFF: no strips or tiles")
    if len(offsets) < grid[0] * grid[1] or len(counts) < len(offsets):
        raise ValueError("TIFF: too few strips or tiles")
    samples = np.zeros((grid[0] * tl, grid[1] * tw * spp),
                       np.float32 if bits == 32 else np.uint16 if bits == 16 else np.uint8)
    for k in range(grid[0] * grid[1]):
        ty, tx = divmod(k, grid[1])
        rows = tl if 324 in f else min(tl, h - ty * tl)
        nbytes = rows * tw * spp * bits // 8
        blob = data[offsets[k]:offsets[k] + counts[k]]
        px = _decompress(kind, blob, nbytes).reshape(rows, tw * spp * bits // 8)
        vals = _predict(px, predictor, spp, bits, bo)
        if bits == 32 and predictor != 3:
            vals = vals.view(np.float32)
        if bits == 32 and bo == ">" and kind != "none":
            # libtiff hands Pillow native-order floats, which Pillow's
            # "F;32BF" unpacker reads as big-endian: the bytes swapped
            vals = vals.astype(np.float32).byteswap()
        samples[ty * tl:ty * tl + rows, tx * tw * spp:(tx + 1) * tw * spp] = vals
    px = samples[:h, :w * spp].reshape(h, w, spp)
    if bits == 32 or (bits == 16 and spp == 1):
        grey = px[..., 0].astype(np.float32)
        if bits == 16:
            grey = grey / np.float32(65535.0)
        return np.concatenate([np.repeat(grey[..., None], 3, -1),
                               np.ones((h, w, 1), np.float32)], axis=-1)
    if bits == 16:
        px = (px >> 8).astype(np.uint8)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if photo != 2:
        out[..., :3] = 255 - px[..., :1] if photo == 0 else px[..., :1]
        if spp == 2:
            out[..., 3] = px[..., 1]
        return out
    out[..., :3] = px[..., :3]
    if spp == 4 and extra != (0,):
        out[..., 3] = px[..., 3]
        if extra == (1,):  # Unpack.c unpackRGBa: the associated alpha divided out
            a = px[..., 3:4].astype(np.int32)
            rgb = np.minimum(px[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
            out[..., :3] = np.where(a == 255, px[..., :3], np.where(a == 0, 0, rgb))
    return out


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
