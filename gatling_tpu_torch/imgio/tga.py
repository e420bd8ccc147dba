"""Truevision TGA decoder and writer, as Pillow's TgaImagePlugin reads and
writes them (the JAX package's imgio goes through Pillow).

Read: image types 1-3 uncompressed and 9-11 run-length encoded (a packet
that runs past its row raises, as Pillow rejects it); true colour of 24 (BGR) and 32 bits (BGRA, the
alpha taken as stored whatever the descriptor's alpha bits say), grey of
8 bits and of 16 (grey, alpha), and colour-mapped 8-bit indices into a
24-bit map (entry `first` of the map is index `first`; indices outside the
map are black). The descriptor's origin bits orient the image as Pillow
does: bottom-up unless bit 5 is set, mirrored when bit 4 is. 15/16-bit
true colour and 16-bit maps, and 1-bit grey, raise NotImplementedError
(ROADMAP: 'USD content'); a file Pillow rejects (a 32-bit map, a
truncated body) raises ValueError. A TGA has no magic: `accepts` is
Pillow's header check.

Write: uncompressed, top-left origin, type 2 (BGR or BGRA) or 3 (grey).
"""

from __future__ import annotations

import struct

import numpy as np

UNPORTED = "(ROADMAP: 'USD content')"
_HEADER = struct.Struct("<BBBHHBHHHHBB")


def accepts(data: bytes) -> bool:
    """Pillow's TgaImageFile._open checks on the 18-byte header."""
    if len(data) < 18:
        return False
    _idl, cmap_type, itype, _cs, _cl, _cd, _x, _y, w, h, depth, flags = _HEADER.unpack(data[:18])
    return (cmap_type in (0, 1) and w > 0 and h > 0 and depth in (1, 8, 16, 24, 32)
            and itype in (1, 2, 3, 9, 10, 11) and not (itype in (1, 9) and not cmap_type))


def _unrle(data: bytes, pos: int, w: int, h: int, size: int) -> np.ndarray:
    """w x h pixels of `size` bytes from TGA run-length packets at pos; a
    packet that runs past the end of its row is an error, as in Pillow's
    TgaRleDecode."""
    out = bytearray()
    row_bytes = w * size
    while len(out) < h * row_bytes:
        if pos >= len(data):
            raise ValueError("TGA: truncated run-length data")
        head = data[pos]
        n = (head & 0x7F) + 1
        if n * size > row_bytes - len(out) % row_bytes:
            raise ValueError("TGA: a run-length packet runs past its row")
        px = data[pos + 1:pos + 1 + (size if head & 0x80 else n * size)]
        if len(px) < (size if head & 0x80 else n * size):
            raise ValueError("TGA: truncated run-length data")
        out += px * n if head & 0x80 else px
        pos += 1 + len(px)
    return np.frombuffer(bytes(out), np.uint8)


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> [H, W, 4] uint8 RGBA (the JAX package's
    imgio.load_image(data).data)."""
    if not accepts(data):
        raise ValueError("not a TGA file")
    id_len, cmap_type, itype, cstart, clen, cdepth, _x, _y, w, h, depth, flags = \
        _HEADER.unpack(data[:18])
    base = itype & 7
    if (base, depth) not in ((1, 8), (2, 24), (2, 32), (3, 8), (3, 16)):
        raise NotImplementedError(f"TGA: image type {itype} of {depth} bits is not ported "
                                  f"{UNPORTED}")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        if cdepth == 16:
            raise NotImplementedError(f"TGA: 16-bit colour maps are not ported {UNPORTED}")
        if cdepth != 24:
            raise ValueError(f"TGA: a {cdepth}-bit colour map")
        entries = np.frombuffer(data[pos:pos + 3 * clen], np.uint8)
        if entries.size < 3 * clen:
            raise ValueError("TGA: truncated colour map")
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        rgb = np.concatenate([np.zeros((cstart, 3), np.uint8),
                              entries.reshape(-1, 3)[:, ::-1]])[:256]
        palette[:len(rgb), :3] = rgb
        pos += 3 * clen
    size = depth // 8
    if itype & 8:
        px = _unrle(data, pos, w, h, size)
    else:
        px = np.frombuffer(data[pos:pos + w * h * size], np.uint8)
        if px.size < w * h * size:
            raise ValueError("TGA: truncated image data")
    px = px.reshape(h, w, size)
    if not flags & 0x20:  # bottom-up rows
        px = px[::-1]
    if flags & 0x10:  # right-to-left
        px = px[:, ::-1]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if base == 1:
        if palette is None:
            raise ValueError("TGA: a colour-mapped image without a map")
        out[:] = palette[px[..., 0]]
    elif base == 3:
        out[..., :3] = px[..., :1]
        if depth == 16:
            out[..., 3] = px[..., 1]
    else:
        out[..., :3] = px[..., 2::-1]
        if size == 4:
            out[..., 3] = px[..., 3]
    return out


def encode_tga(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> an
    uncompressed, top-left TGA."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3, 4):
        raise ValueError(f"TGA: expected 1, 3 or 4 channels, got {img.shape}")
    px = img if c == 1 else np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    flags = 0x20 | (8 if c == 4 else 0)
    return (_HEADER.pack(0, 0, 3 if c == 1 else 2, 0, 0, 0, 0, 0, w, h, 8 * c, flags)
            + np.ascontiguousarray(px).tobytes())
