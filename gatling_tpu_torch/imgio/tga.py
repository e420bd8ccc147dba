"""Truevision TGA decoder and writer, as Pillow's TgaImagePlugin reads and
writes them (the JAX package's imgio goes through Pillow).

Read: image types 1-3 uncompressed and 9-11 run-length encoded (a raw
packet may run on into the next rows; a run packet that runs past its row
raises, as Pillow rejects it); true colour of 16
(Pillow's "BGRA;15Z": 5-5-5 scaled by 255 / 31, alpha 255 where bit 15 is
clear and 0 where it is set), 24 (BGR) and 32 bits (BGRA, the alpha taken
as stored whatever the descriptor's alpha bits say), grey of 1 bit
(Pillow's mode "1", a bool image), 8 bits and 16 (grey, alpha), and
colour-mapped 8-bit indices into a 16-, 24- or 32-bit map (entry `first`
of the map is index `first`, the entries before it zeros; indices outside
the map are black). The descriptor's origin bits orient the image as
Pillow does: bottom-up unless bit 5 is set, mirrored when bit 4 is. A
file Pillow rejects raises ValueError: a layout it has no raw mode for
(Pillow opens it with no tile and cannot load it), a colour map on a
1-bit, RGB or RGBA image (its palette cannot be put on such an image), a
truncated body, run-length 1-bit grey. A TGA has no magic: `accepts` is
Pillow's header check.

Write: uncompressed, top-left origin, type 2 (BGR or BGRA) or 3 (grey).
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio.modes import finish, raw_rows, unpack_bgr15, unpack_bits

# Pillow's MODES: (image type & 7, bits) -> raw mode
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
             (2, 24): "BGR", (2, 32): "BGRA"}
_HEADER = struct.Struct("<BBBHHBHHHHBB")


def accepts(data: bytes) -> bool:
    """Pillow's TgaImageFile._open checks on the 18-byte header."""
    if len(data) < 18:
        return False
    _idl, cmap_type, itype, _cs, _cl, _cd, _x, _y, w, h, depth, flags = _HEADER.unpack(data[:18])
    return (cmap_type in (0, 1) and w > 0 and h > 0 and depth in (1, 8, 16, 24, 32)
            and itype in (1, 2, 3, 9, 10, 11) and not (itype in (1, 9) and not cmap_type))


def _unrle(data: bytes, pos: int, w: int, h: int, size: int) -> np.ndarray:
    """w x h pixels of `size` bytes from TGA run-length packets at pos, as
    Pillow's TgaRleDecode reads them: a raw packet runs on into the next
    rows, a run packet that runs past the end of its row is an error."""
    out = bytearray()
    row_bytes = w * size
    while len(out) < h * row_bytes:
        if pos >= len(data):
            raise ValueError("TGA: truncated run-length data")
        head = data[pos]
        n = (head & 0x7F) + 1
        if head & 0x80 and n * size > row_bytes - len(out) % row_bytes:
            raise ValueError("TGA: a run-length packet runs past its row")
        px = data[pos + 1:pos + 1 + (size if head & 0x80 else n * size)]
        if len(px) < (size if head & 0x80 else n * size):
            raise ValueError("TGA: truncated run-length data")
        out += px * n if head & 0x80 else px
        pos += 1 + len(px)
    return np.frombuffer(bytes(out[:h * row_bytes]), np.uint8)


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> [H, W, 4] RGBA: uint8, or bool for 1-bit grey (the JAX
    package's imgio.load_image(data).data)."""
    if not accepts(data):
        raise ValueError("not a TGA file")
    id_len, cmap_type, itype, cstart, clen, cdepth, _x, _y, w, h, depth, flags = \
        _HEADER.unpack(data[:18])
    base = itype & 7
    raw = _RAWMODES.get((base, depth))
    if raw is None:  # Pillow opens the file with no tile: "cannot load this image"
        raise ValueError(f"TGA: image type {itype} of {depth} bits has no Pillow raw mode")
    if cmap_type and (base == 2 or depth == 1):
        # Pillow reads the map, then cannot put a palette on a "1", RGB or RGBA image
        raise ValueError(f"TGA: a colour map on an image type {itype} of {depth} bits")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        if cdepth not in (16, 24, 32):
            raise ValueError(f"TGA: a {cdepth}-bit colour map")
        size = cdepth // 8
        entries = data[pos:pos + size * clen]
        pos += len(entries)
        entries = bytes(size * cstart) + entries
        n = len(entries) // size
        if n > 256:
            raise ValueError("TGA: a colour map of more than 256 entries")
        e = np.frombuffer(entries[:n * size], np.uint8).reshape(n, size)
        if cdepth == 16:
            palette = unpack_bgr15(e.view("<u2")[:, 0], "15Z")
        else:
            palette = e[:, [2, 1, 0, 3][:size]]
    if depth == 1:
        if itype & 8:
            raise ValueError("TGA: Pillow decodes no run-length 1-bit grey")
        rows = raw_rows(data, pos, w, h, (w + 7) // 8)
        px = unpack_bits(rows, w, 1)[..., None]
    else:
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
    if base == 1:
        return finish("P", px[..., 0], palette)
    if depth == 1:
        return finish("1", px[..., 0])
    if base == 3:
        return finish("L" if depth == 8 else "LA", px)
    if depth == 16:
        return finish("RGBA", unpack_bgr15(px.view("<u2")[..., 0], "15Z"))
    return finish("RGB" if depth == 24 else "RGBA", px[..., [2, 1, 0, 3][:size]])


def encode_tga(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes
    TgaImagePlugin._save writes: an uncompressed bottom-up TGA (8 alpha
    bits flagged for RGBA) and the TGA 2.0 footer."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3, 4):
        raise ValueError(f"TGA: expected 1, 3 or 4 channels, got {img.shape}")
    px = img if c == 1 else np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return (_HEADER.pack(0, 0, 3 if c == 1 else 2, 0, 0, 0, 0, 0, w, h, 8 * c, 8 if c == 4 else 0)
            + np.ascontiguousarray(px[::-1]).tobytes() + b"\0" * 8 + b"TRUEVISION-XFILE.\0")
