"""BLP textures (Warcraft III, World of Warcraft) as Pillow 12.1 reads them
(BlpImagePlugin), for the JAX package's imgio.

Quirks reproduced:
- the mode is RGBA when the header's alpha field is set, else RGB;
- BLP1 JPEG: the shared JPEG header, then the first mipmap (the bytes
  between the header and the mipmap's offset skipped), decoded as Pillow's
  JPEG plugin decodes it, converted to RGB and then read as BGR: red and
  blue swap; the JPEG's own size need not be the header's (its bytes are
  read as rows of the header's width);
- BLP1 palette: the palette right after the offset tables, and the
  mipmap's bytes read from right after the palette, not from its offset;
- BLP2 palette: the mipmap at its offset, each byte a BGRA palette entry;
  its alpha (not the file's 1-, 4- or 8-bit alpha plane) is the pixel's;
  an index past a short palette fails;
- BLP2 DXT1/DXT3/DXT5 through the plugin's own Python block decoders
  (5-6-5 colours shifted, not replicated; integer thirds and halves), a
  row of blocks 4 pixels a block wide, so a width that is not a multiple
  of 4 skews the rows, and DXT3/DXT5's RGBA pixels read as RGB skew them
  too when the alpha field is clear; a DXT1 block's transparent black
  keeps its alpha only with the alpha field set;
- a short table, palette or mipmap is "Truncated File Read", too little
  pixel data "not enough image data", other compressions and encodings
  fail.
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio import jpeg
from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish


def _read(f: Reader, n: int) -> bytes:
    """ImageFile._safe_read: n bytes or OSError (nothing for n <= 0)."""
    if n <= 0:
        return b""
    got = f.read(n)
    if len(got) < n:
        raise ValueError("Truncated File Read")
    return got


def _palette(f: Reader) -> np.ndarray:
    """_read_palette: up to 256 BGRA entries, as many as the file holds."""
    raw = f.read(1024)
    n = len(raw) // 4
    return np.frombuffer(raw, np.uint8, 4 * n).reshape(n, 4)


def _bgra(f: Reader, palette: np.ndarray, alpha: bool, length: int) -> np.ndarray:
    idx = np.frombuffer(_read(f, length), np.uint8)
    if idx.size and int(idx.max()) >= len(palette):
        raise ValueError("BLP: a palette index past the palette")  # IndexError
    px = palette[idx][:, [2, 1, 0, 3]]
    return (px if alpha else px[:, :3]).reshape(-1)


def _565(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int32)
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _colours(blocks: np.ndarray, off: int, dxt1: bool) -> tuple:
    """The four colours of each block [n, 4, 3] and whether DXT1 made
    index 3 transparent [n]."""
    c0 = blocks[:, off].astype(np.int32) | blocks[:, off + 1].astype(np.int32) << 8
    c1 = blocks[:, off + 2].astype(np.int32) | blocks[:, off + 3].astype(np.int32) << 8
    p0, p1 = _565(c0), _565(c1)
    third = np.stack([p0, p1, (2 * p0 + p1) // 3, (2 * p1 + p0) // 3], 1)
    if not dxt1:
        return third, np.zeros(len(blocks), bool)
    half = np.stack([p0, p1, (p0 + p1) // 2, np.zeros_like(p0)], 1)
    four = c0 > c1
    return np.where(four[:, None, None], third, half), ~four


def _dxt(raw: bytes, nx: int, kind: int, alpha: bool) -> bytes:
    """decode_dxt1/3/5 over rows of nx blocks: the rows' bytes in order."""
    size = 8 if kind == 0 else 16
    blocks = np.frombuffer(raw, np.uint8).reshape(-1, size)
    off = 0 if kind == 0 else 8
    colours, clear = _colours(blocks, off, kind == 0)
    code = (blocks[:, off + 4].astype(np.uint32) | blocks[:, off + 5].astype(np.uint32) << 8
            | blocks[:, off + 6].astype(np.uint32) << 16 | blocks[:, off + 7].astype(np.uint32)
            << 24)
    k = np.arange(16)
    sel = ((code[:, None] >> (2 * k)) & 3).astype(np.int64)  # [n, 16]
    rgb = np.take_along_axis(colours, sel[..., None], 1)  # [n, 16, 3]
    if kind == 0:
        a = np.where(clear[:, None] & (sel == 3), 0, 255)
    elif kind == 1:
        nib = blocks[:, :8].repeat(2, 1).astype(np.int32)
        a = np.where(k % 2 == 0, nib & 0xF, nib >> 4) * 17
    else:
        a0, a1 = blocks[:, 0].astype(np.int32), blocks[:, 1].astype(np.int32)
        bits = np.zeros(len(blocks), np.uint64)
        for j in range(6):
            bits |= blocks[:, 2 + j].astype(np.uint64) << np.uint64(8 * j)
        ac = ((bits[:, None] >> (3 * k).astype(np.uint64)) & np.uint64(7)).astype(np.int32)
        a = np.where(ac == 0, a0[:, None], np.where(ac == 1, a1[:, None], 0))
        eight = ((8 - ac) * a0[:, None] + (ac - 1) * a1[:, None]) // 7
        six = ((6 - ac) * a0[:, None] + (ac - 1) * a1[:, None]) // 5
        six = np.where(ac == 6, 0, np.where(ac == 7, 255, six))
        a = np.where(ac <= 1, a, np.where((a0 > a1)[:, None], eight, six))
    keep_alpha = kind != 0 or alpha
    px = np.concatenate([rgb, a[..., None]], -1) if keep_alpha else rgb
    ch = px.shape[-1]
    rows = px.reshape(-1, nx, 4, 4, ch).transpose(0, 2, 1, 3, 4)  # [by, j, bx, i, ch]
    return rows.astype(np.uint8).tobytes()


def _raw(mode: str, raw: bytes, w: int, h: int, channels: int = 0) -> np.ndarray:
    """set_as_raw: the image's rows read in order from raw (`channels`
    bytes a pixel, the mode's by default); too few is an error."""
    c = channels or len(mode)
    if len(raw) < w * h * c:
        raise ValueError("not enough image data")
    return np.frombuffer(raw, np.uint8, w * h * c).reshape(h, w, c)


def decode_blp(data: bytes) -> np.ndarray:
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise Skip("not a BLP file")
    f = Reader(data, 4)
    try:
        (compression,) = struct.unpack("<i", f.read(4))
        if magic == b"BLP1":
            alpha = struct.unpack("<I", f.read(4))[0] != 0
        else:
            encoding, alpha_field, alpha_encoding = struct.unpack("<bbb", f.read(3))
            alpha = alpha_field != 0
            f.pos += 1
        w, h = struct.unpack("<II", f.read(8))
        if magic == b"BLP1":
            (encoding,) = struct.unpack("<i", f.read(4))
    except struct.error as e:
        raise Skip("BLP: short header") from e
    if w == 0 or h == 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    mode = "RGBA" if alpha else "RGB"
    f.pos = 28 if magic == b"BLP1" else 20
    tables = _read(f, 128)
    offsets = struct.unpack_from("<16I", tables)
    lengths = struct.unpack_from("<16I", tables, 64)
    if magic == b"BLP1":
        if compression == 0:
            (size,) = struct.unpack("<I", _read(f, 4))
            head = _read(f, size)
            _read(f, offsets[0] - f.pos)
            stream = head + _read(f, lengths[0])
            rgb = jpeg.decode_jpeg(stream)[..., :3]  # convert("RGB")
            bomb_check(rgb.shape[1], rgb.shape[0])
            bgr = rgb[..., ::-1]
            raw = _raw("RGB", bgr.tobytes(), w, h, 3) if (rgb.shape[1], rgb.shape[0]) != (w, h) \
                else np.ascontiguousarray(bgr)
            return finish(mode, raw if mode == "RGB" else np.concatenate(
                [raw, np.full(raw.shape[:2] + (1,), 255, np.uint8)], -1))
        if compression == 1 and encoding in (4, 5):
            return finish(mode, _raw(mode, _bgra(f, _palette(f), alpha, lengths[0]).tobytes(),
                                     w, h))
        raise ValueError(f"Unsupported BLP compression {compression} / encoding {encoding}")
    palette = _palette(f)
    f.pos = offsets[0]
    if compression != 1:
        raise ValueError(f"Unknown BLP compression {compression}")
    if encoding == 1:
        return finish(mode, _raw(mode, _bgra(f, palette, alpha, lengths[0]).tobytes(), w, h))
    if encoding != 2:
        raise ValueError(f"Unknown BLP encoding {encoding}")
    kind = {0: 0, 1: 1, 7: 2}.get(alpha_encoding)
    if kind is None:
        raise ValueError(f"Unsupported alpha encoding {alpha_encoding}")
    nx, ny = (w + 3) // 4, (h + 3) // 4
    line = nx * (8 if kind == 0 else 16)
    raw = b"".join(_read(f, line) for _ in range(ny))
    return finish(mode, _raw(mode, _dxt(raw, nx, kind, alpha), w, h))
