"""Pillow's image modes, carried into the port: the arrays a decoder of
the port builds in a mode of Pillow's, turned into the RGBA array that the
JAX package's imgio gives for an image of that mode
(gatling_tpu/imgio/__init__.py `_decode_pil`):
- "P" and "CMYK" go through Pillow's convert("RGBA") (no decoder of the
  port gives "YCbCr", the third mode the JAX package converts);
- "I;16", "I;16B" and "I" become float32 code / 65535, "F" float32 as is;
- every other mode is its array, grey (1 band) or grey + alpha (2 bands)
  spread over RGB, an opaque alpha added to 3 bands (`to_rgba`): uint8,
  or bool for mode "1".

Also here: Pillow's raw unpackers that more than one format uses, and its
raw decoder's row walk (RawDecode.c), so that a short or oddly strided
image fails where Pillow's fails.
"""

from __future__ import annotations

import numpy as np

UNPORTED = "(ROADMAP: 'USD content')"
# Image.MAX_IMAGE_PIXELS: Image.open raises DecompressionBombError above twice this
MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)


class Skip(Exception):
    """Pillow's plugin gives the bytes up while it opens them (its _open
    raised SyntaxError, IndexError, TypeError or struct.error): Image.open
    goes on to the next plugin."""


class Reader:
    """A file object's read and readline over bytes in memory, as the
    plugins of Pillow's read their files (short reads at the end)."""

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        got = self.data[self.pos:] if n < 0 else self.data[self.pos:self.pos + n]
        self.pos += len(got)
        return got

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        got = self.data[self.pos:end]
        self.pos = end
        return got


def bomb_check(w: int, h: int) -> None:
    """Image._decompression_bomb_check: an image of more than twice
    MAX_IMAGE_PIXELS is refused."""
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"image size ({w * h} pixels) exceeds the decompression bomb limit")


def to_rgba(arr: np.ndarray) -> np.ndarray:
    """The JAX package's imgio.image.to_rgba: grey, grey + alpha or RGB to
    RGBA with an opaque alpha (255, 1.0 or True by dtype)."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c == 4:
        return np.ascontiguousarray(arr)
    out = np.empty((h, w, 4), arr.dtype)
    out[..., 3] = np.array(255 if arr.dtype == np.uint8 else 1.0, arr.dtype)
    if c == 1:
        out[..., :3] = arr
    elif c == 2:
        out[..., :3] = arr[..., :1]
        out[..., 3] = arr[..., 1]
    elif c == 3:
        out[..., :3] = arr
    else:
        raise ValueError(f"unsupported channel count {c}")
    return out


def palette_table(entries: np.ndarray | None) -> np.ndarray:
    """Pillow's 256-entry RGBA palette of a "P" image from its entries
    [N, 3] (opaque) or [N, 4]: entries past the last are black."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    if entries is not None and len(entries):
        entries = np.asarray(entries, np.uint8)[:256]
        table[:len(entries), :entries.shape[1]] = entries
    return table


def p_to_rgba(idx: np.ndarray, entries: np.ndarray | None,
              transparency: int | None = None) -> np.ndarray:
    """convert("RGBA") of a "P" image: each index looked up in its palette;
    the image's transparent index (info["transparency"]) gets alpha 0."""
    table = palette_table(entries)
    if transparency is not None and 0 <= transparency < 256:
        table[transparency, 3] = 0
    return table[idx]


def cmyk_to_rgba(cmyk: np.ndarray) -> np.ndarray:
    """Convert.c cmyk2rgb: each of R, G, B is nk - c * nk / 255 (nk = 255 -
    k, Pillow's MULDIV255 rounding), alpha opaque."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    out = np.empty(cmyk.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    out[..., 3] = 255
    return out


def finish(mode: str, arr: np.ndarray, palette: np.ndarray | None = None,
           transparency: int | None = None) -> np.ndarray:
    """The JAX package's array for an image of Pillow mode `mode` whose
    bands are arr ([H, W] or [H, W, bands]; "P": indices with its palette
    entries and transparent index)."""
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if mode == "P":
        return p_to_rgba(arr, palette, transparency)
    if mode == "CMYK":
        return cmyk_to_rgba(arr)
    if mode in ("I;16", "I;16B", "I", "F"):
        f = arr.astype(np.float32)
        if mode != "F":
            f = f / np.float32(65535.0)
        return to_rgba(f)
    if mode == "1":
        return to_rgba(arr.astype(bool))
    return to_rgba(arr.astype(np.uint8))


def scale_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """Pillow's unpackers of 4-, 5- and 6-bit fields: v * 255 // (2^bits - 1)."""
    return (v.astype(np.int32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def unpack_bgr15(v: np.ndarray, alpha: str | None = None) -> np.ndarray:
    """"BGR;15" (5-5-5, red in bits 10-14) of little-endian 16-bit words v;
    alpha "15" takes bit 15 as alpha 255, "15Z" as alpha 0 ("BGRA;15",
    "BGRA;15Z")."""
    v = v.astype(np.int32)
    out = [scale_bits((v >> 10) & 31, 5), scale_bits((v >> 5) & 31, 5), scale_bits(v & 31, 5)]
    if alpha is not None:
        bit = (v >> 15) & 1
        out.append(np.where(bit == (1 if alpha == "15" else 0), 255, 0).astype(np.uint8))
    return np.stack(out, axis=-1)


def unpack_bgr16(v: np.ndarray) -> np.ndarray:
    """"BGR;16" (5-6-5, red in bits 11-15) of 16-bit words v."""
    v = v.astype(np.int32)
    return np.stack([scale_bits((v >> 11) & 31, 5), scale_bits((v >> 5) & 63, 6),
                     scale_bits(v & 31, 5)], axis=-1)


def raw_rows(data: bytes, pos: int, w: int, h: int, line: int, stride: int = 0,
             ystep: int = 1) -> np.ndarray:
    """RawDecode.c over data[pos:]: h lines of `line` bytes, `stride`
    bytes apart (0: packed), the first line the top one (ystep 1) or the
    bottom one (-1). Returns [h, line] uint8, top row first. A stride
    shorter than a line is a configuration error, and a short file
    Pillow's "image file is truncated": both ValueError."""
    if stride and stride < line:
        raise ValueError("raw decoder: a stride shorter than a line")
    step = stride or line
    need = step * (h - 1) + line if h else 0
    if pos < 0 or len(data) - pos < need:
        raise ValueError("image file is truncated")
    if h == 0 or line == 0:
        return np.zeros((h, line), np.uint8)
    buf = np.frombuffer(data, np.uint8, need, pos)
    rows = np.lib.stride_tricks.as_strided(buf, (h, line), (step, 1))
    return np.ascontiguousarray(rows[::-1] if ystep < 0 else rows)


def unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """Rows of packed MSB-first samples of `bits` (1, 2 or 4) bits -> [h, w]
    sample values."""
    h = rows.shape[0]
    b = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits).astype(np.uint8)
    return (b * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
