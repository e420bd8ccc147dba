"""Netpbm images as Pillow's PpmImagePlugin reads and writes them (the JAX
package's imgio goes through Pillow).

Read: P1-P6 (plain and raw bitmaps, greymaps and pixmaps) with any maxval
up to 65535, Pillow's own P0CMYK, PyP, PyRGBA and PyCMYK, and the grey PFM
("Pf", Pillow's mode "F": the floats as stored, bottom row first, little-
endian for a negative scale). The header's tokens are read as Pillow's
_read_token reads them (comments, a token of at most 10 bytes). Samples
rescale as Pillow's decoders rescale them: round(v / maxval * 255), or to
65535 for a greymap of maxval above 255 (Pillow's mode "I", which the JAX
package divides by 65535: float32 v / 65535 at maxval 65535). Bitmaps are
Pillow's mode "1": bool, white True.

Write: Pillow's _save for .pbm, .pgm, .ppm, .pnm and .pfm alike: grey as
P5, RGB and RGBA (the alpha dropped) as P6, maxval 255.
"""

from __future__ import annotations

import math

import numpy as np

from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish, raw_rows, unpack_bits

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1024 * 1024


def accepts(data: bytes) -> bool:
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


def _read_token(f: Reader) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("Reached EOF while reading header")
    if len(token) > 10:
        raise ValueError("Token too long in file header")
    return token


class _Plain:
    """PpmPlainDecoder over the data from the tile's offset."""

    def __init__(self, f: Reader) -> None:
        self.f, self.spans = f, False

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def _ignore_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.f.read(SAFEBLOCK)
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> bytes:
        data = b""
        while len(data) != total:
            block = self.f.read(SAFEBLOCK)
            if not block:
                break
            tokens = b"".join(self._ignore_comments(block).split())
            if any(t not in (48, 49) for t in tokens):
                raise ValueError("Invalid token for this mode")
            data = (data + tokens)[:total]
        return data.translate(bytes.maketrans(b"01", b"\xff\x00"))

    def values(self, total: int, maxval: int, out_max: int) -> list[int]:
        data: list[int] = []
        half = b""
        while len(data) != total:
            block = self.f.read(SAFEBLOCK)
            if not block:
                if half:
                    block = b" "
                else:
                    break
            block = self._ignore_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError("Token too long found in data")
            for token in tokens:
                if len(token) > 10:
                    raise ValueError("Token too long found in data")
                value = int(token)
                if value < 0 or value > maxval:
                    raise ValueError(f"Channel value out of range: {value}")
                data.append(round(value / maxval * out_max))
                if len(data) == total:
                    break
        return data


def decode_pnm(data: bytes) -> np.ndarray:
    """Netpbm bytes -> RGBA, the JAX package's imgio.load_image(data).data."""
    f = Reader(data)
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise Skip("not a PPM file")
    mode = _MODES[magic]
    w, h = int(_read_token(f)), int(_read_token(f))
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = None
    if mode == "F":
        scale = float(_read_token(f))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
    elif mode != "1":
        maxval = int(_read_token(f))
        if not 0 < maxval < 65536:
            raise ValueError("maxval must be greater than 0 and less than 65536")
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    out_mode = "I" if (maxval or 0) > 255 and mode == "L" else mode
    bands = _BANDS[out_mode]
    if plain:
        dec = _Plain(f)
        if mode == "1":
            raw = dec.bitonal(w * h)
            if len(raw) < w * h:
                raise ValueError("not enough image data")
            px = np.frombuffer(raw, np.uint8).reshape(h, w) != 0
            return finish("1", px)
        out_max = 65535 if out_mode == "I" else 255
        vals = dec.values(w * h * bands, maxval, out_max)
        if len(vals) < w * h * bands:
            raise ValueError("not enough image data")
        px = np.array(vals, np.int64).reshape(h, w, bands)
        return finish(out_mode, px if out_mode == "I" else px.astype(np.uint8))
    if mode == "1":
        rows = raw_rows(data, f.pos, w, h, (w + 7) // 8)
        return finish("1", unpack_bits(rows, w, 1) == 0)
    if mode == "F":
        rows = raw_rows(data, f.pos, w, h, 4 * w, 0, -1)
        px = rows.view("<f4" if scale < 0 else ">f4").reshape(h, w).astype(np.float32)
        return finish("F", px)
    if maxval == 65535 and mode == "L":
        rows = raw_rows(data, f.pos, w, h, 2 * w)
        return finish("I", rows.view(">u2").reshape(h, w))
    if maxval == 255:
        rows = raw_rows(data, f.pos, w, h, w * bands)
        return finish(out_mode, rows.reshape(h, w, bands))
    # PpmDecoder: samples of 1 or 2 bytes rescaled to 255 (or 65535 for "I")
    width = 1 if maxval < 256 else 2
    out_max = 65535 if out_mode == "I" else 255
    n = w * h * bands
    if len(data) - f.pos < n * width:
        raise ValueError("not enough image data")
    raw = np.frombuffer(data, np.uint8, n * width, f.pos)
    v = raw.view(">u2") if width == 2 else raw
    scaled = np.minimum(out_max, np.round(v.astype(np.float64) / maxval * out_max))
    px = scaled.astype(np.int64).reshape(h, w, bands)
    return finish(out_mode, px if out_mode == "I" else px.astype(np.uint8))


def encode_pnm(img: np.ndarray) -> bytes:
    """[H, W] or [H, W, 1] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 ->
    the bytes Pillow's PPM _save writes: P5 or P6 (alpha dropped), maxval
    255."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        head, px = b"P5", img
    elif img.shape[2] in (3, 4):
        head, px = b"P6", img[..., :3]
    else:
        raise ValueError(f"PPM: expected 1, 3 or 4 channels, got {img.shape}")
    h, w = px.shape[:2]
    return head + b"\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(px).tobytes()

