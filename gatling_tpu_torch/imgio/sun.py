"""Sun raster images (.ras) as Pillow 12.1 reads them (SunImagePlugin,
SunRleDecode.c), for the JAX package's imgio.

Quirks reproduced:
- 1 bit is mode "1" with the bits inverted ("1;I": a set bit is black);
  a palette on it fails the load (Pillow cannot put one on a "1" image);
  4 bits "L" scaled by 17 ("L;4"), or "P" indices with a palette; 8 bits
  "L", or "P" with a palette; 24 and 32 bits RGB, read as BGR and BGRX
  unless the file type is 3 (RGB, RGBX);
- the palette is planar ("RGB;L": reds, then greens, then blues),
  palette_length // 3 entries; one of more than 256 entries fails the
  load; every palette type but 1 skips the plugin;
- raw rows are padded to 16 bits; RLE rows (type 2) are not, and a run
  carries on across rows;
- a file that ends before its last row is "image file is truncated".
The run-length loop is the native library's gatling_sun_rle_decode.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish, raw_rows, unpack_bits


def decode_sun(data: bytes) -> np.ndarray:
    s = data[:32]
    if len(s) < 4 or struct.unpack_from(">I", s)[0] != 0x59A66A95:
        raise Skip("not a Sun raster file")
    if len(s) < 32:
        raise Skip("Sun: short header")  # struct.error in i32
    _, w, h, depth, _length, file_type, palette_type, palette_length = struct.unpack(">8I", s)
    if depth not in (1, 4, 8, 24, 32):
        raise Skip("Unsupported Mode/Bit Depth")
    mode = {1: "1", 4: "L", 8: "L", 24: "RGB", 32: "RGB"}[depth]
    offset = 32
    palette = None
    if palette_length:
        if palette_length > 1024:
            raise Skip("Unsupported Color Palette Length")
        if palette_type != 1:
            raise Skip("Unsupported Palette Type")
        raw = data[32:32 + palette_length]
        offset += palette_length
        n = len(raw) // 3
        palette = np.frombuffer(raw, np.uint8, 3 * n).reshape(3, n).T
        if mode == "L":
            mode = "P"
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise Skip("Unsupported Sun Raster file type")
    if w == 0 or h == 0 or w >= 1 << 31 or h >= 1 << 31:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    if palette is not None and (len(palette) > 256 or depth == 1):
        raise ValueError("a palette Pillow cannot put on this image")
    line = (w * depth + 7) // 8
    if file_type == 2:
        src = np.ascontiguousarray(np.frombuffer(data, np.uint8, max(0, len(data) - offset),
                                                 min(offset, len(data))))
        rows = np.zeros((h, line), np.uint8)
        if native.library().gatling_sun_rle_decode(native.ptr(src, ctypes.c_uint8), src.size,
                                                   line, h, native.ptr(rows, ctypes.c_uint8)):
            raise ValueError("image file is truncated")
    else:
        rows = raw_rows(data, offset, w, h, line, ((w * depth + 15) // 16) * 2)
    if depth == 1:
        return finish("1", unpack_bits(rows, w, 1) == 0)
    if depth == 4:
        v = unpack_bits(rows, w, 4)
        return finish(mode, v if mode == "P" else v * np.uint8(17), palette)
    if depth == 8:
        return finish(mode, rows, palette)
    px = rows.reshape(h, w, depth // 8)[..., :3]
    return finish("RGB", px if file_type == 3 else px[..., ::-1])
