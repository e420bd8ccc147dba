"""SGI images (.rgb, .rgba, .bw, .int, .inta, .sgi) as Pillow 12.1 reads
them (SgiImagePlugin, SgiRleDecode.c), for the JAX package's imgio.

Quirks reproduced:
- the rows are stored bottom first; a 16-bit file becomes 8-bit "L",
  "RGB" or "RGBA", each sample its high byte (the "L;16B" and "RGB;16B"
  unpackers, and SGI16Decoder's "L;16B" planes);
- the header's dimension (1, 2 or 3) only picks the mode with bpc and
  zsize; 1- and 2-dimensional images of one channel are the same;
- RLE rows: a chunk list counts chunks, not bytes, and one that ends on
  anything but its terminator stops the decode there (the rows above it
  stay 0: Pillow reports no error); a row whose chunks end before its
  width keeps the previous row's samples past them (the decoder's row
  buffer); a copy or run that would read the file's last byte, a run past
  the width or an offset before the header is an overrun, an error;
- a raw file too short for its planes is "image file is truncated".
The run-length loop is the native library's gatling_sgi_rle_decode.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish

# (bpc, dimension, zsize) -> Pillow's raw mode (SgiImagePlugin.MODES)
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
         (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}
HEADER = 512


def decode_sgi(data: bytes) -> np.ndarray:
    if len(data) < 2 or struct.unpack_from(">H", data)[0] != 474:
        raise Skip("not an SGI file")
    s = data[:HEADER]
    if len(s) < 12:
        raise Skip("SGI: short header")  # struct.error in i16
    compression, bpc = s[2], s[3]
    dimension, w, h, zsize = struct.unpack_from(">HHHH", s, 4)
    rawmode = MODES.get((bpc, dimension, zsize))
    if rawmode is None:
        raise ValueError("Unsupported SGI image mode")
    mode = rawmode.split(";")[0]
    if compression not in (0, 1) or w == 0 or h == 0:
        raise Skip("not identified by this plugin")  # no tile: Pillow's "no mode/size" skip
    bomb_check(w, h)
    bands = len(mode)
    if compression == 0:
        page = w * h * bpc
        if len(data) < HEADER + page * bands:
            raise ValueError("image file is truncated")
        planes = np.frombuffer(data, np.uint8, page * bands, HEADER).reshape(bands, h, w, bpc)
        px = planes[..., 0].transpose(1, 2, 0)  # the high byte of a 16-bit sample
    else:
        buf = np.frombuffer(data, np.uint8, len(data) - HEADER, HEADER) if len(data) > HEADER \
            else np.zeros(0, np.uint8)
        src = np.ascontiguousarray(buf)
        rows = np.zeros((h, w * bands * bpc), np.uint8)
        got = native.library().gatling_sgi_rle_decode(
            native.ptr(src, ctypes.c_uint8), src.size, w, h, bands, bpc,
            native.ptr(rows, ctypes.c_uint8))
        if got < 0:
            raise ValueError("SGI: RLE data overruns its rows")
        px = rows.reshape(h, w, bands, bpc)[..., 0]
    return finish(mode, np.ascontiguousarray(px[::-1]))


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def encode_sgi(img: np.ndarray, path: str) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes
    SgiImagePlugin._save writes for `path` (whatever its extension): the
    512-byte header, uncompressed, 1 byte a sample, the file's base name
    without its extension in the name field; then each channel's rows,
    bottom to top."""
    img = np.asarray(img, np.uint8)
    planes = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
    z, h, w = planes.shape
    dimension = (1 if h == 1 else 2) if img.ndim == 2 else 3
    name = os.path.splitext(os.path.basename(path))[0].encode("ascii", "ignore")
    head = (struct.pack(">hBBHHHHll", 474, 0, 1, dimension, w, h, z, 0, 255) + b"\0" * 4
            + struct.pack("79s", name) + b"\0" + struct.pack(">l", 0) + b"\0" * 404)
    return head + np.ascontiguousarray(planes[:, ::-1]).tobytes()
