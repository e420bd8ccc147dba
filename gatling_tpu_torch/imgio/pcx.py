"""PCX and DCX images as Pillow 12.1 reads them (PcxImagePlugin,
DcxImagePlugin, PcxDecode.c), for the JAX package's imgio.

Quirks reproduced:
- 1 bit in 1 plane is mode "1"; 1 bit in 2 or 4 planes "P" over the
  header's 16-colour palette, its planes read ("P;2L", "P;4L") at
  ceil(width / 8) bytes apart whatever the stride; 8 bits in 1 plane
  (version 5) "L", or "P" when the last 769 bytes of the file are 12 and a
  palette that is not the grey ramp; 8 bits in 3 planes RGB;
- the stride is the header's where it equals ceil(width * bits / 8), else
  that rounded up to even; the decoder's rows are planes x stride bytes,
  the planes moved together where that is not a multiple of the width
  (PcxDecode.c's memmove);
- a run longer than the row left fails the image once it is decoded; a
  file that ends first is "image file is truncated";
- DCX: the first frame of the directory, read as a PCX file at its
  offset, its VGA palette still the last 769 bytes of the whole file.
The run-length loop is the native library's gatling_pcx_decode.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.identify import i16, i32
from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish, unpack_bits


def _accept(p: bytes) -> bool:
    return len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)


def _planes(rows: np.ndarray, w: int, planes: int) -> np.ndarray:
    """Unpack.c's unpackP2L / unpackP4L: bit planes (pixels + 7) / 8 bytes
    apart, plane k worth 2^k."""
    s = (w + 7) // 8
    out = np.zeros((rows.shape[0], w), np.uint8)
    for k in range(planes):
        out |= unpack_bits(np.ascontiguousarray(rows[:, k * s:(k + 1) * s]), w, 1) << k
    return out


def decode_frame(data: bytes, at: int) -> np.ndarray:
    """PcxImageFile._open and load of the PCX image at data[at:] (the VGA
    palette from the end of data)."""
    s = data[at:at + 68]
    if not _accept(s):
        raise Skip("not a PCX file")
    x0, y0, x1, y1 = i16(s, 4), i16(s, 6), i16(s, 8) + 1, i16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise Skip("bad PCX image size")
    if len(s) < 68:
        raise Skip("PCX: short header")  # IndexError on s[65]
    version, bits, planes = s[1], s[3], s[65]
    provided = i16(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[max(0, len(data) - 769):]
        if len(tail) == 769 and tail[0] == 12:
            table = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (table == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", table
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError("unknown PCX mode")
    w, h = x1 - x0, y1 - y0
    bomb_check(w, h)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    nbytes = planes * stride
    if (w * (bits * planes if mode != "1" else 1) + 7) // 8 > nbytes:
        raise ValueError("PCX: rows shorter than their pixels")  # IMAGING_CODEC_OVERRUN
    src = np.ascontiguousarray(np.frombuffer(data, np.uint8, max(0, len(data) - at - 128),
                                             min(len(data), at + 128)))
    rows = np.zeros((h, nbytes), np.uint8)
    got = native.library().gatling_pcx_decode(native.ptr(src, ctypes.c_uint8), src.size, w,
                                              nbytes, h, native.ptr(rows, ctypes.c_uint8))
    if got == -2:
        raise ValueError("image file is truncated")
    if got < 0:
        raise ValueError("PCX: a run overruns its row")
    if mode == "1":
        return finish("1", unpack_bits(rows, w, 1))
    if mode == "P" and bits == 1:
        return finish("P", _planes(rows, w, planes), palette)
    if mode == "RGB":  # "RGB;L": a row of R, then of G, then of B
        return finish("RGB", np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1))
    return finish(mode, np.ascontiguousarray(rows[:, :w]), palette)


def decode_pcx(data: bytes) -> np.ndarray:
    return decode_frame(data, 0)


def decode_dcx(data: bytes) -> np.ndarray:
    """DcxImageFile: the component directory (at most 1024 offsets, 0 ends
    it), then the first frame."""
    if len(data) < 4 or i32(data) != 987654321:
        raise Skip("not a DCX file")
    f = Reader(data, 4)
    offsets = []
    for _ in range(1024):
        off = i32(f.read(4))
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise Skip("DCX: no frames")  # IndexError in seek(0)
    return decode_frame(data, offsets[0])
