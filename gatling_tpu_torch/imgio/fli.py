"""FLI and FLC animations as Pillow 12.1 reads them (FliImagePlugin,
FliDecode.c), for the JAX package's imgio: the first frame.

Quirks reproduced:
- the palette is a grey ramp, changed only by the first COLOR chunk
  (types 4 and 11; 11's 6-bit values shifted by 2 and masked to 8 bits)
  of the first frame's subchunks, walked in _open (a prefix chunk 0xF100
  skipped there); the image is "P" over it;
- the frame is decoded from offset 128 whatever came first, so a file
  that starts with a prefix chunk fails to load; the frame is read whole
  (its size word) and its subchunks decoded in order into a zeroed image:
  SS2 word deltas (line skips, the odd last byte), LC byte deltas, BLACK,
  BRUN run-length lines, COPY, the postage stamp ignored; a packet that
  would cross the width ends its line list, and the chunk then fails
  unless every line was done; any other chunk type fails, and so does a
  subchunk that starts fewer than 10 bytes before the frame's end;
- a file that ends inside the frame is "image file is truncated".
The frame loop is the native library's gatling_fli_decode.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.identify import i16, i32
from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish


def _palette(f: Reader, palette: np.ndarray, shift: int) -> None:
    i = 0
    for _ in range(i16(f.read(2))):
        s = f.read(2)
        if len(s) < 2:
            raise Skip("FLI: short colour packet")  # IndexError
        i += s[0]
        n = s[1] or 256
        s = f.read(n * 3)
        if len(s) % 3:
            raise Skip("FLI: short colour packet")  # IndexError
        for k in range(0, len(s), 3):
            if i >= 256:
                raise Skip("FLI: colour index past 255")  # IndexError
            palette[i] = [(s[k] << shift) & 255, (s[k + 1] << shift) & 255,
                          (s[k + 2] << shift) & 255]
            i += 1


def decode_fli(data: bytes) -> np.ndarray:
    s = data[:128]
    if not (len(s) >= 16 and i16(s, 4) in (0xAF11, 0xAF12) and i16(s, 14) in (0, 3)
            and s[20:22] == b"\x00" * 2 and s[42:80] == b"\x00" * 38 and s[88:] == b"\x00" * 40):
        raise Skip("not an FLI/FLC file")
    w, h = i16(s, 8), i16(s, 10)
    i32(s, 16)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    f = Reader(data, 128)
    c = f.read(16)
    if i16(c, 4) == 0xF100:
        f.pos = 128 + i32(c)
        c = f.read(16)
    if i16(c, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(i16(c, 6)):
            if chunk_size is not None:
                f.pos = max(0, f.pos + chunk_size - 6)
            head = f.read(6)
            kind = i16(head, 4)
            if kind in (4, 11):
                _palette(f, palette, 2 if kind == 11 else 0)
                break
            chunk_size = i32(head)
            if not chunk_size:
                break
    if w == 0 or h == 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    size = data[128:132]
    if len(size) < 4:
        raise ValueError("missing frame size")  # EOFError from seek(0)
    (framesize,) = struct.unpack("<I", size)
    frame = np.ascontiguousarray(np.frombuffer(data, np.uint8, min(framesize, len(data) - 128),
                                               128))
    out = np.zeros((h, w), np.uint8)
    got = native.library().gatling_fli_decode(native.ptr(frame, ctypes.c_uint8), frame.size, w,
                                              h, native.ptr(out, ctypes.c_uint8))
    if got == 0:
        raise ValueError("image file is truncated")
    if got < 0:
        raise ValueError("FLI: a broken frame")
    return finish("P", out, palette)
