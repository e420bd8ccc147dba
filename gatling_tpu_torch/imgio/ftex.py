"""FTEX textures (Independence War 2) as Pillow 12.1 reads them
(FtexImagePlugin), for the JAX package's imgio.

Quirks reproduced: one format only (a count other than 1 fails); format 0
is DXT1 through Pillow's BC1 decoder (BcnDecode.c, the same blocks as
dds.py's: RGBA, the 3-colour blocks' index 3 transparent), format 1 raw
RGB; the first mipmap alone, its size word at the offset the header gives;
a mipmap shorter than its image is "image file is truncated".
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio import dds
from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish


def decode_ftex(data: bytes) -> np.ndarray:
    if not data.startswith(b"FTEX"):
        raise Skip("not an FTEX file")
    if len(data) < 32:
        raise Skip("FTEX: short header")  # struct.error
    w, h, _mips, count = struct.unpack_from("<4i", data, 8)
    if count != 1:
        raise ValueError("FTEX: format count is not 1")  # an AssertionError in Pillow
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0 or len(data) < where + 4:
        raise Skip("FTEX: short read")
    (size,) = struct.unpack_from("<i", data, where)
    mip = data[where + 4:where + 4 + size] if size >= 0 else data[where + 4:]  # read(-n): all
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt}")
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    if fmt == 0:
        if len(mip) < ((w + 3) // 4) * ((h + 3) // 4) * 8:
            raise ValueError("image file is truncated")
        return finish("RGBA", dds.bcn_decode(mip, 1, 0, w, h))
    if len(mip) < w * h * 3:
        raise ValueError("image file is truncated")
    return finish("RGB", np.frombuffer(mip, np.uint8, w * h * 3).reshape(h, w, 3))
