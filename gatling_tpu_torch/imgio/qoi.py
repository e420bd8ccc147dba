"""QOI as Pillow's QoiImagePlugin reads it (the JAX package's imgio goes
through Pillow).

Pillow's decoder, op for op: QOI_OP_RGB, _RGBA, _INDEX (an unseen slot is
(0, 0, 0, 0)), _DIFF, _LUMA and _RUN, the running pixel starting at
(0, 0, 0, 255). A header of 3 channels is RGB, any other count RGBA. Data
that ends before the last pixel raises ValueError, as Pillow's decoder
fails there.
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> RGBA, the JAX package's imgio.load_image(data).data."""
    if not data.startswith(b"qoif"):
        raise Skip("not a QOI file")
    if len(data) < 13:
        raise Skip("QOI: short header")
    w, h = struct.unpack_from(">II", data, 4)
    bands = 3 if data[12] == 3 else 4
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    need = w * h * bands
    out = bytearray()
    seen: dict[int, bytes] = {}
    prev = bytes((0, 0, 0, 255))
    pos = 14
    try:
        while len(out) < need:
            byte = data[pos]
            pos += 1
            if byte == 0xFE:
                value = data[pos:pos + 3] + prev[3:]
                pos += 3
            elif byte == 0xFF:
                value = data[pos:pos + 4]
                pos += 4
            else:
                op = byte >> 6
                if op == 0:
                    value = seen.get(byte & 63, bytes(4))
                elif op == 1:
                    value = bytes(((prev[0] + ((byte >> 4) & 3) - 2) % 256,
                                   (prev[1] + ((byte >> 2) & 3) - 2) % 256,
                                   (prev[2] + (byte & 3) - 2) % 256, prev[3]))
                elif op == 2:
                    second = data[pos]
                    pos += 1
                    dg = (byte & 63) - 32
                    dr, db = (second >> 4) - 8, (second & 15) - 8
                    value = bytes(((prev[0] + dg + dr) % 256, (prev[1] + dg) % 256,
                                   (prev[2] + dg + db) % 256, prev[3]))
                else:
                    out += (prev if bands == 4 else prev[:3]) * ((byte & 63) + 1)
                    continue
            if len(value) != 4:
                raise ValueError("QOI: truncated pixel data")
            prev = value
            r, g, b, a = value
            seen[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = value
            out += value if bands == 4 else value[:3]
    except IndexError as e:
        raise ValueError("QOI: truncated pixel data") from e
    px = np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w, bands)
    return finish("RGB" if bands == 3 else "RGBA", px)
