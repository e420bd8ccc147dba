"""QOI as Pillow's QoiImagePlugin reads it (the JAX package's imgio goes
through Pillow).

Pillow's decoder, op for op: QOI_OP_RGB, _RGBA, _INDEX (an unseen slot is
(0, 0, 0, 0)), _DIFF, _LUMA and _RUN, the running pixel starting at
(0, 0, 0, 255). A header of 3 channels is RGB, any other count RGBA. Data
that ends before the last pixel raises ValueError, as Pillow's decoder
fails there.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
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


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def encode_qoi(img: np.ndarray) -> bytes:
    """[H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes QoiImagePlugin
    writes (colour space 1, linear; the ops of its QoiEncoder, run by the
    native library's gatling_qoi_encode). Grey raises ValueError, as
    Pillow does."""
    img = np.asarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("Unsupported QOI image mode")
    h, w, c = img.shape
    px = np.ascontiguousarray(img)
    cap = px.size + h * w + 64
    out = np.empty(cap, np.uint8)
    n = native.library().gatling_qoi_encode(native.ptr(px, ctypes.c_uint8), h * w, c,
                                            native.ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError("QOI: output overran its buffer")
    return b"qoif" + struct.pack(">IIBB", w, h, c, 1) + out[:n].tobytes()


def ops_ref(img: np.ndarray) -> bytes:
    """The NumPy twin of encode_qoi's native ops (QoiEncoder.encode)."""
    img = np.asarray(img, np.uint8)
    c = img.shape[2]
    seen = {0: (0, 0, 0, 0)}
    prev, run, out = (0, 0, 0, 255), 0, bytearray()

    def delta(a: int, b: int) -> int:
        r = (a - b) & 255
        return r - 256 if r >= 128 else r

    for p in img.reshape(-1, c).tolist():
        p = tuple(p) if c == 4 else (*p, 255)
        if p == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
        else:
            if run:
                out.append(0xC0 | (run - 1))
                run = 0
            r, g, b, a = p
            k = (r * 3 + g * 5 + b * 7 + a * 11) % 64
            if seen.get(k) == p:
                out.append(k)
            else:
                seen[k] = p
                if prev[3] == a:
                    dr, dg, db = delta(r, prev[0]), delta(g, prev[1]), delta(b, prev[2])
                    if -2 <= dr < 2 and -2 <= dg < 2 and -2 <= db < 2:
                        out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                    else:
                        dgr, dgb = delta(dr, dg), delta(db, dg)
                        if -8 <= dgr < 8 and -32 <= dg < 32 and -8 <= dgb < 8:
                            out.extend((0x80 | (dg + 32), (dgr + 8) << 4 | (dgb + 8)))
                        else:
                            out.extend((0xFE, r, g, b))
                else:
                    out.extend((0xFF, r, g, b, a))
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    return bytes(out) + bytes((0, 0, 0, 0, 0, 0, 0, 1))
