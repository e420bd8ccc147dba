"""Radiance HDR (.hdr / RGBE) codec in pure NumPy: the port's copy of the
JAX package's imgio/hdr.py, the same operations.

The reference decodes Radiance HDR through stb (src/imgio/impl/HdrDecoder.cpp);
this reads the format directly: flat and new-style run-length scanlines.
RGBE->float conversion matches stb: f = c * 2^(e - 136).
"""

from __future__ import annotations

import io

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float32 -> [..., 4] uint8 RGBE (stb-compatible encoding)."""
    maxc = rgb.max(axis=-1)
    valid = maxc >= 1e-32
    mant, exp = np.frexp(np.where(valid, maxc, 1.0))
    scale = mant * 256.0 / np.where(valid, maxc, 1.0)
    out = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    quant = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., :3] = np.where(valid[..., None], quant, 0)
    out[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    return out


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode a Radiance HDR file to [H, W, 4] float32 (alpha = 1)."""
    f = io.BytesIO(data)
    magic = f.readline().strip()
    if not magic.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    # header lines until blank
    while True:
        line = f.readline()
        if line in (b"\n", b"\r\n", b""):
            break
    res = f.readline().split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR resolution spec: {res!r}")
    height, width = int(res[1]), int(res[3])

    body = np.frombuffer(f.read(), dtype=np.uint8)
    pos = 0
    rgbe = np.zeros((height, width, 4), dtype=np.uint8)

    for y in range(height):
        if width < 8 or width > 0x7FFF or body[pos] != 2 or body[pos + 1] != 2 or (body[pos + 2] & 0x80):
            # flat (old-style) scanline
            rgbe[y] = body[pos:pos + width * 4].reshape(width, 4)
            pos += width * 4
            continue
        if (int(body[pos + 2]) << 8 | int(body[pos + 3])) != width:
            raise ValueError("HDR scanline width mismatch")
        pos += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(body[pos]); pos += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = body[pos]
                    pos += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x:x + count, c] = body[pos:pos + count]
                    pos += count
                    x += count

    out = np.ones((height, width, 4), dtype=np.float32)
    out[:, :, :3] = _rgbe_to_float(rgbe)
    return out


def encode_hdr(rgb: np.ndarray) -> bytes:
    """Encode [H, W, >=3] float data as a flat (non-RLE) Radiance HDR file."""
    rgb = np.asarray(rgb, dtype=np.float32)[:, :, :3]
    h, w = rgb.shape[:2]
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return header + _float_to_rgbe(rgb).tobytes()
