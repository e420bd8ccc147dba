"""Photoshop documents as Pillow's PsdImagePlugin reads them: the merged
image (the JAX package's imgio goes through Pillow).

Pillow reads 8-bit documents in bitmap, grey, palette (a 768-byte colour
table, stored as three planes), RGB, CMYK, multichannel, duotone and Lab
mode, raw or PackBits, and takes only the channels its mode has: an RGB
document of exactly four channels is RGBA, every other extra channel is
dropped (so a grey or CMYK document keeps no alpha). CMYK channels are
stored inverted ("C;I" ...) and converted to RGBA as Pillow converts CMYK;
Lab's a and b channels have their sign bit flipped, and the three bands
come out as R, G and B. A PackBits packet that runs past its line's end is
cut there, as Pillow's decoder cuts it.
Other depths (16 and 32 bits) and modes are refused by Pillow: ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish, unpack_bits

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


def _u16(f: Reader) -> int:
    s = f.read(2)
    if len(s) < 2:
        raise Skip("PSD: short read")
    return struct.unpack(">H", s)[0]


def _u32(f: Reader) -> int:
    s = f.read(4)
    if len(s) < 4:
        raise Skip("PSD: short read")
    return struct.unpack(">I", s)[0]


def _packbits_lines(data: bytes, pos: int, line: int, rows: int) -> np.ndarray:
    """PackbitsDecode.c: `rows` lines of `line` bytes from data[pos:], each
    line from its own packets (a packet that runs past the line's end is
    cut there); data that ends first is a truncated file (ValueError)."""
    out = np.zeros((rows, line), np.uint8)
    n = len(data)
    for y in range(rows):
        x = 0
        while x < line:
            if pos >= n:
                raise ValueError("image file is truncated")
            c = data[pos]
            if c == 0x80:
                pos += 1
                continue
            if c & 0x80:
                if pos + 2 > n:
                    raise ValueError("image file is truncated")
                k = min(257 - c, line - x)
                out[y, x:x + k] = data[pos + 1]
                pos += 2
            else:
                if pos + 2 + c > n:
                    raise ValueError("image file is truncated")
                k = min(c + 1, line - x)
                out[y, x:x + k] = np.frombuffer(data, np.uint8, k, pos + 1)
                pos += 2 + c
            x += k
    return out


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes -> RGBA of the merged image, the JAX package's
    imgio.load_image(data).data."""
    f = Reader(data)
    s = f.read(26)
    if not s.startswith(b"8BPS") or len(s) < 6 or struct.unpack_from(">H", s, 4)[0] != 1:
        raise Skip("not a PSD file")
    if len(s) < 26:
        raise Skip("PSD: short header")
    psd_channels, height, width, bits, psd_mode = struct.unpack_from(">HIIHH", s, 12)
    if (psd_mode, bits) not in _MODES:
        raise ValueError(f"PSD: Pillow reads no mode {psd_mode} at {bits} bits")
    mode, channels = _MODES[(psd_mode, bits)]
    if channels > psd_channels:
        raise ValueError("not enough channels")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    palette = None
    size = _u32(f)
    if size:
        block = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(block, np.uint8).reshape(3, 256).T
    size = _u32(f)
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            _u16(f)
            s = f.read(1)
            if not s:
                raise Skip("PSD: short read")
            name = f.read(s[0])
            if not len(name) & 1:
                f.read(1)
            block = f.read(_u32(f))
            if len(block) & 1:
                f.read(1)
    size = _u32(f)
    if size:
        end = f.pos + size
        _u32(f)
        f.pos = end
    compression = _u16(f)
    if width <= 0 or height <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(width, height)
    line = (width + 7) // 8 if mode == "1" else width
    planes = []
    if compression == 0:
        offset = f.pos
        for _ in range(channels):
            chunk = data[offset:offset + line * height]
            if len(chunk) < line * height:
                raise ValueError("image file is truncated")
            planes.append(np.frombuffer(chunk, np.uint8).reshape(height, line))
            offset += width * height
    elif compression == 1:
        counts = f.read(channels * height * 2)
        if len(counts) < channels * height * 2:
            raise Skip("PSD: short byte counts")
        counts = np.frombuffer(counts, ">u2").astype(np.int64)
        offset = f.pos
        for c in range(channels):
            planes.append(_packbits_lines(data, offset, line, height))
            offset += int(counts[c * height:(c + 1) * height].sum())
    else:
        raise ValueError(f"PSD: Pillow decodes no compression {compression}")
    if mode == "1":
        return finish("1", unpack_bits(planes[0], width, 1) != 0)
    px = np.stack(planes, axis=-1)
    if mode == "CMYK":
        px = 255 - px
    if mode == "LAB":  # Pillow's "A" and "B" raw modes flip the sign bit
        px[..., 1:] ^= 0x80
        mode = "RGB"
    return finish(mode, px, palette)
