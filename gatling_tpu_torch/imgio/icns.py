"""Apple icon files (.icns) as Pillow 12.1 reads them (IcnsImagePlugin),
for the JAX package's imgio.

Quirks reproduced:
- the element directory up to the header's file size, a later element of
  a type replacing an earlier one; the largest (width, height, scale) that
  any known element gives is the image;
- at that size, a PNG or JPEG 2000 element wins: a PNG is the PNG read from
  the element's start to wherever its chunks end (its own mode: the JAX
  package's array of that PNG), a JPEG 2000 stream its RGBA conversion;
- else the RGB element (`it32` after its 4 zero bytes, `ih32`, `il32`,
  `is32`): raw when its length is exactly 3 bytes a pixel, else three
  packbits-like channels one after another (a run of byte - 125 copies, a
  literal of byte + 1 bytes), each filling exactly its pixels or failing;
  with its `*8mk` mask as alpha (RGBA), else RGB;
- a mask alone, or no known element, fails.
The channel loop is the native library's gatling_icns_rle_channel.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio import jpeg2000
from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish, to_rgba

_PNG = "png"
# IcnsFile.SIZES: (width, height, scale) -> its element types, in order
SIZES = {
    (512, 512, 2): [(b"ic10", _PNG)], (512, 512, 1): [(b"ic09", _PNG)],
    (256, 256, 2): [(b"ic14", _PNG)], (256, 256, 1): [(b"ic08", _PNG)],
    (128, 128, 2): [(b"ic13", _PNG)],
    (128, 128, 1): [(b"ic07", _PNG), (b"it32", "32t"), (b"t8mk", "mk")],
    (64, 64, 1): [(b"icp6", _PNG)], (32, 32, 2): [(b"ic12", _PNG)],
    (48, 48, 1): [(b"ih32", "32"), (b"h8mk", "mk")],
    (32, 32, 1): [(b"icp5", _PNG), (b"il32", "32"), (b"l8mk", "mk")],
    (16, 16, 2): [(b"ic11", _PNG)],
    (16, 16, 1): [(b"icp4", _PNG), (b"is32", "32"), (b"s8mk", "mk")],
}


def _png_or_jpeg2000(data: bytes, start: int, length: int) -> np.ndarray:
    from gatling_tpu_torch.imgio import decode_png

    sig = data[start:start + 12]
    if sig.startswith(b"\x89PNG\x0d\x0a\x1a\x0a"):
        return decode_png(data[start:], transparency=False)
    if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
            sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
        img = jpeg2000.decode_jpeg2000(data[start:start + max(length, 0)])
        if img.dtype == np.uint8:
            return img
        # an "I;16" image's convert("RGBA"): each code clipped to 255
        codes = np.rint(img[..., 0] * np.float32(65535.0)).astype(np.int64)
        return to_rgba(np.minimum(codes, 255).astype(np.uint8))
    raise ValueError("Unsupported icon subimage format")


def _rgb(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    """read_32: [side, side, 3]."""
    n = side * side
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError("not enough image data")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3)
    src = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    pos = ctypes.c_int64(min(start, len(data)))
    written = ctypes.c_int64()
    bands = []
    for _ in range(3):
        out = np.zeros(n, np.uint8)
        left = native.library().gatling_icns_rle_channel(
            native.ptr(src, ctypes.c_uint8), src.size, ctypes.byref(pos), n,
            native.ptr(out, ctypes.c_uint8), ctypes.byref(written))
        if left != 0:
            raise ValueError(f"Error reading channel [{left} left]")
        if written.value < n:
            raise ValueError("not enough image data")
        bands.append(out.reshape(side, side))
    return np.stack(bands, -1)


def decode_icns(data: bytes) -> np.ndarray:
    if not data.startswith(b"icns"):
        raise Skip("not an icns file")
    if len(data) < 8:
        raise Skip("icns: short header")
    (filesize,) = struct.unpack_from(">i", data, 4)
    elements: dict[bytes, tuple[int, int]] = {}
    i = pos = 8
    while i < filesize:
        if pos + 8 > len(data):
            raise Skip("icns: short element header")  # struct.error in nextheader
        sig, size = struct.unpack_from(">4si", data, pos)
        if size <= 0:
            raise Skip("invalid block header")
        i += 8
        elements[sig] = (i, size - 8)
        pos += size
        i += size - 8
    sizes = [size for size, kinds in SIZES.items() if any(k in elements for k, _ in kinds)]
    if not sizes:
        raise Skip("No 32bit icon resources found")
    best = max(sizes)
    side = best[0] * best[2]
    bomb_check(side, side)
    channels: dict[str, np.ndarray] = {}
    for kind, reader in SIZES[best]:
        if kind not in elements:
            continue
        start, length = elements[kind]
        if reader == _PNG:
            channels["RGBA"] = _png_or_jpeg2000(data, start, length)
        elif reader == "mk":
            raw = data[start:start + side * side]
            if len(raw) < side * side:
                raise ValueError("not enough image data")
            channels["A"] = np.frombuffer(raw, np.uint8).reshape(side, side)
        else:
            if reader == "32t":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("Unknown signature, expecting 0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb(data, start, length, side)
    if "RGBA" in channels:
        img = channels["RGBA"]
        h, w = img.shape[:2]
        # IcnsImageFile's size setter: the payload's size must divide one
        # of the file's sizes evenly
        if not any(w and h and (s[1] * s[2]) / h == (s[0] * s[2]) // w for s in sizes):
            raise ValueError("This is not one of the allowed sizes of this image")
        return img
    if "RGB" not in channels:
        raise ValueError("icns: a mask without its icon")  # KeyError in getimage
    if "A" in channels:
        return np.concatenate([channels["RGB"], channels["A"][..., None]], -1)
    return finish("RGB", channels["RGB"])
