"""Corrupt TIFF directories in the port's TIFF decoder (imgio/tiff.py)
against the JAX package's imgio (Pillow 12.1, which reads an
uncompressed TIFF itself and hands a compressed one to libtiff).

Pillow writes a TIFF (uncompressed, LZW, Deflate, PackBits, LZMA and ZSTD
of RGB, RGBA and grey; Group 4 of the same images thresholded to one bit);
for each seed two bytes of its first IFD, at the directory's
real offset (its entry count, its entries and the next-IFD offset), are
changed. Each file meets the contract: the same array, or ValueError in
both packages. What this holds the port to: Pillow's own reading of the
directory (a value past the end of the file ends it) for the mode, and
for a compressed file libtiff's (tif_dirread.c TIFFReadDirectory: tags
that must read or the directory is refused, tags left unset when they do
not, strip arrays padded with zeros, byte counts estimated when absent or
zero) for the layout, and Pillow's libtiff decoder's own checks (libtiff's
image size and row size must be Pillow's). A directory whose corruption
names another compression is decoded by that codec, as libtiff does.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from gatling_tpu import imgio as jimgio

from gatling_tpu_torch import imgio

COMPRESSIONS = ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "group4", "lzma", "zstd")
SHAPES = ((40, 56, 3), (33, 30, 4), (20, 24, 1))
SEEDS = 150


def texture(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([0.5 + 0.35 * np.sin(9.0 * xx + 5.0 * yy * (k + 1) + k)
                    for k in range(channels)], axis=-1) + rng.normal(0, 0.03, (h, w, channels))
    img = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def pillow_tiff(arr: np.ndarray, compression: str) -> bytes:
    buf = io.BytesIO()
    img = Image.fromarray(arr)
    if compression == "group4":  # CCITT takes one bit a pixel
        img = img.convert("L").point(lambda v: 255 if v > 127 else 0).convert("1")
    img.save(buf, "TIFF", **({} if compression == "raw" else {"compression": compression}))
    return buf.getvalue()


def ifd_span(data: bytes) -> tuple[int, int]:
    """The first IFD's bytes: its entry count, its entries, the next
    offset."""
    bo = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack_from(bo + "I", data, 4)
    (n,) = struct.unpack_from(bo + "H", data, off)
    return off, off + 2 + 12 * n + 4


def contract(data: bytes) -> str:
    try:
        want = jimgio.load_image(data).data
    except ValueError:
        try:
            imgio.load_image(data)
        except ValueError:
            return "rejected"
        raise AssertionError("the port decoded a file the JAX package rejects")
    got = imgio.load_image(data)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    # a bool array by value: Pillow's "1" arrays hold 255 for True
    assert np.array_equal(got, want) if got.dtype == bool else got.tobytes() == want.tobytes()
    return "array"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_corrupt_directories_meet_the_contract(compression, shape):
    data = pillow_tiff(texture(*shape, len(shape) + shape[2]), compression)
    lo, hi = ifd_span(data)
    seen = set()
    for seed in range(SEEDS):
        rng = np.random.default_rng(seed)
        b = bytearray(data)
        for _ in range(2):
            b[int(rng.integers(lo, hi))] = int(rng.integers(0, 256))
        seen.add(contract(bytes(b)))
    assert {"array", "rejected"} <= seen
