"""Windows icons (.ico) as Pillow 12.1's IcoImagePlugin._save writes them
(the JAX package's writer goes through Pillow; the reader is bmp.py's
decode_ico): one PNG frame for each of Pillow's default sizes that fits
the image, each a LANCZOS thumbnail (resample.py) of the image to that size
(its aspect kept), or the image itself at its own size.
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio import resample

SIZES = ((16, 16), (24, 24), (32, 32), (48, 48), (64, 64), (128, 128), (256, 256))


def frames(img: np.ndarray) -> list[np.ndarray]:
    """The images IcoImagePlugin._save stores for img, in file order."""
    h, w = img.shape[:2]
    return [img if (w, h) == size else resample.thumbnail(img, size)
            for size in SIZES if size[0] <= w and size[1] <= h]


def encode_ico(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> Pillow's .ico
    bytes: the directory (width and height, 0 for 256; 32 bits a pixel) and
    the frames as PNG (the port's encode_png, Pillow's bytes)."""
    from gatling_tpu_torch.imgio import encode_png

    pngs = [(f.shape[1], f.shape[0], encode_png(f)) for f in frames(np.asarray(img, np.uint8))]
    head = [b"\0\0\1\0" + struct.pack("<H", len(pngs))]
    offset = 6 + 16 * len(pngs)
    for w, h, data in pngs:
        head.append(bytes((w if w < 256 else 0, h if h < 256 else 0, 0, 0))
                    + struct.pack("<HHII", 0, 32, len(data), offset))
        offset += len(data)
    return b"".join(head + [data for *_, data in pngs])
