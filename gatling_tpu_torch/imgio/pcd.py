"""Kodak Photo CD images (.pcd) as Pillow 12.1 reads them (PcdImagePlugin,
PcdDecode.c and the "YCC;P" unpacker), for the JAX package's imgio: the
768 x 512 base image.

Quirks reproduced:
- the image data at sector 96; each pair of rows two luma rows, then a
  row of each chroma at half the width, each chroma sample shared by a 2 x
  2 block (no interpolation);
- PhotoYCC to RGB by the five integer tables of Pillow's
  libImaging/UnpackYCC.c (its YCC2RGB): R = L[y] + CR[cr], G = L[y] +
  GR[cr] + GB[cb], B = L[y] + CB[cb], each clipped to 0-255. `_TABLES`
  writes each table as its first value and the steps between its 256
  entries (a step of 0-3; L and CR, CB rise, GR and GB fall, each of the
  chroma tables 0 at its neutral code, CR and GR at 137, CB and GB at
  156);
- the header's orientation (byte 1538 of sector 1, low two bits) 1
  rotates the image 90 degrees counter-clockwise, 3 by 270 (512 x 768);
- a file shorter than the base image is "image file is truncated".
"""

from __future__ import annotations

import numpy as np

from gatling_tpu_torch.imgio.modes import Skip, finish

W, H = 768, 512
OFFSET = 96 * 2048

# UnpackYCC.c's tables: name: (first value, the sign of the steps, the
# steps' sizes)
_TABLES = {
    "L": (0, 1, (
        "1211212112112112112121121121121121211211211211212112112112121121"
        "1211211212112112112112121121121121121211211211211212112112112121"
        "1211211211212112112112112121121121121121211211211212112112112112"
        "121121121121121211211211211212112112112121121121121121211211211")),
    "CR": (-249, 1, (
        "2222212222122222122222122221222221222212222212222212222122222122"
        "2212222212222212222122222122221222221222221222212222212222122222"
        "1222221212212222212222212222122222122221222221222221222212222212"
        "222122222122222122221222221222212222212222212222122222122221222")),
    "CB": (-345, 1, (
        "2232223222232222322232222322232222322232222322223222322223222322"
        "2232222322232222322232222322223222322223222322223222322223222232"
        "2232222322232222322223222321223222322223222232223222232223222232"
        "222322232222322232222322232222322223222322223222322223222232223")),
    "GR": (127, -1, (
        "1111110111111111111101111111111111011111111111101111111111111011"
        "1111111111101111111111110111111111111101111111111111011111111111"
        "1101111110111110111111111111101111111111111011111111111110111111"
        "111111011111111111110111111111111101111111111110111111111111101")),
    "GB": (67, -1, (
        "0101001010100101010010101001010101001010100101010010101001010100"
        "1010100101010010101001010100101010010101001010100101010100101010"
        "0101010010101001010100101010000101001010100101010010101001010100"
        "101010100101010010101001010100101010010101001010100101010010101")),
}


def _table(name: str) -> np.ndarray:
    first, sign, steps = _TABLES[name]
    return first + sign * np.concatenate([[0], np.cumsum([int(c) for c in steps])])


def ycc_tables() -> dict[str, np.ndarray]:
    return {name: _table(name).astype(np.int32) for name in _TABLES}


def decode_pcd(data: bytes) -> np.ndarray:
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise Skip("not a PCD file")
    if len(s) < 1539:
        raise Skip("PCD: short header")  # IndexError on s[1538]
    orientation = s[1538] & 3
    need = OFFSET + H // 2 * 3 * W
    if len(data) < need:
        raise ValueError("image file is truncated")
    pairs = np.frombuffer(data, np.uint8, H // 2 * 3 * W, OFFSET).reshape(H // 2, 3 * W)
    y = pairs[:, :2 * W].reshape(H, W)
    c1 = np.repeat(np.repeat(pairs[:, 2 * W:5 * W // 2], 2, 0), 2, 1)
    c2 = np.repeat(np.repeat(pairs[:, 5 * W // 2:], 2, 0), 2, 1)
    t = ycc_tables()
    lum = t["L"][y]
    rgb = np.stack([lum + t["CR"][c2], lum + t["GR"][c2] + t["GB"][c1], lum + t["CB"][c1]], -1)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, 3)
    return finish("RGB", np.ascontiguousarray(rgb))
