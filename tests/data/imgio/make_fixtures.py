"""Write the image fixtures of tests/test_torch_imgio.py and chip_smoke.py
phase 4n, and fixtures.npz beside them: for each file, the array the JAX
package decodes it to (gatling_tpu.imgio.load_image(data).data), which the
port's decoders must equal bit for bit, also where Pillow is absent.

Pillow writes every file it can write: JPEG baseline at 4:2:0, 4:2:2 and
4:4:4, with restart markers, progressive and grey; TGA raw and run-length;
TIFF LZW with predictor 2, Deflate of 16-bit grey, Deflate of floats with
predictor 3; 16-bit and 1-bit grey PNGs. `raw_png` writes the two PNGs
Pillow cannot: Adam7-interlaced, and 16-bit RGB. The images are smooth
procedural textures with a little noise, from a seed.

Run from the repository root, where Pillow and JAX are installed:

    JAX_PLATFORMS=cpu python tests/data/imgio/make_fixtures.py
"""

from __future__ import annotations

import io
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def texture(h: int, w: int, channels: int, seed: int, depth: int = 8) -> np.ndarray:
    """A smooth colourful pattern with noise: [h, w, channels] of `depth`
    bits (uint8 or uint16)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    phase = rng.uniform(0, 6.3, channels)
    base = np.stack([0.5 + 0.35 * np.sin(9.0 * xx + 5.0 * yy * (k + 1) + phase[k])
                     for k in range(channels)], axis=-1)
    tiles = ((xx * 6).astype(int) + (yy * 6).astype(int)) % 2
    img = base * (0.8 + 0.2 * tiles[..., None]) + rng.normal(0, 0.03, base.shape)
    top = (1 << depth) - 1
    return np.clip(np.round(img * top), 0, top).astype(np.uint8 if depth == 8 else np.uint16)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def raw_png(samples: np.ndarray, interlace: bool = False, depth: int | None = None,
            colour_type: int | None = None, palette: bytes | None = None,
            trns: bytes | None = None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of samples [h, w, c] (uint8 or uint16, or the values of a
    1/2/4-bit depth), each row filtered by the next of `filters` in turn
    (the filter is undone by the decoder whatever the row holds)."""
    h, w, c = samples.shape
    depth = depth or samples.dtype.itemsize * 8
    ctype = COLOUR_TYPES[c] if colour_type is None else colour_type

    def rows(px: np.ndarray) -> bytes:
        if depth == 16:
            lines = px.astype(">u2").reshape(px.shape[0], -1).view(np.uint8)
        elif depth < 8:
            bits = (px.reshape(px.shape[0], -1, 1).astype(np.uint8)
                    >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
            lines = np.packbits(bits.reshape(px.shape[0], -1), axis=1)
        else:
            lines = px.astype(np.uint8).reshape(px.shape[0], -1)
        bpp = max(1, c * depth // 8)
        out = bytearray()
        prev = np.zeros(lines.shape[1], np.int32)
        for y, line in enumerate(lines.astype(np.int32)):
            f = filters[y % len(filters)]
            left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            if f == 4:
                p = left + prev - upleft
                pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            else:
                pred = [0 * line, left, prev, (left + prev) >> 1][f]
            out += bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
            prev = line
        return bytes(out)

    if interlace:
        raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                       if x0 < w and y0 < h)
    else:
        raw = rows(samples)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
            + (_chunk(b"PLTE", palette) if palette is not None else b"")
            + (_chunk(b"tRNS", trns) if trns is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def pillow(img: np.ndarray, fmt: str, mode: str | None = None, **kwargs) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(img.squeeze(-1) if img.ndim == 3 and img.shape[2] == 1 else img)
    if mode:
        im = im.convert(mode) if mode == "1" else im
    im.save(buf, fmt, **kwargs)
    return buf.getvalue()


def fixtures() -> dict[str, bytes]:
    """Every fixture's file name and bytes."""
    from PIL import Image

    grey16 = texture(64, 64, 1, 12, depth=16)[..., 0]
    buf = io.BytesIO()
    Image.frombytes("I;16", (64, 64), grey16.astype("<u2").tobytes()).save(buf, "PNG")
    png_grey16 = buf.getvalue()
    buf = io.BytesIO()
    Image.frombytes("I;16", (50, 40), texture(40, 50, 1, 13, depth=16)[..., 0]
                    .astype("<u2").tobytes()).save(buf, "TIFF", compression="tiff_adobe_deflate")
    tiff_deflate16 = buf.getvalue()
    floats = (texture(40, 48, 1, 14).astype(np.float32)[..., 0] / 64.0 - 1.0)
    buf = io.BytesIO()
    Image.fromarray(floats, "F").save(buf, "TIFF", compression="tiff_adobe_deflate",
                                      tiffinfo={317: 3})
    tiff_float = buf.getvalue()
    return {
        "jpeg_420.jpg": pillow(texture(93, 117, 3, 1), "JPEG"),
        "jpeg_422.jpg": pillow(texture(80, 96, 3, 2), "JPEG", subsampling=1),
        "jpeg_444.jpg": pillow(texture(72, 80, 3, 3), "JPEG", subsampling=0, quality=90),
        "jpeg_restart.jpg": pillow(texture(96, 128, 3, 4), "JPEG", restart_marker_blocks=3),
        "jpeg_progressive.jpg": pillow(texture(77, 101, 3, 5), "JPEG", progressive=True),
        "jpeg_grey.jpg": pillow(texture(66, 90, 1, 6), "JPEG"),
        "tga_raw.tga": pillow(texture(48, 64, 3, 7), "TGA"),
        "tga_rle.tga": pillow(texture(50, 70, 4, 8), "TGA", compression="tga_rle"),
        "tiff_lzw_pred2.tif": pillow(texture(60, 80, 3, 9), "TIFF", compression="tiff_lzw",
                                     tiffinfo={317: 2}),
        "tiff_deflate16.tif": tiff_deflate16,
        "tiff_float.tif": tiff_float,
        "png_interlaced.png": raw_png(texture(55, 77, 4, 10), interlace=True),
        "png_rgb16.png": raw_png(texture(44, 60, 3, 11, depth=16)),
        "png_grey16.png": png_grey16,
        "png_grey1.png": pillow(texture(48, 64, 1, 15) > 127, "PNG"),
    }


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from gatling_tpu import imgio

    decoded = {}
    for name, data in fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        decoded[name] = imgio.load_image(data).data
        print(f"{name}: {len(data)} bytes, {decoded[name].dtype} {decoded[name].shape}")
    np.savez_compressed(os.path.join(HERE, "fixtures.npz"), **decoded)
    return 0


if __name__ == "__main__":
    sys.exit(main())
