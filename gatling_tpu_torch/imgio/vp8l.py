"""VP8L (WebP's lossless bitstream, RFC 9649) as libwebp 1.6.0 decodes
it, the decoder behind Pillow's WebP plugin (the JAX package's imgio goes
through Pillow).

`image_info` is VP8LGetInfo: the signature byte 0x2F, the 14-bit width
and height (each minus one), the alpha_is_used hint and the 3-bit version,
which must be 0. `decode_vp8l` decodes a whole image and
`decode_alpha_stream` the headerless stream of an ALPH chunk, both through
the native library's gatling_vp8l_decode: the transforms (each type at
most once), the colour cache (1-11 bits), the meta prefix codes, the
prefix codes (simple or from code lengths; a code must be complete unless
it has one symbol), LZ77 with the 120-entry distance map and the colour
cache lookups, then the inverse transforms in reverse order. libwebp's
reader is followed to the bit, its end-of-stream rule included (a stream
of fewer than 8 bytes reads zeros up to 64 bits).

`inverse_transform` runs one inverse transform in the native library;
`inverse_transform_ref` is its NumPy twin, which the tests hold it to bit
for bit: 0 predictor (the 14 modes over 2^bits tiles; 14 and 15 the
black pixel), 1 cross-colour, 2 subtract-green, 3 colour indexing (1, 2,
4 or 8 bits an index, packed LSB first in the green byte).
"""

from __future__ import annotations

import ctypes

import numpy as np

from gatling_tpu_torch import native

SIGNATURE = 0x2F
INFO_FIELDS = ("transforms", "type0", "type1", "type2", "type3", "bits0", "bits1", "bits2",
               "bits3", "cache_bits", "meta_bits", "groups", "alpha_8bit")


def _bits(data: bytes, start: int, n: int) -> int:
    v = int.from_bytes(data[:8].ljust(8, b"\0"), "little")
    return (v >> start) & ((1 << n) - 1)


def image_info(data: bytes) -> tuple[int, int, int]:
    """VP8LGetInfo: (width, height, alpha_is_used); ValueError where
    libwebp rejects the header."""
    if len(data) < 5 or data[0] != SIGNATURE or data[4] >> 5:
        raise ValueError("VP8L: bad signature")
    return _bits(data, 8, 14) + 1, _bits(data, 22, 14) + 1, _bits(data, 36, 1)


def _decode(data: bytes, w: int, h: int, alpha: int) -> tuple[np.ndarray, dict]:
    buf = np.frombuffer(bytes(data), np.uint8)
    argb = np.empty((h, w), np.uint32)
    info = np.zeros(len(INFO_FIELDS), np.int32)
    status = native.library().gatling_vp8l_decode(
        native.ptr(buf, ctypes.c_uint8) if buf.size else None, buf.size, w, h, alpha,
        native.ptr(argb, ctypes.c_uint32), native.ptr(info, ctypes.c_int32))
    if status:
        raise ValueError("VP8L: bitstream error")
    return argb, dict(zip(INFO_FIELDS, info.tolist()))


def decode_vp8l(data: bytes) -> tuple[np.ndarray, dict]:
    """A VP8L chunk's payload -> (uint8 RGBA [h, w, 4] as decoded, alpha
    included whatever the header's hint, the stream's fields)."""
    w, h, _alpha = image_info(data)
    argb, info = _decode(data, w, h, 0)
    return argb_to_rgba(argb), info


def decode_alpha_stream(data: bytes, w: int, h: int) -> np.ndarray:
    """The headerless VP8L stream of a compressed ALPH chunk -> the w x h
    alpha plane before its unfilter (the green channel)."""
    argb, _info = _decode(data, w, h, 1)
    return ((argb >> 8) & 0xFF).astype(np.uint8)


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    """0xAARRGGBB words [h, w] -> uint8 RGBA [h, w, 4]."""
    b = argb.astype("<u4").view(np.uint8).reshape(argb.shape + (4,))  # B, G, R, A
    return np.ascontiguousarray(b[..., [2, 1, 0, 3]])


def inverse_transform(kind: int, bits: int, xsize: int, ysize: int, tdata: np.ndarray,
                      pixels: np.ndarray) -> np.ndarray:
    """gatling_vp8l_inverse_transform: `pixels` (uint32, ysize rows of the
    transform's input width) through the inverse of transform `kind`
    with its data `tdata` (the sub-sampled image, or the expanded colour
    map) -> uint32 [ysize, xsize]."""
    tdata = np.ascontiguousarray(tdata, np.uint32).reshape(-1)
    pixels = np.ascontiguousarray(pixels, np.uint32).reshape(-1)
    out = np.empty((ysize, xsize), np.uint32)
    native.library().gatling_vp8l_inverse_transform(
        kind, bits, xsize, ysize, native.ptr(tdata, ctypes.c_uint32),
        native.ptr(pixels, ctypes.c_uint32), native.ptr(out, ctypes.c_uint32))
    return out


# ---------------------------------------------------------------------------
# NumPy twins of the inverse transforms
# ---------------------------------------------------------------------------

def _bytes(p: np.ndarray) -> np.ndarray:
    """uint32 words [...] -> their bytes [..., 4] as int32 (B, G, R, A)."""
    return p.astype("<u4").view(np.uint8).reshape(p.shape + (4,)).astype(np.int32)


def _words(b: np.ndarray) -> np.ndarray:
    return (b & 0xFF).astype(np.uint8).view("<u4")[..., 0].astype(np.uint32)


def _avg2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a + b) >> 1  # per byte: libwebp's Average2


def _predict(mode: np.ndarray, left: np.ndarray, t: np.ndarray, tl: np.ndarray,
             tr: np.ndarray) -> np.ndarray:
    """The predictors over byte arrays [n, 4] (int32), mode [n]."""
    def half(a, b):  # ClampedAddSubtractHalf, C's division toward zero
        d = a - b
        return np.clip(a + np.where(d < 0, -((-d) // 2), d // 2), 0, 255)

    sel = (np.abs(left - tl).sum(-1) - np.abs(t - tl).sum(-1) <= 0)[:, None]
    preds = [np.broadcast_to(np.array([0, 0, 0, 255]), left.shape), left, t, tr, tl,
             _avg2(_avg2(left, tr), t), _avg2(left, tl), _avg2(left, t), _avg2(tl, t),
             _avg2(t, tr), _avg2(_avg2(left, tl), _avg2(t, tr)), np.where(sel, t, left),
             np.clip(left + t - tl, 0, 255), half(_avg2(left, t), tl)]
    out = np.empty_like(left)
    for m in range(16):
        k = mode == m
        if k.any():
            out[k] = preds[m if m < 14 else 0][k]
    return out


def inverse_transform_ref(kind: int, bits: int, xsize: int, ysize: int, tdata: np.ndarray,
                          pixels: np.ndarray) -> np.ndarray:
    """NumPy twin of inverse_transform."""
    tdata = np.asarray(tdata, np.uint32).reshape(-1)
    if kind == 2:  # add green to red and blue
        b = _bytes(np.asarray(pixels, np.uint32).reshape(ysize, xsize))
        b[..., 0] += b[..., 1]
        b[..., 2] += b[..., 1]
        return _words(b)
    if kind == 3:  # colour indexing
        per = 8 >> bits
        packed = np.asarray(pixels, np.uint32).reshape(ysize, -1)
        x = np.arange(xsize)
        idx = ((packed[:, x >> bits] >> 8) & 0xFF) >> ((x & ((1 << bits) - 1)) * per)
        return tdata[idx & ((1 << per) - 1)]
    tiles = (xsize + (1 << bits) - 1) >> bits
    data = tdata.reshape(-1, tiles)
    codes = data[np.arange(ysize)[:, None] >> bits, np.arange(xsize)[None, :] >> bits]
    src = _bytes(np.asarray(pixels, np.uint32).reshape(ysize, xsize))
    if kind == 1:  # cross colour: deltas of signed bytes, >> 5
        cb = _bytes(codes).astype(np.int8).astype(np.int32)
        g2r, g2b, r2b = cb[..., 0], cb[..., 1], cb[..., 2]
        green = src[..., 1].astype(np.uint8).view(np.int8).astype(np.int32)
        red = (src[..., 2] + ((g2r * green) >> 5)) & 0xFF
        red_s = red.astype(np.uint8).view(np.int8).astype(np.int32)
        blue = (src[..., 0] + ((g2b * green) >> 5) + ((r2b * red_s) >> 5)) & 0xFF
        out = src.copy()
        out[..., 2], out[..., 0] = red, blue
        return _words(out)
    # predictor: row 0 from the left (the first pixel from black), then each
    # row from the one above, the first pixel from the top
    modes = ((codes >> 8) & 0xF).astype(np.int32)
    out = np.zeros((ysize * xsize + 1, 4), np.int32)  # one word past: the top-right's wrap
    flat = src.reshape(-1, 4)
    acc = np.array([0, 0, 0, 255])
    for x in range(xsize):
        acc = (flat[x] + acc) & 0xFF
        out[x] = acc
    for y in range(1, ysize):
        row = y * xsize
        out[row] = (flat[row] + out[row - xsize]) & 0xFF
        # within a row, each pixel waits for its left neighbour
        for x in range(1, xsize):
            i = row + x
            p = _predict(modes[y, x:x + 1], out[i - 1:i], out[i - xsize:i - xsize + 1],
                         out[i - xsize - 1:i - xsize], out[i - xsize + 1:i - xsize + 2])
            out[i] = (flat[i] + p[0]) & 0xFF
    return _words(out[:-1].reshape(ysize, xsize, 4))
