"""Pillow 12.1's 8-bit resampling, for the writers that store resized
frames (ico.py, icns.py): Image.resize with BICUBIC (its default) and
Image.thumbnail(size, LANCZOS, reducing_gap=None).

`resize` runs the native library's gatling_resample, Resample.c's two
passes: each output sample a sum of input samples with coefficients from
the filter (BICUBIC a = -0.5 over 2 taps a side, LANCZOS over 3, both
widened by the scale when shrinking), normalised in double and rounded to
22-bit fixed point, then clipped; the horizontal pass runs over the rows the
vertical pass reads. An RGBA image is premultiplied first and divided back
after (Convert.c's rgba2rgbA and rgbA2rgba), as Image.resize does through
mode "RGBa". `resize_ref` is its NumPy twin; the card's path never takes it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from gatling_tpu_torch import native

BICUBIC, LANCZOS = 0, 1
PRECISION_BITS = 32 - 8 - 2
_SUPPORT = {BICUBIC: 2.0, LANCZOS: 3.0}


def resize(img: np.ndarray, width: int, height: int, filt: int = BICUBIC) -> np.ndarray:
    """img [H, W] grey, [H, W, 3] or [H, W, 4] uint8 resized to
    [height, width(, C)] as Image.resize((width, height), filt) gives it."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((height, width, c), np.uint8)
    native.library().gatling_resample(native.ptr(img, ctypes.c_uint8), w, h, c, width, height,
                                      filt, int(c == 4), native.ptr(out, ctypes.c_uint8))
    return out[..., 0] if img.ndim == 2 else out


def thumbnail_size(w: int, h: int, size: tuple[int, int]) -> tuple[int, int] | None:
    """The size Image.thumbnail(size) gives a w x h image (its
    preserve_aspect_ratio), None where it leaves the image as it is."""
    x, y = (math.floor(v) for v in size)
    if x >= w and y >= h:
        return None
    aspect = w / h

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Image.thumbnail(size, LANCZOS, reducing_gap=None) of img."""
    h, w = img.shape[:2]
    final = thumbnail_size(w, h, size)
    if final is None or final == (w, h):
        return img
    return resize(img, final[0], final[1], LANCZOS)


# ---------------------------------------------------------------------------
# the NumPy twin
# ---------------------------------------------------------------------------

def _filter(filt: int, x: float) -> float:
    if filt == BICUBIC:
        a = -0.5
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def coefficients(in_size: int, out_size: int, filt: int) -> tuple[np.ndarray, np.ndarray]:
    """Resample.c's precompute_coeffs and normalize_coeffs_8bpc over the box
    (0, in_size): each output's (first input, count) [out, 2] and its
    fixed-point coefficients [out, ksize]."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[filt] * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_filter(filt, (x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        k = [v / ww if ww != 0.0 else v for v in k]
        kk[xx, :xmax] = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0 else
                         int(0.5 + v * (1 << PRECISION_BITS)) for v in k]
        bounds[xx] = xmin, xmax
    return bounds, kk


def _pass(src: np.ndarray, bounds: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One pass along axis 1 of src [rows, n, c] (int64)."""
    taps = np.minimum(bounds[:, :1] + np.arange(kk.shape[1]), src.shape[1] - 1)
    acc = (src[:, taps, :] * kk[None, :, :, None]).sum(axis=2) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255)


def resize_ref(img: np.ndarray, width: int, height: int, filt: int = BICUBIC) -> np.ndarray:
    """The NumPy twin of `resize`."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    x = img.reshape(h, w, -1).astype(np.int64)
    c = x.shape[2]
    if c == 4:
        t = x[..., :3] * x[..., 3:] + 128
        x[..., :3] = ((t >> 8) + t) >> 8
    bh, kh = coefficients(w, width, filt)
    bv, kv = coefficients(h, height, filt)
    if width != w:
        first, last = bv[0, 0], bv[-1, 0] + bv[-1, 1]
        x = _pass(x[first:last], bh, kh)
        bv = bv - np.array([first, 0])
    if height != h:
        x = _pass(x.transpose(1, 0, 2), bv, kv).transpose(1, 0, 2)
    if c == 4:
        a = x[..., 3:]
        div = np.minimum(255 * x[..., :3] // np.maximum(a, 1), 255)
        x[..., :3] = np.where((a == 0) | (a == 255), x[..., :3], div)
    out = x.astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out
