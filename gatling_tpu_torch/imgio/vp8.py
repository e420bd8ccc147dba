"""VP8 key frames (WebP's lossy bitstream, RFC 6386) as libwebp 1.6.0
decodes them, the decoder behind Pillow's WebP plugin (the JAX package's
imgio goes through Pillow).

`frame_size` is VP8GetInfo, the checks of the frame's uncompressed header
that every WebP reader makes before decoding: the key-frame bit, the
profile, the show bit, the first partition's length against the chunk,
the start code and the 14-bit sizes (their two scale bits ignored).
`decode_vp8` is VP8GetHeaders and VP8Decode: the header above again, then
the native library's gatling_vp8_decode (the boolean-coded header: colour
space, clamping, segments, loop filter, 1/2/4/8 token partitions,
quantisers, coefficient probabilities; then the macroblocks: intra modes,
tokens, dequantisation, the inverse WHT and DCT, prediction and the
simple or normal loop filter). It returns the Y, U and V planes at
macroblock size. Each block's inverse transform is libwebp's on x86: its
C code for blocks with a DC term or three coefficients, its SSE2 code
(16-bit lanes, whose sums wrap where a damaged stream's coefficients
overflow) for the others and for the chroma of a macroblock with chroma
AC terms; `transform` runs either alone, `transform_ref` is its NumPy
twin. `yuv_to_rgba` is libwebp's fancy upsampler with its 14-bit YUV ->
RGB (gatling_webp_yuv_to_rgba); `yuv_to_rgba_ref` is its NumPy twin. The
tests hold both twins to the native code bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gatling_tpu_torch import native

START_CODE = b"\x9d\x01\x2a"
# gatling_vp8_decode's failures, as libwebp reports them
_ERRORS = {-1: "cannot parse segment header", -2: "cannot parse filter header",
           -3: "cannot parse partitions", -4: "Premature end-of-partition0 encountered.",
           -5: "Premature end-of-file encountered."}
INFO_FIELDS = ("colour_space", "clamping", "segments", "segment_map", "filter_type",
               "filter_level", "sharpness", "partitions", "base_q", "skip_proba")


def frame_size(data: bytes, chunk_size: int) -> tuple[int, int]:
    """VP8GetInfo: (width, height) of a VP8 bitstream whose chunk declares
    `chunk_size` bytes; ValueError where libwebp rejects it."""
    if len(data) < 10:
        raise ValueError("VP8: not enough data")
    if data[3:6] != START_CODE:
        raise ValueError("VP8: bad start code")
    bits = data[0] | data[1] << 8 | data[2] << 16
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if bits & 1:
        raise ValueError("VP8: not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        raise ValueError("VP8: incorrect keyframe parameters")
    if w == 0 or h == 0:
        raise ValueError("VP8: empty frame")
    return w, h


def decode_vp8(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int, dict]:
    """One VP8 key frame's bytes (the chunk's payload with any pad byte)
    -> (y, u, v, width, height, info): planes of the frame's macroblocks
    (16 * ceil(w / 16) wide, 8 * ceil(w / 16) for U and V), filtered, and
    the header's fields (INFO_FIELDS)."""
    if len(data) < 4:
        raise ValueError("VP8: Truncated header.")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError("VP8: Not a key frame.")
    if (bits >> 1) & 7 > 3:
        raise ValueError("VP8: Incorrect keyframe parameters.")
    if not (bits >> 4) & 1:
        raise ValueError("VP8: Frame not displayable.")
    part0 = bits >> 5
    if len(data) < 10:
        raise ValueError("VP8: cannot parse picture header")
    if data[3:6] != START_CODE:
        raise ValueError("VP8: Bad code word")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if part0 > len(data) - 10:
        raise ValueError("VP8: bad partition length")
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    y = np.empty((mb_h * 16, mb_w * 16), np.uint8)
    u = np.empty((mb_h * 8, mb_w * 8), np.uint8)
    v = np.empty((mb_h * 8, mb_w * 8), np.uint8)
    info = np.zeros(len(INFO_FIELDS), np.int32)
    buf = np.frombuffer(data, np.uint8)
    rest = buf[10 + part0:]
    status = native.library().gatling_vp8_decode(
        native.ptr(buf[10:], ctypes.c_uint8), part0,
        native.ptr(rest, ctypes.c_uint8) if rest.size else None, rest.size, mb_w, mb_h,
        native.ptr(y, ctypes.c_uint8), native.ptr(u, ctypes.c_uint8),
        native.ptr(v, ctypes.c_uint8), native.ptr(info, ctypes.c_int32))
    if status:
        raise ValueError(f"VP8: {_ERRORS[status]}")
    return y, u, v, w, h, dict(zip(INFO_FIELDS, info.tolist()))


def transform(coeffs: np.ndarray, pred: np.ndarray, simd: bool) -> np.ndarray:
    """gatling_vp8_transform: blocks' coefficients [n, 16] (int16, natural
    order) inverse-transformed onto their predictions [n, 4, 4] (uint8) by
    libwebp's C TransformOne or its Transform_SSE2."""
    c = np.ascontiguousarray(coeffs, np.int16).reshape(-1, 16)
    out = np.ascontiguousarray(pred, np.uint8).reshape(-1, 4, 4).copy()
    native.library().gatling_vp8_transform(native.ptr(c, ctypes.c_int16), c.shape[0],
                                           int(simd), native.ptr(out, ctypes.c_uint8))
    return out


def transform_ref(coeffs: np.ndarray, pred: np.ndarray, simd: bool) -> np.ndarray:
    """NumPy twin of transform. Both passes (columns, then rows with +4)
    take x * 35468 >> 16 and x + (x * 20091 >> 16); the C code sums in 32
    bits and adds x >> 3 to the prediction with a clip, the SSE2 code
    wraps every sum to 16 bits (the multiplications as (x * -30068 >> 16)
    + x and (x * 20091 >> 16) + x) and saturates the 16-bit sum."""
    c = np.asarray(coeffs, np.int64).reshape(-1, 4, 4)
    w = (lambda x: (x + 32768) % 65536 - 32768) if simd else (lambda x: x)

    def one_d(i0, i1, i2, i3):
        a, b = w(i0 + i2), w(i0 - i2)
        if simd:
            c_ = w(w(i1 - i3) + w(((i1 * -30068) >> 16) - ((i3 * 20091) >> 16)))
            d = w(w(i1 + i3) + w(((i1 * 20091) >> 16) + ((i3 * -30068) >> 16)))
        else:
            c_ = ((i1 * 35468) >> 16) - (((i3 * 20091) >> 16) + i3)
            d = (((i1 * 20091) >> 16) + i1) + ((i3 * 35468) >> 16)
        return w(a + d), w(b + c_), w(b - c_), w(a - d)

    cols = np.stack(one_d(c[:, 0], c[:, 1], c[:, 2], c[:, 3]), axis=1)  # [n, k, col]
    rows = np.stack(one_d(w(cols[:, :, 0] + 4), cols[:, :, 1], cols[:, :, 2],
                          cols[:, :, 3]), axis=2)  # [n, row, col]
    total = np.asarray(pred, np.int64).reshape(-1, 4, 4) + (rows >> 3)
    return np.clip(w(total), 0, 255).astype(np.uint8)


def yuv_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray, w: int, h: int) -> np.ndarray:
    """The w x h picture of planes y, u, v as libwebp's fancy upsampler
    and YUV -> RGB give it: uint8 [h, w, 4], alpha 255."""
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    out = np.empty((h, w, 4), np.uint8)
    native.library().gatling_webp_yuv_to_rgba(
        native.ptr(y, ctypes.c_uint8), native.ptr(u, ctypes.c_uint8),
        native.ptr(v, ctypes.c_uint8), w, h, y.shape[1], u.shape[1],
        native.ptr(out, ctypes.c_uint8))
    return out


def _to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """dsp/yuv.h VP8YuvToRgb: 14-bit fixed point, MultHi = (x * k) >> 8,
    the result >> 6 and clipped."""
    def hi(a, k):
        return (a * k) >> 8

    def clip(a):
        return np.clip(a >> 6, 0, 255)

    yy = hi(y, 19077)
    return np.stack([clip(yy + hi(v, 26149) - 14234),
                     clip(yy - hi(u, 6419) - hi(v, 13320) + 8708),
                     clip(yy + hi(u, 33050) - 17685)], axis=-1).astype(np.uint8)


def yuv_to_rgba_ref(y: np.ndarray, u: np.ndarray, v: np.ndarray, w: int, h: int) -> np.ndarray:
    """NumPy twin of yuv_to_rgba. Each output row takes its two nearest
    chroma rows (the first row and, at an even height, the last one their
    own row twice); along the row the chroma sits between luma pairs.
    Within a 2x2 neighbourhood (near-left a, near b, far-left c, far d),
    libwebp's averages are two shifts: the odd pixel (((a + b + c + d + 8
    + 2 (b + c)) >> 3) + a) >> 1, the even one (((... + 2 (a + d)) >> 3)
    + b) >> 1; the first pixel, and the last at an even width,
    (3 near + far + 2) >> 2."""
    yv = y[:h, :w].astype(np.int32)
    rows = np.arange(h)
    near_r = np.where(rows == 0, 0, np.where(rows & 1, (rows - 1) >> 1, rows >> 1))
    far_r = np.where(rows == 0, 0, np.where(rows & 1, np.minimum((rows + 1) >> 1, (h - 1) >> 1),
                                            (rows >> 1) - 1))
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    chans = []
    for plane in (u, v):
        p = plane.astype(np.int32)
        near, far = p[near_r], p[far_r]  # [h, uv_w]
        res = np.empty((h, w), np.int32)
        res[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
        npair = (w - 1) >> 1
        if npair:
            a, c = near[:, :npair], far[:, :npair]  # the left samples
            b, d = near[:, 1:npair + 1], far[:, 1:npair + 1]
            avg = a + b + c + d + 8
            d12 = (avg + 2 * (b + c)) >> 3
            d03 = (avg + 2 * (a + d)) >> 3
            res[:, 1:2 * npair:2] = (d12 + a) >> 1
            res[:, 2:2 * npair + 1:2] = (d03 + b) >> 1
        if w % 2 == 0:
            res[:, w - 1] = (3 * near[:, npair] + far[:, npair] + 2) >> 2
        chans.append(res)
    out[..., :3] = _to_rgb(yv, chans[0], chans[1])
    return out
