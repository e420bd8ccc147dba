"""WebP as Pillow 12.1's WebP plugin reads it (the JAX package's imgio
goes through Pillow): libwebp 1.6.0's animation decoder over its demuxer,
for still images too.

- `_demux` is WebPDemux: the RIFF header and size (a file shorter than
  its RIFF size is refused, bytes past it ignored), then a simple file's
  one `VP8 ` or `VP8L` chunk, or an extended file's `VP8X` (flags, canvas
  size) and the chunks after it: a still image's `ALPH` and image chunk
  (its `ALPH` dropped when the alpha flag is clear), or `ANIM` and
  `ANMF` frames (offsets stored x2, sizes - 1, each with its own `ALPH`
  and image chunk); unknown chunks skipped, odd sizes padded; every image
  chunk's header checked (vp8.frame_size, vp8l.image_info) and every
  frame inside the canvas.
- `_has_alpha` is WebPGetFeatures, which Pillow asks for the mode: "RGB"
  (Pillow's raw mode "RGBX") when it reports no alpha, and the JAX
  package then sets alpha to 255, whatever the pixels hold.
- `decode_webp` is WebPAnimDecoderGetNext of the first frame: a zeroed
  canvas, the frame decoded into its rectangle as non-premultiplied RGBA
  (nothing blended, the background colour unused). A VP8 frame is
  vp8.decode_vp8 and vp8.yuv_to_rgba, its alpha the `ALPH` chunk's plane
  (`_alpha_plane`: raw or a VP8L stream, then its unfilter; nonzero
  reserved bits, an unknown method or pre-processing refuse the frame); a
  VP8L frame is vp8l.decode_vp8l.

`unfilter` is the native ALPH unfilter (0 none, 1 horizontal, 2
vertical, 3 gradient); `unfilter_ref` its NumPy twin. Every failure is a
ValueError, as Pillow's OSError becomes one in the JAX package.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio import vp8, vp8l
from gatling_tpu_torch.imgio.modes import bomb_check

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
ICCP_FLAG, EXIF_FLAG, XMP_FLAG = 0x20, 0x08, 0x04
ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | ICCP_FLAG | EXIF_FLAG | XMP_FLAG
ANMF_CHUNK_SIZE, ANIM_CHUNK_SIZE, VP8X_CHUNK_SIZE = 16, 6, 10


class _NeedMoreData(Exception):
    """WebPGetFeatures's VP8_STATUS_NOT_ENOUGH_DATA."""


class _Frame:
    def __init__(self) -> None:
        self.x = self.y = self.width = self.height = 0
        self.num = 0
        self.complete = False
        self.image = (0, 0)  # (offset, size) of the image chunk, header included
        self.alpha = (0, 0)  # of the ALPH chunk


class _Mem:
    """The demuxer's MemBuffer: data up to the RIFF's end, a read position."""

    def __init__(self, data: bytes, riff_end: int) -> None:
        self.buf, self.start, self.riff_end = data, 12, riff_end
        self.end = min(len(data), riff_end)

    def left(self) -> int:
        return self.end - self.start

    def size_invalid(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.start)
        self.start += 4
        return v

    def u24(self) -> int:
        v = int.from_bytes(self.buf[self.start:self.start + 3], "little")
        self.start += 3
        return v


def _features(chunk: bytes) -> tuple[int, int]:
    """WebPGetFeatures of one image chunk (header included): its (width,
    height); ValueError where libwebp rejects its header."""
    (size,) = struct.unpack_from("<I", chunk, 4)
    body = chunk[8:]
    if chunk[:4] == b"VP8L":
        return vp8l.image_info(body)[:2]
    return vp8.frame_size(body, size)


# The demuxer below reads a whole file (Pillow hands it every byte): where
# libwebp would wait for more data, a whole file is refused.

def _store_frame(mem: _Mem, frame: _Frame, num: int, min_size: int) -> None:
    """StoreFrame: the frame's ALPH and image chunks from mem's position,
    up to the first other chunk (left unread)."""
    if mem.left() < 8 or mem.left() < min_size:
        raise ValueError("WebP: truncated frame")
    alpha_chunks = image_chunks = 0
    while True:
        start = mem.start
        fourcc = mem.buf[start:start + 4]
        mem.start += 4
        size = mem.u32()
        if size > MAX_CHUNK_PAYLOAD:
            raise ValueError("WebP: chunk too large")
        padded = size + (size & 1)
        if mem.size_invalid(padded):
            raise ValueError("WebP: chunk runs past the RIFF")
        if fourcc == b"ALPH" and alpha_chunks == 0:
            alpha_chunks = 1
            frame.alpha = (start, 8 + padded)
        elif fourcc in (b"VP8L", b"VP8 ") and image_chunks == 0:
            if fourcc == b"VP8L" and alpha_chunks:
                raise ValueError("WebP: VP8L after ALPH")
            frame.width, frame.height = _features(mem.buf[start:start + 8 + padded])
            image_chunks = 1
            frame.image = (start, 8 + padded)
            frame.complete = True
        else:
            mem.start -= 8
            return
        frame.num = num
        mem.start += padded
        if mem.start == mem.riff_end:
            return
        if mem.left() < 8:
            raise ValueError("WebP: truncated chunk header")


def _demux(data: bytes) -> tuple[int, int, int, list[_Frame]]:
    """WebPDemux over the whole file: (canvas width, height, VP8X flags,
    frames); ValueError where it returns NULL."""
    if len(data) < 20:
        raise ValueError("WebP: truncated header")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 8 or riff > MAX_CHUNK_PAYLOAD:
        raise ValueError("WebP: bad RIFF size")
    if len(data) < riff + 8:
        raise ValueError("WebP: truncated file")
    mem = _Mem(data, riff + 8)
    frames: list[_Frame] = []
    if data[12:16] == b"VP8X":
        (w, h), flags = _vp8x(mem, frames)
    else:
        _single_image(mem, frames, 0)
        (w, h), flags = (frames[0].width, frames[0].height), 0
        return w, h, flags, frames
    if not frames:
        raise ValueError("WebP: no frame")
    animated = bool(flags & ANIMATION_FLAG)
    if flags & ~ALL_VALID_FLAGS & 0xFF:
        raise ValueError("WebP: reserved VP8X flags")
    for f in frames:  # IsValidExtendedFormat
        if not animated and f.num > 1:
            raise ValueError("WebP: frames in a still image")
        if not f.complete:
            raise ValueError("WebP: a frame without its image")
        if f.alpha[1] and f.alpha[0] > f.image[0]:
            raise ValueError("WebP: ALPH after its image")
        if not animated and (f.x or f.y or f.width != w or f.height != h):
            raise ValueError("WebP: the image is not the canvas")
        if f.x + f.width > w or f.y + f.height > h:
            raise ValueError("WebP: a frame outside the canvas")
    return w, h, flags, frames


def _single_image(mem: _Mem, frames: list, flags: int) -> None:
    """ParseSingleImage: the one frame of a still image, its ALPH chunk
    dropped when the VP8X flags say there is no alpha."""
    if frames:
        raise ValueError("WebP: a second image")
    if mem.size_invalid(8) or mem.left() < 8:
        raise ValueError("WebP: truncated image chunk")
    frame = _Frame()
    _store_frame(mem, frame, 1, 0)
    if not flags & ALPHA_FLAG:
        frame.alpha = (0, 0)
    frames.append(frame)


def _vp8x(mem: _Mem, frames: list):
    """ParseVP8X and ParseVP8XChunks: ((canvas width, height), flags)."""
    if mem.left() < 8:
        raise ValueError("WebP: truncated VP8X")
    mem.start += 4
    size = mem.u32()
    if size > MAX_CHUNK_PAYLOAD or size < VP8X_CHUNK_SIZE:
        raise ValueError("WebP: bad VP8X chunk")
    size += size & 1
    if mem.size_invalid(size) or mem.left() < size:
        raise ValueError("WebP: VP8X runs past the RIFF")
    flags = mem.buf[mem.start]
    mem.start += 4
    w, h = 1 + mem.u24(), 1 + mem.u24()
    if w * h >= MAX_IMAGE_AREA:
        raise ValueError("WebP: canvas too large")
    mem.start += size - VP8X_CHUNK_SIZE
    if mem.size_invalid(8) or mem.left() < 8:
        raise ValueError("WebP: no chunk after VP8X")
    animated = bool(flags & ANIMATION_FLAG)
    anim_chunks = 0
    while True:
        start = mem.start
        fourcc = mem.buf[start:start + 4]
        mem.start += 4
        csize = mem.u32()
        if csize > MAX_CHUNK_PAYLOAD:
            raise ValueError("WebP: chunk too large")
        padded = csize + (csize & 1)
        if mem.size_invalid(padded):
            raise ValueError("WebP: chunk runs past the RIFF")
        if fourcc == b"VP8X":
            raise ValueError("WebP: a second VP8X")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim_chunks or animated:
                raise ValueError("WebP: an image chunk outside ANMF")
            mem.start = start
            _single_image(mem, frames, flags)
        elif fourcc == b"ANMF":
            if anim_chunks == 0:
                raise ValueError("WebP: ANMF before ANIM")
            _frame(mem, frames, padded, animated)
        else:  # ANIM (its colour and loop count unused) and every other chunk
            if fourcc == b"ANIM":
                if padded < ANIM_CHUNK_SIZE:
                    raise ValueError("WebP: short ANIM")
                anim_chunks = 1
            mem.start += padded
        if mem.start == mem.riff_end:
            return (w, h), flags
        if mem.left() < 8:
            raise ValueError("WebP: truncated chunk header")


def _frame(mem: _Mem, frames: list, chunk_size: int, animated: bool) -> None:
    """ParseAnimationFrame: offsets stored halved, sizes less one; the
    frame's size is then its bitstream's."""
    if mem.size_invalid(ANMF_CHUNK_SIZE) or chunk_size < ANMF_CHUNK_SIZE:
        raise ValueError("WebP: bad ANMF chunk")
    frame = _Frame()
    frame.x, frame.y = 2 * mem.u24(), 2 * mem.u24()
    w, h = 1 + mem.u24(), 1 + mem.u24()
    mem.start += 4  # duration, dispose and blend: the first frame needs none
    if w * h >= MAX_IMAGE_AREA:
        raise ValueError("WebP: frame too large")
    start = mem.start
    _store_frame(mem, frame, len(frames) + 1, chunk_size - ANMF_CHUNK_SIZE)
    if mem.start - start > chunk_size - ANMF_CHUNK_SIZE:
        raise ValueError("WebP: frame chunks past ANMF")
    if animated and frame.num > 0:
        frames.append(frame)


def _has_alpha(data: bytes) -> bool:
    """WebPGetFeatures(data).has_alpha, False where it fails (Pillow then
    keeps the mode RGBA: True)."""
    try:
        return _features_file(data)
    except (ValueError, _NeedMoreData, struct.error, IndexError):
        return True


def _features_file(data: bytes) -> bool:
    """ParseHeadersInternal over the whole file (no data required past
    what it reads)."""
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 12 or riff > MAX_CHUNK_PAYLOAD:
        raise ValueError("bad RIFF")
    pos, flags, found_vp8x = 12, 0, False
    if len(data) - pos < 8:
        raise _NeedMoreData()
    if data[pos:pos + 4] == b"VP8X":
        if struct.unpack_from("<I", data, pos + 4)[0] != VP8X_CHUNK_SIZE:
            raise ValueError("bad VP8X")
        if len(data) - pos < 18:
            raise _NeedMoreData()
        flags = data[pos + 8]
        cw = 1 + int.from_bytes(data[pos + 12:pos + 15], "little")
        ch = 1 + int.from_bytes(data[pos + 15:pos + 18], "little")
        if cw * ch >= MAX_IMAGE_AREA:
            raise ValueError("canvas too large")
        pos += 18
        found_vp8x = True
    has_alpha = bool(flags & ALPHA_FLAG)
    if found_vp8x and flags & ANIMATION_FLAG:
        return has_alpha
    found_alpha = False
    try:
        if len(data) - pos < 4:
            raise _NeedMoreData()
        if found_vp8x:  # ParseOptionalChunks
            total = 4 + 8 + VP8X_CHUNK_SIZE
            while True:
                if len(data) - pos < 8:
                    raise _NeedMoreData()
                (size,) = struct.unpack_from("<I", data, pos + 4)
                if size > MAX_CHUNK_PAYLOAD:
                    raise ValueError("bad chunk")
                disk = (8 + size + 1) & ~1
                total += disk
                if total > riff:
                    raise ValueError("chunk past the RIFF")
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if len(data) - pos < disk:
                    raise _NeedMoreData()
                if data[pos:pos + 4] == b"ALPH":
                    found_alpha = True
                pos += disk
        if len(data) - pos < 8:
            raise _NeedMoreData()
        tag = data[pos:pos + 4]
        if tag not in (b"VP8 ", b"VP8L"):
            raise ValueError("no image chunk")
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if riff >= 12 and size > riff - 12:
            raise ValueError("inconsistent sizes")
        body = data[pos + 8:]
        if tag == b"VP8 ":
            if len(body) < 10:
                raise _NeedMoreData()
            w, h = vp8.frame_size(body, size)
        else:
            if len(body) < 5:
                raise _NeedMoreData()
            w, h, has_alpha = vp8l.image_info(body)
            has_alpha = bool(has_alpha)
        if found_vp8x and (w, h) != (cw, ch):
            raise ValueError("image is not the canvas")
    except _NeedMoreData:
        if not found_vp8x:
            raise
    return has_alpha or found_alpha


def _alpha_plane(chunk: bytes, w: int, h: int) -> np.ndarray:
    """ALPHInit and ALPHDecode: the ALPH chunk's payload -> the w x h
    alpha plane."""
    if len(chunk) <= 1:
        raise ValueError("WebP: empty ALPH chunk")
    head = chunk[0]
    method, filt, pre, rsrv = head & 3, (head >> 2) & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or rsrv:
        raise ValueError("WebP: bad ALPH header")
    if method == 0:
        if len(chunk) - 1 < w * h:
            raise ValueError("WebP: short ALPH data")
        plane = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    else:
        plane = vp8l.decode_alpha_stream(chunk[1:], w, h)
    return unfilter(plane, filt)


def _decode_frame(data: bytes, frame: _Frame) -> np.ndarray:
    """WebPDecode of the frame's payload (its ALPH chunk through its image
    chunk) into RGBA [h, w, 4]."""
    off, size = frame.image
    chunk = data[off:off + size]
    (declared,) = struct.unpack_from("<I", chunk, 4)
    body = chunk[8:]
    if declared > len(body):
        raise ValueError("WebP: truncated image chunk")
    if chunk[:4] == b"VP8L":
        rgba, _info = vp8l.decode_vp8l(body)
        return rgba
    w, h = vp8.frame_size(body, declared)
    alpha = None
    if frame.alpha[1]:
        aoff, asize = frame.alpha
        (alen,) = struct.unpack_from("<I", data, aoff + 4)
        alpha = data[aoff + 8:aoff + 8 + alen]
    y, u, v, w, h, _info = vp8.decode_vp8(body)
    rgba = vp8.yuv_to_rgba(y, u, v, w, h)
    if alpha is not None:
        rgba[..., 3] = _alpha_plane(alpha, w, h)
    return rgba


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> the JAX package's imgio.load_image(data).data: the
    first frame on its canvas, uint8 [H, W, 4]."""
    has_alpha = _has_alpha(data)
    w, h, _flags, frames = _demux(data)
    bomb_check(w, h)
    canvas = np.zeros((h, w, 4), np.uint8)
    f = frames[0]
    canvas[f.y:f.y + f.height, f.x:f.x + f.width] = _decode_frame(data, f)
    if not has_alpha:
        canvas[..., 3] = 255
    return canvas


def unfilter(plane: np.ndarray, filt: int) -> np.ndarray:
    """gatling_webp_unfilter: the ALPH plane [h, w] with filter `filt`
    undone."""
    src = np.ascontiguousarray(plane, np.uint8)
    out = np.empty_like(src)
    h, w = src.shape
    native.library().gatling_webp_unfilter(native.ptr(src, ctypes.c_uint8), w, h, filt,
                                          native.ptr(out, ctypes.c_uint8))
    return out


def unfilter_ref(plane: np.ndarray, filt: int) -> np.ndarray:
    """NumPy twin of unfilter: horizontal sums along each row (a row after
    the first starting from the pixel above its first), vertical sums down
    the columns (the first row horizontal), gradient adds each pixel's
    clip(left + top - top-left) in turn (the first column from the top)."""
    src = np.asarray(plane, np.uint8).astype(np.int64)
    h, w = src.shape
    out = np.zeros((h, w), np.int64)
    if filt == 0:
        return src.astype(np.uint8)
    out[0] = np.cumsum(src[0]) & 0xFF
    for r in range(1, h):
        if filt == 1:
            out[r] = (out[r - 1, 0] + np.cumsum(src[r])) & 0xFF
        elif filt == 2:
            out[r] = (out[r - 1] + src[r]) & 0xFF
        else:
            left = out[r - 1, 0]
            for i in range(w):
                top, tl = out[r - 1, i], out[r - 1, i - 1] if i else out[r - 1, 0]
                left = (src[r, i] + np.clip(left + top - tl, 0, 255)) & 0xFF
                out[r, i] = left
    return out.astype(np.uint8)
