"""DirectDraw Surface textures as Pillow's DdsImagePlugin reads them: the
first mip level (the JAX package's imgio goes through Pillow).

Uncompressed: RGB and RGBA by their bit masks (Pillow's DdsRgbDecoder:
each field scaled by 255 / its mask's maximum and truncated; data past the
file's end read as zeros, as Pillow reads it), 8-bit luminance, 16-bit
luminance + alpha, 8-bit palette indices (a 256-entry RGBA palette), and
R8G8B8A8 through the DX10 header. Block compressed, by FourCC or the DX10
header's DXGI format: DXT1/BC1, DXT3/BC2, DXT5/BC3 (RGBA), BC4/ATI1
(grey), BC5/ATI2 unsigned and signed (RGB, blue 0, or 128 when signed),
BC6H unsigned and signed (the signed deltas added but, as in Pillow, not
sign-extended again), and BC7 (RGBA). Pillow gives BC6H as 8-bit RGB: each half-float
texel clamped to [0, 1] and scaled by 255, truncated, so the port does
too. The block decoders are the native library's gatling_bcn_decode
(Pillow's BcnDecode.c); `bcn_decode_ref` is their NumPy twin, which the
tests hold them against. A format Pillow does not read raises ValueError,
as Pillow's NotImplementedError ends the JAX package's open.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish, raw_rows

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000


def _cc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


# FourCC -> (BCn, signed, Pillow mode)
_FOURCC = {_cc(b"DXT1"): (1, 0, "RGBA"), _cc(b"DXT3"): (2, 0, "RGBA"),
           _cc(b"DXT5"): (3, 0, "RGBA"), _cc(b"BC4U"): (4, 0, "L"), _cc(b"ATI1"): (4, 0, "L"),
           _cc(b"BC5S"): (5, 1, "RGB"), _cc(b"BC5U"): (5, 0, "RGB"),
           _cc(b"ATI2"): (5, 0, "RGB")}
# DXGI format -> (BCn, signed, Pillow mode); BCn 0: raw RGBA
_DXGI = {70: (1, 0, "RGBA"), 71: (1, 0, "RGBA"), 73: (2, 0, "RGBA"), 74: (2, 0, "RGBA"),
         76: (3, 0, "RGBA"), 77: (3, 0, "RGBA"), 79: (4, 0, "L"), 80: (4, 0, "L"),
         82: (5, 0, "RGB"), 83: (5, 0, "RGB"), 84: (5, 1, "RGB"), 95: (6, 0, "RGB"),
         96: (6, 1, "RGB"), 97: (7, 0, "RGBA"), 98: (7, 0, "RGBA"), 99: (7, 0, "RGBA"),
         27: (0, 0, "RGBA"), 28: (0, 0, "RGBA"), 29: (0, 0, "RGBA")}


def block_bytes(fmt: int) -> int:
    return 8 if fmt in (1, 4) else 16


def bcn_decode(blocks: bytes, fmt: int, sign: int, w: int, h: int) -> np.ndarray:
    """gatling_bcn_decode of the ceil(w / 4) * ceil(h / 4) blocks at the
    head of `blocks`: [h, w, 4] uint8 (BC4: [h, w])."""
    n = ((w + 3) // 4) * ((h + 3) // 4)
    src = np.ascontiguousarray(np.frombuffer(blocks, np.uint8, n * block_bytes(fmt)))
    out = np.zeros((h, w) if fmt == 4 else (h, w, 4), np.uint8)
    native.library().gatling_bcn_decode(native.ptr(src, ctypes.c_uint8), n, fmt, sign, w, h,
                                        native.ptr(out, ctypes.c_uint8))
    return out


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes -> RGBA, the JAX package's imgio.load_image(data).data."""
    if not data.startswith(b"DDS "):
        raise Skip("not a DDS file")
    if len(data) < 8:
        raise Skip("DDS: short read")
    if _cc(data[4:8]) != 124:
        raise ValueError("Unsupported header size")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"Incomplete header: {len(header)} bytes")
    _flags, h, w = struct.unpack_from("<3I", header)
    _pfsize, pfflags, fourcc, bitcount = struct.unpack_from("<4I", header, 68)
    pos = 128
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    if pfflags & DDPF_RGB:
        count = 4 if pfflags & DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", header, 84)
        return finish("RGBA" if count == 4 else "RGB", _rgb_masks(data, pos, w, h, bitcount,
                                                                  masks))
    palette, raw_mode, fmt, sign = None, None, 0, 0
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            raw_mode = "L"
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            raw_mode = "LA"
        else:
            raise ValueError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & DDPF_PALETTEINDEXED8:
        raw_mode = "P"
        pal = data[pos:pos + 1024]
        pos += len(pal)
        palette = np.frombuffer(pal[:len(pal) // 4 * 4], np.uint8).reshape(-1, 4)
    elif pfflags & DDPF_FOURCC:
        if fourcc == _cc(b"DX10"):
            if len(data) < pos + 4:
                raise Skip("DDS: short DX10 header")
            dxgi = _cc(data[pos:pos + 4])
            pos += min(20, len(data) - pos)
            if dxgi not in _DXGI:
                raise ValueError(f"Unimplemented DXGI format {dxgi}")
            fmt, sign, mode = _DXGI[dxgi]
            if fmt == 0:
                raw_mode = "RGBA"
        elif fourcc in _FOURCC:
            fmt, sign, mode = _FOURCC[fourcc]
        else:
            raise ValueError(f"Unimplemented pixel format {fourcc!r}")
    else:
        raise ValueError(f"Unknown pixel format flags {pfflags}")
    if raw_mode is not None:
        bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[raw_mode]
        rows = raw_rows(data, pos, w, h, w * bands)
        return finish(raw_mode, rows.reshape(h, w, bands), palette)
    n = ((w + 3) // 4) * ((h + 3) // 4) * block_bytes(fmt)
    if len(data) - pos < n:
        raise ValueError("image file is truncated")
    px = bcn_decode(data[pos:pos + n], fmt, sign, w, h)
    return finish(mode, px if fmt == 4 else px[..., :4 if mode == "RGBA" else 3])


def _rgb_masks(data: bytes, pos: int, w: int, h: int, bitcount: int,
               masks: tuple[int, ...]) -> np.ndarray:
    """DdsRgbDecoder: each pixel a little-endian word of bitcount // 8
    bytes (zeros past the data's end), each mask's field scaled to 255."""
    nbytes = bitcount // 8
    # only a word's low 32 bits meet a mask: its first four bytes
    starts = pos + np.arange(w * h, dtype=np.int64) * nbytes
    buf = np.frombuffer(data, np.uint8)
    words = np.zeros(w * h, np.uint64)
    for k in range(min(nbytes, 4)):
        idx = starts + k
        ok = idx < len(data)
        byte = np.zeros(w * h, np.uint64)
        byte[ok] = buf[idx[ok]]
        words |= byte << np.uint64(8 * k)
    out = np.empty((w * h, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        offset = 0
        if mask:
            while (mask >> (offset + 1)) << (offset + 1) == mask:
                offset += 1
        total = mask >> offset
        if not total:
            out[:, i] = 0
            continue
        v = (words & np.uint64(mask)) >> np.uint64(offset)
        out[:, i] = (v.astype(np.float64) / total * 255).astype(np.int64).astype(np.uint8)
    return out.reshape(h, w, len(masks))


# ---------------------------------------------------------------------------
# NumPy twins of the native block decoders (one block at a time)
# ---------------------------------------------------------------------------

def _565(x: int) -> list[int]:
    r = (x & 0xF800) >> 8
    g = (x & 0x7E0) >> 3
    b = (x & 0x1F) << 3
    return [r | r >> 5, g | g >> 6, b | b >> 5, 255]


def _bc1_ref(b: bytes, separate_alpha: bool) -> np.ndarray:
    c0, c1, lut = struct.unpack_from("<HHI", b)
    p0, p1 = _565(c0), _565(c1)
    if c0 > c1 or separate_alpha:
        p2 = [(2 * p0[k] + p1[k]) // 3 for k in range(3)] + [255]
        p3 = [(p0[k] + 2 * p1[k]) // 3 for k in range(3)] + [255]
    else:
        p2 = [(p0[k] + p1[k]) // 2 for k in range(3)] + [255]
        p3 = [0, 0, 0, 0]
    p = (p0, p1, p2, p3)
    return np.array([p[(lut >> (2 * k)) & 3] for k in range(16)], np.uint8)


def _alpha_ref(b: bytes, sign: bool) -> np.ndarray:
    if sign:
        a0, a1 = struct.unpack_from("<bb", b)
        a0, a1 = a0 + 128, a1 + 128
    else:
        a0, a1 = b[0], b[1]
    if a0 > a1:
        a = [a0, a1] + [((7 - k) * a0 + k * a1) // 7 for k in range(1, 7)]
    else:
        a = [a0, a1] + [((5 - k) * a0 + k * a1) // 5 for k in range(1, 5)] + [0, 255]
    bits = int.from_bytes(b[2:8], "little")
    return np.array([a[(bits >> (3 * k)) & 7] & 255 for k in range(16)], np.uint8)


def _bits(b: bytes, bit: int, count: int) -> int:
    if not count:
        return 0
    by, bit = bit >> 3, bit & 7
    x = b[by] | ((b[by + 1] << 8) if bit + count > 8 else 0)
    return (x >> bit) & ((1 << count) - 1)


_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
            4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


def _tables() -> tuple:
    """The partition and anchor tables, read from the native source so the
    twin and the library cannot drift apart."""
    from gatling_tpu_torch.ops.cuda_lib import CSRC
    import re

    src = (CSRC / "gatling_native.cpp").read_text()

    def table(name: str) -> list[int]:
        body = re.search(name + r"\[64\] = \{(.*?)\};", src, re.S).group(1)
        return [int(v, 0) for v in re.findall(r"0x[0-9a-f]+|\d+", body)]

    return table("kSi2"), table("kSi3"), table("kAi0"), table("kAi1"), table("kAi2")


_TABLES: tuple | None = None


def _subset(ns: int, partition: int, n: int) -> int:
    si2, si3 = _TABLES[0], _TABLES[1]
    if ns == 2:
        return (si2[partition] >> n) & 1
    if ns == 3:
        return (si3[partition] >> (2 * n)) & 3
    return 0


def _bc7_ref(b: bytes) -> np.ndarray:
    mode = b[0]
    if not mode:
        return np.tile(np.array([0, 0, 0, 255], np.uint8), (16, 1))
    mode = (mode & -mode).bit_length() - 1
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    bit = mode + 1
    cw = _WEIGHTS[ib]
    aw = _WEIGHTS[ib2 if (ab and ib2) else ib]

    def load(n: int) -> int:
        nonlocal bit
        v = _bits(b, bit, n)
        bit += n
        return v

    partition, rotation, index_sel = load(pb), load(rb), load(isb)
    numep = ns * 2
    ep = [[0, 0, 0, 0] for _ in range(numep)]
    for c in range(3):
        for i in range(numep):
            ep[i][c] = load(cb)
    for i in range(numep):
        ep[i][3] = load(ab) if ab else 255
    if epb:
        cb += 1
        ab += 1 if ab else 0
        for i in range(numep):
            v = load(1)
            for c in range(4 if ab else 3):
                ep[i][c] = ((ep[i][c] << 1) | v) & 255
    if spb:
        cb += 1
        ab += 1 if ab else 0
        for i in range(0, numep, 2):
            v = load(1)
            for j in range(2):
                for c in range(4 if ab else 3):
                    ep[i + j][c] = ((ep[i + j][c] << 1) | v) & 255

    def expand(v: int, n: int) -> int:
        v = (v << (8 - n)) & 255
        return v | (v >> n)

    for i in range(numep):
        for c in range(3):
            ep[i][c] = expand(ep[i][c], cb)
        if ab:
            ep[i][3] = expand(ep[i][3], ab)
    _, _, ai0, ai1, ai2 = _TABLES
    cibit, aibit = bit, bit + 16 * ib - ns
    out = np.zeros((16, 4), np.uint8)
    for i in range(16):
        s = _subset(ns, partition, i) * 2
        n = ib
        if i == 0 or (ns == 2 and i == ai0[partition]) or (
                ns == 3 and i in (ai1[partition], ai2[partition])):
            n -= 1
        i0 = _bits(b, cibit, n)
        cibit += n
        s0 = s1 = cw[i0]
        if ab and ib2:
            n2 = ib2 - (1 if i == 0 else 0)
            i1 = _bits(b, aibit, n2)
            aibit += n2
            s0, s1 = (aw[i1], cw[i0]) if index_sel else (cw[i0], aw[i1])
        e0, e1 = ep[s], ep[s + 1]
        px = [((64 - s0) * e0[c] + s0 * e1[c] + 32) >> 6 for c in range(3)]
        px.append(((64 - s1) * e0[3] + s1 * e1[3] + 32) >> 6)
        if rotation:
            px[rotation - 1], px[3] = px[3], px[rotation - 1]
        out[i] = px
    return out


_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
              (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
              (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
_BC6_FIELDS = {"rw": 0, "gw": 1, "bw": 2, "rx": 3, "gx": 4, "bx": 5, "ry": 6, "gy": 7,
               "by": 8, "rz": 9, "gz": 10, "bz": 11}


def _bc6_layouts() -> list[list[tuple[int, int]]]:
    """The endpoint bits of each BC6H mode as (component, bit), read from
    the native source's table."""
    from gatling_tpu_torch.ops.cuda_lib import CSRC
    import re

    src = (CSRC / "gatling_native.cpp").read_text()
    body = re.search(r"kBc6Bits\[14\]\[75\] = \{(.*?)\n\};", src, re.S).group(1)
    modes = []
    for row in re.findall(r"\{(.*?)\}", body.replace("\n", " "), re.S):
        bits = []
        for tok in re.findall(r"BC6_R(\d+)\(BC6_(\w\w)\)|BC6_(\w\w)\((\d+)\)", row):
            if tok[0]:
                bits += [(_BC6_FIELDS[tok[1].lower()], k) for k in range(int(tok[0]))]
            else:
                bits.append((_BC6_FIELDS[tok[2].lower()], int(tok[3])))
        modes.append(bits)
    return modes


_BC6_LAYOUTS: list | None = None


def _sext(v: int, prec: int) -> int:
    if v & (1 << (prec - 1)):
        v |= -1 << prec
    return v & 0xFFFF


def _unquantize(v: int, prec: int, sign: bool) -> int:
    if not sign:
        if prec >= 15 or v == 0:
            return v
        if v == (1 << prec) - 1:
            return 0xFFFF
        return ((v << 15) + 0x4000) >> (prec - 1)
    x = v - 0x10000 if v & 0x8000 else v
    if prec >= 16:
        return x
    s = x < 0
    x = -x if s else x
    if x:
        x = 0x7FFF if x >= (1 << (prec - 1)) - 1 else ((x << 15) + 0x4000) >> (prec - 1)
    return -x if s else x


def _half8(v: int, sign: bool) -> int:
    """bc6_finalize then bc6_clamp: the half-float's bits to a float32,
    clamped to [0, 1] and scaled by 255, truncated."""
    if sign:
        h = (0x8000 | ((-v) * 31) // 32) if v < 0 else (v * 31) // 32
    else:
        h = (v * 31) // 64
    f = np.array([h & 0xFFFF], np.uint16).view(np.float16).astype(np.float32)[0]
    if f < 0:
        return 0
    if f > 1:
        return 255
    return int(np.float32(f) * np.float32(255.0))


def _bc6_ref(b: bytes, sign: bool) -> np.ndarray:
    mode = b[0] & 0x1F
    bit, epbits, ib = 5, 75, 3
    if mode & 3 in (0, 1):
        mode, bit = mode & 3, 2
    elif mode & 3 == 2:
        mode, epbits = 2 + (mode >> 2), 72
    else:
        mode, epbits, ib = 10 + (mode >> 2), 60, 4
    out = np.zeros((16, 4), np.uint8)
    if mode >= 14:
        return out
    ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[mode]
    ep = [0] * 12
    for i, (comp, k) in enumerate(_BC6_LAYOUTS[mode][:epbits]):
        ep[comp] |= _bits(b, bit + i, 1) << k
    bit += epbits
    partition = _bits(b, bit, pb)
    bit += pb
    numep = 12 if ns == 2 else 6
    if sign:
        ep[0:3] = [_sext(v, epb) for v in ep[0:3]]
    if sign or tr:
        for i in range(3, numep, 3):
            ep[i:i + 3] = [_sext(ep[i], rb), _sext(ep[i + 1], gb), _sext(ep[i + 2], bb)]
    if tr:
        for i in range(3, numep, 3):
            for c in range(3):
                ep[i + c] = (ep[i + c] + ep[c]) & ((1 << epb) - 1)
    u = [_unquantize(v, epb, sign) for v in ep[:numep]]
    cw = _WEIGHTS[ib]
    ai0 = _TABLES[2]
    for i in range(16):
        s = _subset(ns, partition, i) * 6
        n = ib - (1 if i == 0 or (ns == 2 and i == ai0[partition]) else 0)
        wgt = cw[_bits(b, bit, n)]
        bit += n
        for c in range(3):
            out[i, c] = _half8((u[s + c] * (64 - wgt) + u[s + 3 + c] * wgt) >> 6, sign)
    return out


def bcn_decode_ref(blocks: bytes, fmt: int, sign: int, w: int, h: int) -> np.ndarray:
    """The NumPy twin of bcn_decode, block by block."""
    global _TABLES, _BC6_LAYOUTS
    if _TABLES is None:
        _TABLES = _tables()
    if fmt == 6 and _BC6_LAYOUTS is None:
        _BC6_LAYOUTS = _bc6_layouts()
    size = block_bytes(fmt)
    bw, bh = (w + 3) // 4, (h + 3) // 4
    full = np.zeros((bh * 4, bw * 4, 4), np.uint8)
    for k in range(bw * bh):
        b = blocks[k * size:(k + 1) * size]
        if fmt == 1:
            col = _bc1_ref(b, False)
        elif fmt == 2:
            col = _bc1_ref(b[8:], True)
            nib = int.from_bytes(b[:8], "little")
            col[:, 3] = [((nib >> (4 * i)) & 15) * 17 for i in range(16)]
        elif fmt == 3:
            col = _bc1_ref(b[8:], True)
            col[:, 3] = _alpha_ref(b, False)
        elif fmt == 4:
            col = np.zeros((16, 4), np.uint8)
            col[:, 0] = _alpha_ref(b, False)
        elif fmt == 5:
            col = np.zeros((16, 4), np.uint8)
            col[:, 0], col[:, 1] = _alpha_ref(b, bool(sign)), _alpha_ref(b[8:], bool(sign))
            col[:, 2] = 128 if sign else 0
        elif fmt == 6:
            col = _bc6_ref(b, bool(sign))
        else:
            col = _bc7_ref(b)
        by, bx = divmod(k, bw)
        full[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = col.reshape(4, 4, 4)
    out = full[:h, :w]
    return np.ascontiguousarray(out[..., 0] if fmt == 4 else out)



# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def encode_dds(img: np.ndarray) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes
    DdsImagePlugin._save writes without a pixel format: uncompressed, grey
    as luminance, RGB as BGR, RGBA as BGRA, with the pitch and masks."""
    img = np.asarray(img, np.uint8)
    c = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x8  # CAPS, HEIGHT, WIDTH, PIXELFORMAT, PITCH
    if c == 1:
        pixel_flags, masks, px = 0x20000, [0xFF000000] * 3 + [0], img
    else:
        pixel_flags, masks = 0x40, [0x00FF0000, 0x0000FF00, 0x000000FF]
        px = img[..., [2, 1, 0, 3][:c]]
        if c == 4:
            pixel_flags |= 0x1
        masks.append(0xFF000000 if c == 4 else 0)
    head = (struct.pack("<I", 0x20534444)
            + struct.pack("<7I", 124, flags, h, w, (w * 8 * c + 7) // 8, 0, 0)
            + struct.pack("11I", *((0,) * 11))
            + struct.pack("<4I", 32, pixel_flags, 0, 8 * c) + struct.pack("<4I", *masks)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + np.ascontiguousarray(px).tobytes()
