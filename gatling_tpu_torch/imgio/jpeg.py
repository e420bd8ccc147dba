"""JPEG decoder and baseline encoder that reproduce libjpeg-turbo's output
code for code (the JAX package reads and writes JPEG through Pillow, which
links libjpeg-turbo).

The decoder reads Huffman-coded baseline, extended-sequential and
progressive files of 8-bit samples, with one (grey), three (YCbCr or RGB)
or four components (CMYK, or YCCK by the Adobe APP14 transform), any
integer sampling ratios (1 to 4 in each direction), restart intervals, and
any APPn or COM segments. It decodes as libjpeg does with its defaults:
- the markers are parsed here and each scan's entropy-coded segment is
  Huffman-decoded by the native library (gatling_jpeg_decode_scan: the
  sequential decoder of jdhuff.c and the four progressive ones of
  jdphuff.c), into coefficient blocks;
- jidctint.c's islow IDCT dequantises and transforms them
  (gatling_jpeg_idct_islow);
- jdsample.c brings the chroma to full size: the fancy h2v1, h1v2 and
  h2v2 triangle filters (their alternating rounding biases, the edge
  sample repeated), and int_upsample's replication for every other ratio;
- jdcolor.c's fixed-point tables convert YCbCr to RGB, and YCCK to CMYK;
  Pillow reads four components as "CMYK;I", inverted, and converts them
  to RGBA as it converts CMYK.
Progressive block smoothing never applies: libjpeg smooths only while
some coefficient bits are missing after the last scan, and such a file
raises here. Arithmetic coding and lossless and hierarchical frames
raise NotImplementedError (ROADMAP: 'USD content'); a file Pillow or
libjpeg rejects (another precision than 8 bits, two components, a height
given only by a DNL marker, fractional sampling) raises ValueError.

The encoder writes what Pillow writes at its defaults (quality 75,
4:2:0 for colour, the standard Huffman tables, the islow DCT): jccolor.c's
RGB to YCbCr tables, jcsample.c's 2x2 box average with biases 1 and 2,
the edge padding of jcprepct.c and jccoefct.c, jfdctint.c's islow FDCT
with jcdctmgr.c's quantiser (gatling_jpeg_fdct_islow) and jchuff.c's
Huffman coder (gatling_jpeg_encode_scan).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import finish

UNPORTED = "(ROADMAP: 'USD content')"

# jpeg_natural_order: the block index of the k-th coefficient in zigzag order
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# coefficients 0-9 decide libjpeg's progressive block smoothing (jdcoefct.c
# SAVED_COEFS)
_SMOOTH_COEFS = 10

_SOF_SUPPORTED = {0xC0: False, 0xC1: False, 0xC2: True}  # marker -> progressive
# the frames libjpeg-turbo decodes that the port does not
_SOF_UNPORTED = {0xC3: "lossless", 0xC9: "arithmetic", 0xCA: "arithmetic",
                 0xCB: "arithmetic lossless"}
# jdmarker.c read_markers: the frame types it refuses (hierarchical, JPG and
# the differential arithmetic ones), and the markers it knows; any other
# (DHP, EXP, JPGn, RESn) ends the decode
_SOF_REFUSED = (0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF)
_KNOWN_MARKERS = frozenset([0x01, 0xC4, 0xCC, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE,
                            *_SOF_SUPPORTED, *_SOF_UNPORTED, *range(0xD0, 0xD8),
                            *range(0xE0, 0xF0)])


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _segment(data: bytes, pos: int) -> tuple[bytes, int]:
    """The payload of the marker segment whose length field is at pos."""
    if pos + 2 > len(data):
        raise ValueError("JPEG: truncated marker segment")
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    if length < 2 or pos + length > len(data):
        raise ValueError("JPEG: truncated marker segment")
    return data[pos + 2:pos + length], pos + length


def _dht(payload: bytes, dc: dict, ac: dict) -> None:
    i = 0
    while i < len(payload):
        if i + 17 > len(payload):
            raise ValueError("JPEG: bad DHT segment")
        tc, th = payload[i] >> 4, payload[i] & 15
        counts = payload[i + 1:i + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or i + 17 + n > len(payload):
            raise ValueError("JPEG: bad DHT segment")
        spec = np.zeros(272, np.uint8)
        spec[:16] = np.frombuffer(counts, np.uint8)
        spec[16:16 + n] = np.frombuffer(payload[i + 17:i + 17 + n], np.uint8)
        (ac if tc else dc)[th] = spec
        i += 17 + n


def _dqt(payload: bytes, tables: dict) -> None:
    i = 0
    while i < len(payload):
        pq, tq = payload[i] >> 4, payload[i] & 15
        width = 2 if pq else 1
        if tq > 3 or pq > 1 or i + 1 + 64 * width > len(payload):
            raise ValueError("JPEG: bad DQT segment")
        vals = np.frombuffer(payload[i + 1:i + 1 + 64 * width], ">u2" if pq else np.uint8)
        table = np.zeros(64, np.uint16)
        table[NATURAL] = vals
        tables[tq] = table
        i += 1 + 64 * width


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int) -> None:
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan (jdinput.c)
        self.coef_bits = np.full(64, -1, np.int64)

    def layout(self, width: int, height: int, hmax: int, vmax: int, mcux: int, mcuy: int):
        self.blocks_w = -(-width * self.h // (hmax * 8))   # width_in_blocks
        self.blocks_h = -(-height * self.v // (vmax * 8))  # height_in_blocks
        self.down_w = -(-width * self.h // hmax)           # downsampled_width
        self.down_h = -(-height * self.v // vmax)
        self.stride = mcux * self.h
        self.coefs = np.zeros((mcuy * self.v, self.stride, 64), np.int16)


def _dac(payload: bytes) -> None:
    """jdmarker.c get_dac: (index, value) pairs, index below 32, a DC
    table's lower bound not above its upper."""
    if len(payload) % 2:
        raise ValueError("JPEG: bad DAC length")
    for k in range(0, len(payload), 2):
        index, val = payload[k], payload[k + 1]
        if index >= 32 or (index < 16 and (val & 15) > (val >> 4)):
            raise ValueError("JPEG: bad DAC entry")


def _sos_components(payload: bytes, comps: list) -> list:
    """jdmarker.c get_sos: the length is exactly 6 + 2n (n in 1..4), and
    each scan component is found among the frame's first four components
    whose slot in the scan list is still empty (a component named twice,
    or one that comes back to an earlier frame position already filled,
    is refused)."""
    n = payload[0] if payload else 0
    if not 1 <= n <= 4 or len(payload) != 4 + 2 * n:
        raise ValueError("JPEG: bad SOS segment")
    slots: list = [None] * 4
    for i in range(n):
        cc = payload[1 + 2 * i]
        found = next((ci for ci, c in enumerate(comps[:4])
                      if c.cid == cc and slots[ci] is None), None)
        if found is None or comps[found] in slots[:i]:
            raise ValueError("JPEG: a scan names an unknown or repeated component")
        slots[i] = comps[found]
    return slots[:n]


def _check_progressive(ncomp: int, ss: int, se: int, ah: int, al: int) -> None:
    """jdphuff.c start_pass_phuff_decoder's scan checks."""
    bad = (se != 0) if ss == 0 else (se < ss or se > 63 or ncomp != 1)
    if bad or (ah != 0 and al != ah - 1) or al > 13:
        raise ValueError(f"JPEG: invalid progressive scan Ss={ss} Se={se} Ah={ah} Al={al}")


def _decode_scan(data: bytes, pos: int, comps: list, mcu: tuple[int, int], dc: dict, ac: dict,
                 sel: list, progressive: bool, spectral: tuple, restart: int) -> int:
    tables = np.zeros((8, 272), np.uint8)
    present = np.zeros(8, np.int32)
    for k, spec in dc.items():
        tables[k], present[k] = spec, 1
    for k, spec in ac.items():
        tables[4 + k], present[4 + k] = spec, 1
    info = np.zeros((len(comps), 6), np.int32)
    for i, (c, (td, ta)) in enumerate(zip(comps, sel)):
        hv = (c.h, c.v) if len(comps) > 1 else (1, 1)
        info[i] = (*hv, c.stride, td, ta, 0)
    src = np.frombuffer(data, np.uint8)
    ss, se, ah, al = spectral
    got = native.library().gatling_jpeg_decode_scan(
        native.ptr(src, ctypes.c_uint8), src.size, pos, len(comps),
        native.ptr(info, ctypes.c_int32), native.pointers([c.coefs for c in comps]),
        mcu[0], mcu[1], native.ptr(tables, ctypes.c_uint8), native.ptr(present, ctypes.c_int32),
        int(progressive), ss, se, ah, al, restart)
    if got == -2:
        raise ValueError("JPEG: the data ends within a scan (image file is truncated)")
    if got < 0:
        raise ValueError("JPEG: a scan uses an undefined or malformed Huffman table")
    return int(got)


def _idct_plane(c: _Component) -> np.ndarray:
    """The component's samples [blocks_h * 8, blocks_w * 8] (jidctint.c)."""
    blocks = np.ascontiguousarray(c.coefs[:c.blocks_h, :c.blocks_w])
    out = np.empty((c.blocks_h, c.blocks_w, 8, 8), np.uint8)
    quant = np.ascontiguousarray(c.quant, np.uint16)
    native.library().gatling_jpeg_idct_islow(
        native.ptr(blocks, ctypes.c_int16), blocks.shape[0] * blocks.shape[1],
        native.ptr(quant, ctypes.c_uint16), native.ptr(out, ctypes.c_uint8))
    return out.transpose(0, 2, 1, 3).reshape(c.blocks_h * 8, c.blocks_w * 8)


def _prev(n: int) -> np.ndarray:
    return np.maximum(np.arange(n) - 1, 0)


def _next(n: int) -> np.ndarray:
    return np.minimum(np.arange(n) + 1, n - 1)


def _upsample(p: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c at do_fancy_upsampling: p [down_h, down_w] to hr x vr
    times its size, the edge samples repeated as libjpeg's context rows
    and edge columns repeat them."""
    dh, dw = p.shape
    x = p.astype(np.int32)
    if (hr, vr) == (1, 1):
        return p
    if (hr, vr) not in ((2, 1), (1, 2), (2, 2)):  # int_upsample: each sample repeated
        return np.repeat(np.repeat(p, hr, axis=1), vr, axis=0)
    if (hr, vr) == (1, 2):  # h1v2_fancy_upsample
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + x[_prev(dh)] + 1) >> 2
        out[1::2] = (3 * x + x[_next(dh)] + 2) >> 2
        return out.astype(np.uint8)
    if dw <= 2:  # h2v1_upsample / h2v2_upsample: sample replication
        return np.repeat(np.repeat(p, hr, axis=1), vr, axis=0)
    if vr == 1:  # h2v1_fancy_upsample
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + x[:, _prev(dw)] + 1) >> 2
        out[:, 1::2] = (3 * x + x[:, _next(dw)] + 2) >> 2
        return out.astype(np.uint8)
    cols = np.empty((2 * dh, dw), np.int32)  # h2v2_fancy_upsample: column sums,
    cols[0::2] = 3 * x + x[_prev(dh)]          # the row above for even rows,
    cols[1::2] = 3 * x + x[_next(dh)]          # the row below for odd
    out = np.empty((2 * dh, 2 * dw), np.int32)
    out[:, 0::2] = (3 * cols + cols[:, _prev(dw)] + 8) >> 4
    out[:, 1::2] = (3 * cols + cols[:, _next(dw)] + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its build_ycc_rgb_table tables."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    yy = y.astype(np.int64)
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _decode(data: bytes) -> tuple:
    """The full-size planes of a JPEG stream's components, their ids, and
    whether it has a JFIF marker and which Adobe transform."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos, frame, progressive, restart = 2, None, False, 0
    dc, ac, quant = {}, {}, {}
    jfif, adobe = False, None
    comps: list[_Component] = []
    ended, scans, multi_scan = False, 0, False
    # once the one scan of a single-scan file is decoded, Pillow has every
    # row: jpeg_finish_decompress reads the markers left, and data that
    # runs out there ends the decode without error
    finishing = False
    while pos < len(data):
        while pos < len(data) and data[pos] != 0xFF:  # garbage before a marker
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            ended = True
            break
        if 0xD0 <= m <= 0xD7 or m in (0x00, 0x01):  # stray RSTn, a stuffed 0xFF, TEM
            continue
        if m in _SOF_REFUSED or (frame is not None and (m in _SOF_SUPPORTED or m in _SOF_UNPORTED)):
            raise ValueError(f"JPEG: a refused or second SOF marker (0x{m:02X})")
        if m not in _KNOWN_MARKERS:
            raise ValueError(f"JPEG: unknown marker 0x{m:02X}")
        if m in _SOF_UNPORTED:
            raise NotImplementedError(f"JPEG: {_SOF_UNPORTED[m]} coding (SOF{m - 0xC0}) is not "
                                      f"ported {UNPORTED}")
        if (m >= 0xE0 or m in (0xDC, 0xFE)) and data[pos:pos + 2] in (b"\0\0", b"\0\1"):
            pos += 2  # skip_variable: a length below 2 skips nothing
            continue
        if finishing and (pos + 2 > len(data) or
                          pos + struct.unpack(">H", data[pos:pos + 2])[0] > len(data)):
            ended = True  # the segment runs past the data: libjpeg suspends
            break
        payload, pos = _segment(data, pos)
        if m in _SOF_SUPPORTED:
            if frame is not None:
                raise ValueError("JPEG: two SOF markers")
            progressive = _SOF_SUPPORTED[m]
            precision, height, width, n = struct.unpack(">BHHB", payload[:6])
            if precision != 8:  # JpegImagePlugin.SOF gives up on any other precision
                raise ValueError(f"JPEG: Pillow reads no {precision}-bit samples")
            if n not in (1, 3, 4):
                raise ValueError(f"JPEG: Pillow reads no image of {n} components")
            if height == 0 or width == 0 or len(payload) < 6 + 3 * n:
                raise ValueError("JPEG: bad SOF segment (an empty image: libjpeg reads no "
                                 "DNL height)")
            comps = [_Component(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                                payload[7 + 3 * i] & 15, payload[8 + 3 * i]) for i in range(n)]
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                raise ValueError("JPEG: bad sampling factors")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if any(hmax % c.h or vmax % c.v for c in comps):
                raise ValueError("JPEG: fractional sampling (libjpeg: not implemented)")
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.layout(width, height, hmax, vmax, mcux, mcuy)
            frame = (width, height, hmax, vmax, mcux, mcuy)
        elif m == 0xC4:
            _dht(payload, dc, ac)
        elif m == 0xDB:
            _dqt(payload, quant)
        elif m == 0xDD:
            if len(payload) < 2:
                raise ValueError("JPEG: bad DRI segment")
            (restart,) = struct.unpack(">H", payload[:2])
        elif m == 0xE0 and len(payload) >= 14 and payload[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe = payload[11]
        elif m == 0xCC:  # DAC: arithmetic conditioning, checked and unused
            _dac(payload)
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            if scans and not multi_scan:  # jdinput.c consume_markers
                raise ValueError("JPEG: a second scan in a one-scan file")
            scan = _sos_components(payload, comps)
            n = len(scan)
            if not scans:
                multi_scan = progressive or n < len(comps)
            scans += 1
            if n > 1 and sum(c.h * c.v for c in scan) > 10:
                raise ValueError("JPEG: sampling factors too large for an interleaved scan")
            sel = [(payload[2 + 2 * i] >> 4, payload[2 + 2 * i] & 15) for i in range(n)]
            ss, se, ahl = payload[1 + 2 * n:4 + 2 * n]
            ah, al = ahl >> 4, ahl & 15
            if progressive:
                _check_progressive(n, ss, se, ah, al)
            else:
                ss, se, ah, al = 0, 63, 0, 0
            for c in scan:
                if c.quant is None:
                    if c.tq not in quant:
                        raise ValueError(f"JPEG: quantisation table {c.tq} is undefined")
                    c.quant = quant[c.tq].copy()
                c.coef_bits[ss:se + 1] = al
            mcu = frame[4:] if n > 1 else (scan[0].blocks_w, scan[0].blocks_h)
            pos = _decode_scan(data, pos, scan, mcu, dc, ac, sel, progressive,
                               (ss, se, ah, al), restart)
            finishing = not multi_scan
    ended = ended or (finishing and pos >= len(data))
    if frame is None or not ended:
        raise ValueError("JPEG: truncated file" if frame is not None else "JPEG: no frame")
    if any(c.quant is None for c in comps):
        raise ValueError("JPEG: a component has no scan")
    # jdcoefct.c smoothing_ok: every DC known and some AC bits among 1-9 not
    if progressive and all(c.coef_bits[0] >= 0 for c in comps) and any(
            (c.coef_bits[1:_SMOOTH_COEFS] != 0).any() for c in comps):
        raise NotImplementedError("JPEG: a progressive file whose coefficients are not all "
                                  "refined (libjpeg's block smoothing) is not ported "
                                  f"{UNPORTED}")
    width, height, hmax, vmax = frame[:4]
    planes = [_upsample(_idct_plane(c)[:c.down_h, :c.down_w], hmax // c.h,
                        vmax // c.v)[:height, :width] for c in comps]
    return planes, tuple(c.cid for c in comps), jfif, adobe


def _ycck_to_cmyk(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, k: np.ndarray) -> np.ndarray:
    """jdcolor.c ycck_cmyk_convert: YCbCr to RGB by its tables, each
    inverted, K passed through."""
    return np.concatenate([255 - _ycc_to_rgb(y, cb, cr), k[..., None]], axis=-1)


def decode_planes(data: bytes, ycc: bool) -> np.ndarray:
    """The decoded samples [H, W, components] of a JPEG stream, converted
    from YCbCr to RGB if `ycc` (libtiff's JPEG colour mode for a YCbCr
    TIFF), else as coded."""
    planes = _decode(data)[0]
    if ycc and len(planes) == 3:
        return _ycc_to_rgb(*planes)
    return np.stack(planes, axis=-1)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H, W, 4] uint8 RGBA (a grey image in R, G and B), the
    JAX package's imgio.load_image(data).data for the same file."""
    planes, ids, jfif, adobe = _decode(data)
    if len(planes) == 1:
        return finish("L", planes[0])
    if len(planes) == 4:
        # jdapimin.c default_decompress_parms: an Adobe transform of 2 is
        # YCCK (any other value but 0 too, with a warning); without the
        # marker, or at 0, CMYK. Pillow reads either as "CMYK;I", inverted.
        cmyk = (np.stack(planes, axis=-1) if adobe in (None, 0)
                else _ycck_to_cmyk(*planes))
        return finish("CMYK", 255 - cmyk)
    # jdapimin.c default_decompress_parms: JFIF, then Adobe's transform, then
    # the component ids decide whether the samples are YCbCr
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    return finish("RGB", np.stack(planes, axis=-1) if rgb else _ycc_to_rgb(*planes))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

# jcparam.c's standard tables (ITU-T T.81 Annex K), natural order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# jstdhuff.c: (16 code counts, symbols) of DC luma, DC chroma, AC luma, AC chroma
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], list(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))


def quant_table(base: np.ndarray, quality: int = 75) -> np.ndarray:
    """jcparam.c jpeg_set_quality -> jpeg_add_quant_table, baseline limits."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)


def _spec(table: tuple) -> np.ndarray:
    counts, symbols = table
    spec = np.zeros(272, np.uint8)
    spec[:16] = counts
    spec[16:16 + len(symbols)] = symbols
    return spec


def _rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, ...]:
    """jccolor.c rgb_ycc_convert with its rgb_ycc_start tables."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b + offset + half - 1) >> 16
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _edge(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """p repeated at its bottom and right edges to [rows, cols]."""
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def _downsample(p: np.ndarray, h: int, v: int, cols: int) -> np.ndarray:
    """jcsample.c: full-size rows p [v * n, >= h * cols] to h x v fewer
    samples. h2v2_downsample adds 1 and 2 at alternate columns before its
    shift, h2v1_downsample 0 and 1, int_downsample (h1v2) half the count."""
    q = p[:, :h * cols].astype(np.int64)
    s = sum(q[y::v, x::h] for y in range(v) for x in range(h))
    bias = {(1, 1): [0, 0], (2, 1): [0, 1], (1, 2): [1, 1], (2, 2): [1, 2]}[(h, v)]
    return ((s + np.tile(bias, cols)[:cols]) // (h * v)).astype(np.uint8)


def _fdct(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantised coefficients [rows / 8, cols / 8, 64] of a padded plane."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = np.ascontiguousarray(plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3), np.uint8)
    coefs = np.empty((bh, bw, 64), np.int16)
    native.library().gatling_jpeg_fdct_islow(
        native.ptr(blocks, ctypes.c_uint8), bh * bw, native.ptr(quant, ctypes.c_uint16),
        native.ptr(coefs, ctypes.c_int16))
    return coefs


def _dummy_blocks(coefs: np.ndarray, h: int, v: int, blocks_w: int, blocks_h: int) -> None:
    """jccoefct.c compress_data's dummy blocks past the component's edge
    inside an MCU: AC zero, DC copied from the block before it (the one to
    the left, or below the bottom edge the MCU's last block above)."""
    bh, bw = coefs.shape[:2]
    for bx in range(blocks_w, bw):
        coefs[:, bx] = 0
        coefs[:, bx, 0] = coefs[:, bx - 1, 0]
    for by in range(blocks_h, bh):
        if by % v == 0:  # a whole MCU row of dummies cannot occur
            continue
        above = coefs[by - 1, h - 1::h, 0].copy()
        coefs[by] = 0
        coefs[by, :, 0] = np.repeat(above, h)


def encode_jpeg(img: np.ndarray, quality: int = 75, sampling: tuple[int, int] = (2, 2)) -> bytes:
    """[H, W] or [H, W, 1] grey, or [H, W, 3] RGB uint8 -> a baseline JPEG
    that decodes to what Pillow's file of the same image at the same
    quality decodes to. `sampling`: the luma's sampling factors (h, v) of
    a colour image over chroma at 1 x 1; Pillow's default (2, 2) is 4:2:0,
    (2, 1) 4:2:2, (1, 2) 4:4:0 and (1, 1) 4:4:4."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    height, width, nc = img.shape
    if nc not in (1, 3):
        raise ValueError(f"JPEG: expected 1 or 3 channels, got {img.shape}")
    h, v = sampling if nc == 3 else (1, 1)
    if h not in (1, 2) or v not in (1, 2):
        raise ValueError(f"JPEG: luma sampling factors {sampling} are not 1 or 2")
    qt = [quant_table(_STD_LUMA, quality), quant_table(_STD_CHROMA, quality)]
    mcux, mcuy = -(-width // (8 * h)), -(-height // (8 * v))
    planes = [img[..., 0]] if nc == 1 else _rgb_to_ycc(img)
    coefs = [_fdct(_edge(planes[0], 8 * v * mcuy, 8 * h * mcux), qt[0])]
    _dummy_blocks(coefs[0], h, v, -(-width // 8), -(-height // 8))
    for p in planes[1:]:
        # jcprepct.c: rows to a multiple of v, jcsample.c: columns to h times
        # the output's, then the output's last row down to the iMCU row
        full = _edge(p, -(-height // v) * v, 8 * h * mcux)
        coefs.append(_fdct(_edge(_downsample(full, h, v, 8 * mcux), 8 * mcuy, 8 * mcux), qt[1]))
    factors = [(h, v), (1, 1), (1, 1)][:nc]
    info = np.array([(h, v, c.shape[1], min(k, 1), min(k, 1), 0)
                     for k, ((h, v), c) in enumerate(zip(factors, coefs))], np.int32)
    tables = np.stack([_spec(t) for t in (_DC_LUMA, _DC_CHROMA, _AC_LUMA, _AC_CHROMA)])
    cap = sum(c.size for c in coefs) * 4 + 1024
    body = np.empty(cap, np.uint8)
    n = native.library().gatling_jpeg_encode_scan(
        nc, native.ptr(info, ctypes.c_int32), native.pointers(coefs), mcux, mcuy,
        native.ptr(tables, ctypes.c_uint8), native.ptr(body, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError("JPEG: the entropy-coded scan overflowed its buffer")

    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    ids = range(1, nc + 1)
    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for k in range(min(nc, 2)):
        out.append(seg(0xDB, bytes([k]) + qt[k][NATURAL].astype(np.uint8).tobytes()))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, height, width, nc) + b"".join(
        bytes([i, h << 4 | v, min(i - 1, 1)]) for i, (h, v) in zip(ids, factors))))
    for cls, k, t in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA),
                      (1, 1, _AC_CHROMA))[:2 if nc == 1 else 4]:
        out.append(seg(0xC4, bytes([cls << 4 | k, *t[0], *t[1]])))
    sel = b"".join(bytes([i, 0x11 if i > 1 else 0x00]) for i in ids)
    out.append(seg(0xDA, bytes([nc]) + sel + b"\x00\x3f\x00"))
    out += [body[:n].tobytes(), b"\xff\xd9"]
    return b"".join(out)
