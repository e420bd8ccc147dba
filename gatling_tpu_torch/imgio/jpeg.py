"""JPEG decoder and baseline encoder that reproduce libjpeg-turbo's output
code for code (the JAX package reads and writes JPEG through Pillow, which
links libjpeg-turbo 3.1).

The decoder reads 8-bit files of every process libjpeg-turbo decodes:
baseline and extended-sequential, progressive and lossless frames,
Huffman- or arithmetic-coded, with one (grey), three (YCbCr or RGB) or
four components (CMYK, or YCCK by the Adobe APP14 transform), any integer
sampling ratios (1 to 4 in each direction), restart intervals, and any
APPn or COM segments. It decodes as libjpeg does with its defaults:
- the markers are parsed here; each scan's entropy-coded segment is
  decoded by the native library into coefficient blocks: Huffman
  (gatling_jpeg_decode_scan: the sequential decoder of jdhuff.c and the
  four progressive ones of jdphuff.c) or arithmetic
  (gatling_jpeg_decode_arith_scan: jdarith.c, its DAC conditioning with
  the SOI defaults, restart intervals resetting the statistics);
- jidctint.c's islow IDCT dequantises and transforms them
  (gatling_jpeg_idct_islow); a progressive file whose first AC
  coefficients are not all refined after its last scan is smoothed first
  as jdcoefct.c decompress_smooth_data smooths it (`_smooth`: the
  estimates from the 5x5 neighbourhood of DC values, the coef_bits latch,
  the previous scan's bits past the last good iMCU row);
- a lossless frame (SOF3) is undifferenced as jddiffct.c and jdlossls.c do
  (gatling_jpeg_decode_lossless: predictors 1-7, the point transform);
- jdsample.c brings the chroma to full size: the fancy h2v1, h1v2 and
  h2v2 triangle filters (their alternating rounding biases, the edge
  sample repeated), and int_upsample's replication for every other ratio
  and for every lossless frame;
- jdcolor.c's fixed-point tables convert YCbCr to RGB, and YCCK to CMYK;
  Pillow reads four components as "CMYK;I", inverted, and converts them
  to RGBA as it converts CMYK.
A file Pillow or libjpeg rejects (another precision than 8 bits, two
components, a height given only by a DNL marker, fractional sampling,
hierarchical frames, arithmetic-coded lossless frames, which
libjpeg-turbo does not implement) raises ValueError.

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
from types import SimpleNamespace

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import finish

# jpeg_natural_order: the block index of the k-th coefficient in zigzag order
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# coefficients 0-9 decide libjpeg's progressive block smoothing (jdcoefct.c
# SAVED_COEFS)
_SMOOTH_COEFS = 10

# the frames libjpeg-turbo reads: marker -> (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False), 0xC2: (True, False, False),
        0xC3: (False, False, True), 0xC9: (False, True, False), 0xCA: (True, True, False),
        0xCB: (False, True, True)}
# jdmarker.c read_markers: the frame types it refuses (hierarchical, JPG and
# the differential arithmetic ones), and the markers it knows; any other
# (DHP, EXP, JPGn, RESn) ends the decode
_SOF_REFUSED = (0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF)
_KNOWN_MARKERS = frozenset([0x01, 0xC4, 0xCC, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE,
                            *_SOF, *range(0xD0, 0xD8), *range(0xE0, 0xF0)])


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
        self.scanned = False
        # cinfo->coef_bits and the copy each progressive scan takes first
        self.coef_bits = np.full(64, -1, np.int64)
        self.prev_bits = np.full(64, -1, np.int64)

    def layout(self, width: int, height: int, hmax: int, vmax: int, mcux: int, mcuy: int,
               size: int = 8) -> None:
        """The component's extent in blocks of size x size samples (1 x 1 in
        a lossless frame): coefficient blocks, or the samples themselves."""
        self.blocks_w = -(-width * self.h // (hmax * size))   # width_in_blocks
        self.blocks_h = -(-height * self.v // (vmax * size))  # height_in_blocks
        self.down_w = -(-width * self.h // hmax)              # downsampled_width
        self.down_h = -(-height * self.v // vmax)
        self.stride = mcux * self.h
        if size == 1:
            self.samples = np.zeros((mcuy * self.v, self.blocks_w), np.uint8)
        else:
            self.coefs = np.zeros((mcuy * self.v, self.stride, 64), np.int16)


def _dac(payload: bytes, dac: np.ndarray) -> None:
    """jdmarker.c get_dac: (index, value) pairs, index below 32, a DC
    table's lower bound not above its upper, into dac (L[16], U[16],
    K[16])."""
    if len(payload) % 2:
        raise ValueError("JPEG: bad DAC length")
    for k in range(0, len(payload), 2):
        index, val = payload[k], payload[k + 1]
        if index >= 32 or (index < 16 and (val & 15) > (val >> 4)):
            raise ValueError("JPEG: bad DAC entry")
        if index >= 16:
            dac[32 + index - 16] = val
        else:
            dac[index], dac[16 + index] = val & 15, val >> 4


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


def _tables(dc: dict, ac: dict) -> tuple:
    tables = np.zeros((8, 272), np.uint8)
    present = np.zeros(8, np.int32)
    for k, spec in dc.items():
        tables[k], present[k] = spec, 1
    for k, spec in ac.items():
        tables[4 + k], present[4 + k] = spec, 1
    return tables, present


def _decode_scan(data: bytes, pos: int, comps: list, mcu: tuple[int, int], dc: dict, ac: dict,
                 sel: list, progressive: bool, spectral: tuple, restart: int,
                 dac: np.ndarray | None, state: np.ndarray) -> int:
    """One DCT scan, Huffman-coded, or arithmetic-coded under the
    conditioning dac; state as gatling_jpeg_decode_scan takes it."""
    info = np.zeros((len(comps), 6), np.int32)
    for i, (c, (td, ta)) in enumerate(zip(comps, sel)):
        hv = (c.h, c.v) if len(comps) > 1 else (1, 1)
        info[i] = (*hv, c.stride, td, ta, 0)
    src = np.frombuffer(data, np.uint8)
    ss, se, ah, al = spectral
    lib = native.library()
    args = (native.ptr(src, ctypes.c_uint8), src.size, pos, len(comps),
            native.ptr(info, ctypes.c_int32), native.pointers([c.coefs for c in comps]),
            mcu[0], mcu[1])
    if dac is None:
        tables, present = _tables(dc, ac)
        got = lib.gatling_jpeg_decode_scan(
            *args, native.ptr(tables, ctypes.c_uint8), native.ptr(present, ctypes.c_int32),
            int(progressive), ss, se, ah, al, restart, native.ptr(state, ctypes.c_int32))
    else:
        got = lib.gatling_jpeg_decode_arith_scan(
            *args, native.ptr(dac, ctypes.c_int32), int(progressive), ss, se, ah, al, restart,
            native.ptr(state, ctypes.c_int32))
    if got == -2:
        raise ValueError("JPEG: the data ends within a scan (image file is truncated)")
    if got < 0:
        raise ValueError("JPEG: a scan uses an undefined or malformed Huffman table")
    return int(got)


def _decode_lossless(data: bytes, pos: int, comps: list, mcu: tuple[int, int], dc: dict,
                     sel: list, psv: int, pt: int, restart: int) -> int:
    """One scan of a lossless (SOF3) frame into the components' samples."""
    info = np.array([(c.h, c.v, c.blocks_w, c.blocks_h, td, 0) for c, (td, _) in zip(comps, sel)],
                    np.int32)
    tables, present = _tables(dc, {})
    src = np.frombuffer(data, np.uint8)
    got = native.library().gatling_jpeg_decode_lossless(
        native.ptr(src, ctypes.c_uint8), src.size, pos, len(comps), native.ptr(info, ctypes.c_int32),
        native.pointers([c.samples for c in comps]), mcu[0], mcu[1],
        native.ptr(tables, ctypes.c_uint8), native.ptr(present, ctypes.c_int32), psv, pt, restart,
        8)
    if got == -2:
        raise ValueError("JPEG: the data ends within a scan (image file is truncated)")
    if got == -3:
        raise ValueError("JPEG: a lossless restart interval is not a whole number of MCU rows")
    if got < 0:
        raise ValueError("JPEG: a scan uses an undefined or malformed Huffman table")
    return int(got)


def _idct_plane(c: _Component, blocks: np.ndarray | None = None) -> np.ndarray:
    """The component's samples [rows * 8, cols * 8] (jidctint.c) of its
    coefficient blocks [blocks_h, blocks_w], or of `blocks` [rows, cols,
    64]."""
    if blocks is None:
        blocks = c.coefs[:c.blocks_h, :c.blocks_w]
    blocks = np.ascontiguousarray(blocks, np.int16)
    rows, cols = blocks.shape[:2]
    out = np.empty((rows, cols, 8, 8), np.uint8)
    quant = np.ascontiguousarray(c.quant, np.uint16)
    native.library().gatling_jpeg_idct_islow(
        native.ptr(blocks, ctypes.c_int16), rows * cols,
        native.ptr(quant, ctypes.c_uint16), native.ptr(out, ctypes.c_uint8))
    return out.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _prev(n: int) -> np.ndarray:
    return np.maximum(np.arange(n) - 1, 0)


def _next(n: int) -> np.ndarray:
    return np.minimum(np.arange(n) + 1, n - 1)


def _upsample(p: np.ndarray, hr: int, vr: int, fancy: bool = True) -> np.ndarray:
    """jdsample.c: p [down_h, down_w] to hr x vr times its size, the edge
    samples repeated as libjpeg's context rows and edge columns repeat
    them. Fancy upsampling needs DCT blocks larger than one sample: a
    lossless frame's samples are replicated."""
    dh, dw = p.shape
    x = p.astype(np.int32)
    if (hr, vr) == (1, 1):
        return p
    if not fancy or (hr, vr) not in ((2, 1), (1, 2), (2, 2)):  # each sample repeated
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


# jdcoefct.c: natural-order positions of the zigzag coefficients 1-9
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def _smooth_columns(width: int) -> np.ndarray:
    """The block columns [width, 5] whose DC values decompress_smooth_data's
    sliding registers hold at each block: two to the left, the block, two
    to the right, the row's first and last columns repeated past its
    ends."""
    return np.clip(np.arange(width)[:, None] + np.arange(-2, 3)[None, :], 0, width - 1)


def _smooth(c: _Component, total: int, last_good: int, latch: np.ndarray,
            prev_latch: np.ndarray) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1): the
    component's blocks [blocks_h, blocks_w, 64] with each of the first nine
    AC coefficients that is zero and not known exactly estimated from the
    5x5 neighbourhood of DC values, and, where no AC data at all is known,
    the DC interpolated too. iMCU rows past last_good take the previous
    scan's coefficient bits (prev_latch)."""
    q = c.quant.astype(np.int64)
    q00 = q[0]
    dcs = c.coefs[..., 0].astype(np.int64)
    work = c.coefs[:c.blocks_h, :c.blocks_w].astype(np.int64)
    cols = _smooth_columns(c.blocks_w)
    for r in range(total):
        block_rows = c.v if r < total - 1 else (c.blocks_h % c.v or c.v)
        image_block_rows = block_rows * total
        bits = prev_latch if r > last_good else latch
        change_dc = bool((bits[1:10] == -1).all())
        for br in range(block_rows):
            ibr = r * block_rows + br
            phys = r * c.v + br
            prev = phys - 1 if ibr > 0 else phys
            pprev = phys - 2 if ibr > 1 else prev
            nxt = phys + 1 if ibr < image_block_rows - 1 else phys
            nnxt = phys + 2 if ibr < image_block_rows - 2 else nxt
            # DC[k] of the kernel, k = 1..25 row by row: [width, 26]
            g = dcs[np.array([pprev, prev, phys, nxt, nnxt])[:, None, None], cols.T[None, :, :]]
            DC = np.concatenate([np.zeros((1, c.blocks_w), np.int64),
                                 g.reshape(25, c.blocks_w)])
            w = work[phys]

            def est(k: int, pos: int, qk: int, kernel) -> None:
                al = int(bits[k])
                if al == 0:
                    return
                num = q00 * kernel
                pred = np.where(num >= 0, ((qk << 7) + num) // (qk << 8),
                                ((qk << 7) - num) // (qk << 8))
                if al > 0:
                    pred = np.minimum(pred, (1 << al) - 1)
                pred = np.where(num >= 0, pred, -pred)
                w[:, pos] = np.where(w[:, pos] == 0, pred, w[:, pos])

            D = DC
            if change_dc:
                k01 = (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10]
                       - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17]
                       - 13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25])
                k10 = (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7]
                       + 38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18]
                       - 13 * D[19] + D[20] + D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
                k20 = (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14]
                       + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23])
                k11 = -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]
                k02 = (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13]
                       + 7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19])
            else:
                k01 = -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]
                k10 = -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]
                k20 = -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]
                k11 = (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24]
                       + D[4] - D[6] + 10 * D[7] - 10 * D[9])
                k02 = -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]
            for k, kernel in enumerate((k01, k10, k20, k11, k02), start=1):
                est(k, _SMOOTH_POS[k - 1], int(q[_SMOOTH_POS[k - 1]]), kernel)
            if change_dc:
                for k, kernel in ((6, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]),
                                  (7, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]),
                                  (8, D[7] - 3 * D[12] + D[17] - D[9] + 3 * D[14] - D[19]),
                                  (9, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19])):
                    est(k, _SMOOTH_POS[k - 1], int(q[_SMOOTH_POS[k - 1]]), kernel)
                num = q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6]
                             + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11]
                             + 42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16]
                             + 6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21]
                             - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25])
                pred = np.where(num >= 0, ((q00 << 7) + num) // (q00 << 8),
                                -(((q00 << 7) - num) // (q00 << 8)))
                w[:, 0] = pred
    return work.astype(np.int16)


def read(data: bytes, components: tuple | None = (1, 3, 4)) -> SimpleNamespace:
    """A JPEG stream's frame as libjpeg reads it, every scan decoded: the
    components (ids, sampling, quantisation tables and coefficient blocks
    [rows, stride, 64] padded to whole MCUs, or a lossless frame's samples),
    the scans (Ss, Se, Ah, Al and the components' indices), the restart
    interval, and what decides the colour space (JFIF, Adobe). `components`:
    the component counts Pillow opens (None: any, as libtiff's codec)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos, frame, restart = 2, None, 0
    progressive = arith = lossless = False
    dc, ac, quant = {}, {}, {}
    # jdmarker.c get_soi: every table's arithmetic conditioning L, U and K
    dac = np.array([0] * 16 + [1] * 16 + [5] * 16, np.int32)
    jfif, adobe = False, None
    comps: list[_Component] = []
    ended, scans, multi_scan = False, 0, False
    state = np.zeros(2, np.int32)  # MCU rows an iMCU row, last_good_iMCU_row
    script = []
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
        if m in _SOF_REFUSED or (frame is not None and m in _SOF):
            raise ValueError(f"JPEG: a refused or second SOF marker (0x{m:02X})")
        if m not in _KNOWN_MARKERS:
            raise ValueError(f"JPEG: unknown marker 0x{m:02X}")
        if (m >= 0xE0 or m in (0xDC, 0xFE)) and data[pos:pos + 2] in (b"\0\0", b"\0\1"):
            pos += 2  # skip_variable: a length below 2 skips nothing
            continue
        if finishing and (pos + 2 > len(data) or
                          pos + struct.unpack(">H", data[pos:pos + 2])[0] > len(data)):
            ended = True  # the segment runs past the data: libjpeg suspends
            break
        payload, pos = _segment(data, pos)
        if m in _SOF:
            progressive, arith, lossless = _SOF[m]
            precision, height, width, n = struct.unpack(">BHHB", payload[:6])
            if precision != 8:  # JpegImagePlugin.SOF gives up on any other precision
                raise ValueError(f"JPEG: Pillow reads no {precision}-bit samples")
            if components is not None and n not in components:
                raise ValueError(f"JPEG: Pillow reads no image of {n} components")
            if height == 0 or width == 0 or len(payload) < 6 + 3 * n:
                raise ValueError("JPEG: bad SOF segment (an empty image: libjpeg reads no "
                                 "DNL height)")
            if arith and lossless:  # jdlossls.c: JERR_ARITH_NOTIMPL
                raise ValueError("JPEG: libjpeg-turbo decodes no arithmetic-coded lossless "
                                 "frame (SOF11)")
            comps = [_Component(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                                payload[7 + 3 * i] & 15, payload[8 + 3 * i]) for i in range(n)]
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                raise ValueError("JPEG: bad sampling factors")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if any(hmax % c.h or vmax % c.v for c in comps):
                raise ValueError("JPEG: fractional sampling (libjpeg: not implemented)")
            size = 1 if lossless else 8
            mcux, mcuy = -(-width // (size * hmax)), -(-height // (size * vmax))
            for c in comps:
                c.layout(width, height, hmax, vmax, mcux, mcuy, size)
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
        elif m == 0xCC:  # DAC: the arithmetic coder's conditioning
            _dac(payload, dac)
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
            mcu = frame[4:] if n > 1 else (scan[0].blocks_w, scan[0].blocks_h)
            state[0] = 1 if n > 1 else scan[0].v
            script.append((ss, se, ah, al, tuple(comps.index(c) for c in scan)))
            if lossless:  # jdlossls.c start_pass_lossless
                if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
                    raise ValueError(f"JPEG: invalid lossless scan Ss={ss} Se={se} Ah={ah} "
                                     f"Al={al}")
                for c in scan:
                    c.scanned = True
                pos = _decode_lossless(data, pos, scan, (frame[4], frame[5]), dc, sel, ss, al,
                                       restart)
                finishing = not multi_scan
                continue
            if progressive:
                _check_progressive(n, ss, se, ah, al)
            else:
                ss, se, ah, al = 0, 63, 0, 0
            for c in scan:
                if c.quant is None:
                    if c.tq not in quant:
                        raise ValueError(f"JPEG: quantisation table {c.tq} is undefined")
                    c.quant = quant[c.tq].copy()
                c.scanned = True
                if progressive:  # jdphuff.c / jdarith.c start_pass
                    lo, hi = min(ss, 1), max(se, 9)
                    c.prev_bits[lo:hi + 1] = c.coef_bits[lo:hi + 1] if scans > 1 else 0
                c.coef_bits[ss:se + 1] = al
            pos = _decode_scan(data, pos, scan, mcu, dc, ac, sel, progressive,
                               (ss, se, ah, al), restart, dac if arith else None, state)
            finishing = not multi_scan
    ended = ended or (finishing and pos >= len(data))
    if frame is None or not ended:
        raise ValueError("JPEG: truncated file" if frame is not None else "JPEG: no frame")
    if not all(c.scanned for c in comps):
        raise ValueError("JPEG: a component has no scan")
    return SimpleNamespace(frame=frame, comps=comps, scans=script, restart=restart, jfif=jfif,
                           adobe=adobe, progressive=progressive, arith=arith,
                           lossless=lossless, last_good=int(state[1]))


def _decode(data: bytes, components: tuple | None = (1, 3, 4), frame=None) -> tuple:
    """The full-size planes of a JPEG stream's components, their ids, and
    whether it has a JFIF marker and which Adobe transform (`frame`: the
    stream's `read`, if made already)."""
    f = frame if frame is not None else read(data, components)
    comps = f.comps
    width, height, hmax, vmax = f.frame[:4]
    if f.lossless:
        planes = [_upsample(c.samples[:c.down_h, :c.down_w], hmax // c.h, vmax // c.v,
                            fancy=False)[:height, :width] for c in comps]
        return planes, tuple(c.cid for c in comps), f.jfif, f.adobe
    # jdcoefct.c smoothing_ok: every DC known and some AC bits among 1-9 not
    # (and no quantiser of the ten coefficients zero)
    smooth = (f.progressive and all(c.coef_bits[0] >= 0 for c in comps)
              and all(c.quant[[0, *_SMOOTH_POS]].all() for c in comps)
              and any((c.coef_bits[1:_SMOOTH_COEFS] != 0).any() for c in comps))
    planes = []
    for c in comps:
        blocks = None
        if smooth:
            prev = (c.prev_bits[:_SMOOTH_COEFS] if len(f.scans) > 1
                    else np.full(_SMOOTH_COEFS, -1))
            blocks = _smooth(c, f.frame[5], f.last_good, c.coef_bits[:_SMOOTH_COEFS], prev)
        plane = _idct_plane(c, blocks)[:c.down_h, :c.down_w]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v)[:height, :width])
    return planes, tuple(c.cid for c in comps), f.jfif, f.adobe


def raw_planes(data: bytes) -> tuple:
    """jpeg_read_raw_data: each component's samples at its own resolution,
    every coded block of the MCUs (the dummy blocks at the right and bottom
    edges too), no upsampling or colour conversion; and the frame's
    (width, height, hmax, vmax). libtiff's old-style JPEG codec reads a
    subsampled YCbCr image so."""
    f = read(data, None)
    return [_idct_plane(c, c.coefs) for c in f.comps], f.frame[:4]


def _ycck_to_cmyk(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, k: np.ndarray) -> np.ndarray:
    """jdcolor.c ycck_cmyk_convert: YCbCr to RGB by its tables, each
    inverted, K passed through."""
    return np.concatenate([255 - _ycc_to_rgb(y, cb, cr), k[..., None]], axis=-1)


def decode_planes(data: bytes, ycc: bool, frame=None) -> np.ndarray:
    """The decoded samples [H, W, components] of a JPEG stream of any
    component count (libtiff's codec), converted from YCbCr to RGB if `ycc`
    (libtiff's JPEG colour mode for a YCbCr TIFF), else as coded."""
    planes = _decode(data, None, frame)[0]
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
