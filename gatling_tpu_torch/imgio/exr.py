"""Minimal OpenEXR 2.0 scanline codec on zlib, struct and NumPy: the
port's copy of the JAX package's imgio/exr.py, the same operations.

The reference decodes EXR through the OpenEXR library
(src/imgio/impl/ExrDecoder.cpp); the port depends on no OpenEXR binding, so
this implements the subset that matters for texture and dome light input:
single-part scanline images, NONE/ZIPS/ZIP/RLE compression, HALF/FLOAT/UINT
channels. The writer emits ZIP-compressed half or float data.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_COMPRESSION_LINES = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE, ZIPS, ZIP


def _read_cstr(f: io.BytesIO) -> bytes:
    out = bytearray()
    while True:
        c = f.read(1)
        if c in (b"", b"\x00"):
            return bytes(out)
        out += c


def _unpredict_and_interleave(raw: bytes) -> bytes:
    """Undo EXR's delta predictor + two-half split used by ZIP/ZIPS/RLE."""
    d = np.frombuffer(raw, dtype=np.uint8).astype(np.int16)
    d = (np.cumsum(d - 128, dtype=np.int64) + 128).astype(np.uint8)  # delta decode
    n = len(d)
    out = np.empty(n, dtype=np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _predict_and_deinterleave(raw: bytes) -> bytes:
    d = np.frombuffer(raw, dtype=np.uint8)
    n = len(d)
    half = (n + 1) // 2
    split = np.empty(n, dtype=np.uint8)
    split[:half] = d[0::2]
    split[half:] = d[1::2]
    s = split.astype(np.int16)
    delta = np.empty(n, dtype=np.int16)
    delta[0] = s[0]
    delta[1:] = s[1:] - s[:-1] + 128
    return delta.astype(np.uint8).tobytes()


def _rle_decompress(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        count = struct.unpack_from("<b", raw, i)[0]
        i += 1
        if count < 0:
            out += raw[i:i - count]
            i += -count
        else:
            out += raw[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


def decode_exr(data: bytes) -> np.ndarray:
    """Decode an EXR file to [H, W, 4] float32 (missing channels filled, A=1)."""
    f = io.BytesIO(data)
    magic, version = struct.unpack("<iI", f.read(8))
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    if version & 0x800:
        raise ValueError("deep EXR not supported")
    if version & 0x2FF != 2 and (version & 0xFF) != 2:
        raise ValueError(f"unsupported EXR version {version}")

    channels: list[tuple[str, int]] = []
    compression = None
    data_window = None
    while True:
        name = _read_cstr(f)
        if name == b"":
            break
        _type = _read_cstr(f)
        size = struct.unpack("<i", f.read(4))[0]
        payload = f.read(size)
        if name == b"channels":
            pf = io.BytesIO(payload)
            while True:
                cname = _read_cstr(pf)
                if cname == b"":
                    break
                ptype, _plin, _xs, _ys = struct.unpack("<iB3xii", pf.read(16))
                channels.append((cname.decode(), ptype))
        elif name == b"compression":
            compression = payload[0]
        elif name == b"dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _COMPRESSION_LINES:
        raise ValueError(f"unsupported EXR compression {compression}")
    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = _COMPRESSION_LINES[compression]
    n_blocks = (height + lines_per_block - 1) // lines_per_block

    # channels are stored sorted by name within each scanline
    chan_sorted = sorted(channels, key=lambda c: c[0])
    bytes_per_px = sum(_PIXEL_DTYPES[t].itemsize for _, t in chan_sorted)

    f.read(8 * n_blocks)  # skip line offset table; chunks follow in order

    planes = {cname: np.zeros((height, width), np.float32) for cname, _ in channels}
    for _ in range(n_blocks):
        y, nbytes = struct.unpack("<ii", f.read(8))
        raw = f.read(nbytes)
        y0 = y - ymin
        n_lines = min(lines_per_block, height - y0)
        expected = n_lines * width * bytes_per_px
        if compression in (2, 3):  # ZIPS / ZIP
            if nbytes < expected:
                raw = _unpredict_and_interleave(zlib.decompress(raw))
        elif compression == 1:  # RLE
            if nbytes < expected:
                raw = _unpredict_and_interleave(_rle_decompress(raw))
        buf = memoryview(raw)
        off = 0
        for line in range(n_lines):
            for cname, ptype in chan_sorted:
                dt = _PIXEL_DTYPES[ptype]
                row = np.frombuffer(buf[off:off + width * dt.itemsize], dtype=dt)
                off += width * dt.itemsize
                planes[cname][y0 + line] = row.astype(np.float32)

    out = np.ones((height, width, 4), dtype=np.float32)
    names = {c for c, _ in channels}
    if {"R", "G", "B"} <= names:
        out[:, :, 0], out[:, :, 1], out[:, :, 2] = planes["R"], planes["G"], planes["B"]
        if "A" in names:
            out[:, :, 3] = planes["A"]
    elif "Y" in names:  # luminance image
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = planes["Y"]
    else:  # fall back to the first channel
        first = chan_sorted[0][0]
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = planes[first]
    return out


def encode_exr(rgba: np.ndarray, half: bool = True) -> bytes:
    """Encode [H, W, 3|4] float data as a ZIP-compressed scanline EXR."""
    rgba = np.asarray(rgba, dtype=np.float32)
    h, w = rgba.shape[:2]
    has_alpha = rgba.shape[2] >= 4
    dt = np.dtype("<f2") if half else np.dtype("<f4")
    ptype = 1 if half else 2

    chan_names = (["A"] if has_alpha else []) + ["B", "G", "R"]  # alphabetical
    plane = {
        "R": rgba[:, :, 0], "G": rgba[:, :, 1], "B": rgba[:, :, 2],
        **({"A": rgba[:, :, 3]} if has_alpha else {}),
    }

    def attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
        return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(payload)) + payload

    chlist = b""
    for cn in chan_names:
        chlist += cn.encode() + b"\x00" + struct.pack("<i4xii", ptype, 1, 1)
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        attr(b"channels", b"chlist", chlist),
        attr(b"compression", b"compression", b"\x03"),  # ZIP
        attr(b"dataWindow", b"box2i", box),
        attr(b"displayWindow", b"box2i", box),
        attr(b"lineOrder", b"lineOrder", b"\x00"),
        attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0)),
        attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
    ]) + b"\x00"

    lines_per_block = 16
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    chunks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        n_lines = min(lines_per_block, h - y0)
        raw = bytearray()
        for line in range(n_lines):
            for cn in chan_names:
                raw += plane[cn][y0 + line].astype(dt).tobytes()
        comp = zlib.compress(_predict_and_deinterleave(bytes(raw)))
        if len(comp) >= len(raw):
            comp = bytes(raw)
        chunks.append(struct.pack("<ii", y0, len(comp)) + comp)

    prefix = struct.pack("<iI", _MAGIC, 2) + header
    table_pos = len(prefix)
    offsets = []
    pos = table_pos + 8 * n_blocks
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    table = struct.pack(f"<{n_blocks}Q", *offsets)
    return prefix + table + b"".join(chunks)
