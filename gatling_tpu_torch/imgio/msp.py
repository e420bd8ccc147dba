"""Windows Paint files (.msp) as Pillow 12.1 reads them (MspImagePlugin),
for the JAX package's imgio: mode "1".

Quirks reproduced: the header's 16 words must XOR to 0; version 1
("DanM") is raw rows of ceil(width / 8) bytes; version 2 ("LinS") has a
row map of byte counts after the header and its rows after that, each a
list of runs (0, count, byte) and literals (count, bytes), a row of 0
bytes all white; the rows' output is not padded or cut, so a row that
makes more or fewer bytes than the width shifts every row after it; a
literal cut by its row's end keeps what is left; a short row map or row,
or a run cut in the middle, fails.
"""

from __future__ import annotations

import struct

import numpy as np

from gatling_tpu_torch.imgio.modes import Skip, bomb_check, finish, raw_rows, unpack_bits


def decode_msp(data: bytes) -> np.ndarray:
    s = data[:32]
    if not s.startswith((b"DanM", b"LinS")):
        raise Skip("not an MSP file")
    if len(s) < 32:
        raise Skip("MSP: short header")  # struct.error in i16
    words = struct.unpack("<16H", s)
    checksum = 0
    for v in words:
        checksum ^= v
    if checksum != 0:
        raise Skip("bad MSP checksum")
    w, h = words[2], words[3]
    if w == 0 or h == 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    line = (w + 7) // 8
    if s.startswith(b"DanM"):
        return finish("1", unpack_bits(raw_rows(data, 32, w, h, line), w, 1))
    if len(data) < 32 + 2 * h:
        raise ValueError("Truncated MSP file in row map")
    rowmap = struct.unpack_from(f"<{h}H", data, 32)
    out = bytearray()
    pos = 32 + 2 * h
    for y, rowlen in enumerate(rowmap):
        if rowlen == 0:
            out += b"\xff" * line
            continue
        row = data[pos:pos + rowlen]
        pos += rowlen
        if len(row) != rowlen:
            raise ValueError(f"Truncated MSP file, expected {rowlen} bytes on row {y}")
        i = 0
        while i < rowlen:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > rowlen:
                    raise ValueError(f"Corrupted MSP file in row {y}")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    if len(out) < line * h:
        raise ValueError("not enough image data")
    rows = np.frombuffer(bytes(out), np.uint8, line * h).reshape(h, line)
    return finish("1", unpack_bits(rows, w, 1))
