"""Write the hand-made JPEG 2000 codestreams of tests/test_torch_jpeg2000.py
that settle four header orders against OpenJPEG 2.5.4 (through Pillow),
each an edit of ../style_reset_53.j2k (one tile, one tile-part):

- coc_before_cod.j2k: a COC for component 0 before the COD, with the
  COD's own parameters; coc_differs_before_cod.j2k: the same COC with one
  resolution fewer, which the later COD overrides in OpenJPEG;
- qcc_before_qcd.j2k: a QCC for component 0 before the QCD, with the
  QCD's parameters; qcc_differs_before_qcd.j2k: its guard bits changed;
- psot12.j2k: the tile's data split over two tile-parts, the first of
  Psot 12 (an SOT followed straight by its SOD, with no data);
- repeated_part0.j2k: the tile's data split over two tile-parts, the
  second again tile-part 0, of 0 tile-parts.

Run from the repository root:

    python tests/data/jpeg2000/repairs/make_repairs.py
"""

from __future__ import annotations

import os
import struct

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "style_reset_53.j2k")


def segments(cs: bytes) -> tuple[list[tuple[int, bytes]], bytes]:
    """The main header's marker segments [(marker, payload)] up to the first
    SOT, and the rest of the codestream from that SOT."""
    out, pos = [], 2
    while True:
        (m,) = struct.unpack_from(">H", cs, pos)
        if m == 0xFF90:
            return out, cs[pos:]
        (n,) = struct.unpack_from(">H", cs, pos + 2)
        out.append((m, cs[pos + 4:pos + 2 + n]))
        pos += 2 + n


def join(segs: list[tuple[int, bytes]], rest: bytes) -> bytes:
    return b"\xff\x4f" + b"".join(struct.pack(">HH", m, len(p) + 2) + p for m, p in segs) + rest


def sot(psot: int, part: int, parts: int) -> bytes:
    return struct.pack(">HHHIBB", 0xFF90, 10, 0, psot, part, parts)


def tile_parts(rest: bytes, first: tuple[int, int], second: tuple[int, int],
               psot12: bool = False) -> bytes:
    """The one tile's packet data split over two tile-parts."""
    data = rest[14:]
    assert data.endswith(b"\xff\xd9")
    data = data[:-2]
    if psot12:
        return sot(12, *first) + b"\xff\x93" + sot(14 + len(data), *second) + b"\xff\x93" \
            + data + b"\xff\xd9"
    cut = len(data) // 2
    return (sot(14 + cut, *first) + b"\xff\x93" + data[:cut] + sot(14 + len(data) - cut, *second)
            + b"\xff\x93" + data[cut:] + b"\xff\xd9")


def files() -> dict[str, bytes]:
    with open(SOURCE, "rb") as f:
        cs = f.read()
    segs, rest = segments(cs)
    kinds = [m for m, _ in segs]
    cod = segs[kinds.index(0xFF52)][1]
    qcd = segs[kinds.index(0xFF5C)][1]
    at_cod, at_qcd = kinds.index(0xFF52), kinds.index(0xFF5C)
    # COC: Ccoc (one byte: fewer than 257 components), Scoc (the precinct bit
    # of Scod), then SPcod; QCC: Cqcc, then Sqcd and its step sizes
    coc = bytes([0, cod[0] & 1]) + cod[5:]
    fewer = bytes([0, cod[0] & 1, cod[5] - 1]) + cod[6:]
    qcc = bytes([0]) + qcd
    guard = bytes([0, (qcd[0] + 0x20) & 0xFF]) + qcd[1:]
    return {
        "coc_before_cod.j2k": join(segs[:at_cod] + [(0xFF53, coc)] + segs[at_cod:], rest),
        "coc_differs_before_cod.j2k": join(segs[:at_cod] + [(0xFF53, fewer)] + segs[at_cod:],
                                           rest),
        "qcc_before_qcd.j2k": join(segs[:at_qcd] + [(0xFF5D, qcc)] + segs[at_qcd:], rest),
        "qcc_differs_before_qcd.j2k": join(segs[:at_qcd] + [(0xFF5D, guard)] + segs[at_qcd:],
                                           rest),
        "psot12.j2k": join(segs, tile_parts(rest, (0, 2), (1, 2), psot12=True)),
        "repeated_part0.j2k": join(segs, tile_parts(rest, (0, 1), (0, 0))),
    }


def main() -> None:
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        print(f"{name}: {len(data)} bytes")


if __name__ == "__main__":
    main()
