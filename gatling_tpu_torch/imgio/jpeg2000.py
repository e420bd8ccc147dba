"""JPEG 2000 decoder that reproduces Pillow 12.1 over OpenJPEG 2.5.4 code
for code (the JAX package reads JPEG 2000 through Pillow).

Three layers, each as its original does it:
- Pillow's Jpeg2KImagePlugin opens the file: a raw codestream by its SOC
  and SIZ markers, a JP2 file by its signature box (the `ftyp`, `jp2h` with
  `ihdr`, `colr`, `pclr` and `res ` boxes), and decides the mode (L, LA,
  RGB, RGBA, I;16 for one component deeper than 8 bits, CMYK where `colr`
  names it, P or PA through `pclr`);
- OpenJPEG reads the JP2 boxes and the codestream's main and tile-part
  headers (SIZ, CAP, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, TLM, PLM,
  PLT, CRG, COM, CPF, MCT, MCC, MCO, CBD, SOT, SOD, EOC; here, in Python)
  and decodes each tile in the native library (csrc/jpeg2000.cpp,
  gatling_j2k_decode_tile: the packet headers, the MQ decoder's three
  coding passes or the HT block decoder, dequantisation, the
  inverse 5/3 or 9/7 wavelet, the inverse RCT or ICT, the DC level shift).
  Damage that OpenJPEG tolerates decodes as it decodes it; where it gives
  up (its strict mode, Pillow's default), Pillow's "broken data stream" is
  ValueError here;
- Pillow's unpackers (Jpeg2KDecode.c j2ku_*) place each tile's samples:
  the shift of each component's precision to 8 (or, for I;16, 16) bits,
  signed components offset by half their range, subsampled components
  read as Pillow reads them, sYCC converted by Pillow's own tables.

Pillow decodes a JP2 file tile by tile, so OpenJPEG applies neither the
palette (`pclr`, `cmap`) nor the channel definitions (`cdef`): a `pclr`
file is its indices with the palette Pillow read from the box, converted
to RGBA by the JAX package (a PA image stays index and alpha).

High-throughput code-blocks (HTJ2K, JPEG 2000 Part 15: COD's HT style
bit) decode in the native library as OpenJPEG's ht_dec.c decodes them,
its tier 2 giving the cleanup pass a segment of its own. Of the Part 2
and Part 15 markers, OpenJPEG reads CAP and CPF and ignores them; MCT,
MCC and MCO as its readers do (an MCO takes every component's DC level
shift away, and an MCC's offset array gives each its own; COD cannot
name the decorrelation matrix, so it is never applied), and CBD sets each
component's precision and signedness. A COD or QCD
after a COC or QCC in one header overrides it for every component, as in
OpenJPEG; a tile-part of Psot 12 holds no data; a repeated tile-part 0 of
0 counts as one more tile-part (opj_j2k_need_nb_tile_parts_correction).

NumPy twins of the native transforms: `idwt53_ref`, `idwt97_ref` (float32,
step for step) and `mct_ref`; `idwt` and `mct` call the native ones.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gatling_tpu_torch import native
from gatling_tpu_torch.imgio.modes import (Reader, Skip, bomb_check, cmyk_to_rgba, p_to_rgba,
                                           to_rgba)

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
J2K_START = b"\xff\x4f\xff\x51"

# the parameter block of gatling_j2k_decode_tile (csrc/jpeg2000.cpp)
(H_TX0, H_TY0, H_TX1, H_TY1, H_IX0, H_IY0, H_IX1, H_IY1, H_NCOMP, H_NLAYERS, H_PRG, H_MCT,
 H_CSTY, H_NPOC, H_EXTHDR) = range(15)
H_POC, H_POC_SIZE, H_MAXPOC = 16, 6, 32
H_COMP = H_POC + H_POC_SIZE * H_MAXPOC
(C_DX, C_DY, C_PREC, C_SGND, C_NUMRES, C_CBLKW, C_CBLKH, C_CBLKSTY, C_QMFBID, C_QNTSTY,
 C_NUMGBITS, C_ROISHIFT, C_DCSHIFT) = range(13)
C_PRCW = 13
C_PRCH = C_PRCW + 33
C_EXPN = C_PRCH + 33
C_MANT = C_EXPN + 97
C_SIZE = C_MANT + 97
MAXRLVLS, MAXBANDS, MAX_POCS = 33, 97, 32

# opj_j2k_t decoder states
MHSOC, MHSIZ, MH, TPHSOT, TPH, NEOC, DATA, EOC = 1, 2, 4, 8, 16, 64, 128, 256
SOT, SOD, EOC_MARKER = 0xFF90, 0xFF93, 0xFFD9
# OPJ_COLOR_SPACE
CS_UNKNOWN, CS_UNSPECIFIED, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK = -1, 0, 1, 2, 3, 4, 5


class _Broken(Exception):
    """OpenJPEG failed: Pillow's "broken data stream"."""


# ---------------------------------------------------------------------------
# Pillow's open (Jpeg2KImagePlugin.py)
# ---------------------------------------------------------------------------

class _BoxReader:
    """Jpeg2KImagePlugin.BoxReader: SyntaxError is Skip, OSError ValueError."""

    def __init__(self, fp: Reader, length: int = -1) -> None:
        self.fp, self.has_length, self.length, self.remaining = fp, length >= 0, length, -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.pos + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise Skip("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise ValueError(f"JPEG 2000: expected to read {n} bytes but only got {len(data)}")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def read_fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining
        return _BoxReader(Reader(self._read_bytes(size)), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.pos + self.remaining < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.read_fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.read_fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise Skip("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _pil_palette(npc: int, entries: list) -> bytes:
    """The bytes of the ImagePalette that _parse_jp2_header builds with
    getcolor, one entry at a time (repeated colours share an index)."""
    mode = "RGBA" if npc == 4 else "RGB"
    width = len(mode)
    palette = bytearray()
    colors: dict = {}
    for color in entries:
        color = tuple(color)
        if mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            color = color[:3]
        elif mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        index = len(palette) // width
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colors[color] = index
        if index * width < len(palette):
            palette = palette[:index * width] + bytes(color) + palette[index * width + width:]
        else:
            palette += bytes(color)
    return mode, bytes(palette)


def _parse_jp2_header(fp: Reader) -> tuple:
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    size = mode = bpc = nc = palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            depths = header.read_fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                entries = [header.read_fields(">" + "B" * npc) for _ in range(ne)]
                palette = _pil_palette(npc, entries)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise Skip("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp: Reader) -> None:
    """Jpeg2KImageFile._parse_comment: only its failures matter here."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        if len(marker) < 2:
            raise Skip("JPEG 2000: short marker")
        if marker[1] in (0x90, 0xD9):
            break
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise Skip("JPEG 2000: short marker segment")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            fp.read(length - 2)
            break
        fp.pos = max(fp.pos + length - 2, 0)


def pillow_open(data: bytes) -> tuple:
    """Jpeg2KImageFile._open: (codec, size, mode, palette), Skip where
    Image.open goes on to the next plugin, ValueError where it fails."""
    fp = Reader(data)
    sig = fp.read(4)
    palette = None
    if sig == J2K_START:
        codec = "j2k"
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise Skip("JPEG 2000: short SIZ")
        lsiz = struct.unpack(">H", hdr)[0]
        siz = hdr + fp.read(lsiz - 2)
        if len(siz) < 38:
            raise Skip("JPEG 2000: short SIZ")
        xsiz, ysiz, xo, yo = struct.unpack_from(">IIII", siz, 4)
        csiz = struct.unpack_from(">H", siz, 36)[0]
        if csiz == 1:
            if len(siz) < 39:
                raise Skip("JPEG 2000: short SIZ")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise Skip("unable to determine J2K image mode")
        size = (xsiz - xo, ysiz - yo)
        _parse_comment(fp)
    else:
        sig += fp.read(8)
        if sig != JP2_SIGNATURE:
            raise Skip("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            hdr = fp.read(2)
            if len(hdr) < 2:
                raise Skip("JPEG 2000: short SIZ")
            fp.pos = max(fp.pos + struct.unpack(">H", hdr)[0] - 2, 0)
            _parse_comment(fp)
    if size[0] <= 0 or size[1] <= 0:
        raise Skip("not identified by this plugin")
    return codec, size, mode, palette


# ---------------------------------------------------------------------------
# OpenJPEG: the JP2 boxes (jp2.c opj_jp2_read_header_procedure)
# ---------------------------------------------------------------------------

_JP2_TOP = (b"jP  ", b"ftyp", b"jp2h")
_JP2_IMG = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


class _Jp2:
    def __init__(self) -> None:
        self.state = 0  # 1 signature, 2 file type, 4 header, 8 codestream
        self.ihdr = None
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None  # the channel count of the palette
        self.cmap = False
        self.cdef = False


def _box_header(data: bytes, pos: int, limit: int) -> tuple:
    """opj_jp2_read_boxhdr_char over data[pos:limit]: (length, type, hlen)."""
    if limit - pos < 8:
        raise _Broken("Cannot handle box of less than 8 bytes")
    length, tbox = struct.unpack_from(">I4s", data, pos)
    hlen = 8
    if length == 1:
        if limit - pos < 16:
            raise _Broken("Cannot handle XL box of less than 16 bytes")
        hi, lo = struct.unpack_from(">II", data, pos + 8)
        if hi:
            raise _Broken("Cannot handle box sizes higher than 2^32")
        length, hlen = lo, 16
        if length == 0:
            raise _Broken("Cannot handle box of undefined sizes")
    elif length == 0:
        raise _Broken("Cannot handle box of undefined sizes")
    if length < hlen:
        raise _Broken("Box length is inconsistent")
    return length, tbox, hlen


def _jp2_handler(jp2: _Jp2, tbox: bytes, p: bytes) -> None:
    if tbox == b"jP  ":
        if jp2.state != 0 or len(p) != 4 or p != b"\r\n\x87\n":
            raise _Broken("bad JP signature box")
        jp2.state |= 1
    elif tbox == b"ftyp":
        if jp2.state != 1 or len(p) < 8 or (len(p) - 8) % 4:
            raise _Broken("bad ftyp box")
        jp2.state |= 2
    elif tbox == b"jp2h":
        if jp2.state & 2 != 2:
            raise _Broken("the jp2h box is misplaced")
        pos, has_ihdr = 0, False
        while pos < len(p):
            length, sub, hlen = _box_header(p, pos, len(p))
            if length > len(p) - pos:
                raise _Broken("box length is inconsistent")
            if sub in _JP2_IMG:
                _jp2_handler(jp2, sub, p[pos + hlen:pos + length])
            has_ihdr |= sub == b"ihdr"
            pos += length
        if not has_ihdr:
            raise _Broken("no ihdr box")
        jp2.state |= 4
    elif tbox == b"ihdr":
        if jp2.ihdr is not None:
            return
        if len(p) != 14:
            raise _Broken("Bad image header box")
        h, w, nc = struct.unpack_from(">IIH", p)
        if not 1 <= nc <= 16384:
            raise _Broken("Invalid number of components (ihdr)")
        jp2.ihdr = (w, h, nc)
    elif tbox == b"colr":
        if len(p) < 3:
            raise _Broken("Bad COLR header box")
        if jp2.has_colr:
            return
        meth = p[0]
        if meth == 1:
            if len(p) < 7:
                raise _Broken("Bad COLR header box")
            jp2.enumcs = struct.unpack_from(">I", p, 3)[0]
            jp2.has_colr = True
        elif meth == 2:
            jp2.has_colr = True
    elif tbox == b"bpcc":  # per-component depths: SIZ's decide
        if jp2.ihdr is None or len(p) != jp2.ihdr[2]:
            raise _Broken("Bad BPCC header box")
    elif tbox == b"pclr":
        if jp2.pclr is not None or len(p) < 3:
            raise _Broken("bad pclr box")
        ne, npc = struct.unpack_from(">HB", p)
        if not 1 <= ne <= 1024 or npc == 0 or len(p) < 3 + npc:
            raise _Broken("Invalid PCLR box")
        sizes = [min(((b & 0x7F) + 1 + 7) >> 3, 4) for b in p[3:3 + npc]]
        if 3 + npc + ne * sum(sizes) > len(p):
            raise _Broken("Invalid PCLR box")
        jp2.pclr = npc
    elif tbox == b"cmap":
        if jp2.pclr is None or jp2.cmap or len(p) < jp2.pclr * 4:
            raise _Broken("bad cmap box")
        jp2.cmap = True
    elif tbox == b"cdef":
        if jp2.cdef or len(p) < 2:
            raise _Broken("bad cdef box")
        n = struct.unpack_from(">H", p)[0]
        if n == 0 or len(p) < 2 + 6 * n:
            raise _Broken("bad cdef box")
        jp2.cdef = True


def _jp2_boxes(data: bytes) -> tuple:
    """The offset of the codestream and the header's facts."""
    jp2, pos = _Jp2(), 0
    while True:
        if len(data) - pos < 8:
            break  # opj_jp2_read_boxhdr fails: the box loop ends
        length, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if length == 0:
            length = len(data) - pos  # the last box
        elif length == 1:
            if len(data) - pos < 16:
                break
            hi, lo = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise _Broken("Cannot handle box sizes higher than 2^32")
            length, hlen = lo, 16
        body = pos + hlen
        if tbox == b"jp2c":
            if jp2.state & 4:
                jp2.state |= 8
                return body, jp2
            raise _Broken("bad placed jpeg codestream")
        if length == 0:
            raise _Broken("Cannot handle box of undefined sizes")
        if length < hlen:
            raise _Broken("invalid box size")
        size = length - hlen
        if tbox in _JP2_TOP or tbox in _JP2_IMG:
            if tbox in _JP2_IMG and not jp2.state & 4:
                if body + size > len(data):
                    raise _Broken("Problem with skipping JPEG2000 box, stream error")
                pos = body + size
                continue
            if size > len(data) - body:
                raise _Broken("Invalid box size")
            _jp2_handler(jp2, tbox, data[body:body + size])
        else:
            if not jp2.state & 1 or not jp2.state & 2:
                raise _Broken("Malformed JP2 file format")
            if body + size > len(data):
                raise _Broken("Problem with skipping JPEG2000 box, stream error")
        pos = body + size
    if not jp2.state & 4:
        raise _Broken("JP2H box missing")
    if jp2.ihdr is None:
        raise _Broken("IHDR box missing")
    # no jp2c: opj_j2k_read_header meets the end of the stream
    raise _Broken("no codestream")


# ---------------------------------------------------------------------------
# OpenJPEG: the codestream (j2k.c)
# ---------------------------------------------------------------------------

class _Tccp:
    def __init__(self) -> None:
        self.csty = self.numresolutions = self.cblkw = self.cblkh = self.cblksty = 0
        self.qmfbid = self.qntsty = self.numgbits = self.roishift = self.dc_level_shift = 0
        self.prcw = [0] * MAXRLVLS
        self.prch = [0] * MAXRLVLS
        self.expn = [0] * MAXBANDS
        self.mant = [0] * MAXBANDS

    def copy(self) -> "_Tccp":
        c = _Tccp()
        c.__dict__.update({k: (v[:] if isinstance(v, list) else v)
                           for k, v in self.__dict__.items()})
        return c


class _Tcp:
    def __init__(self, ncomp: int) -> None:
        self.csty = self.prg = self.numlayers = self.mct = 0
        self.poc = False
        self.pocs: list = []
        self.tccps = [_Tccp() for _ in range(ncomp)]
        self.mct_records: list = []  # MCT: {index, element, data}
        self.mcc_records: list = []  # MCC: {index, nb_comps, deco, offset} (MCT records)
        self.ppt = False
        self.ppt_markers: dict = {}
        self.ppt_data = None
        self.data = None
        self.current_part = -1
        self.nb_parts = 0

    def copy(self) -> "_Tcp":
        t = _Tcp(0)
        t.csty, t.prg, t.numlayers, t.mct = self.csty, self.prg, self.numlayers, self.mct
        t.poc, t.pocs = self.poc, [list(p) for p in self.pocs]
        t.tccps = [c.copy() for c in self.tccps]
        # opj_j2k_copy_default_tcp_and_create_tcd: the records, each MCC
        # pointing into the copy's own MCT records
        t.mct_records = [dict(r) for r in self.mct_records]
        moved = {id(a): b for a, b in zip(self.mct_records, t.mct_records)}
        t.mcc_records = [{k: moved.get(id(v), v) if isinstance(v, dict) else v
                          for k, v in r.items()} for r in self.mcc_records]
        return t


class _Comp:
    def __init__(self, prec: int, sgnd: int, dx: int, dy: int) -> None:
        self.prec, self.sgnd, self.dx, self.dy = prec, sgnd, dx, dy
        self.resno_decoded = 0


class _Codestream:
    """opj_j2k_t: the stream position, the state and what the headers set."""

    def __init__(self, data: bytes, pos: int, ihdr) -> None:
        self.d, self.pos, self.ihdr = data, pos, ihdr
        self.state = MHSOC
        self.default = None
        self.tcps: list = []
        self.comps: list = []
        self.ppm = False
        self.ppm_markers: dict = {}
        self.ppm_data = b""
        self.ppm_pos = 0
        self.current_tile = 0
        self.sot_length = 0
        self.last_tile_part = False
        self.can_decode = False
        self.correction = 0
        self.correction_checked = False

    # -- the stream
    def left(self) -> int:
        return len(self.d) - self.pos

    def read(self, n: int) -> bytes:
        if n > self.left():
            raise _Broken("Stream too short")
        b = self.d[self.pos:self.pos + n]
        self.pos += n
        return b

    def read16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def tcp(self) -> _Tcp:
        return self.tcps[self.current_tile] if self.state == TPH else self.default

    def ncomp(self) -> int:
        return len(self.comps)

    def comp_room(self) -> int:
        return 1 if self.ncomp() <= 256 else 2

    # -- the main header (opj_j2k_read_header_procedure)
    def main_header(self) -> None:
        if self.read(2) != b"\xff\x4f":
            raise _Broken("Expected a SOC marker")
        self.state = MHSIZ
        marker = self.read16()
        seen = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise _Broken("A marker ID was expected")
            if marker not in _HANDLERS:
                marker = self._read_unknown()
                if marker == SOT:
                    break
            states, handler = _HANDLERS[marker]
            seen.add(marker)
            if not self.state & states:
                raise _Broken("Marker is not compliant with its position")
            size = self.read16()
            if size < 2:
                raise _Broken("Invalid marker size")
            handler(self, self.read(size - 2))
            marker = self.read16()
        for m, name in ((0xFF51, "SIZ"), (0xFF52, "COD"), (0xFF5C, "QCD")):
            if m not in seen:
                raise _Broken(f"required {name} marker not found in main header")
        self._merge_ppm()
        self.tcps = [self.default.copy() for _ in range(self.tw * self.th)]
        self.state = TPHSOT

    def _read_unknown(self) -> int:
        """opj_j2k_read_unk: two bytes at a time to a known marker."""
        while True:
            m = self.read16()
            if m < 0xFF00:
                continue
            states = _HANDLERS[m][0] if m in _HANDLERS else MH | TPH
            if not self.state & states:
                raise _Broken("Marker is not compliant with its position")
            if m in _HANDLERS:
                return m

    def _merge_ppm(self) -> None:
        if not self.ppm:
            return
        out, remaining = bytearray(), 0
        for z in sorted(self.ppm_markers):
            chunk = self.ppm_markers[z]
            if remaining >= len(chunk):
                remaining -= len(chunk)
                out += chunk
                continue
            out += chunk[:remaining]
            chunk = chunk[remaining:]
            remaining = 0
            while chunk:
                if len(chunk) < 4:
                    raise _Broken("Not enough bytes to read Nppm")
                n = struct.unpack_from(">I", chunk)[0]
                chunk = chunk[4:]
                if len(chunk) >= n:
                    out += chunk[:n]
                    chunk = chunk[n:]
                else:
                    out += chunk
                    remaining = n - len(chunk)
                    chunk = b""
        if remaining:
            raise _Broken("Corrupted PPM markers")
        self.ppm_data = bytes(out)

    # -- the tile-parts (opj_j2k_read_tile_header, opj_j2k_read_sod)
    def read_tile_header(self):
        """The index of the next tile to decode, or None at the end."""
        marker = SOT
        if self.state == EOC:
            marker = EOC_MARKER
        elif self.state != TPHSOT:
            raise _Broken("no tile-part follows")
        nb_tiles = self.tw * self.th
        while not self.can_decode and marker != EOC_MARKER:
            while marker != SOD:
                if self.left() == 0:
                    self.state = NEOC
                    break
                size = self.read16()
                if size < 2:
                    raise _Broken("Inconsistent marker size")
                if marker == 0x8080 and self.left() == 0:
                    self.state = NEOC
                    break
                if self.state & TPH and self.sot_length != 0:
                    if self.sot_length < size + 2:
                        raise _Broken("Sot length is less than marker size + marker ID")
                    self.sot_length -= size + 2
                states, handler = _HANDLERS.get(marker, (MH | TPH, None))
                if not self.state & states:
                    raise _Broken("Marker is not compliant with its position")
                payload = self.read(size - 2)
                if handler is None:
                    raise _Broken("unknown marker in a tile-part header")
                handler(self, payload)
                marker = self.read16()
            if self.left() == 0 and self.state == NEOC:
                break
            self._read_sod()
            if self.can_decode and not self.correction_checked:
                self.correction_checked = True
                if self._correction_needed(self.current_tile):
                    self.can_decode = False
                    self.correction = 1
                    for t in self.tcps:
                        if t.nb_parts:
                            t.nb_parts += 1
            if not self.can_decode:
                if self.left() < 2:
                    if self.current_tile + 1 == nb_tiles:
                        lone = [i for i, t in enumerate(self.tcps)
                                if t.current_part == 0 and t.nb_parts == 0]
                        if lone:
                            self.current_tile = lone[0]
                            marker = EOC_MARKER
                            self.state = EOC
                            break
                    raise _Broken("Stream too short")
                marker = self.read16()
        if marker == EOC_MARKER and self.state != EOC:
            self.current_tile = 0
            self.state = EOC
        if not self.can_decode:
            while self.current_tile < nb_tiles and self.tcps[self.current_tile].data is None:
                self.current_tile += 1
            if self.current_tile == nb_tiles:
                return None
        tcp = self.tcps[self.current_tile]
        if tcp.ppt:
            if tcp.ppt_data is not None:
                raise _Broken("opj_j2k_merge_ppt() has already been called")
            tcp.ppt_data = b"".join(tcp.ppt_markers[z] for z in sorted(tcp.ppt_markers))
        self.state |= DATA
        return self.current_tile

    def _read_sod(self) -> None:
        tcp = self.tcps[self.current_tile]
        if self.last_tile_part:
            self.sot_length = (self.left() - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        # else Psot 12, an SOT with no data: OpenJPEG reads none
        if self.sot_length:
            if self.sot_length > self.left():
                raise _Broken("Tile part length size inconsistent with stream length")
            chunk = self.read(self.sot_length)
            tcp.data = (tcp.data or b"") + chunk
        self.state = TPHSOT

    def _correction_needed(self, tile: int) -> bool:
        """opj_j2k_need_nb_tile_parts_correction: look ahead for the tile's
        next tile-part, the stream position restored."""
        backup = self.pos
        try:
            while True:
                if self.left() < 2:
                    return False
                if self.read16() != SOT:
                    return False
                if self.read16() != 10:
                    raise _Broken("Inconsistent marker size")
                isot, psot, tpsot, tnsot = struct.unpack(">HIBB", self.read(8))
                if isot == tile:
                    return tpsot == tnsot
                if psot < 14:
                    return False
                if psot - 12 > self.left():
                    return False
                self.pos += psot - 12
        finally:
            self.pos = backup

    def after_tile(self) -> None:
        """The end of opj_j2k_decode_tile: the marker after the tile."""
        self.can_decode = False
        self.state &= ~DATA
        if self.left() == 0 and self.state == NEOC:
            return
        if self.state != EOC:
            m = self.read16()
            if m == EOC_MARKER:
                self.current_tile = 0
                self.state = EOC
            elif m != SOT:
                if self.left() == 0:
                    self.state = NEOC
                    return
                raise _Broken("Stream too short, expected SOT")


# -- the marker segments' handlers (opj_j2k_read_*)

def _siz(cs: _Codestream, p: bytes) -> None:
    if len(p) < 36 or (len(p) - 36) % 3:
        raise _Broken("Error with SIZ marker size")
    # Rsiz does not decide the decoding (nor does its HT bit): a
    # high-throughput block is known by COD's code-block style
    x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc = struct.unpack_from(">IIIIIIIIH", p, 2)
    if nc >= 16385 or nc != (len(p) - 36) // 3:
        raise _Broken("Error with SIZ marker: number of components")
    if x0 >= x1 or y0 >= y1:
        raise _Broken("Error with SIZ marker: negative or zero image size")
    if tdx == 0 or tdy == 0:
        raise _Broken("Error with SIZ marker: invalid tile size")
    tx1, ty1 = min(tx0 + tdx, 0xFFFFFFFF), min(ty0 + tdy, 0xFFFFFFFF)
    if tx0 > x0 or ty0 > y0 or tx1 <= x0 or ty1 <= y0:
        raise _Broken("Error with SIZ marker: illegal tile offset")
    if cs.ihdr and cs.ihdr[0] > 0 and cs.ihdr[1] > 0 and (cs.ihdr[0], cs.ihdr[1]) != (x1 - x0,
                                                                                 y1 - y0):
        raise _Broken("Error with SIZ marker: IHDR w h vs. SIZ w h")
    comps = []
    for i in range(nc):
        s, dx, dy = p[36 + 3 * i:39 + 3 * i]
        prec, sgnd = (s & 0x7F) + 1, s >> 7
        if not 1 <= dx <= 255 or not 1 <= dy <= 255:
            raise _Broken("Invalid values for comp: dx dy")
        if prec > 31:
            raise _Broken("Invalid values for comp: prec")
        comps.append(_Comp(prec, sgnd, dx, dy))
    tw, th = -(-(x1 - tx0) // tdx), -(-(y1 - ty0) // tdy)
    if tw == 0 or th == 0 or tw > 65535 // th:
        raise _Broken("Invalid number of tiles")
    cs.image = (x0, y0, x1, y1)
    cs.tiling = (tx0, ty0, tdx, tdy)
    cs.tw, cs.th, cs.comps = tw, th, comps
    cs.default = _Tcp(nc)
    for c, tccp in zip(comps, cs.default.tccps):
        if not c.sgnd:
            tccp.dc_level_shift = 1 << (c.prec - 1)
    cs.state = MH


def _spcod(cs: _Codestream, tccp: _Tccp, p: bytes) -> int:
    """opj_j2k_read_SPCod_SPCoc: the bytes it read."""
    if len(p) < 5:
        raise _Broken("Error reading SPCod SPCoc element")
    tccp.numresolutions = p[0] + 1
    if tccp.numresolutions > MAXRLVLS:
        raise _Broken("Invalid value for numresolutions")
    tccp.cblkw, tccp.cblkh = p[1] + 2, p[2] + 2
    if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
        raise _Broken("Invalid cblkw/cblkh combination")
    tccp.cblksty = p[3]
    if tccp.cblksty & 0x80:
        raise _Broken("Unsupported Mixed HT code-block style")
    tccp.qmfbid = p[4]
    if tccp.qmfbid > 1:
        raise _Broken("Invalid transformation found")
    used = 5
    if tccp.csty & 1:
        if len(p) - 5 < tccp.numresolutions:
            raise _Broken("Error reading SPCod SPCoc element")
        for i in range(tccp.numresolutions):
            v = p[5 + i]
            if i != 0 and ((v & 15) == 0 or (v >> 4) == 0):
                raise _Broken("Invalid precinct size")
            tccp.prcw[i], tccp.prch[i] = v & 15, v >> 4
        used += tccp.numresolutions
    else:
        for i in range(tccp.numresolutions):
            tccp.prcw[i] = tccp.prch[i] = 15
    return used


def _cod(cs: _Codestream, p: bytes) -> None:
    tcp = cs.tcp()
    if len(p) < 5:
        raise _Broken("Error reading COD marker")
    tcp.csty = p[0]
    if tcp.csty & ~7:
        raise _Broken("Unknown Scod value in COD marker")
    tcp.prg = p[1] if p[1] <= 4 else -1
    tcp.numlayers = struct.unpack_from(">H", p, 2)[0]
    if tcp.numlayers < 1:
        raise _Broken("Invalid number of layers in COD marker")
    tcp.mct = p[4]
    if tcp.mct > 1:
        raise _Broken("Invalid multiple component transformation")
    for tccp in tcp.tccps:
        tccp.csty = tcp.csty & 1
    used = _spcod(cs, tcp.tccps[0], p[5:])
    if used != len(p) - 5:
        raise _Broken("Error reading COD marker")
    ref = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        tccp.numresolutions, tccp.cblkw, tccp.cblkh = ref.numresolutions, ref.cblkw, ref.cblkh
        tccp.cblksty, tccp.qmfbid = ref.cblksty, ref.qmfbid
        tccp.prcw[:], tccp.prch[:] = ref.prcw, ref.prch


def _coc(cs: _Codestream, p: bytes) -> None:
    tcp, room = cs.tcp(), cs.comp_room()
    if len(p) < room + 1:
        raise _Broken("Error reading COC marker")
    compno = int.from_bytes(p[:room], "big")
    if compno >= cs.ncomp():
        raise _Broken("Error reading COC marker (bad number of components)")
    tccp = tcp.tccps[compno]
    tccp.csty = p[room]
    if _spcod(cs, tccp, p[room + 1:]) != len(p) - room - 1:
        raise _Broken("Error reading COC marker")


def _sqcd(cs: _Codestream, tccp: _Tccp, p: bytes) -> None:
    if len(p) < 1:
        raise _Broken("Error reading SQcd or SQcc element")
    tccp.qntsty, tccp.numgbits = p[0] & 0x1F, p[0] >> 5
    rest = p[1:]
    if tccp.qntsty == 1:
        nband = 1
    else:
        nband = len(rest) if tccp.qntsty == 0 else len(rest) // 2
    if tccp.qntsty == 0:
        for b in range(nband):
            if b < MAXBANDS:
                tccp.expn[b], tccp.mant[b] = rest[b] >> 3, 0
    else:
        if len(rest) < 2 * nband:
            raise _Broken("Error reading SQcd or SQcc element")
        for b in range(nband):
            v = struct.unpack_from(">H", rest, 2 * b)[0]
            if b < MAXBANDS:
                tccp.expn[b], tccp.mant[b] = v >> 11, v & 0x7FF
    if tccp.qntsty == 1:
        for b in range(1, MAXBANDS):
            tccp.expn[b] = max(tccp.expn[0] - (b - 1) // 3, 0)
            tccp.mant[b] = tccp.mant[0]
    used = 1 + (nband if tccp.qntsty == 0 else 2 * nband)
    if used != len(p):
        raise _Broken("Error reading QCD or QCC marker")


def _qcd(cs: _Codestream, p: bytes) -> None:
    tcp = cs.tcp()
    _sqcd(cs, tcp.tccps[0], p)
    ref = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        tccp.qntsty, tccp.numgbits = ref.qntsty, ref.numgbits
        tccp.expn[:], tccp.mant[:] = ref.expn, ref.mant


def _qcc(cs: _Codestream, p: bytes) -> None:
    tcp, room = cs.tcp(), cs.comp_room()
    if len(p) < room:
        raise _Broken("Error reading QCC marker")
    compno = int.from_bytes(p[:room], "big")
    if compno >= cs.ncomp():
        raise _Broken("Invalid component number")
    _sqcd(cs, tcp.tccps[compno], p[room:])


def _rgn(cs: _Codestream, p: bytes) -> None:
    room = cs.comp_room()
    if len(p) != 2 + room:
        raise _Broken("Error reading RGN marker")
    compno = int.from_bytes(p[:room], "big")
    if compno >= cs.ncomp():
        raise _Broken("bad component number in RGN")
    cs.tcp().tccps[compno].roishift = p[room + 1]


def _poc(cs: _Codestream, p: bytes) -> None:
    room = cs.comp_room()
    chunk = 5 + 2 * room
    n, rem = divmod(len(p), chunk)
    if n <= 0 or rem:
        raise _Broken("Error reading POC marker")
    tcp = cs.tcp()
    old = len(tcp.pocs) if tcp.poc else 0
    if old + n >= MAX_POCS:
        raise _Broken("Too many POCs")
    tcp.poc = True
    del tcp.pocs[old:]
    for i in range(n):
        q = p[i * chunk:(i + 1) * chunk]
        resno0 = q[0]
        compno0 = int.from_bytes(q[1:1 + room], "big")
        layno1 = min(struct.unpack_from(">H", q, 1 + room)[0], tcp.numlayers)
        resno1 = q[3 + room]
        compno1 = min(int.from_bytes(q[4 + room:4 + 2 * room], "big"), cs.ncomp())
        tcp.pocs.append([resno0, compno0, layno1, resno1, compno1, q[4 + 2 * room]])


def _sot(cs: _Codestream, p: bytes) -> None:
    if len(p) != 8:
        raise _Broken("Error reading SOT marker")
    isot, psot, part, nparts = struct.unpack(">HIBB", p)
    cs.current_tile = isot
    if isot >= cs.tw * cs.th:
        raise _Broken("Invalid tile number")
    tcp = cs.tcps[isot]
    if tcp.current_part + 1 != part:
        raise _Broken("Invalid tile part index")
    tcp.current_part = part
    if psot != 0 and psot < 14:
        if psot != 12:
            raise _Broken("Psot value is not correct")
    if not psot:
        cs.last_tile_part = True
    if tcp.nb_parts and part >= tcp.nb_parts:
        cs.last_tile_part = True
        raise _Broken("TPsot is not valid")
    if nparts:
        nparts += cs.correction
        if part >= nparts:
            cs.last_tile_part = True
            raise _Broken("TPsot is not valid")
        tcp.nb_parts = nparts
    if tcp.nb_parts and tcp.nb_parts == part + 1:
        cs.can_decode = True
    cs.sot_length = (psot - 12) & 0xFFFFFFFF if not cs.last_tile_part else 0
    cs.state = TPH


def _tlm(cs: _Codestream, p: bytes) -> None:
    if len(p) < 2:
        raise _Broken("Error reading TLM marker")
    st = (p[1] >> 4) & 3
    if st == 3:
        raise _Broken("opj_j2k_read_tlm(): ST = 3 is invalid")
    q = ((p[1] >> 6) & 1) * 2 + 2 + st
    if (len(p) - 2) % q:
        raise _Broken("Error reading TLM marker")


def _plm(cs: _Codestream, p: bytes) -> None:
    if len(p) < 1:
        raise _Broken("Error reading PLM marker")


def _plt(cs: _Codestream, p: bytes) -> None:
    if len(p) < 1:
        raise _Broken("Error reading PLT marker")
    length = 0
    for b in p[1:]:
        length |= b & 0x7F
        length = length << 7 if b & 0x80 else 0
    if length:
        raise _Broken("Error reading PLT marker")


def _ppm(cs: _Codestream, p: bytes) -> None:
    if len(p) < 2:
        raise _Broken("Error reading PPM marker")
    cs.ppm = True
    if p[0] in cs.ppm_markers:
        raise _Broken("Zppm already read")
    cs.ppm_markers[p[0]] = p[1:]


def _ppt(cs: _Codestream, p: bytes) -> None:
    if len(p) < 2:
        raise _Broken("Error reading PPT marker")
    if cs.ppm:
        raise _Broken("Error reading PPT marker: PPM in the main header")
    tcp = cs.tcps[cs.current_tile]
    tcp.ppt = True
    if p[0] in tcp.ppt_markers:
        raise _Broken("Zppt already read")
    tcp.ppt_markers[p[0]] = p[1:]


def _crg(cs: _Codestream, p: bytes) -> None:
    if len(p) != cs.ncomp() * 4:
        raise _Broken("Error reading CRG marker")


def _com(cs: _Codestream, p: bytes) -> None:
    pass


def _cap(cs: _Codestream, p: bytes) -> None:
    """opj_j2k_read_cap: Part 15's capabilities, read and ignored."""


def _cpf(cs: _Codestream, p: bytes) -> None:
    """opj_j2k_read_cpf: Part 15's corresponding profile, read and ignored."""


# MCT_ELEMENT_SIZE: int16, int32, float32, float64
_MCT_ELEMENT = ((2, ">H"), (4, ">i"), (4, ">f"), (8, ">d"))


def _mct(cs: _Codestream, p: bytes) -> None:
    """opj_j2k_read_mct: one array record, kept by its index (a record read
    again under its index is replaced in place)."""
    tcp = cs.tcp()
    if len(p) < 2:
        raise _Broken("Error reading MCT marker")
    if struct.unpack_from(">H", p)[0] != 0:  # Zmct: "Cannot take in charge mct data
        return                               # within multiple MCT records"
    if len(p) <= 6:
        raise _Broken("Error reading MCT marker")
    imct, ymct = struct.unpack_from(">HH", p, 2)
    rec = next((r for r in tcp.mct_records if r["index"] == imct & 0xFF), None)
    if rec is None:
        rec = {}
        tcp.mct_records.append(rec)
    rec.update(index=imct & 0xFF, element=(imct >> 10) & 3, data=b"")
    if ymct != 0:  # "Cannot take in charge multiple MCT markers": the record stays empty
        return
    rec["data"] = p[6:]


def _mcc(cs: _Codestream, p: bytes) -> None:
    """opj_j2k_read_mcc: one array-based decorrelation collection naming its
    decorrelation and offset records; what OpenJPEG cannot take is a
    warning, and the record counts only when read whole."""
    tcp = cs.tcp()
    if len(p) < 2:
        raise _Broken("Error reading MCC marker")
    if struct.unpack_from(">H", p)[0] != 0:  # "Cannot take in charge multiple data spanning"
        return
    if len(p) < 7:
        raise _Broken("Error reading MCC marker")
    index = p[2]
    known = next((r for r in tcp.mcc_records if r["index"] == index), None)
    rec = known if known is not None else {}
    rec["index"] = index
    ymcc, qmcc = struct.unpack_from(">HH", p, 3)
    if ymcc != 0 or qmcc > 1:  # multiple data spanning, multiple collections
        return
    at, left = 7, len(p) - 7
    for _ in range(qmcc):
        if left < 3:
            raise _Broken("Error reading MCC marker")
        if p[at] != 1:  # "collections other than array decorrelation"
            return
        nmcc = struct.unpack_from(">H", p, at + 1)[0]
        at, left = at + 3, left - 3
        room, rec["nb_comps"] = 1 + (nmcc >> 15), nmcc & 0x7FFF
        if left < room * rec["nb_comps"] + 2:
            raise _Broken("Error reading MCC marker")
        left -= room * rec["nb_comps"] + 2
        for j in range(rec["nb_comps"]):
            if int.from_bytes(p[at:at + room], "big") != j:  # "indix shuffle"
                return
            at += room
        mmcc = struct.unpack_from(">H", p, at)[0]
        at += 2
        room = 1 + (mmcc >> 15)
        if mmcc & 0x7FFF != rec["nb_comps"]:  # "without same number of indixes"
            return
        if left < room * rec["nb_comps"] + 3:
            raise _Broken("Error reading MCC marker")
        left -= room * rec["nb_comps"] + 3
        for j in range(rec["nb_comps"]):
            if int.from_bytes(p[at:at + room], "big") != j:
                return
            at += room
        tmcc = int.from_bytes(p[at:at + 3], "big")
        at += 3
        rec["deco"] = rec["offset"] = None
        for key, idx in (("deco", tmcc & 0xFF), ("offset", (tmcc >> 8) & 0xFF)):
            if idx:
                rec[key] = next((r for r in tcp.mct_records if r["index"] == idx), None)
                if rec[key] is None:
                    raise _Broken("Error reading MCC marker")
    if left != 0:
        raise _Broken("Error reading MCC marker")
    if known is None:
        tcp.mcc_records.append(rec)


def _mco(cs: _Codestream, p: bytes) -> None:
    """opj_j2k_read_mco: the one transform stage. Every component loses its
    DC level shift; an MCC with an offset record gives each its offset. The
    decorrelation matrix is never applied: COD's transform byte cannot name
    it (above 1 is an error)."""
    tcp = cs.tcp()
    if len(p) < 1:
        raise _Broken("Error reading MCO marker")
    if p[0] > 1:  # "Cannot take in charge multiple transformation stages."
        return
    if len(p) != p[0] + 1:
        raise _Broken("Error reading MCO marker")
    for tccp in tcp.tccps:
        tccp.dc_level_shift = 0
    for stage in p[1:]:
        _add_mct(cs, tcp, stage)


def _add_mct(cs: _Codestream, tcp: _Tcp, index: int) -> None:
    """opj_j2k_add_mct. Its search compares the first MCC record's index
    each time round, so only the first record can be applied."""
    recs = tcp.mcc_records
    if not recs or recs[0]["index"] != index:
        return
    rec = recs[0]
    n = cs.ncomp()
    if rec.get("nb_comps") != n:
        return
    for key, count in (("deco", n * n), ("offset", n)):
        arr = rec.get(key)
        if arr is None:
            continue
        size, fmt = _MCT_ELEMENT[arr["element"]]
        if len(arr["data"]) != size * count:
            raise _Broken("MCT record size")
        if key == "offset":
            for i, tccp in enumerate(tcp.tccps):
                v = struct.unpack_from(fmt, arr["data"], size * i)[0]
                tccp.dc_level_shift = _to_int32(v)


def _to_int32(v) -> int:
    """OpenJPEG's cast of an offset to OPJ_INT32: a float truncates (x86's
    cvttsd2si: out of range, or NaN, is INT_MIN), an integer wraps."""
    if isinstance(v, float):
        if not -2147483649.0 < v < 2147483648.0:
            return -(1 << 31)
        return int(v)
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _cbd(cs: _Codestream, p: bytes) -> None:
    """opj_j2k_read_cbd: each component's precision and signedness anew (the
    image's, so Pillow's unpacker sees them too; the DC level shift stays
    SIZ's)."""
    n = cs.ncomp()
    if len(p) != n + 2 or struct.unpack_from(">H", p)[0] != n:
        raise _Broken("Error reading CBD marker")
    for comp, b in zip(cs.comps, p[2:]):
        comp.sgnd, comp.prec = b >> 7, (b & 0x7F) + 1
        if comp.prec > 31:
            raise _Broken("Invalid values for comp: prec")


_HANDLERS = {
    SOT: (MH | TPHSOT, _sot), 0xFF52: (MH | TPH, _cod), 0xFF53: (MH | TPH, _coc),
    0xFF5E: (MH | TPH, _rgn), 0xFF5C: (MH | TPH, _qcd), 0xFF5D: (MH | TPH, _qcc),
    0xFF5F: (MH | TPH, _poc), 0xFF51: (MHSIZ, _siz), 0xFF55: (MH, _tlm), 0xFF57: (MH, _plm),
    0xFF58: (TPH, _plt), 0xFF60: (MH, _ppm), 0xFF61: (TPH, _ppt), 0xFF91: (0, None),
    0xFF63: (MH, _crg), 0xFF64: (MH | TPH, _com), 0xFF74: (MH | TPH, _mct),
    0xFF78: (MH, _cbd), 0xFF50: (MH, _cap), 0xFF59: (MH, _cpf), 0xFF75: (MH | TPH, _mcc),
    0xFF77: (MH | TPH, _mco),
}


def _tile_bounds(cs: _Codestream, index: int) -> tuple:
    x0, y0, x1, y1 = cs.image
    tx0, ty0, tdx, tdy = cs.tiling
    p, q = index % cs.tw, index // cs.tw
    return (max(tx0 + p * tdx, x0), max(ty0 + q * tdy, y0),
            min(tx0 + (p + 1) * tdx, x1), min(ty0 + (q + 1) * tdy, y1))


def _decode_tile(cs: _Codestream, index: int) -> tuple:
    """opj_j2k_decode_tile then opj_tcd_update_tile_data: the tile's bounds
    and each component's samples at its decoded resolution."""
    tcp = cs.tcps[index]
    if not cs.state & DATA or tcp.data is None:
        raise _Broken("no tile data")
    bounds = _tile_bounds(cs, index)
    hdr = np.zeros(H_COMP + C_SIZE * cs.ncomp(), np.int32)
    hdr[[H_TX0, H_TY0, H_TX1, H_TY1]] = bounds
    hdr[[H_IX0, H_IY0, H_IX1, H_IY1]] = cs.image
    hdr[H_NCOMP], hdr[H_NLAYERS], hdr[H_PRG] = cs.ncomp(), tcp.numlayers, tcp.prg
    hdr[H_MCT], hdr[H_CSTY] = tcp.mct, tcp.csty
    if tcp.poc:
        hdr[H_NPOC] = len(tcp.pocs)
        for i, q in enumerate(tcp.pocs):
            hdr[H_POC + H_POC_SIZE * i:H_POC + H_POC_SIZE * (i + 1)] = q
    ext = b""
    if cs.ppm:
        hdr[H_EXTHDR], ext = 1, cs.ppm_data
    elif tcp.ppt:
        hdr[H_EXTHDR], ext = 1, tcp.ppt_data
    sizes = []
    for c, (comp, tccp) in enumerate(zip(cs.comps, tcp.tccps)):
        b = hdr[H_COMP + C_SIZE * c:H_COMP + C_SIZE * (c + 1)]
        b[:C_PRCW] = (comp.dx, comp.dy, comp.prec, comp.sgnd, tccp.numresolutions, tccp.cblkw,
                      tccp.cblkh, tccp.cblksty, tccp.qmfbid, tccp.qntsty, tccp.numgbits,
                      tccp.roishift, tccp.dc_level_shift)
        b[C_PRCW:C_PRCH] = tccp.prcw
        b[C_PRCH:C_EXPN] = tccp.prch
        b[C_EXPN:C_MANT] = tccp.expn
        b[C_MANT:C_SIZE] = tccp.mant
        w = -(-bounds[2] // comp.dx) - -(-bounds[0] // comp.dx)
        h = -(-bounds[3] // comp.dy) - -(-bounds[1] // comp.dy)
        sizes.append(w * h)
    src = np.frombuffer(tcp.data + b"\0\0", np.uint8).copy()
    extbuf = np.frombuffer(ext + b"\0", np.uint8).copy()
    ext_pos = np.array([cs.ppm_pos if cs.ppm else 0], np.int64)
    resno = np.array([c.resno_decoded for c in cs.comps], np.int32)
    outs = [np.zeros(max(n, 1), np.int32) for n in sizes]
    dims = np.zeros(2 * cs.ncomp(), np.int32)
    got = native.library().gatling_j2k_decode_tile(
        native.ptr(hdr, ctypes.c_int32), native.ptr(src, ctypes.c_uint8), len(tcp.data),
        native.ptr(extbuf, ctypes.c_uint8), len(ext), native.ptr(ext_pos, ctypes.c_int64),
        native.ptr(resno, ctypes.c_int32), native.pointers(outs), native.ptr(dims, ctypes.c_int32))
    if got < 0:
        raise _Broken("Failed to decode the tile")
    for c, r in zip(cs.comps, resno):
        c.resno_decoded = int(r)
    if cs.ppm:
        cs.ppm_pos = int(ext_pos[0])
    tcp.data = None
    planes = [outs[c][:dims[2 * c] * dims[2 * c + 1]] for c in range(cs.ncomp())]
    return bounds, planes


# ---------------------------------------------------------------------------
# Pillow's unpackers (Jpeg2KDecode.c)
# ---------------------------------------------------------------------------

def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _shift_params(comp: _Comp, bits: int) -> tuple:
    shift = bits - comp.prec
    offset = 1 << (comp.prec - 1) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    return shift, offset


def _shifted(words: np.ndarray, shift: int, offset: int, out_bits: int) -> np.ndarray:
    """j2ku_shift(offset + word, shift) stored in an out_bits-wide field."""
    v = (words.astype(np.uint64) + np.uint64(offset)) & np.uint64(0xFFFFFFFF)
    v = v >> np.uint64(-shift) if shift < 0 else (v << np.uint64(shift)) & np.uint64(0xFFFFFFFF)
    return (v & np.uint64((1 << out_bits) - 1)).astype(np.uint8 if out_bits == 8 else np.uint16)


def _words(buf: np.ndarray, start: int, csiz: int, count: int) -> np.ndarray:
    """count unsigned csiz-byte little-endian words of buf from byte start."""
    raw = buf[start:start + count * csiz]
    dt = {1: "<u1", 2: "<u2", 4: "<u4"}[csiz]
    return np.frombuffer(raw.tobytes(), dt, count)


# YCbCr -> RGB of Pillow's ConvertYCbCr.c (SCALE 6), as fixed-point tables
def _ycbcr_tables() -> tuple:
    x = np.arange(256) - 128
    scale = 64

    def table(k: float) -> np.ndarray:  # (int)(v + 0.5), truncated toward zero
        return np.trunc(x * k * scale + 0.5).astype(np.int64)

    return table(1.40200), table(-0.34414), table(-0.71414), table(1.77200)


def _sycc_to_rgb(rows: np.ndarray) -> np.ndarray:
    """ImagingConvertYCbCr2RGB over [..., 4] bytes (Y, Cb, Cr, A)."""
    r_cr, g_cb, g_cr, b_cb = _YCC_TABLES
    y, cb, cr = (rows[..., k].astype(np.int64) for k in range(3))
    out = rows.copy()
    out[..., 0] = np.clip(y + (r_cr[cr] >> 6), 0, 255)
    out[..., 1] = np.clip(y + ((g_cb[cb] + g_cr[cr]) >> 6), 0, 255)
    out[..., 2] = np.clip(y + (b_cb[cb] >> 6), 0, 255)
    return out


_YCC_TABLES = _ycbcr_tables()

# (mode, colour space, components, subsampling allowed, unpacker)
_UNPACKERS = (
    ("L", CS_GRAY, 1, False, "gray_l"), ("P", CS_SRGB, 1, False, "gray_l"),
    ("PA", CS_SRGB, 2, False, "graya_la"), ("I;16", CS_GRAY, 1, False, "gray_i"),
    ("LA", CS_GRAY, 2, False, "graya_la"),
    ("RGB", CS_GRAY, 1, False, "gray_rgb"), ("RGB", CS_GRAY, 2, False, "gray_rgb"),
    ("RGB", CS_SRGB, 3, True, "srgb_rgb"), ("RGB", CS_SYCC, 3, True, "sycc_rgb"),
    ("RGB", CS_SRGB, 4, True, "srgb_rgb"), ("RGB", CS_SYCC, 4, True, "sycc_rgb"),
    ("RGBA", CS_GRAY, 1, False, "gray_rgb"), ("RGBA", CS_GRAY, 2, False, "graya_la"),
    ("RGBA", CS_SRGB, 3, True, "srgb_rgb"), ("RGBA", CS_SYCC, 3, True, "sycc_rgb"),
    ("RGBA", CS_GRAY, 4, True, "srgba_rgba"), ("RGBA", CS_SRGB, 4, True, "srgba_rgba"),
    ("RGBA", CS_SYCC, 4, True, "sycca_rgba"),
    ("CMYK", CS_CMYK, 4, True, "srgba_rgba"),
)


def _unpack(kind: str, comps: list, bounds: tuple, image_origin: tuple, buf: np.ndarray,
            im: np.ndarray) -> None:
    """One tile's samples from Pillow's buffer into its image storage im:
    [H, W] uint8 for L and P, [H, W] uint16 for I;16, [H, W, 4] else."""
    x0, y0 = bounds[0] - image_origin[0], bounds[1] - image_origin[1]
    w, h = bounds[2] - bounds[0], bounds[3] - bounds[1]
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        c = comps[0]
        bits = 16 if kind == "gray_i" else 8
        shift, offset = _shift_params(c, bits)
        cs = _csiz(c.prec)
        v = _shifted(_words(buf, 0, cs, w * h), shift, offset, bits).reshape(h, w)
        if kind == "gray_rgb":
            im[y0:y0 + h, x0:x0 + w, :3] = v[..., None]
            im[y0:y0 + h, x0:x0 + w, 3] = 255
        else:
            im[y0:y0 + h, x0:x0 + w] = v
        return
    if kind == "graya_la":
        c, a = comps[0], comps[1]
        shift, offset = _shift_params(c, 8)
        ashift, aoffset = _shift_params(a, 8)
        cs, acs = _csiz(c.prec), _csiz(a.prec)
        v = _shifted(_words(buf, 0, cs, w * h), shift, offset, 8).reshape(h, w)
        av = _shifted(_words(buf, cs * w * h, acs, w * h), ashift, aoffset, 8).reshape(h, w)
        im[y0:y0 + h, x0:x0 + w, :3] = v[..., None]
        im[y0:y0 + h, x0:x0 + w, 3] = av
        return
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    tile = np.empty((h, w, 4), np.uint8)
    tile[..., 3] = 255
    start = 0
    for k in range(n):
        c = comps[k]
        shift, offset = _shift_params(c, 8)
        cs = _csiz(c.prec)
        cw, ch = w // c.dx, h // c.dy
        ys = (np.arange(h) // c.dy)[:, None]
        xs = (np.arange(w) // c.dx)[None, :]
        idx = ys * cw + xs
        words = _words(buf, start, cs, max(cw * ch, int(idx.max()) + 1) if idx.size else 0)
        tile[..., k] = _shifted(words[idx], shift, offset, 8)
        start += cs * cw * ch
    if kind in ("sycc_rgb", "sycca_rgba"):
        tile = _sycc_to_rgb(tile)
    im[y0:y0 + h, x0:x0 + w] = tile


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _pillow_image(data: bytes, codec: str, size: tuple, mode: str) -> np.ndarray:
    """Pillow's Jpeg2KDecode over OpenJPEG: the image storage of `mode`."""
    cs_pos, ihdr, color_space = 0, None, CS_UNSPECIFIED
    if codec == "jp2":
        cs_pos, jp2 = _jp2_boxes(data)
        ihdr = jp2.ihdr
        color_space = {16: CS_SRGB, 17: CS_GRAY, 18: CS_SYCC, 24: CS_EYCC,
                       12: CS_CMYK}.get(jp2.enumcs, CS_UNKNOWN)
    cs = _Codestream(data, cs_pos, ihdr)
    cs.main_header()
    ncomp = cs.ncomp()
    if not 1 <= ncomp <= 4:
        raise _Broken("an image Pillow cannot handle")
    # Jpeg2KDecode.c: an unknown or unspecified colour space follows the
    # component count, sYCC where the first subsampled component is a
    # chroma one
    first_sub = next((i for i, c in enumerate(cs.comps) if c.dx != 1 or c.dy != 1), ncomp)
    subsampled = first_sub < ncomp
    if color_space in (CS_UNKNOWN, CS_UNSPECIFIED):
        if ncomp <= 2:
            color_space = CS_GRAY
        else:
            color_space = CS_SYCC if first_sub in (1, 2) else CS_SRGB
    kind = next((u[4] for u in _UNPACKERS if u[0] == mode and u[1] == color_space
                 and u[2] == ncomp and (u[3] or not subsampled)), None)
    if kind is None:
        raise _Broken("no unpacker for this image")
    w, h = size
    shape = {"L": (h, w), "P": (h, w), "I;16": (h, w)}.get(mode, (h, w, 4))
    im = np.zeros(shape, np.uint16 if mode == "I;16" else np.uint8)
    buf = np.zeros(0, np.uint8)
    widths = [_csiz(c.prec) for c in cs.comps]
    x0, y0 = cs.image[:2]
    while True:
        index = cs.read_tile_header()
        if index is None:
            break
        bounds = _tile_bounds(cs, index)
        tw, th = bounds[2] - bounds[0], bounds[3] - bounds[1]
        if (bounds[0] >= bounds[2] or bounds[1] >= bounds[3] or bounds[0] < x0
                or bounds[1] < y0 or bounds[2] - x0 > w or bounds[3] - y0 > h):
            raise _Broken("tile outside the image")
        data_size = 0
        for c, cw in zip(cs.comps, widths):
            data_size += cw * ((-(-bounds[2] // c.dx) - -(-bounds[0] // c.dx))
                               * (-(-bounds[3] // c.dy) - -(-bounds[1] // c.dy)))
        need = max(tw * th * sum(widths), data_size)
        if buf.size < need:
            buf = np.zeros(need, np.uint8)
        _, planes = _decode_tile(cs, index)
        at = 0
        for c, cw, plane in zip(cs.comps, widths, planes):
            masked = plane.astype(np.int64) & ((1 << (8 * cw)) - 1)
            raw = masked.astype({1: "<u1", 2: "<u2", 4: "<u4"}[cw]).view(np.uint8)
            buf[at:at + raw.size] = raw
            at += raw.size
        _unpack(kind, cs.comps, bounds, (x0, y0), buf, im)
        cs.after_tile()
    return im


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """JPEG 2000 bytes (a JP2 file or a raw codestream) -> the JAX
    package's imgio.load_image(data).data for the same file."""
    codec, size, mode, palette = pillow_open(data)
    bomb_check(*size)
    try:
        im = _pillow_image(data, codec, size, mode)
    except _Broken as e:
        raise ValueError(f"JPEG 2000: broken data stream ({e})") from e
    if mode == "P":
        pmode, pbytes = palette
        width = len(pmode)
        n = len(pbytes) // width
        return p_to_rgba(im, np.frombuffer(pbytes[:n * width], np.uint8).reshape(n, width))
    if mode in ("LA", "PA"):
        return to_rgba(im[..., [0, 3]])
    if mode == "RGB":
        return to_rgba(im[..., :3])
    if mode == "RGBA":
        return np.ascontiguousarray(im)
    if mode == "CMYK":
        return cmyk_to_rgba(im)
    if mode == "I;16":
        return to_rgba(im.astype(np.float32) / np.float32(65535.0))
    return to_rgba(im)


# ---------------------------------------------------------------------------
# the native transforms and their NumPy twins
# ---------------------------------------------------------------------------

def resolution_rects(x0: int, y0: int, x1: int, y1: int, numres: int) -> np.ndarray:
    """The rectangles [numres, 4] of a tile-component's resolutions."""
    out = np.empty((numres, 4), np.int32)
    for r in range(numres):
        level = numres - 1 - r
        out[r] = [-(-v // (1 << level)) for v in (x0, y0, x1, y1)]
    return out


def idwt(data: np.ndarray, rects: np.ndarray, reversible: bool) -> np.ndarray:
    """The native inverse wavelet (gatling_j2k_idwt) of a tile-component's
    coefficients data [h, w] (int32 for the 5/3, float32 for the 9/7)."""
    out = np.ascontiguousarray(data, np.int32 if reversible else np.float32).copy()
    rects = np.ascontiguousarray(rects, np.int32)
    native.library().gatling_j2k_idwt(out.ctypes.data, native.ptr(rects, ctypes.c_int32),
                                      len(rects), out.shape[1], int(reversible))
    return out


def mct(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray, reversible: bool) -> tuple:
    """The native inverse RCT (int32) or ICT (float32) of three planes."""
    dt = np.int32 if reversible else np.float32
    out = [np.ascontiguousarray(c, dt).copy() for c in (c0, c1, c2)]
    native.library().gatling_j2k_mct(out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data,
                                     out[0].size, int(reversible))
    return tuple(out)


def _idwt53_lines(a: np.ndarray, dn: int, sn: int, cas: int) -> None:
    """dwt.c opj_dwt_decode_1_ over lines a [L, sn + dn] in place (int32)."""
    if not cas:
        if dn > 0 or sn > 1:
            s, d = a[:, 0::2], a[:, 1::2]
            i = np.arange(sn)
            s -= (d[:, np.clip(i - 1, 0, dn - 1)] + d[:, np.clip(i, 0, dn - 1)] + 2) >> 2
            j = np.arange(dn)
            d += (s[:, np.clip(j, 0, sn - 1)] + s[:, np.clip(j + 1, 0, sn - 1)]) >> 1
    elif sn == 0 and dn == 1:
        a[:, 0] = np.where(a[:, 0] < 0, -((-a[:, 0]) // 2), a[:, 0] // 2)
    else:
        s, d = a[:, 0::2], a[:, 1::2]
        i = np.arange(sn)
        d -= (s[:, np.clip(i, 0, dn - 1)] + s[:, np.clip(i + 1, 0, dn - 1)] + 2) >> 2
        j = np.arange(dn)
        s += (d[:, np.clip(j, 0, sn - 1)] + d[:, np.clip(j - 1, 0, sn - 1)]) >> 1


_F = np.float32
_ALPHA, _BETA, _GAMMA, _DELTA = _F(1.586134342), _F(0.052980118), _F(-0.882911075), _F(-0.443506852)
_K, _TWO_INVK = _F(1.230174105), _F(1.625732422)


def _step2(W: np.ndarray, lo: int, s: int, end: int, m: int, c: np.float32) -> None:
    """opj_v8dwt_decode_step2 on lines W: the samples s-1, s+1, ... get the
    sum of their neighbours times c (the first's left neighbour is W[lo])."""
    imax = min(end, m)
    if imax >= 1:
        t = s - 1 + 2 * np.arange(imax)
        left = W[:, t - 1].copy()
        left[:, 0] = W[:, lo]
        W[:, t] = W[:, t] + (left + W[:, t + 1]) * c
    if m < end:
        t = s - 1 + 2 * imax
        W[:, t] = W[:, t] + (c + c) * W[:, t - 1]


def _idwt97_lines(W: np.ndarray, dn: int, sn: int, cas: int) -> None:
    """opj_v8dwt_decode over lines W [L, sn + dn] in place (float32)."""
    if cas == 0:
        if not (dn > 0 or sn > 1):
            return
        a, b = 0, 1
    else:
        if not (sn > 0 or dn > 1):
            return
        a, b = 1, 0
    W[:, a:a + 2 * sn:2] *= _K
    W[:, b:b + 2 * dn:2] *= _TWO_INVK
    _step2(W, b, a + 1, sn, max(min(sn, dn - a), 0), _DELTA)
    _step2(W, a, b + 1, dn, max(min(dn, sn - b), 0), _GAMMA)
    _step2(W, b, a + 1, sn, max(min(sn, dn - a), 0), _BETA)
    _step2(W, a, b + 1, dn, max(min(dn, sn - b), 0), _ALPHA)


def _idwt_ref(data: np.ndarray, rects: np.ndarray, lines) -> np.ndarray:
    out = data.copy()
    rw, rh = rects[0, 2] - rects[0, 0], rects[0, 3] - rects[0, 1]
    for r in range(1, len(rects)):
        hsn, vsn = rw, rh
        rw, rh = rects[r, 2] - rects[r, 0], rects[r, 3] - rects[r, 1]
        hcas, vcas = rects[r, 0] % 2, rects[r, 1] % 2
        block = out[:rh, :rw]
        line = np.zeros((rh, rw), out.dtype)
        line[:, hcas:hcas + 2 * hsn:2] = block[:, :hsn]
        line[:, 1 - hcas:1 - hcas + 2 * (rw - hsn):2] = block[:, hsn:rw]
        lines(line, int(rw - hsn), int(hsn), int(hcas))
        out[:rh, :rw] = line
        block = out[:rh, :rw].T
        line = np.zeros((rw, rh), out.dtype)
        line[:, vcas:vcas + 2 * vsn:2] = block[:, :vsn]
        line[:, 1 - vcas:1 - vcas + 2 * (rh - vsn):2] = block[:, vsn:rh]
        lines(line, int(rh - vsn), int(vsn), int(vcas))
        out[:rh, :rw] = line.T
    return out


def idwt53_ref(data: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """NumPy twin of the native inverse 5/3 wavelet (int32)."""
    return _idwt_ref(np.asarray(data, np.int32), np.asarray(rects), _idwt53_lines)


def idwt97_ref(data: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """NumPy twin of the native inverse 9/7 wavelet (float32, step for step)."""
    return _idwt_ref(np.asarray(data, np.float32), np.asarray(rects), _idwt97_lines)


def mct_ref(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray, reversible: bool) -> tuple:
    """NumPy twin of the native inverse RCT (int32) or ICT (float32)."""
    if reversible:
        y, u, v = (np.asarray(c, np.int32) for c in (c0, c1, c2))
        g = y - ((u + v) >> 2)
        return v + g, g, u + g
    y, u, v = (np.asarray(c, np.float32) for c in (c0, c1, c2))
    r = y + v * _F(1.402)
    g = (y - u * _F(0.34413)) - v * _F(0.71414)
    b = y + u * _F(1.772)
    return r, g, b


# ---------------------------------------------------------------------------
# the encoder (Pillow's saver, lossless by its defaults)
# ---------------------------------------------------------------------------

CBLK = 64  # OpenJPEG's default code-block side
MAX_LEVELS = 5  # OpenJPEG's default 6 resolutions
_GAIN = (0, 1, 1, 2)  # log2 of each band's gain (LL, HL, LH, HH) on the 5/3


def levels_for(w: int, h: int) -> int:
    """The decomposition levels Pillow's encoder uses: OpenJPEG's 5, fewer
    where the smaller side holds fewer than 2^levels samples."""
    return min(MAX_LEVELS, max(min(w, h), 1).bit_length() - 1)


def fdwt53(data: np.ndarray, levels: int) -> np.ndarray:
    """The native forward 5/3 (gatling_j2k_fdwt53) of data [h, w] over
    `levels` levels: each level's columns, then its rows, the low-pass half
    first, into the top-left corner the next level works on."""
    out = np.ascontiguousarray(data, np.int32).copy()
    native.library().gatling_j2k_fdwt53(native.ptr(out, ctypes.c_int32), out.shape[1],
                                        out.shape[0], levels)
    return out


def fdwt53_ref(data: np.ndarray, levels: int) -> np.ndarray:
    """The NumPy twin of `fdwt53`."""
    out = np.asarray(data, np.int64).copy()
    rh, rw = out.shape
    for _ in range(levels):
        for axis, n in ((0, rh), (1, rw)):
            region = out[:rh, :rw] if axis == 1 else out[:rh, :rw].T
            sn, dn = (n + 1) // 2, n // 2
            s, d = region[:, 0::2].copy(), region[:, 1::2].copy()
            if dn > 0 or sn > 1:
                right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)[:, :dn]
                d -= (s[:, :dn] + right) >> 1
                dl = np.concatenate([d[:, :1], d], axis=1)[:, :sn] if dn else np.zeros_like(s)
                dr = np.concatenate([d, d[:, -1:]], axis=1)[:, :sn] if dn else np.zeros_like(s)
                s += (dl + dr + 2) >> 2
            region[:, :sn], region[:, sn:] = s, d
        rh, rw = (rh + 1) // 2, (rw + 1) // 2
    return out.astype(np.int32)


def encode_cblk(coef: np.ndarray, orient: int) -> tuple[bytes, int, int]:
    """Tier 1 of one code-block in the native library
    (gatling_j2k_encode_cblk): (its MQ segment, bit-planes, passes)."""
    coef = np.ascontiguousarray(coef, np.int32)
    h, w = coef.shape
    cap = coef.size * 8 + 64
    out = np.empty(cap, np.uint8)
    info = np.zeros(2, np.int32)
    n = native.library().gatling_j2k_encode_cblk(
        native.ptr(coef, ctypes.c_int32), w, w, h, orient, native.ptr(out, ctypes.c_uint8), cap,
        native.ptr(info, ctypes.c_int32))
    if n < 0:
        raise RuntimeError("JPEG 2000: code-block output overran its buffer")
    return out[:n].tobytes(), int(info[0]), int(info[1])


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def encode_jpeg2000(img: np.ndarray, jp2: bool = True) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> a lossless JPEG
    2000 file with Pillow's defaults (Jpeg2KImagePlugin._save): one tile,
    the reversible 5/3 over levels_for(w, h) levels, 64x64 code-blocks, one
    layer in LRCP order, no MCT, each component DC-shifted by 128; a bare
    codestream, or (`jp2`) in the JP2 boxes Pillow's encoder writes (ihdr,
    colr sRGB or greyscale, cdef marking RGBA's alpha). The bytes are the
    port's own; Pillow and the port decode them to img."""
    img = np.asarray(img, np.uint8)
    planes = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
    nc, h, w = planes.shape
    levels = levels_for(w, h)
    comps = [fdwt53(p.astype(np.int32) - 128, levels) for p in planes]
    ptrs = native.pointers(comps)
    cap = sum(c.size for c in comps) * 8 + 4096
    out = np.empty(cap, np.uint8)
    guard = 2  # OpenJPEG's; more where a code-block needs more bit-planes
    while True:
        expn = [8 + _GAIN[0]] + [8 + g for _ in range(levels) for g in _GAIN[1:]]
        bandbps = np.array([expn[0] + guard - 1, 0, 0]
                           + [e + guard - 1 for e in expn[1:]], np.int32)
        n = native.library().gatling_j2k_encode_tile(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), nc, w, h, levels,
            native.ptr(bandbps, ctypes.c_int32), native.ptr(out, ctypes.c_uint8), cap)
        if n == -2 and guard < 7:
            guard += 1
            continue
        if n < 0:
            raise RuntimeError(f"JPEG 2000: the tile encoder failed ({n})")
        break
    packets = out[:n].tobytes()
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + b"\x07\x01\x01" * nc
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, levels, 4, 4, 0, 1)
    qcd = bytes([guard << 5] + [e << 3 for e in expn])
    sot = struct.pack(">HIBB", 0, 12 + 2 + len(packets), 0, 1)
    stream = (b"\xff\x4f" + _marker(0xFF51, siz) + _marker(0xFF52, cod) + _marker(0xFF5C, qcd)
              + _marker(0xFF90, sot) + b"\xff\x93" + packets + b"\xff\xd9")
    if not jp2:
        return stream
    head = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    head += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17 if nc == 1 else 16))
    if nc == 4:
        head += _box(b"cdef", struct.pack(">H", 4) + struct.pack(">12H", 0, 0, 1, 1, 0, 2, 2, 0,
                                                                 3, 3, 1, 0))
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + _box(b"jp2h", head) + _box(b"jp2c", stream))


# the MQ coder's tables (mqc.c) and the tier-1 contexts (t1.c), for the twin
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001,
       0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801,
       0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1,
       0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009,
       0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
         25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20,
         21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
         43, 46)
_SWITCH = {0, 6, 14}
_ZC, _SC, _MAG, _AGG, _UNI = 0, 9, 14, 17, 18


def _zc(orient: int, h: int, v: int, d: int) -> int:
    """The zero-coding context of t1.c (Table D.1)."""
    if orient == 3:
        hv = h + v
        if d == 0:
            return (0, 1, 2)[min(hv, 2)]
        if d == 1:
            return (3, 4, 5)[min(hv, 2)]
        return 6 if d == 2 and hv == 0 else 7 if d == 2 else 8
    if orient == 1:
        h, v = v, h
    if h == 0:
        return (0 if d == 0 else 1 if d == 1 else 2) if v == 0 else 3 if v == 1 else 4
    if h == 1:
        return (5 if d == 0 else 6) if v == 0 else 7
    return 8


class _MqRef:
    """mqc.c's MQ encoder."""

    def __init__(self) -> None:
        self.out = bytearray(1)
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[_UNI], self.state[_AGG], self.state[_ZC] = 46, 3, 4

    def _byteout(self) -> None:
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self) -> None:
        while True:
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, cx: int, d: int) -> None:
        s = self.state[cx]
        qe = _QE[s]
        self.a -= qe
        if self.mps[cx] == d:
            if not self.a & 0x8000:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.state[cx] = _NMPS[s]
                self._renorm()
            else:
                self.c += qe
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if s in _SWITCH:
                self.mps[cx] ^= 1
            self.state[cx] = _NLPS[s]
            self._renorm()

    def flush(self) -> bytes:
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        for _ in range(2):
            self.c = (self.c << self.ct) & 0xFFFFFFFF
            self._byteout()
        return bytes(self.out[1:] if self.out[-1] != 0xFF else self.out[1:-1])


def encode_cblk_ref(coef: np.ndarray, orient: int) -> tuple[bytes, int, int]:
    """The NumPy twin of `encode_cblk`: t1.c's passes over a code-block."""
    coef = np.asarray(coef, np.int64)
    h, w = coef.shape
    mag, neg = np.abs(coef).tolist(), (coef < 0).tolist()
    top = int(np.abs(coef).max(initial=0))
    numbps = top.bit_length()
    if not numbps:
        return b"", 0, 0
    sig = [[False] * (w + 2) for _ in range(h + 2)]
    negf = [[False] * (w + 2) for _ in range(h + 2)]
    visit = [[False] * w for _ in range(h)]
    refined = [[False] * w for _ in range(h)]
    mq = _MqRef()

    def nbr(x: int, y: int) -> tuple[int, int, int]:
        X, Y = x + 1, y + 1
        hh = sig[Y][X - 1] + sig[Y][X + 1]
        vv = sig[Y - 1][X] + sig[Y + 1][X]
        dd = sig[Y - 1][X - 1] + sig[Y - 1][X + 1] + sig[Y + 1][X - 1] + sig[Y + 1][X + 1]
        return hh, vv, dd

    def sign(x: int, y: int) -> None:
        X, Y = x + 1, y + 1

        def contrib(yy: int, xx: int) -> int:
            return 0 if not sig[yy][xx] else (-1 if negf[yy][xx] else 1)

        # each direction's neighbours count once for each sign (Table D.2)
        hp = (contrib(Y, X - 1) > 0) + (contrib(Y, X + 1) > 0)
        hn = (contrib(Y, X - 1) < 0) + (contrib(Y, X + 1) < 0)
        vp = (contrib(Y - 1, X) > 0) + (contrib(Y + 1, X) > 0)
        vn = (contrib(Y - 1, X) < 0) + (contrib(Y + 1, X) < 0)
        hc = (hp > 0) - (hn > 0)
        vc = (vp > 0) - (vn > 0)
        h0, v0 = hc, vc
        if hc < 0:
            hc, vc = -hc, -vc
        n = (0 if vc == 0 else 1) if hc == 0 else (2 if vc == -1 else 3 if vc == 0 else 4)
        spb = 0 if (h0 == 0 and v0 == 0) else int(not (h0 > 0 or (h0 == 0 and v0 > 0)))
        mq.encode(_SC + n, int(neg[y][x]) ^ spb)
        sig[Y][X], negf[Y][X] = True, neg[y][x]

    def cln_sample(x: int, y: int, bp: int) -> None:
        b = (mag[y][x] >> bp) & 1
        mq.encode(_ZC + _zc(orient, *nbr(x, y)), b)
        if b:
            sign(x, y)

    for bp in range(numbps - 1, -1, -1):
        if bp != numbps - 1:
            for k in range(0, h, 4):  # significance propagation
                for x in range(w):
                    for y in range(k, min(k + 4, h)):
                        if sig[y + 1][x + 1] or visit[y][x] or not any(nbr(x, y)):
                            continue
                        b = (mag[y][x] >> bp) & 1
                        mq.encode(_ZC + _zc(orient, *nbr(x, y)), b)
                        if b:
                            sign(x, y)
                        visit[y][x] = True
            for k in range(0, h, 4):  # magnitude refinement
                for x in range(w):
                    for y in range(k, min(k + 4, h)):
                        if not sig[y + 1][x + 1] or visit[y][x]:
                            continue
                        ctx = _MAG + 2 if refined[y][x] else _MAG + (1 if any(nbr(x, y)) else 0)
                        mq.encode(ctx, (mag[y][x] >> bp) & 1)
                        refined[y][x] = True
        for k in range(0, h, 4):  # cleanup
            rows = range(k, min(k + 4, h))
            for x in range(w):
                run = len(rows) == 4 and not any(
                    sig[y + 1][x + dx + 1] for y in range(k - 1, k + 5) for dx in (-1, 0, 1)) \
                    and not any(visit[y][x] for y in rows)
                if run:
                    bits = [(mag[y][x] >> bp) & 1 for y in rows]
                    first = bits.index(1) if 1 in bits else -1
                    mq.encode(_AGG, int(first >= 0))
                    if first >= 0:
                        mq.encode(_UNI, first >> 1)
                        mq.encode(_UNI, first & 1)
                        sign(x, k + first)
                        for y in range(k + first + 1, k + 4):
                            cln_sample(x, y, bp)
                else:
                    for y in rows:
                        if not sig[y + 1][x + 1] and not visit[y][x]:
                            cln_sample(x, y, bp)
                for y in rows:
                    visit[y][x] = False
    return mq.flush(), numbps, 3 * numbps - 2
