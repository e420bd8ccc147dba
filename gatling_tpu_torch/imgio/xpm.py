"""X11 pixmaps (.xpm) and bitmaps (.xbm) as Pillow 12.1 reads them
(XpmImagePlugin, XbmImagePlugin and XbmDecode.c), for the JAX package's
imgio.

XPM quirks reproduced:
- the header line is the first line that starts '"w h n cpp'; each colour
  line's key is its characters 1 to cpp, its value the first "c" pair of
  the words between the key and the line's last two characters: "#rrggbb"
  (any hex digits, the low 24 bits taken), "None", or anything else,
  which fails; a line without a "c" fails, a "c" without a value skips
  the plugin;
- up to 256 colours is "P" over the colours in the order their keys first
  came (a repeated key keeps its place and takes the later colour); more
  is RGB; "None" takes no palette entry: a pixel of it fails, and its key's
  bytes become the alphas of the first palette entries (Pillow's
  transparency for "P" is bytes of alphas);
- the pixel lines: whatever lies between the first and the last '"' of
  each line, a "/* pixels */" line skipped once, until enough pixels are
  read or the file ends (too few fails);
XBM: every 'x' after the header's "_bits[]" starts a hex byte (two
characters, anything else counting 0), bits least significant first,
rows of ceil(width / 8) bytes; too few is "image file is truncated".
"""

from __future__ import annotations

import re

import numpy as np

from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish

_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _k, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _k
for _k, _c in enumerate(b"ABCDEF"):
    _HEX[_c] = 10 + _k


def _int(v: bytes) -> int:
    try:
        return int(v)
    except ValueError as e:
        raise ValueError(f"XPM: not a number: {v!r}") from e


def decode_xpm(data: bytes) -> np.ndarray:
    if not data.startswith(b"/* XPM */"):
        raise Skip("not an XPM file")
    f = Reader(data, 9)
    while True:
        line = f.readline()
        if not line:
            raise Skip("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    w, h, n, bpp = (_int(g) for g in m.groups())
    palette: dict[bytes, bytes] = {}
    transparency = None
    for _ in range(n):
        line = f.readline().rstrip()
        key = line[1:bpp + 1]
        words = line[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise Skip("XPM: a colour without a value")  # IndexError
                rgb = words[i + 1]
                if rgb == b"None":
                    transparency = key
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError as e:
                        raise ValueError("cannot read this XPM file") from e
                    palette[key] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    keys = list(palette)
    rgb_mode = n > 256
    index = {k: i for i, k in enumerate(keys)}
    need = w * h
    px: list = []
    header = False
    while len(px) < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(body), bpp):
            key = body[i:i + bpp]
            if rgb_mode:
                if key not in palette:
                    raise ValueError(f"XPM: no colour {key!r}")  # KeyError
                px.append(palette[key])
            else:
                if key not in index:
                    raise ValueError(f"XPM: no palette entry {key!r}")  # tuple.index
                px.append(index[key])
    if len(px) < need:
        raise ValueError("not enough image data")
    if rgb_mode:
        rgb = np.frombuffer(b"".join(px[:need]), np.uint8).reshape(h, w, 3)
        return finish("RGB", rgb)
    entries = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    idx = np.array(px[:need], np.uint8).reshape(h, w)
    if transparency is None:
        return finish("P", idx, entries)
    table = np.zeros((len(entries), 4), np.uint8)
    table[:, :3] = entries
    table[:, 3] = 255
    alphas = np.frombuffer(transparency, np.uint8)[:len(entries)]
    table[:len(alphas), 3] = alphas  # putpalettealphas
    return finish("P", idx, table)


def decode_xbm(data: bytes) -> np.ndarray:
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise Skip("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    line = (w + 7) // 8
    need = line * h
    body = np.frombuffer(data, np.uint8, len(data) - m.end(), m.end())
    xs = np.flatnonzero(body == ord("x"))
    # each 'x' takes itself and the two characters after it; the next search
    # starts past them, and the last needs all three inside the data
    vals = []
    at = -1
    for k in xs:
        if k < at:
            continue
        if k + 3 > body.size:
            break
        vals.append((int(_HEX[body[k + 1]]) << 4) + int(_HEX[body[k + 2]]))
        at = k + 3
        if len(vals) == need:
            break
    if len(vals) < need:
        raise ValueError("image file is truncated")
    rows = np.array(vals, np.uint8).reshape(h, line)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return finish("1", bits)
