"""IFUNC Image Memory files (.im) as Pillow 12.1 reads them
(ImImagePlugin), for the JAX package's imgio.

Quirks reproduced:
- the header's lines up to a 0 byte, ^Z or the end (a line over 100
  bytes, or one that is no "key: value", skips the plugin; at least one
  known key is needed); the image size and type from "Image size (x*y)"
  and "Image type" (Pillow's OPEN table of types; without the line, a
  512x512 "L" image), the data after the ^Z that ends the header;
- a "Lut" of 768 bytes: on an L or P image, a palette that is not grey
  makes the image "P" over it (planar: reds, greens, blues); a grey one
  changes nothing (Pillow keeps a non-linear one aside, unused); on an LA
  image a non-grey one makes it "PA" (its index and alpha reach the JAX
  package's array as grey and alpha: it converts "P" alone); a "PA image"
  without one is "LA" read through "PA;L", which Pillow has no raw mode
  for: the load fails;
- every image is stored bottom row first; "RGB;L" and the other ";L"
  layouts hold each row's bands one after another; RGB3/RYB3 ("RGB;T")
  are three whole planes, green, red, blue;
- the "L n image" types are Pillow's "F" (float32 of 8-bit, signed 8-bit,
  16-bit, signed 16-bit, 32-bit and float samples, little-endian) or
  "I;16", "I;16L", "I;16B", "I" (32-bit signed); "I;16L" is not one of
  the modes the JAX package turns into floats, so its array is uint16
  with an alpha of 1; "L 32 S" reads unsigned 32-bit words into "I";
- B2 and B4 images are "P" of 2- and 4-bit indices; without a Lut their
  palette is empty (black).
Not ported (NotImplementedError): Pillow's "bit" decoder of the "L*n
image" types of n bits other than 8, 16 and 32; the RLB and RYB types;
YCC images, which Pillow converts with its own YCbCr tables.
"""

from __future__ import annotations

import re

import numpy as np

from gatling_tpu_torch.imgio.modes import (UNPORTED, Reader, Skip, bomb_check, finish, raw_rows,
                                           to_rgba, unpack_bits)

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name",
         "Scale (x,y)", "Image size (x*y)", "Image type"}

# ImImagePlugin.OPEN: image type -> (mode, raw mode)
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
        "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
        "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
        "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
        "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
        "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
        "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
        "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

# numeric raw modes: their samples' numpy type
_NUMERIC = {"F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4",
            "F;32F": "<f4", "I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4",
            "I;32S": "<i4", "F;32S": "<i4"}
_PLANAR = {"RGB;L": 3, "LA;L": 2, "PA;L": 2, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def decode_im(data: bytes) -> np.ndarray:
    if b"\n" not in data[:100]:
        raise Skip("not an IM file")
    f = Reader(data)
    n = 0
    info: dict = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    s = b""
    while True:
        s = f.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + f.readline()
        if len(s) > 100:
            raise Skip("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise Skip("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            except ValueError as e:
                raise ValueError(f"IM: bad number in {k}") from e
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        if k in _TAGS:
            n += 1
    if not n:
        raise Skip("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = f.read(1)
    if not s:
        raise Skip("File truncated")
    palette = None
    if "Lut" in info:
        lut = f.read(768)
        if len(lut) < 768:
            raise ValueError("IM: short Lut")  # IndexError in the palette loop
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((p[0] == p[1]).all() and (p[1] == p[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
                palette = p.T
            else:
                mode, rawmode = "PA", "PA;L"
    if not isinstance(size, tuple) or len(size) != 2 or not all(isinstance(x, int)
                                                                for x in size):
        raise ValueError("IM: bad image size")
    w, h = size
    if not isinstance(mode, str) or mode not in ("1", "L", "P", "RGB", "RGBA", "LA", "PA", "CMYK",
                                                "YCbCr", "I", "F", "I;16", "I;16L", "I;16B"):
        raise ValueError("unrecognized image mode")
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    offs = f.pos
    if rawmode in ("RLB", "YCbCr;L") or (rawmode.startswith("F;") and rawmode[2:].isdigit()
                                         and int(rawmode[2:]) not in (8, 16, 32)):
        raise NotImplementedError(f"IM images of raw mode {rawmode} are not ported {UNPORTED}")
    if (mode == "LA" and rawmode != "LA;L") or (rawmode == "L" and mode not in ("L", "P")):
        raise ValueError("unknown raw mode for given image mode")
    if rawmode in ("RGB;T", "RYB;T"):
        planes = [raw_rows(data, offs + k * w * h, w, h, w, ystep=-1) for k in range(3)]
        return finish("RGB", np.stack([planes[1], planes[0], planes[2]], -1))
    if rawmode == "1":
        return finish("1", unpack_bits(raw_rows(data, offs, w, h, (w + 7) // 8, ystep=-1), w, 1))
    if rawmode in ("P;2", "P;4"):
        bits = int(rawmode[2])
        rows = raw_rows(data, offs, w, h, (w * bits + 7) // 8, ystep=-1)
        return finish("P", unpack_bits(rows, w, bits), palette)
    if rawmode in ("L", "P"):
        return finish(mode, raw_rows(data, offs, w, h, w, ystep=-1), palette)
    if rawmode == "RGB":
        return finish("RGB", raw_rows(data, offs, w, h, 3 * w, ystep=-1).reshape(h, w, 3))
    if rawmode in _PLANAR:
        b = _PLANAR[rawmode]
        rows = raw_rows(data, offs, w, h, b * w, ystep=-1).reshape(h, b, w).transpose(0, 2, 1)
        bands = np.ascontiguousarray(rows[..., :len(mode)])
        return to_rgba(bands) if mode == "PA" else finish(mode, bands)
    dt = np.dtype(_NUMERIC[rawmode])
    v = raw_rows(data, offs, w, h, w * dt.itemsize, ystep=-1).view(dt).reshape(h, w)
    if mode == "I;16L":
        return to_rgba(v.astype(np.uint16))
    if mode == "F":
        return finish("F", v.astype(np.float32))
    return finish(mode, v.astype(np.int32) if mode == "I" else v)
