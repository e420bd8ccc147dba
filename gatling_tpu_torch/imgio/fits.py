"""FITS images as Pillow 12.1 reads them (FitsImagePlugin), for the JAX
package's imgio.

Quirks reproduced:
- the first header that gives an image decides: the primary HDU's NAXIS1
  x NAXIS2 (NAXIS 1: one column of NAXIS1 rows), or a BINTABLE extension
  with ZIMAGE T and ZCMPTYPE 'GZIP_1' (Pillow's compressed tile table:
  its heap gunzipped whole);
- BITPIX 8 is "L", 16 "I;16", 32 "I", -32 and -64 "F", every one read as
  Pillow's raw mode of that name: little-endian, so FITS's big-endian
  samples come out byte-swapped, and -64 reads 4 of each 8 bytes' worth;
  the rows bottom first (orientation -1);
- GZIP_1: each pixel takes 4 bytes of the gunzipped heap, the last
  min(BITPIX / 8, 4) of them (none for negative BITPIX: too little data),
  the rows reversed;
- the header's cards: a value runs to a '/', an '=' stripped; a first
  card other than SIMPLE = T skips the plugin; a file that ends in its
  header fails.
"""

from __future__ import annotations

import gzip
import math

import numpy as np

from gatling_tpu_torch.imgio.modes import Reader, Skip, bomb_check, finish, raw_rows

_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
          -64: ("F", "<f4")}


def _int(v: bytes) -> int:
    try:
        return int(v)
    except ValueError as e:
        raise ValueError(f"FITS: not an integer: {v!r}") from e


def _size(headers: dict, prefix: bytes):
    if prefix + b"NAXIS" not in headers:
        raise Skip("FITS: no NAXIS")  # KeyError
    naxis = _int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    key1, key2 = prefix + b"NAXIS1", prefix + b"NAXIS2"
    if key1 not in headers or (naxis != 1 and key2 not in headers):
        raise Skip("FITS: no axis length")  # KeyError
    if naxis == 1:
        return 1, _int(headers[key1])
    return _int(headers[key1]), _int(headers[key2])


def _parse(headers: dict):
    prefix, gz, offset = b"", False, 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers.get(b"ZCMPTYPE", None) == b"'GZIP_1  '"):
        w, h = _size(headers, b"") or (0, 0)
        offset = w * h * (_int(headers[b"BITPIX"]) // 8)
        prefix, gz = b"Z", True
    elif (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
          and b"ZCMPTYPE" not in headers):
        raise Skip("FITS: no ZCMPTYPE")  # KeyError
    size = _size(headers, prefix)
    if not size:
        return None
    if prefix + b"BITPIX" not in headers:
        raise Skip("FITS: no BITPIX")
    return size, _int(headers[prefix + b"BITPIX"]), gz, offset


def decode_fits(data: bytes) -> np.ndarray:
    if not data.startswith(b"SIMPLE"):
        raise Skip("not a FITS file")
    f = Reader(data)
    headers: dict[bytes, bytes] = {}
    in_progress = False
    found = None
    while True:
        header = f.read(80)
        if not header:
            raise ValueError("Truncated FITS file")
        keyword = header[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            f.pos = math.ceil(f.pos / 2880) * 2880
            if found is None:
                found = _parse(headers) or None
            in_progress = False
            continue
        if found is not None:
            continue
        value = header[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise Skip("Not a FITS file")
        headers[keyword] = value
    if found is None:
        raise ValueError("No image data")
    (w, h), bits, gz, offset = found
    if bits not in _MODES:
        raise Skip("not identified by this plugin")  # no mode
    if w <= 0 or h <= 0:
        raise Skip("not identified by this plugin")
    bomb_check(w, h)
    mode, dt = _MODES[bits]
    size = np.dtype(dt).itemsize
    offset += f.pos - 80
    if not gz:
        rows = raw_rows(data, offset, w, h, w * size, ystep=-1)
        return finish(mode, rows.view(dt).reshape(h, w))
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, ValueError) as e:
        raise ValueError(f"FITS: bad GZIP_1 data: {e}") from e
    take = min(bits // 8, 4)
    need = w * h * size
    if take <= 0:
        raise ValueError("not enough image data")
    words = np.frombuffer(value[:4 * (len(value) // 4)], np.uint8).reshape(-1, 4)
    got = words[:w * h, 4 - take:].reshape(-1)
    if got.size < need:
        raise ValueError("not enough image data")
    rows = got[:need].reshape(h, w * size)[::-1]
    return finish(mode, np.ascontiguousarray(rows).view(dt).reshape(h, w))
