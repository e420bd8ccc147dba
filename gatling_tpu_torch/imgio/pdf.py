"""One-page PDF files as Pillow 12.1's PdfImagePlugin._save writes them
through its PdfParser (the JAX package's writer goes through Pillow): the
catalog, the page tree, the image XObject, the page, its contents and the
document information, in Pillow's object numbers and order, then the
cross-reference table and the trailer. A grey or RGB image is stored as
the JPEG Pillow's saver writes (jpeg.py, DCTDecode), an RGBA one as a JP2
file (jpeg2000.py, JPXDecode; the port's own lossless bytes). `/Title` is
the file's base name without its extension, and the dates are the time of
writing, as in Pillow.
"""

from __future__ import annotations

import os
import time

import numpy as np

from gatling_tpu_torch.imgio import jpeg, jpeg2000


def _name(name: str) -> bytes:
    """PdfName: '#xx' for every byte outside the regular characters."""
    allowed = set(range(33, 127)) - {ord(c) for c in "#%/()<>[]{}"}
    return b"/" + b"".join(bytes((b,)) if b in allowed else b"#%02X" % b
                           for b in name.encode("us-ascii"))


def _text(s: str) -> bytes:
    """pdf_repr of a str: UTF-16BE with its byte order mark, escaped."""
    b = b"\xfe\xff" + s.encode("utf_16_be")
    return b"(" + b.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)") + b")"


def _repr(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, dict):
        return _dict(v)
    if isinstance(v, list):
        return b"[ " + b" ".join(_repr(x) for x in v) + b" ]"
    return str(v).encode("us-ascii")


def _dict(d: dict) -> bytes:
    """PdfDict: each entry on a line of its own."""
    return (b"<<" + b"".join(b"\n" + _name(k) + b" " + _repr(v) for k, v in d.items())
            + b"\n>>")


def _date(t: time.struct_time) -> bytes:
    return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", t).encode("us-ascii") + b")"


def encode_pdf(img: np.ndarray, path: str) -> bytes:
    """[H, W] grey, [H, W, 3] RGB or [H, W, 4] RGBA uint8 -> the bytes of
    Pillow's PDF of img saved to `path` now (72 dpi: a point a pixel)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    when = time.gmtime()
    if c == 4:
        stream = jpeg2000.encode_jpeg2000(img, jp2=True)
        image = {"Filter": _name("JPXDecode"), "SMaskInData": 1}
    else:
        stream = jpeg.encode_jpeg(img)
        image = {"Filter": _name("DCTDecode"), "BitsPerComponent": 8,
                 "ColorSpace": _name("DeviceGray" if c == 1 else "DeviceRGB")}
    ref = {k: b"%d 0 R" % k for k in range(1, 7)}
    objects = {  # object number -> (dict, stream), in the order Pillow writes them
        4: ({"Type": _name("Catalog"), "Pages": ref[5]}, None),
        5: ({"Type": _name("Pages"), "Count": 1, "Kids": [ref[2]]}, None),
        1: ({"Type": _name("XObject"), "Subtype": _name("Image"), "Width": w, "Height": h,
             **image}, stream),
        2: ({"Resources": {"ProcSet": [_name("PDF"), _name("ImageB" if c == 1 else "ImageC")],
                           "XObject": {"image": ref[1]}},
             "MediaBox": [0, 0, float(w), float(h)], "Contents": ref[3],
             "Type": _name("Page"), "Parent": ref[5]}, None),
        3: ({}, b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (float(w), float(h))),
        6: ({"Title": _text(os.path.splitext(os.path.basename(path))[0]),
             "CreationDate": _date(when), "ModDate": _date(when)}, None),
    }
    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}
    for number, (entries, data) in objects.items():
        offsets[number] = len(out)
        if data is not None:
            entries = {**entries, "Length": len(data)}
        out += b"%d 0 obj" % number + _dict(entries)
        if data is not None:
            out += b"stream\n" + data + b"\nendstream\n"
        out += b"endobj\n"
    start = len(out)
    out += b"xref\n0 7\n" + b"%010d %05d f \n" % (0, 65536)
    out += b"".join(b"%010d %05d n \n" % (offsets[k], 0) for k in range(1, 7))
    out += (b"trailer\n" + _dict({"Root": ref[4], "Size": 7, "Info": ref[6]})
            + b"\nstartxref\n%d\n%%%%EOF" % start)
    return bytes(out)
